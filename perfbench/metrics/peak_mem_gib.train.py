"""GiB the caching allocator held at its peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
  return run["window"]["memory_peak_bytes"] / 2 ** 30
