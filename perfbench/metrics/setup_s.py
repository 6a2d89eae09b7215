"""Seconds from the start of the process to the first timed step: the
imports, the kernel library's build or load, the weights and batches,
and the three checked steps that warm every shape (host clock)."""


def read(run):
  return run["setup_s"]
