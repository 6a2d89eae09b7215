"""Percent of the device's busy time in the traced steps spent in K1, the
flash attention operation: every device event launched under the port's
flash op (``epl_torch::flash_attention_fwd``) or its backward node
(``GeneratedBackwardFor_epl_torch_flash_attention_fwd...``), which
covers the forward, dQ and dK/dV kernels and the backward's eager
``delta``."""

from perfbench import trace as trace_lib

OP = "flash_attention_fwd"


def read(run):
  trace = run.get("trace")
  if not trace:
    return None
  events = trace_lib.under(trace, OP)
  if not any("flash" in name for name, _, _ in events):
    return None
  return 100.0 * sum(e - s for _, s, e in events) / 1e6 / trace["busy_s"]
