"""K1's share of its roofline in the traced steps, in percent: the least
time of the attention operations the steps require (forward and
backward a layer, counted by ``perfbench/roofline.py``: kept score
pairs, no recompute, each input read and each output written once),
over the device time of everything launched under the port's flash op
or its backward node.  A recompute of the forward under remat adds time
and no required work."""

from perfbench import roofline
from perfbench import trace as trace_lib

OP = "flash_attention_fwd"


def read(run):
  trace = run.get("trace")
  if not trace:
    return None
  events = trace_lib.under(trace, OP)
  if not any("flash" in name for name, _, _ in events):
    return None
  least = 0.0
  for a in run["attention_ops"]:
    for flops, nbytes in (roofline.attention_forward(a),
                          roofline.attention_backward(a)):
      least += roofline.least_seconds(flops, nbytes, run["peak_flops"],
                                      run["peak_bytes_per_s"])
  spent = sum(e - s for _, s, e in events) / 1e6
  return 100.0 * least * trace["steps"] / spent
