"""Percent of the traced steps' wall in which no operation ran on the
device: 1 - the union of every device interval over the wall, from a
trace of the device alone (recording the host's ops as well slows a
host-paced step and would read as idle)."""


def read(run):
  trace = run.get("device_trace")
  if not trace or not trace["kernels"]:
    return None
  return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
