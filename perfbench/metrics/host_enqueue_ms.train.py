"""Host milliseconds a train step's call takes to return when it starts
on an idle device, no synchronize inside: the median over the traced
run's enqueue steps (host clock).  Beside the step's device time it says
how far the host's dispatch paces the card."""

import statistics


def read(run):
  times = run.get("enqueue_s")
  if not times:
    return None
  return 1e3 * statistics.median(times)
