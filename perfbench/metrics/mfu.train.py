"""The whole step's share of the card's peak, in percent: the window's
tokens per second times the FLOPs a token requires (the family's count:
the matrix products, attention's kept pairs, no recompute) over the
published dense peak of the configuration's compute dtype."""


def read(run):
  window = run["window"]
  if not window["steps"]:
    return None
  rate = window["tokens"] / window["seconds"]
  return 100.0 * rate * run["flops_per_token"] / run["peak_flops"]
