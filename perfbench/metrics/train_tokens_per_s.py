"""Tokens of every step completed in the window over the window's wall
time, the window ended by a synchronize (host clock)."""


def read(run):
  window = run["window"]
  if not window["steps"]:
    return None
  return window["tokens"] / window["seconds"]
