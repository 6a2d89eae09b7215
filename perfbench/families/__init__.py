"""How each model family is built through the port, its weights drawn
and its work counted (``perfbench/families/<family>.py``, named by a
configuration's ``family``)."""
