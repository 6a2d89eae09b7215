"""Deterministic builders for tests and smoke runs of the PyTorch port."""

from easyparallellibrary_tpu_torch.testing import chaos  # noqa: F401
