"""Deterministic builders for tests and smoke runs of the PyTorch port."""
