"""Profiling helpers of the PyTorch port."""
