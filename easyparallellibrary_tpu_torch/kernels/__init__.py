"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version.  Built at first use (``_build``), never at import."""
