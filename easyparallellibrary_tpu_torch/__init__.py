"""PyTorch/CUDA port of easyparallellibrary_tpu.

A package beside the JAX one, mirroring its module paths; the JAX
package stays the reference the port is tested against.  Ported so far:
the paged serving path (``serving.ContinuousBatchingEngine`` over
``models.gpt.GPT``), with paged attention as a hand-written CUDA kernel
for Hopper (``kernels/csrc/paged_attention.cu``).  ROADMAP.md lists what
is still to port.

Importing the package is cheap: no kernel is built until first use.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
