"""Compute ops: the position-keyed noise stream (``noise``), the plain
torch stencil core (``stencil``), the kernel spec (``kernelgen``) and
the fused CUDA kernel's dispatch with its plain versions
(``cuda_stencil``, over ``csrc/stencil_chain.cu``)."""
