"""Compute ops: the position-keyed noise stream (``noise``), the plain
torch stencil core (``stencil``), the kernel generator (``kernelgen``:
a model's reaction traced and emitted as CUDA), the per-model build
(``_build``, into the template ``csrc/stencil_chain.cu``) and the fused
kernel's dispatch with its plain versions (``cuda_stencil``)."""
