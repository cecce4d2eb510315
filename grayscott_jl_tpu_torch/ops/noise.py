"""Position-keyed noise stream (counterpart of ``grayscott_jl_tpu/ops/noise.py``).

Each global cell's draw at each step is a pure function of ``(key,
step, global x, global y, global z)`` through the lowbias32 integer
hash, so chunking, fusion depth and restarts do not change a
trajectory. The bits equal the reference stream's bit for bit.

torch has no usable unsigned 32-bit arithmetic on the CPU (``>>`` on
``uint32`` is not implemented there), so every value here is an int64
holding a uint32 in ``[0, 2**32)``: each operation masks back to 32
bits, a negative int32 input wraps modulo ``2**32``, and the 32x32-bit
products are formed from 16-bit halves so that no int64 product
overflows. The CUDA kernel evaluates the same functions on ``uint32_t``
(``ops/csrc/stencil_chain.cu``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x):
    """A Python int or integer tensor as a uint32 value in int64
    (negative values wrap modulo 2**32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32  # gslint: disable=trace-safety — x is a Python int here


def mul32(x, c):
    """``(x * c) mod 2**32`` for uint32 values ``x`` (tensor or int) and
    ``c``, with every intermediate below 2**49."""
    lo = (x * (c & 0xFFFF)) & MASK32
    hi = ((x * ((c >> 16) & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x):
    """lowbias32 integer finalizer on uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def plane_seed(k0, k1, step, gx):
    """Per-(key, step, global x-plane) seed; ``gx`` may be a tensor."""
    return hash32(
        hash32(hash32(u32(k0)) ^ u32(k1))
        ^ hash32(hash32(u32(step)) ^ u32(gx))
    )


def cell_hash(iy, iz, row):
    """Avalanche hash of the per-cell (y, z) counter ``iy * row + iz``
    (uint32 arithmetic)."""
    return hash32((mul32(u32(iy), u32(row)) + u32(iz)) & MASK32)


def block_bits(seed, iy, iz, row):
    """uint32 noise bits for cells at broadcastable global y/z
    coordinates: ``hash32(cell_hash(y, z) ^ seed)``."""
    return hash32(cell_hash(iy, iz, row) ^ seed)


def bits_to_pm1(bits, dtype):
    """uint32 bits -> uniform [-1, 1): the top 23 bits as the mantissa
    of a float32 in [1, 2), then ``* 2 - 3`` in float32, then ``dtype``."""
    f12 = (0x3F800000 | (bits >> 9)).to(torch.int32).view(torch.float32)
    return (f12 * 2.0 - 3.0).to(dtype)


def uniform_pm1_block(key, step, offsets, shape, row, dtype, device=None):
    """Uniform [-1, 1) noise for the 3D block of ``shape`` at global
    ``offsets``. ``key`` is the integer pair ``(k0, k1)`` (the int32
    words of the reference's PRNG key), ``step`` the absolute step,
    ``row`` the global grid side L. Member keys (``key`` = ``(k0s,
    k1s)``, N-tuples of key words) give the N members' blocks stacked
    ``(N, *shape)``, each member's its own stream."""
    if isinstance(key[0], (tuple, list)):
        return torch.stack([
            uniform_pm1_block((k0, k1), step, offsets, shape, row, dtype,
                              device=device)
            for k0, k1 in zip(*key)])

    def axis(n, off, dim):
        idx = torch.arange(n, dtype=torch.int64, device=device)
        view = [1, 1, 1]
        view[dim] = n
        return ((idx + u32(off)) & MASK32).view(view)

    gx = axis(shape[0], offsets[0], 0)
    seed = plane_seed(key[0], key[1], step, gx)
    iy = axis(shape[1], offsets[1], 1)
    iz = axis(shape[2], offsets[2], 2)
    return bits_to_pm1(block_bits(seed, iy, iz, row), dtype)
