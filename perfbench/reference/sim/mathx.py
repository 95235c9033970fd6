# Frozen copy of heligym_tpu_torch/utils/math.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Small math helpers over (batched) torch scalars."""
import math

import numpy as np
import torch


def recip32(c: float) -> float:
    """`1/c` the way XLA and PyTorch's CUDA kernels divide by a constant:
    both rewrite `x / c` as `x * (f32(1) / f32(c))`, the reciprocal rounded
    once in float32. `cdiv` uses it so every backend of the port (CPU
    tensors, CUDA tensors, the CUDA kernel's constant table) rounds a
    division by a constant the same way as the JAX package."""
    return float(np.float32(1.0) / np.float32(c))


def cdiv(x, c: float):
    """`x / c` for a Python-float constant `c`, rounded as XLA rounds it."""
    return x * recip32(c)


def rdiv(c: float, x):
    """`c / x` for a Python-float constant `c`, rounded once as XLA divides.
    (A tensor's `c / x` is `x.reciprocal() * c`: two roundings.)"""
    return torch.full_like(x, c) / x


def pi_bound(x):
    """Wrap angle(s) to (-pi, pi]: `(x + pi) % (2 pi) - pi` with floored-mod
    semantics (`torch.remainder`, like numpy's `%` and `jnp.mod`)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def cross(a, b):
    """3-vector cross product over tuple vectors (reference component order).
    Returns a 3-tuple of (batched) scalars."""
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )
