"""Per-element gathers along axis 0 and axis 1: two hand-written CUDA kernels.

Counterparts of the two TPU probe kernels of the JAX package's
`tools/exp_gather.py` (`gather_axis0_kernel`, `gather_axis1_kernel`), which
asked whether `take_along_axis` can run inside a kernel: for f32 `x (S, L)`
and i32 `idx (S, L)`,

    gather_axis0: out[s, l] = x[idx[s, l], l]
    gather_axis1: out[s, l] = x[s, idx[s, l]]

`gather_axis0` / `gather_axis1` are the wrappers: CUDA tensors launch the
kernel of `csrc/gather.cu` (or raise); CPU tensors run the plain version,
`torch.take_along_dim`. Nothing falls back from one to the other. Indices
must lie in [0, n) — numpy's negative wrap-around is not offered;
`check=True` verifies that on the host (one device sync) and raises
IndexError, `check=False` skips it and the kernel clamps.
"""
from __future__ import annotations

import functools

import torch

KERNEL = "gather"               # csrc/gather.cu holds both kernels
REPLACES = {"gather_axis0": "tools/exp_gather.py:18",
            "gather_axis1": "tools/exp_gather.py:22"}
BYTES_PER_ELEMENT = 12          # index in, value in, value out

# Launches of each kernel (not of the plain version) since import.
launches = {"gather_axis0": 0, "gather_axis1": 0}


def gather_plain(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The kernels' function in plain PyTorch."""
    return torch.take_along_dim(x, idx.to(torch.int64), dim=axis)


@functools.lru_cache(maxsize=None)
def kernel_fns():
    """The two C entry points, built from csrc/ at first use."""
    import ctypes

    from . import build
    lib = build.load(KERNEL)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for axis in (0, 1):
        fn = getattr(lib, f"heligym_gather_axis{axis}")
        fn.argtypes = [vp, vp, vp, ci, ci, vp]
        fn.restype = ci
        fns[axis] = fn
    return fns


def _gather(x: torch.Tensor, idx: torch.Tensor, axis: int, check: bool):
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"expected x (S, L) and idx of the same shape, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"expected float32 x and int32 idx, got {x.dtype} "
                         f"and {idx.dtype}")
    if idx.device != x.device:
        raise ValueError(f"x on {x.device}, idx on {idx.device}")
    n = x.shape[axis]
    if check and idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"index out of range [0, {n}) along axis {axis}")
    if x.device.type == "cpu":
        return gather_plain(x, idx, axis)
    if x.device.type != "cuda":
        raise ValueError(f"gather runs on CUDA or CPU tensors, not {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("expected contiguous x and idx")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = kernel_fns()[axis](x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                 x.shape[0], x.shape[1],
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_axis{axis} kernel launch failed: cudaError {err}")
    if idx.numel():
        launches[f"gather_axis{axis}"] += 1
    return out


def gather_axis0(x: torch.Tensor, idx: torch.Tensor, check: bool = True):
    """out[s, l] = x[idx[s, l], l]."""
    return _gather(x, idx, 0, check)


def gather_axis1(x: torch.Tensor, idx: torch.Tensor, check: bool = True):
    """out[s, l] = x[s, idx[s, l]]."""
    return _gather(x, idx, 1, check)
