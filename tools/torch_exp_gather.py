#!/usr/bin/env python3
"""The gather probe on one CUDA card: the port's counterpart of
tools/exp_gather.py.

For each probe size and axis it makes the probe's inputs (numpy, seed 0:
f32 x (S, L), i32 idx (S, L)), runs the hand-written CUDA kernel
(heligym_tpu_torch/ops/cuda/gather.py), checks it against
np.take_along_axis, and times it on the device (torch.profiler's device
time over 200 launches; a loop timed with CUDA events is paced by the host
at these sizes and is printed beside it) against torch.gather on the same
inputs and against the bound (12 bytes per element over the card's
3.35 TB/s). Prints one line per trial:

    axis0 S=1024 L=1024: correct=True  6.1 us/call  torch.gather 7.0 us  ...

Run from the repo root: python3 tools/torch_exp_gather.py
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heligym_tpu_torch.ops.cuda import gather  # noqa: E402
from heligym_tpu_torch.utils.profiling import device_time_ms, event_time_ms  # noqa: E402

AXIS0_SIZES = [(8, 128), (64, 128), (64, 1024), (256, 1024), (1024, 1024)]
AXIS1_SIZES = [(8, 128), (8, 1024), (64, 1024), (1024, 1024)]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory


def probe_inputs(S, L, axis):
    """The probe's inputs, as tools/exp_gather.py makes them."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, L)).astype(np.float32)
    idx = rng.integers(0, S if axis == 0 else L, size=(S, L)).astype(np.int32)
    return x, idx


def time_us(fn, n=200):
    """(device, launch-loop) microseconds per call of `fn`: the profiler's
    device time (the loop's event time where the profiler sees none), and
    the event time of the loop."""
    loop = event_time_ms(fn, n, warmup=10) * 1e3
    dev = device_time_ms(fn, n)
    return (loop if dev is None else dev * 1e3), loop


def trial(axis, S, L, device="cuda"):
    """One probe trial; returns its numbers as a dict."""
    kernel = gather.gather_axis0 if axis == 0 else gather.gather_axis1
    x_np, idx_np = probe_inputs(S, L, axis)
    x, idx = torch.from_numpy(x_np).to(device), torch.from_numpy(idx_np).to(device)
    out = kernel(x, idx)
    want = np.take_along_axis(x_np, idx_np, axis=axis)
    plain = gather.gather_plain(x, idx, axis)
    idx64 = idx.to(torch.int64)
    us, loop_us = time_us(lambda: kernel(x, idx, check=False))
    return {"name": f"gather_axis{axis}", "S": S, "L": L,
            "correct": bool(np.array_equal(out.cpu().numpy(), want)),
            "max_abs_err": float((out - plain).abs().max()),
            "us": us, "loop_us": loop_us,
            "plain_us": time_us(lambda: gather.gather_plain(x, idx, axis))[0],
            "library_us": time_us(lambda: torch.gather(x, axis, idx64))[0],
            "bound_us": S * L * gather.BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e6}


def run_probe(device="cuda"):
    """Every trial of the probe, printed as it goes; returns the rows."""
    rows = []
    for axis, sizes in ((0, AXIS0_SIZES), (1, AXIS1_SIZES)):
        for S, L in sizes:
            r = trial(axis, S, L, device)
            rows.append(r)
            print(f"axis{axis} S={S} L={L}: correct={r['correct']}  "
                  f"{r['us']:.2f} us/call  torch.gather {r['library_us']:.2f} us  "
                  f"take_along_dim {r['plain_us']:.2f} us  bound {r['bound_us']:.3f} us  "
                  f"(launch loop {r['loop_us']:.2f} us)")
    return rows


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print("device:", torch.cuda.get_device_name(0))
    if not all(r["correct"] for r in run_probe()):
        sys.exit("a gather kernel disagrees with np.take_along_axis")
