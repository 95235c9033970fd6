"""Timing on the CUDA card: CUDA events around a launch loop, and device
time by kernel from `torch.profiler`.

A launch loop timed with events is paced by the host whenever a launch
costs the host more than the kernel costs the device; the profiler's device
time is the kernel's own. Both helpers need a CUDA card.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def event_time_ms(fn: Callable, n: int, warmup: int = 3) -> float:
    """Milliseconds per call of `fn` over `n` back-to-back calls, by CUDA
    events (host-paced if the host is the slower side)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def kernel_times_ms(fn: Callable, n: int, warmup: int = 3) -> Dict[str, Dict[str, float]]:
    """Per CUDA kernel name, the device milliseconds ("ms") and the launches
    ("count") of one call of `fn`, from a profile of `n` calls (memcpy and
    memset entries included). Empty where the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        total = getattr(ev, "self_device_time_total", None)
        if total is None:
            total = getattr(ev, "self_cuda_time_total", 0.0)
        if total:
            row = out.setdefault(ev.key, {"ms": 0.0, "count": 0.0})
            row["ms"] += total / 1e3 / n
            row["count"] += ev.count / n
    return out


def device_time_ms(fn: Callable, n: int, match: Optional[str] = None,
                   tries: int = 3) -> Optional[float]:
    """Device milliseconds per call of `fn`: the sum over its kernels, or
    over those whose name contains `match`. A profile that shows no such
    device time is taken again, up to `tries` profiles in all (the profiler
    now and then records no device activity); None if none shows it (time
    with `event_time_ms` then)."""
    for _ in range(tries):
        picked = [row["ms"] for name, row in kernel_times_ms(fn, n).items()
                  if match is None or match in name]
        if picked:
            return sum(picked)
    return None
