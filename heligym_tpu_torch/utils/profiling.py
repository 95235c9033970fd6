"""Profiling and metering: the JAX package's helpers on PyTorch, and timing
on the CUDA card.

* `Timer` / `time_fn`: wall-clock timing; `time_fn` waits for the card
  (`torch.cuda.synchronize()`) when the output lies on it.
* `StepsMeter`: a running env-steps/s meter for training loops.
* `trace(logdir)`: a `torch.profiler` scope that writes a Chrome trace
  (`chrome://tracing`, Perfetto) into `logdir`; the card's kernels are in it
  when there is a card.
* `debug_nans`: a scoped check that raises `FloatingPointError` at the first
  PyTorch op whose floating output is not finite.
* `event_time_ms`, `kernel_times_ms`, `device_time_ms`: the card's time of a
  launch loop by CUDA events, and device time by kernel from
  `torch.profiler`. A launch loop timed with events is paced by the host
  whenever a launch costs the host more than the kernel costs the device;
  the profiler's device time is the kernel's own. These three need a card.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class Timer:
    """`with Timer() as t: ...`, then `t.elapsed` seconds (host clock)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def _wait(out) -> None:
    """Wait for the cards that hold a tensor of `out`."""
    for dev in {x.device for x in tree_leaves(out)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1, **kw) -> float:
    """Seconds per call of `fn(*args, **kw)`: `warmup` untimed calls (builds,
    allocator, caches), then `iters` timed calls, each phase ended by a wait
    for the card where the output lies on it."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    _wait(out)
    return (time.perf_counter() - t0) / iters


class StepsMeter:
    """Running throughput meter: feed it env-step counts, read steps/s."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def add(self, n: int):
        self._steps += n

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """`torch.profiler` scope (the host's ops, and the card's kernels where
    there is a card); on exit the Chrome trace is written to
    `logdir/trace_<pid>_<time>.json`. Yields the profiler, whose
    `key_averages()` sums the scope by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))


# ops whose output is uninitialised memory, not a computed value
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")
_nan_checks = [False]           # debug_nans' current setting


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _nan_checks[0] and func.__name__.split(".")[0] not in _UNINITIALISED:
            for x in tree_leaves(out):
                if (isinstance(x, torch.Tensor) and x.is_floating_point()
                        and not bool(torch.isfinite(x).all())):
                    raise FloatingPointError(
                        f"{func.__name__} produced a non-finite value "
                        f"(shape {tuple(x.shape)})")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope (with `enable`), every PyTorch op checks its floating
    outputs and raises `FloatingPointError` at the first NaN or infinity, as
    the JAX package's `jax_debug_nans` scope raises at the op that made a
    NaN. `enable=False` turns the check off inside an enabled scope. The
    setting before the scope comes back on exit. What runs outside PyTorch's
    dispatcher, such as a ctypes kernel launch, is not checked (its outputs
    are, at the next op that reads them)."""
    prev = _nan_checks[0]
    _nan_checks[0] = enable
    try:
        with (_NanCheck() if enable and not prev else contextlib.nullcontext()):
            yield
    finally:
        _nan_checks[0] = prev


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
