"""Arithmetic shared by the per-layer metrics' readers (`metrics/*.py`).
Each returns None where its run has nothing to read: a reader never gives
0 for a share it could not measure."""
from __future__ import annotations

from statistics import mean
from typing import Optional

from . import counts

STEP_KERNEL = "fused_step_kernel"          # one transition a launch
ROLLOUT_KERNEL = "fused_rollout_kernel"    # T transitions a launch


def span_ms(ctx, name: str) -> Optional[float]:
    """Mean milliseconds of a span over the window's units (CUDA events)."""
    times = ctx.spans.get(name)
    return mean(times) if times else None


def device_idle(ctx) -> Optional[float]:
    """1 - (union of the device's busy intervals / the traced slice's
    wall), in %."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(ctx) -> Optional[float]:
    """The FLOPs the window's units need, counted from shapes, over the
    window and the float32 peak outside the tensor cores, in %."""
    w = ctx.window
    if not w["units"] or w["seconds"] <= 0:
        return None
    return 100.0 * ctx.unit_flops() * w["units"] / w["seconds"] / ctx.peaks["fp32_flops_per_s"]


def kernel_roofline(ctx, kernel: str, steps: int, collected: bool,
                    held_action: bool) -> Optional[float]:
    """A step-kernel launch's least time (`counts.step_launch_bound_s`)
    over its mean device time in the trace, in %."""
    tr = ctx.trace
    if tr is None:
        return None
    launches = tr.launches(kernel)
    if not launches:
        return None
    per_launch = tr.device_s(kernel) / launches
    bound = counts.step_launch_bound_s(ctx.program.n, steps, ctx.env_ops, collected,
                                       held_action)
    return 100.0 * bound / per_launch


def non_kernel_us_per_step(ctx, kernel: str) -> Optional[float]:
    """Device microseconds per env step of every operation but `kernel`."""
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    steps = tr.units * int(ctx.ppo["rollout_steps"])
    return 1e6 * (tr.device_s() - tr.device_s(kernel)) / steps
