"""Device microseconds per rollout step of everything in a collect but the
step kernel (the policy network, its sampling, the copies around the
graph), from the profiler's trace of a slice of collects."""
from harness.readers import STEP_KERNEL, non_kernel_us_per_step


def read(ctx):
    return non_kernel_us_per_step(ctx, STEP_KERNEL)
