"""The one-step launches of `csrc/fused_step.cu` in the collector's graph:
their least time (bytes of the carry, init, action, noise and collect
blocks over the HBM bandwidth, or the plain step's operations over the
float32 peak) over their device time, in %."""
from harness.readers import STEP_KERNEL, kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, STEP_KERNEL, steps=1, collected=True, held_action=False)
