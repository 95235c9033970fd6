"""The operations of the window's env steps (the plain step's count, per env
step), over the window and the float32 peak: the env-only rollout's share
of the chip's peak, beside the step kernel's roofline."""
from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
