"""The T-step launches of `csrc/fused_step.cu` of the env-only rollout: their
least time (bytes of the carry, init, held action, noise and collect blocks
over the HBM bandwidth, or the plain step's operations over the float32
peak) over their device time, in %."""
from harness.readers import ROLLOUT_KERNEL, kernel_roofline


def read(ctx):
    t = ctx.program.traffic
    return kernel_roofline(ctx, ROLLOUT_KERNEL, steps=int(t["steps"]),
                           collected=bool(t["collect"]), held_action=True)
