"""The FLOPs of the window's train steps (the MLP forward of the rollout,
the env step, the value bootstrap, the forward and backward of every
epoch), counted from shapes, over the window and the float32 peak."""
from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
