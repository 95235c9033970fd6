"""The FLOPs of the window's rollouts (the MLP forward, the env step,
the value bootstrap), counted from shapes, over the window and the float32
peak."""
from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
