"""Mean device-timed milliseconds of the update half of a train step
(`PPOLearner.update`: GAE and the epochs of minibatch steps), CUDA events
around each call in the window."""
from harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "update")
