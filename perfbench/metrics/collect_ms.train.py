"""Mean device-timed milliseconds of the collect half of a train step
(`PPOLearner.collect`: the graph replay of the rollout, the value
bootstrap), CUDA events around each call in the window."""
from harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "collect")
