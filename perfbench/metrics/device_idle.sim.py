"""The share of the traced slice in which no operation ran on the device."""
from harness.readers import device_idle


def read(ctx):
    return device_idle(ctx)
