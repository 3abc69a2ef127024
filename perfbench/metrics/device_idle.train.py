"""device_idle.train: the share of the traced window in which nothing ran on
the device (1 - the union of the device's activity intervals over the
window), in percent."""

from perfbench.yardstick.readers import device_idle


def read(ctx):
    return device_idle(ctx)
