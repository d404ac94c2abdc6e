"""The device's idle share of the traced window: 1 - the union of the
intervals in which a kernel, copy or memset ran over the window from the
first to the last of them (``torch.profiler``)."""

from benchmark.yardstick.shares import idle


def read(run):
    return idle(run)
