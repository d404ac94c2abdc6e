"""The eval window's model FLOPs (the configuration's products, counted
from its shapes: ``yardstick``) over the window's seconds times the
precision's peak."""

from benchmark.yardstick.shares import mfu


def read(run):
    return mfu(run, train=False)
