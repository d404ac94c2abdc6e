"""The train window's model FLOPs (forward and backward as autograd takes
them on the plain model, counted from the configuration's shapes:
``yardstick``) over the window's seconds times the precision's peak."""

from benchmark.yardstick.shares import mfu


def read(run):
    return mfu(run, train=True)
