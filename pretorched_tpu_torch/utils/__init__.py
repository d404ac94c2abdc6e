"""Utilities for the example CLIs and training loops."""

from .misc import AverageMeter, DeviceRunningSums  # noqa: F401
from .preemption import PreemptionGuard  # noqa: F401
