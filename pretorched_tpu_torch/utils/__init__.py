"""Utilities for the example CLIs."""

from .misc import AverageMeter, DeviceRunningSums  # noqa: F401
