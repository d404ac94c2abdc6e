"""Utilities for the example CLIs and training loops."""

from .misc import (HTML, AverageMeter, DeviceRunningSums, cache,  # noqa: F401
                   chunks, class_accuracy, lazy_property, log_add, softmax,
                   sort, topk_accuracy)
from .size import SizeEstimator  # noqa: F401
from .profiling import (count, counters, flops_estimate, op_shapes,  # noqa: F401
                        recorded, span, trace)
from .debugging import assert_finite, checked, grad_stats  # noqa: F401
from .preemption import PreemptionGuard  # noqa: F401
