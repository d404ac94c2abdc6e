"""Tracing and profiling utilities.

Counterpart of ``pretorched_tpu/utils/profiling.py``. The reference's
closest artifacts are wall-clock AverageMeters (imagenet_eval.py:163-167)
and shape-printing forward hooks (visu_arch.py:75-92). Here:

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a TensorBoard-viewable trace (CPU, and CUDA when present);
* ``StepTimer``: batch-time / data-time meters with the reference's
  print format;
* ``op_shapes(fn, *args)``: ``(op_name, output_shape)`` of the ATen ops
  ``fn`` runs (by default convolutions and matrix products), caught below
  autograd by a ``TorchDispatchMode``;
* ``flops_estimate(fn, *args)``: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

MATMUL_OPS = ('convolution', 'mm', 'addmm', 'bmm', 'baddbmm')


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block and write its trace (``*.pt.trace.json``) into
    ``logdir`` (default: ``torch-trace`` in the temporary directory)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), 'torch-trace')
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


class StepTimer:
    """batch-time / data-time meters (reference: imagenet_eval.py:163-208)."""

    def __init__(self):
        from .misc import AverageMeter
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._last = time.time()

    def data_loaded(self):
        now = time.time()
        self.data_time.update(now - self._last)
        return self

    def step_done(self):
        now = time.time()
        self.batch_time.update(now - self._last)
        self._last = now
        return self

    def __str__(self):
        return (f'Time {self.batch_time.val:.3f} ({self.batch_time.avg:.3f})\t'
                f'Data {self.data_time.val:.3f} ({self.data_time.avg:.3f})')


class _OpRecorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = set(ops)
        self.seen: List[Tuple[str, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if (not self.ops or name in self.ops) and \
                isinstance(first, torch.Tensor):
            self.seen.append((name, tuple(first.shape)))
        return out


def op_shapes(fn: Callable, *args, ops: Iterable[str] = MATMUL_OPS
              ) -> List[Tuple[str, tuple]]:
    """(op_name, output_shape) of each ATen op in ``ops`` (all ops when
    empty) that ``fn(*args)`` runs, in order; the shape of an op's first
    output where it has several (a max pool's values, not its indices).
    It runs ``fn`` once."""
    recorder = _OpRecorder(ops)
    with recorder:
        fn(*args)
    return recorder.seen


def flops_estimate(fn: Callable, *args) -> float:
    """FLOPs of one call of ``fn(*args)`` (a multiply-add counts 2)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops())
