"""Tracing and profiling utilities.

Counterpart of ``pretorched_tpu/utils/profiling.py``. The reference's
closest artifacts are wall-clock AverageMeters (imagenet_eval.py:163-167)
and shape-printing forward hooks (visu_arch.py:75-92). Here:

* ``span(name)``: a context manager and decorator around one piece of the
  program's work, placed at its layer boundaries (preprocess, the stems,
  the eval and train steps, remat's recompute, the optimizer, each K1 and
  K2 launch). While a ``torch.profiler`` runs it records the host start
  and end, the device time between two CUDA events on the current stream
  and its parent, and opens the range ``pretorched.<name>``, so that the
  span sits on the kernels' timeline in the profiler's trace. With no
  profiler on a span site costs a flag read;
* ``recorded()`` / ``reset()``: the spans recorded so far, by name, and
  forgetting them. Spans stay in memory until the caller reads them;
* ``count(name, n)`` / ``counters()``: counters, always on (preprocess's
  clips and the constants it builds on the host); ``counters()`` also
  reports K1's and K2's launches by program;
* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a TensorBoard-viewable trace (CPU, and CUDA when present) holding
  the kernels and the program's spans. The operator's use::

      with profiling.trace('trace'):
          for _ in range(steps):
              step(x, labels)
      print(profiling.recorded(), profiling.counters())

* ``op_shapes(fn, *args)``: ``(op_name, output_shape)`` of the ATen ops
  ``fn`` runs (by default convolutions and matrix products), caught below
  autograd by a ``TorchDispatchMode``;
* ``flops_estimate(fn, *args)``: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler
from torch.utils._python_dispatch import TorchDispatchMode

MATMUL_OPS = ('convolution', 'mm', 'addmm', 'bmm', 'baddbmm')
# the profiler's name of a span's range
PREFIX = 'pretorched.'

# closed spans in the order they closed (list.append is atomic)
_records: List['_Record'] = []
# every thread's stack of open spans, by thread
_stacks: Dict[int, list] = {}
_counts: Dict[str, int] = {}
_count_lock = threading.Lock()


class _Record:
    __slots__ = ('span', 'parent', 'range', 'start', 'end', 't0', 't1')


class _Local(threading.local):
    def __init__(self):
        self.stack = []
        _stacks[threading.get_ident()] = self.stack


# this thread's stack of open spans
_local = _Local()


def _parent(stack):
    """The innermost span open on this thread. Autograd runs a backward on
    the card on a thread of its own, which has none open: there, the span
    held open by the one other thread that has one (the caller of
    ``backward``)."""
    if stack:
        return stack[-1]
    if torch._C._current_graph_task_id() == -1:
        return None
    held = [s[-1] for s in list(_stacks.values()) if s]
    return held[0] if len(held) == 1 else None


class _Span:
    __slots__ = ('name',)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            stack = _local.stack
            r = _Record()
            r.span, r.parent = self, _parent(stack)
            r.range = _profiler.record_function(PREFIX + self.name)
            r.range.__enter__()
            r.start = r.end = None
            if torch.cuda.is_initialized():
                r.start = torch.cuda.Event(enable_timing=True)
                r.start.record()
            r.t0 = time.perf_counter_ns()
            stack.append(r)
        return self

    def __exit__(self, *exc):
        stack = _local.stack
        if stack and stack[-1].span is self:
            r = stack.pop()
            r.t1 = time.perf_counter_ns()
            if r.start is not None:
                r.end = torch.cuda.Event(enable_timing=True)
                r.end.record()
            r.range.__exit__(None, None, None)
            _records.append(r)

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


_spans: Dict[str, _Span] = {}


def span(name: str) -> _Span:
    """``with span(name):`` or ``@span(name)``: records the block while a
    ``torch.profiler`` runs (``recorded()``), else does nothing. One object
    a name, entered on any thread and recursively: what is open lives on
    each thread's stack."""
    try:
        return _spans[name]
    except KeyError:
        return _spans.setdefault(name, _Span(name))


def recorded() -> Dict[str, dict]:
    """``{name: {'host_ms', 'self_host_ms', 'device_ms', 'self_device_ms':
    [one value a span], 'parent': the name of the first one's parent}}``
    of the spans closed since ``reset()``. Self time is the span's less
    its children's. Device times need CUDA initialised when the span
    opened (else their lists are empty); reading them waits for the
    device."""
    records = list(_records)
    host, device = {}, {}
    for r in records:
        host[id(r)] = (r.t1 - r.t0) / 1e6
        if r.end is not None:
            r.end.synchronize()
            device[id(r)] = r.start.elapsed_time(r.end)
    child_host, child_device = defaultdict(float), defaultdict(float)
    for r in records:
        if r.parent is not None:
            child_host[id(r.parent)] += host[id(r)]
            child_device[id(r.parent)] += device.get(id(r), 0.0)
    out = {}
    for r in records:
        e = out.setdefault(r.span.name, {
            'host_ms': [], 'self_host_ms': [], 'device_ms': [],
            'self_device_ms': [],
            'parent': r.parent.span.name if r.parent is not None else None})
        e['host_ms'].append(host[id(r)])
        e['self_host_ms'].append(host[id(r)] - child_host[id(r)])
        if id(r) in device:
            e['device_ms'].append(device[id(r)])
            e['self_device_ms'].append(device[id(r)] - child_device[id(r)])
    return out


def reset():
    """Forget the spans recorded so far (spans still open stay open)."""
    _records.clear()


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter, and K1's and K2's launches by program as their
    wrappers count them (``k1.<op>.<program>``, ``k2.<kernel>``), where
    not 0."""
    from ..ops.cuda import fused_block, nonlocal_attention as na

    with _count_lock:
        out = dict(_counts)
    for op, fn in (('fwd', na.nonlocal_attention_cuda),
                   ('dq', na.nonlocal_attention_bwd_dq_cuda),
                   ('dkv', na.nonlocal_attention_bwd_dkv_cuda)):
        out.update((f'k1.{op}.{p}', n) for p, n in fn.by_kernel.items() if n)
    out.update((f'k2.{k}', n) for k, n in
               fused_block.fused_bottleneck_tail_cuda.by_kernel.items() if n)
    return out


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block and write its trace (``*.pt.trace.json``) into
    ``logdir`` (default: ``torch-trace`` in the temporary directory). The
    program's spans record inside it and appear in the trace as
    ``pretorched.<name>`` ranges over the kernels they queued."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), 'torch-trace')
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


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
