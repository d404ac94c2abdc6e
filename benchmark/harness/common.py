"""One run of one cell: set-up, the measured window, the check, the result.

``Run`` holds what a mode's module (``modes/<mode>.py``) needs and what
the readers of the per-layer metrics read. A mode's module provides:

* ``measure(run)``: builds the system under test from the configuration
  and the seed, warms up every shape the traffic uses, calls
  ``run.setup_done()``, drives ``run.window(step, samples_per_step)``
  (``run.in_window`` tells a window's step from a traced step after it)
  and returns its evidence, holding no reference to the program's state;
* ``readings(run, evidence)``: the plain reference's check of what the
  window produced: ({number: value}, samples that failed);
* ``control(run, evidence)``: the same readings of the reference in the
  program's place, in the precision below the configuration's.
"""

from __future__ import annotations

import contextlib
import gc
import math
import subprocess
import time

import numpy as np
import torch

from benchmark.reference.ops import Fp8Ops, Ops

from .spans import DeviceTrace, Spans
from .weights import seeded_state


def sub_seeds(seed: int, names=('weights', 'data', 'order')):
    """Independent 63-bit seeds for each use of ``seed``."""
    children = np.random.SeedSequence(seed).spawn(len(names))
    return {n: int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for n, c in zip(names, children)}


def smi():
    """The card's name, power limit and draw, SM clock and its maximum,
    temperature (``nvidia-smi``), or why they were not read."""
    query = 'name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu'
    try:
        out = subprocess.run(['nvidia-smi', f'--query-gpu={query}',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'not measured ({e.__class__.__name__})'
    return (out.stdout.strip().splitlines() or ['not measured'])[0]


def k1_launches():
    """K1's launches so far by op and program (the port's counters)."""
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    return {f'{op} {prog}': n
            for op, fn in (('fwd', na.nonlocal_attention_cuda),
                           ('dq', na.nonlocal_attention_bwd_dq_cuda),
                           ('dkv', na.nonlocal_attention_bwd_dkv_cuda))
            for prog, n in fn.by_kernel.items() if n}


def seeded_model(run):
    """The configuration's factory on the meta device (no storage, nothing
    run) and the seeded state dict on the run's device: (model, state)."""
    import pretorched_tpu_torch as program

    cfg = run.cell.config
    with torch.device('meta'):
        model = program.__dict__[cfg['factory']](**cfg['kwargs'])
    persistent = set(model.state_dict())
    stray = [n for n, _ in model.named_buffers() if n not in persistent]
    if stray:
        raise RuntimeError(f'buffers outside the state dict: {stray}')
    count = sum(p.numel() for p in model.parameters())
    if count != cfg['architecture']['parameters']:
        raise RuntimeError(f"{cfg['factory']} has {count} parameters, the "
                           f"configuration {cfg['architecture']['parameters']}")
    if run.cell.dtype == 'float64':     # the CPU tests' exact arithmetic
        model = model.double()
    return model, seeded_state(model, run.seeds['weights'], run.device,
                               **cfg['init'])


def build_model(run):
    """The model on the run's device with the seeded state dict loaded
    strict: (model, state); ``state`` stays the benchmark's, for the
    reference."""
    model, state = seeded_model(run)
    model = model.to_empty(device=run.device)
    model.load_state_dict(state, strict=True)
    return model, state


# seconds of steps traced by the profiler after a traced run's window
TRACE_SECONDS = 4.0


def p95(values):
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


class Run:
    def __init__(self, cell, seed, seconds, trace, device, t0):
        self.cell, self.seconds = cell, seconds
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self.t0 = t0
        self.seeds = sub_seeds(seed)
        self.spans = Spans(False)
        self.reference_tf32 = False
        self.setup_s = self.window_s = None
        self.steps = self.samples = 0
        self.intervals_ms = []
        self.device_trace = None
        self.span_ms, self.host_ms = {}, {}
        self.peak_bytes = None
        self.in_window = False

    @contextlib.contextmanager
    def lower_precision(self):
        """The control's products: the precision below the traffic's,
        TF32 for float32 (TF32 off), float8 operands for bfloat16."""
        if self.cell.dtype == 'float32':
            self.reference_tf32 = True
            try:
                yield Ops()
            finally:
                self.reference_tf32 = False
        else:
            yield Fp8Ops()

    def note(self, line):
        """An earlier line of the run's output."""
        print(line, flush=True)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        if self.cuda:
            self.k1_before = k1_launches()
            self.note(f'before the window: {smi()}')

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _steps(self, step, i, seconds, marks):
        """``step(i)``, ``step(i + 1)``, ... for ``seconds`` on the host
        clock, at most ``queued_steps`` in flight; returns the next i."""
        queued = self.cell.traffic['queued_steps']
        first, t0 = i, time.perf_counter()
        while i == first or time.perf_counter() - t0 < seconds:
            if self.cuda and len(marks) >= queued:
                with self.spans.host('wait'):
                    marks[-queued].synchronize()
            step(i)
            marks.append(self._mark())
            i += 1
        return i

    def window(self, step, samples_per_step):
        """``step(i)`` for i = 0, 1, ... until ``seconds`` have passed since
        the first dispatch; the window closes when the last step is done.
        A traced run records spans in the window; the window closed, it
        runs the same steps ``TRACE_SECONDS`` more under ``torch.profiler``
        (the device trace), so that the profiler's start-up and cost stay
        out of the window."""
        self.spans.enabled = self.trace and self.cuda
        marks = []
        self.in_window = True
        first = self._mark()
        t_first = time.perf_counter()
        i = self._steps(step, 0, self.seconds, marks)
        self.sync()
        self.window_s = time.perf_counter() - t_first
        self.in_window = False
        self.steps, self.samples = i, i * samples_per_step
        edges = [first] + marks
        self.intervals_ms = ([a.elapsed_time(b) for a, b in zip(edges,
                                                               edges[1:])]
                             if self.cuda else
                             [(b - a) * 1e3 for a, b in zip(edges, edges[1:])])
        self.span_ms, self.host_ms = (self.spans.device_ms(),
                                      self.spans.host_ms())
        if self.cuda:
            self._after_window()
        if self.spans.enabled:
            self.spans.collect = False      # the ranges only, for the gaps
            trace = DeviceTrace()
            trace.start()
            self._steps(step, i, TRACE_SECONDS, [])
            trace.stop()
            self.device_trace = trace.summary
        self.spans.enabled = False

    def _after_window(self):
        """Peak memory, K1's launches and the card's state as the window
        left them."""
        self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        after = k1_launches()
        window = {k: n - self.k1_before.get(k, 0) for k, n in after.items()
                  if n != self.k1_before.get(k, 0)}
        self.note(f'after the window: {smi()}')
        self.note(f'K1 launches by program in the window ({self.steps} '
                  f'steps): {window or "none"}')
        self.note(f'peak device memory: {self.peak_bytes} bytes '
                  f'({self.peak_bytes / 2 ** 30:.3f} GiB)')

    def patch_spans(self):
        """In a traced run, spans around the model's calls of the layers the
        per-layer metrics read (``probes.PROBES``)."""
        if self.trace and self.cuda:
            from . import probes
            probes.install(self.spans)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
