"""Spans around the benchmark's calls into the program, and the device trace.

``Spans`` records, in a traced run, a pair of CUDA events around each call
into a layer (device time between them), the host time of calls whose
return is the point (``host``), and a ``record_function`` range of the same
name, so that the profiler's idle gaps can be labelled by what the host
was doing. In an untraced run it records nothing and costs nothing.

``DeviceTrace`` runs ``torch.profiler`` over steps after the window and
reduces its events: the union of the intervals in which a kernel, copy or
memset ran (busy), the window from the first to the last of them, the
device operations that took most time, and the idle gaps summed by the
innermost span the host was in when each began.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

PREFIX = 'bench.'


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Spans:
    """``enabled``: record; ``collect``: keep the times (off, only the
    ``record_function`` ranges are left, for a device trace's gaps)."""

    def __init__(self, enabled: bool):
        self.enabled, self.collect = enabled, True
        self._events = defaultdict(list)
        self._host = defaultdict(list)
        self._open = {}

    @contextlib.contextmanager
    def span(self, name):
        """Device time of the work queued inside."""
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            start = _event() if self.collect else None
            yield
            if start is not None:
                self._events[name].append((start, _event()))

    @contextlib.contextmanager
    def host(self, name):
        """Host time to return from the call inside."""
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            yield
            if self.collect:
                self._host[name].append(time.perf_counter() - t0)

    def begin(self, name):
        """Open a span that ``finish`` closes (on another call, as autograd
        runs a backward's two ends)."""
        if not self.enabled:
            return
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        self._open[name] = (rf, _event() if self.collect else None)

    def finish(self, name):
        if not self.enabled or name not in self._open:
            return
        rf, start = self._open.pop(name)
        if start is not None:
            self._events[name].append((start, _event()))
        rf.__exit__(None, None, None)

    def device_ms(self):
        """{span: [device ms of each]}; call after a synchronize."""
        return {name: [s.elapsed_time(e) for s, e in pairs]
                for name, pairs in self._events.items()}

    def host_ms(self):
        return {name: [t * 1e3 for t in times]
                for name, times in self._host.items()}


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class DeviceTrace:
    """``torch.profiler`` over [start(), stop()); ``summary`` after stop.
    A first short trace pays the profiler's own start-up (CUPTI's,
    seconds), so that it does not fall between the traced steps."""

    def __init__(self):
        with _profile():
            torch.cuda.synchronize()
        self._prof = _profile()
        self.summary = None

    def start(self):
        self._prof.start()

    def stop(self):
        torch.cuda.synchronize()     # every queued kernel in the trace
        self._prof.stop()
        self.summary = summarize(self._prof.profiler.kineto_results.events())
        self._prof = None


def _union(intervals):
    """Sorted disjoint [start, end) of the intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name, width=120):
    """A kernel's name without its parameter list, at most ``width``
    characters."""
    if name.endswith(')'):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {')': 1, '(': -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.rstrip()[:width]


def _annotation(ev):
    """Whether a kineto event is a ``record_function`` range (on the host,
    or its projection onto the device's timeline)."""
    if hasattr(ev, 'activity_type'):
        return 'annotation' in ev.activity_type()
    return ev.is_user_annotation()


def summarize(events, top: int = 10):
    """busy_s, window_s, device_ops and idle_gaps of kineto's events."""
    device, host = [], []
    for ev in events:
        annotation = _annotation(ev)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not annotation:
                device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                               ev.name()))
        elif annotation and ev.name().startswith(PREFIX):
            host.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                         ev.name()[len(PREFIX):]))
    if not device:
        return None
    busy = _union([(s, e) for s, e, _ in device])
    print(f'device trace: {len(device)} device activities and {len(host)} '
          f'host spans', flush=True)
    window = busy[-1][1] - busy[0][0]
    by_name = defaultdict(float)
    for s, e, name in device:
        by_name[_short(name)] += (e - s) / 1e9
    gaps = defaultdict(float)
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    length = he - hs
    for (_, end), (start, _) in zip(busy, busy[1:]):
        inside = np.flatnonzero((hs <= end) & (end < he))
        label = (host[inside[np.argmin(length[inside])]][2] if inside.size
                 else 'other')
        gaps[label] += (start - end) / 1e9
    return {
        'busy_s': sum(e - s for s, e in busy) / 1e9,
        'window_s': window / 1e9,
        'device_ops': sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        'idle_gaps': sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
    }
