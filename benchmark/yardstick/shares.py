"""The arithmetic of the per-layer shares: a roofline's, the device's
idle time's, the model's FLOPs' of the peak. Each is None where the run
has nothing to read (no span, no trace)."""

from __future__ import annotations

from .bounds import PEAK_FLOPS
from .count import flops


def roofline(bound_s_per_call_set, calls_per_set, spans_ms):
    """100 x the bound of the work over the device time in its spans:
    ``spans_ms`` holds one span a call, ``calls_per_set`` calls make the
    work that ``bound_s_per_call_set`` bounds."""
    if not spans_ms or not calls_per_set:
        return None
    sets = len(spans_ms) / calls_per_set
    return 100.0 * sets * bound_s_per_call_set / (sum(spans_ms) / 1e3)


def idle(run):
    """100 x the device's idle share of the traced window."""
    trace = run.device_trace
    if not trace or not trace['window_s']:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])


def mfu(run, train: bool):
    """100 x the model FLOPs of the window's samples over the window's
    seconds at the precision's peak."""
    if not run.samples or not run.window_s:
        return None
    per_sample = flops(run.cell.yardstick.products(run.cell.config), train)
    return (100.0 * per_sample * run.samples
            / (run.window_s * PEAK_FLOPS[run.cell.dtype]))


def clips_per_step(run):
    return run.samples // run.steps
