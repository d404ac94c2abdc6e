"""What the program records of itself (``utils.profiling``): its spans,
which record while ``torch.profiler`` runs (in a traced run, the steps
the device trace covers after the window), and its counters, always on.
A program without them reads as having recorded nothing, so that each
reader of these returns None there.

Figures a step divide by the number of the step's own spans
(``eval.step``, ``train.step``) in the recording.
"""

from __future__ import annotations


def _profiling():
    try:
        from pretorched_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def recorded():
    """The program's ``profiling.recorded()``, or {}."""
    read = getattr(_profiling(), 'recorded', None)
    return read() if read else {}


def counters():
    """The program's ``profiling.counters()``, or {}."""
    read = getattr(_profiling(), 'counters', None)
    return read() if read else {}


def per_step(step, name, times='device_ms'):
    """The sum of ``times`` (``device_ms`` or ``host_ms``) of the spans
    ``name``, over the number of spans ``step``; None where either was
    not recorded."""
    spans = recorded()
    steps = len(spans.get(step, {}).get('host_ms', ()))
    values = spans.get(name, {}).get(times)
    if not steps or not values:
        return None
    return sum(values) / steps


def ratio(counter, base):
    """``counters()[counter] / counters()[base]``; None without ``base``."""
    got = counters()
    if not got.get(base):
        return None
    return got.get(counter, 0) / got[base]
