"""Preemption-safe training.

The port's own copy of ``pretorched_tpu/utils/preemption.py`` (pure Python,
so the port imports nothing of the JAX package for it). Preemptible and
spot machines, the economical way to run large training jobs, receive
SIGTERM shortly before eviction. The reference has no handling at all: a
preempted run loses everything since the last end-of-epoch ``torch.save``
(reference examples/imagenet_eval.py:252-259 saves only after
``validate``).  :class:`PreemptionGuard` converts
the signal into a cooperative flag the training loop polls at step
granularity (a Python bool check — free next to a train step), so the run
checkpoints *mid-epoch* and exits cleanly instead of dying mid-step.

Typical use::

    with PreemptionGuard() as guard:
        for epoch in ...:
            for step, batch in ...:
                metrics = step(x, labels)
                if guard.requested:
                    save_checkpoint(path, {'model': model.state_dict(), ...})
                    return

Multi-host note: the cluster scheduler signals every process, so each
process latches its own flag and all of them leave the (collective-free)
host-side loop at the same step boundary; the usual process-0-only
checkpoint write then applies unchanged.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable

__all__ = ['PreemptionGuard']


class PreemptionGuard:
    """Context manager latching termination signals into a poll-able flag.

    * First signal: sets :attr:`requested`; the loop is expected to
      checkpoint and exit at its next boundary.
    * Further signals: chained to the previously installed handler — so a
      run stuck before its next poll can still be killed the normal way
      (a second SIGTERM with the default handler terminates the process).

    Handlers are installed on ``__enter__`` and restored on ``__exit__``
    (signal handlers are process-global state; leaving them installed
    past the training loop would latch unrelated shutdowns).  Must enter
    from the main thread — a CPython rule for ``signal.signal``.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._prev: dict = {}

    @property
    def requested(self) -> bool:
        """True once any watched signal has arrived."""
        return self._requested.is_set()

    def _handle(self, signum, frame):
        if self._requested.is_set():
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                # restore + re-raise: the default disposition (terminate)
                # cannot be invoked from Python except by re-delivery
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self._requested.set()

    def __enter__(self) -> 'PreemptionGuard':
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False
