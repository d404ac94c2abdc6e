"""Metric meters for the example CLIs.

Counterpart of the meters in ``pretorched_tpu/utils/misc.py`` (l.117-170).
``DeviceRunningSums`` keeps per-step metric sums on the device, so an eval
loop synchronizes with the card once per printed line, not once per step.
"""

from __future__ import annotations

import torch


class AverageMeter:
    """Running average meter used by the CLIs (reference: imagenet_eval.py:262-278)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class DeviceRunningSums:
    """Accumulates a dict of per-step device scalars without host syncs.

    ``update`` adds the step's scalars into running sums that stay on the
    device (asynchronous, like the step itself); ``snapshot()`` and
    ``totals()`` bring them to the host with ONE transfer each: call them
    only where a line is printed and at the end of the loop."""

    def __init__(self):
        self.last = None       # the most recent step's dict of tensors
        self.sums = None       # running sums, on the device

    def __bool__(self):
        return self.sums is not None

    def update(self, out: dict):
        self.last = out
        self.sums = (dict(out) if self.sums is None
                     else {k: self.sums[k] + out[k] for k in self.sums})

    @staticmethod
    def _to_host(*dicts):
        keys = [list(d) for d in dicts]
        flat = torch.stack([d[k].to(torch.float64)
                            for d, ks in zip(dicts, keys) for k in ks])
        values = iter(flat.tolist())          # the one device -> host copy
        return [{k: next(values) for k in ks} for ks in keys]

    def snapshot(self):
        """One host sync: returns (last_step_dict, totals_dict) as floats."""
        last, sums = self._to_host(self.last, self.sums)
        return last, sums

    def totals(self):
        """One host sync: the running totals as floats."""
        return self._to_host(self.sums)[0]
