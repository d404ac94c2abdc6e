"""What a cell is made of, found by the names in ``BENCHMARK.json``.

* ``configs/<config>.json``: the model configuration (factory and
  arguments, the architecture's sizes, the clip, the preprocessing, the
  seeded init), and ``reference/<reference>.py`` beside
  ``yardstick/<reference>.py``: its plain forward and its products;
* ``traffic/<traffic>.json``: the mix (mode, precision, batch, pool,
  queue depth), which the mode's module ``modes/<mode>.py`` reads;
* ``workloads/<cell>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(run)``.

A later cell or metric is added by adding files and entries; nothing here
names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        bench = root / 'benchmark'
        spec = _json(root / 'BENCHMARK.json')
        entries = {w['name']: w for w in spec['workloads']}
        if name not in entries:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                           f'(have {sorted(entries)})')
        self.name = name
        self.entry = entries[name]
        self.chips = self.entry['chips']
        self.config = _json(bench / 'configs' / f"{self.entry['config']}.json")
        self.traffic = _json(bench / 'traffic' / f"{self.entry['traffic']}.json")
        self.limits = _json(bench / 'workloads' / f'{name}.json')['limits']
        self.mode = self.traffic['mode']
        self.dtype = self.traffic['dtype']
        self.end_to_end = [m for m in spec['end_to_end']
                           if name in m.get('workloads', [name])]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in spec['per_layer']
                          if (name in m['workloads'] if 'workloads' in m
                              else m['moves'] in reported)]
        self.reference = importlib.import_module(
            f"benchmark.reference.{self.config['reference']}")
        self.yardstick = importlib.import_module(
            f"benchmark.yardstick.{self.config['reference']}")
        self.mode_module = importlib.import_module(
            f'benchmark.modes.{self.mode}')

    def reader(self, metric: str):
        """``read(run)`` of ``metrics/<metric>.py``."""
        path = self.root / 'benchmark' / 'metrics' / f'{metric}.py'
        spec = importlib.util.spec_from_file_location(
            'benchmark.metrics.' + metric.replace('.', '_'), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
