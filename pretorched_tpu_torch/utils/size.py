"""Model memory estimate (reference capability: models/utils.py:5-78).

``SizeEstimator(model, input_size, bits).estimate_size()`` returns
``(megabytes, total_bits)`` with the reference's accounting: parameters +
2 x activations (forward and gradient) + the input. The parameters are
counted as the JAX package counts them (every learnable parameter, no BN
statistics). The activations are the outputs of the model's leaf modules
in one forward of a zero input, collected by forward hooks as the
reference collected them; the JAX package counts every traced
equation's output instead, so the two totals differ by design.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


class SizeEstimator:
    """Estimate the memory footprint of a model in MB."""

    def __init__(self, model, input_size: Sequence[int] = (1, 3, 224, 224),
                 bits: int = 32):
        self.model = model
        self.input_size = tuple(input_size)
        self.bits = bits

    def param_bits(self) -> int:
        n = sum(p.numel() for p in self.model.parameters())
        return n * self.bits

    def _activation_elems(self) -> int:
        """Elements of every leaf module's tensor outputs in one forward."""
        total = [0]

        def count(_module, _inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            total[0] += sum(o.numel() for o in outs
                            if isinstance(o, torch.Tensor))

        leaves = [m for m in self.model.modules()
                  if next(m.children(), None) is None]
        hooks = [m.register_forward_hook(count) for m in leaves]
        try:
            p = next(self.model.parameters(), None)
            x = torch.zeros(self.input_size,
                            device=p.device if p is not None else 'cpu')
            with torch.no_grad():
                self.model(x)
        finally:
            for h in hooks:
                h.remove()
        return total[0]

    def estimate_size(self) -> Tuple[float, int]:
        """Returns (megabytes, total_bits)."""
        input_bits = math.prod(self.input_size) * self.bits
        forward_bits = self._activation_elems() * self.bits * 2
        total_bits = self.param_bits() + forward_bits + input_bits
        return total_bits / 8 / 1024 / 1024, total_bits
