"""K1-fwd's share of its roofline in the eval step: the bound of the
forward attentions of a step (``yardstick.bounds.attention_bounds``, at
the configuration's shapes and the step's clips) over the device time in
the spans around the model's calls of ``nonlocalnet.auto_nonlocal_attention``."""

from benchmark.yardstick.bounds import attention_bounds
from benchmark.yardstick.shares import clips_per_step, roofline


def read(run):
    shapes = getattr(run.cell.yardstick, 'attention_shapes', None)
    if shapes is None:
        return None
    shapes = shapes(run.cell.config)
    b = clips_per_step(run)
    bound = sum(attention_bounds(b, *s, run.cell.dtype)['fwd']
                for s in shapes)
    return roofline(bound, len(shapes), run.span_ms.get('k1.fwd'))
