"""K1's share of its roofline in the train step: the bounds of K1-fwd,
K1-dq and K1-dkv at the step's shapes (``yardstick.bounds``) over the
device time in the spans around the model's calls of
``nonlocalnet.auto_nonlocal_attention``, forward, and backward from the
output's gradient to the inputs' gradients."""

from benchmark.yardstick.bounds import attention_bounds
from benchmark.yardstick.shares import clips_per_step, roofline


def read(run):
    shapes = getattr(run.cell.yardstick, 'attention_shapes', None)
    fwd, bwd = run.span_ms.get('k1.fwd'), run.span_ms.get('k1.bwd')
    if shapes is None or not fwd or not bwd or len(fwd) != len(bwd):
        return None
    shapes = shapes(run.cell.config)
    b = clips_per_step(run)
    bound = sum(sum(attention_bounds(b, *s, run.cell.dtype).values())
                for s in shapes)
    return roofline(bound, len(shapes), [f + g for f, g in zip(fwd, bwd)])
