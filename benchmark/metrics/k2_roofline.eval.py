"""K2's share of its roofline in the eval step: the bytes and products
bound of each fused bottleneck tail (``yardstick.bounds.k2_bound``, at the
configuration's tail shapes and the step's clips) over the device time in
the spans around the model's calls of ``slowfast.fused_tail_with_layout``."""

from benchmark.yardstick.bounds import k2_bound
from benchmark.yardstick.shares import clips_per_step, roofline


def read(run):
    shapes = getattr(run.cell.yardstick, 'tail_shapes', None)
    if shapes is None:
        return None
    shapes = shapes(run.cell.config)
    b = clips_per_step(run)
    bound = sum(k2_bound((b, *s), run.cell.dtype) for s in shapes)
    return roofline(bound, len(shapes), run.span_ms.get('k2.fwd'))
