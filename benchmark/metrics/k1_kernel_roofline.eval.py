"""K1-fwd's share of its roofline in the eval step, the kernel alone: the
bound of ``k1_roofline.eval`` (``yardstick.bounds.attention_bounds`` of
the step's attentions) over the device time of the program's spans
``k1.fwd``, each around one C call (the tf32 programs' pre-pass inside
it), without the model's layout copies."""

from benchmark.harness.program_spans import recorded
from benchmark.yardstick.bounds import attention_bounds
from benchmark.yardstick.shares import clips_per_step, roofline


def read(run):
    shapes = getattr(run.cell.yardstick, 'attention_shapes', None)
    ms = recorded().get('k1.fwd', {}).get('device_ms')
    if shapes is None or not ms:
        return None
    shapes = shapes(run.cell.config)
    b = clips_per_step(run)
    bound = sum(attention_bounds(b, *s, run.cell.dtype)['fwd']
                for s in shapes)
    return roofline(bound, len(shapes), ms)
