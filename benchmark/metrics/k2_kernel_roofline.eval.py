"""K2's share of its roofline in the eval step, the kernel alone: the
bound of ``k2_roofline.eval`` (``yardstick.bounds.k2_bound`` of each fused
tail) over the device time of the program's spans ``k2.tail``, each
around one C call, without ``prepare_tail``."""

from benchmark.harness.program_spans import recorded
from benchmark.yardstick.bounds import k2_bound
from benchmark.yardstick.shares import clips_per_step, roofline


def read(run):
    shapes = getattr(run.cell.yardstick, 'tail_shapes', None)
    ms = recorded().get('k2.tail', {}).get('device_ms')
    if shapes is None or not ms:
        return None
    shapes = shapes(run.cell.config)
    b = clips_per_step(run)
    bound = sum(k2_bound((b, *s), run.cell.dtype) for s in shapes)
    return roofline(bound, len(shapes), ms)
