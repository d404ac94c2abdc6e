"""K1's share of its roofline in the train step, the kernels alone: the
bounds of K1-fwd, K1-dq and K1-dkv at the step's shapes (as
``k1_roofline.train``) over the device time of the program's spans
``k1.fwd``, ``k1.dq`` and ``k1.dkv``, each around one C call."""

from benchmark.harness.program_spans import recorded
from benchmark.yardstick.bounds import attention_bounds
from benchmark.yardstick.shares import clips_per_step, roofline

OPS = ('k1.fwd', 'k1.dq', 'k1.dkv')


def read(run):
    shapes = getattr(run.cell.yardstick, 'attention_shapes', None)
    spans = recorded()
    ms = [spans.get(op, {}).get('device_ms') for op in OPS]
    if shapes is None or not all(ms) or len({len(m) for m in ms}) != 1:
        return None
    shapes = shapes(run.cell.config)
    b = clips_per_step(run)
    bound = sum(sum(attention_bounds(b, *s, run.cell.dtype).values())
                for s in shapes)
    return roofline(bound, len(OPS) * len(shapes), [t for m in ms for t in m])
