"""Device ms a step in the program's spans ``remat.recompute``
(``models.resnet3d.checkpointed``'s recompute inside the backward, one a
checkpointed block), over the spans ``train.step``."""

from benchmark.harness.program_spans import per_step


def read(run):
    return per_step('train.step', 'remat.recompute')
