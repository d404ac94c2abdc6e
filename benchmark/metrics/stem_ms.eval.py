"""Device ms a step in the program's spans ``stem`` (the stem conv, BN,
ReLU and pool of ``VideoResNet`` and of each SlowFast pathway), over the
step's spans ``eval.step``."""

from benchmark.harness.program_spans import per_step


def read(run):
    return per_step('eval.step', 'stem')
