"""Device ms a step in the program's spans ``train.optimizer`` (SGD's step
and the schedule's), over the spans ``train.step``."""

from benchmark.harness.program_spans import per_step


def read(run):
    return per_step('train.step', 'train.optimizer')
