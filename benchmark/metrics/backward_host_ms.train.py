"""Host ms a step in the program's spans ``train.backward`` (the loss and
its ``backward()``), over the spans ``train.step``: where the host spends
the step, beside ``step_host_ms.train``."""

from benchmark.harness.program_spans import per_step


def read(run):
    return per_step('train.step', 'train.backward', 'host_ms')
