"""Host ms of the program's span ``train.step`` (a call of
``parallel.train.make_train_step``'s step, no synchronize inside); the
program's twin of ``enqueue_ms.train``."""

from benchmark.harness.program_spans import per_step


def read(run):
    return per_step('train.step', 'train.step', 'host_ms')
