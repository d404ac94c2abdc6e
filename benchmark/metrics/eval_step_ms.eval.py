"""Device ms of the program's span ``eval.step`` (a call of
``parallel.evaluate.multi_clip_eval_step``'s step); the program's twin of
``forward_ms.eval``."""

from benchmark.harness.program_spans import per_step


def read(run):
    return per_step('eval.step', 'eval.step')
