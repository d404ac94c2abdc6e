"""Device ms a step in the program's spans ``preprocess.clip``
(``transforms.fused.preprocess_clip``, once a clip), over the step's
spans ``eval.step``; the program's twin of ``preprocess_ms.eval``,
without the ``cat`` and ``stack``."""

from benchmark.harness.program_spans import per_step


def read(run):
    return per_step('eval.step', 'preprocess.clip')
