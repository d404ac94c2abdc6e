"""Device ms of the span around each call of the eval step
(``parallel.evaluate.multi_clip_eval_step``: the model and the protocol's
sums)."""


def read(run):
    ms = run.span_ms.get('forward')
    return sum(ms) / len(ms) if ms else None
