"""Device ms a forward spends in the spans around the eval step's input:
``transforms.fused.preprocess_clip`` once a clip, the concatenation and
the stack (``modes/eval.py``)."""


def read(run):
    ms = run.span_ms.get('preprocess')
    return sum(ms) / len(ms) if ms else None
