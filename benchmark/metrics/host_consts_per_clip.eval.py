"""Constants the preprocess makes on the host and copies to the device, a
clip: the program's counter ``preprocess.host_consts`` (``resize_weights``
and ``_affine_consts`` in ``transforms/fused.py``) over its counter
``preprocess.clips``."""

from benchmark.harness.program_spans import ratio


def read(run):
    return ratio('preprocess.host_consts', 'preprocess.clips')
