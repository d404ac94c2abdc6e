"""The port's native JPEG decoder is built from its own source.

The port keeps a copy of the JAX package's ``decoder.cpp`` under
``pretorched_tpu_torch/native/`` and reads no file of ``pretorched_tpu``.
"""

from pathlib import Path

import pretorched_tpu_torch
from pretorched_tpu_torch.datasets import native


def test_decoder_source_lies_inside_the_port():
    port = Path(pretorched_tpu_torch.__file__).resolve().parent
    src = native.SRC.resolve()
    assert src.is_file()
    assert src.is_relative_to(port), src


def test_decoder_builds_and_loads():
    """The source compiles with g++ against libjpeg and its entry points
    load (this machine has both)."""
    path = native._build_lib()
    assert path is not None and path.is_file()
    assert native.native_available()
    assert native.decoder_name().startswith('native')
    lib = native._get_lib()
    assert lib.pt_jpeg_dims.restype is not None
    assert lib.pt_jpeg_decode_batch.restype is not None
