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


def _jpegs(n=6):
    import io

    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        h, w = 40 + 8 * i, 64 - 4 * i
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format='JPEG', quality=85)
        out.append(buf.getvalue())
    return out


def test_jpeg_short_side_matches_jax(monkeypatch):
    """Native and PIL header reads both give JAX's answer; junk gives None."""
    from pretorched_tpu.datasets.native import \
        jpeg_short_side as jax_short_side
    bufs = _jpegs() + [b'not a jpeg']
    want = [jax_short_side(b) for b in bufs]
    assert want[-1] is None and want[0] == 40
    assert [native.jpeg_short_side(b) for b in bufs] == want
    monkeypatch.setattr(native, '_get_lib', lambda: None)
    assert [native.jpeg_short_side(b) for b in bufs] == want


def test_threaded_pil_decode_equals_one_thread(monkeypatch):
    """The PIL fallback decodes on ``threads`` threads, in order, byte for
    byte what one thread decodes."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    bufs = _jpegs()
    monkeypatch.setattr(native, '_get_lib', lambda: None)
    pools = []
    real = ThreadPoolExecutor

    def spy(workers):
        pools.append(workers)
        return real(workers)

    monkeypatch.setattr(native, 'ThreadPoolExecutor', spy)
    for denom in (1, 2):
        one = native.decode_jpeg_batch(bufs, threads=1, scale_denom=denom)
        many = native.decode_jpeg_batch(bufs, threads=4, scale_denom=denom)
        assert len(one) == len(many) == len(bufs)
        for a, b in zip(one, many):
            assert a.dtype == np.uint8 and a.shape[2] == 3
            np.testing.assert_array_equal(a, b)
    assert pools == [4, 4]
