"""The port's dynamic-batching server (``pretorched_tpu_torch/serving.py``)
against the JAX package's (``pretorched_tpu/serving.py``), on the CPU.

The twins of ``tests/test_serving.py`` (all but the mesh-sharded apply):
results are each request's own rows however requests were coalesced and
padded; buckets are bounded powers of two; errors reach every future;
``close()`` drains. ``serve_model`` on ``resnet18`` (seeded weights, every
BN randomized, carried by ``state_dict_from_flax``) matches the JAX
``serve_model`` at 2e-3 for each payload, and its own offline path at 1e-4.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.serving import _fit_uint8 as jax_fit_uint8
from pretorched_tpu.serving import serve_model as jax_serve_model
from pretorched_tpu_torch.datasets.native import decode_jpeg_batch
from pretorched_tpu_torch.serving import (InferenceServer, ServerOverloaded,
                                          _fit_uint8, serve_model)
from pretorched_tpu_torch.transforms.fused import (fused_preprocess,
                                                   preprocess_clip)

from torch_port_helpers import port_state_dict, randomize_bn


def _linear_apply(params, x):
    return x.reshape(x.shape[0], -1) @ params['w'] + params['b']


def _params(rng, d_in=12, d_out=5):
    return {'w': torch.from_numpy(rng.randn(d_in, d_out).astype(np.float32)),
            'b': torch.from_numpy(rng.randn(d_out).astype(np.float32))}


def _ref(params, x):
    return _linear_apply(params, torch.from_numpy(np.asarray(x))).numpy()


def _server(apply_fn, params, **kw):
    return InferenceServer(apply_fn, params, device='cpu', **kw)


def test_serving_single_and_batch_requests(rng):
    params = _params(rng)
    with _server(_linear_apply, params, max_batch=8, max_wait_ms=5.0,
                 example_ndim=2) as srv:
        xs = [rng.randn(3, 4).astype(np.float32) for _ in range(7)]
        futs = [srv.submit(x) for x in xs]                 # singles
        xb = rng.randn(4, 3, 4).astype(np.float32)
        fb = srv.submit(xb)                                # a batch
        ref = _ref(params, np.stack(xs))
        for f, r in zip(futs, ref):
            np.testing.assert_allclose(f.result(timeout=60), r, rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(fb.result(timeout=60), _ref(params, xb),
                                   rtol=1e-5, atol=1e-5)
    assert srv.bucket_compiles <= {1, 2, 4, 8}


def test_serving_results_are_plain_cpu_tensors(rng):
    """apply_fn runs under inference mode; the futures get ordinary CPU
    tensors of their own rows (not views of the bucket)."""
    seen = []

    def apply_fn(params, x):
        seen.append(torch.is_inference_mode_enabled())
        return _linear_apply(params, x)

    params = _params(rng)
    with _server(apply_fn, params, max_batch=4, example_ndim=2) as srv:
        y = srv(rng.randn(3, 4).astype(np.float32))
    assert seen and all(seen)
    assert isinstance(y, torch.Tensor) and y.device.type == 'cpu'
    assert not y.is_inference() and y.shape == (5,)
    y.add_(1.0)                               # the caller owns its rows


def test_serving_concurrent_submitters(rng):
    params = _params(rng)
    srv = _server(_linear_apply, params, max_batch=16, max_wait_ms=2.0,
                  example_ndim=2)
    results = {}
    lock = threading.Lock()

    def client(i):
        x = np.full((3, 4), float(i), np.float32)
        y = srv.submit(x).result(timeout=60)
        with lock:
            results[i] = y

    threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    srv.close()
    for i in range(24):
        ref = _ref(params, np.full((1, 3, 4), float(i), np.float32))[0]
        np.testing.assert_allclose(results[i], ref, rtol=1e-5, atol=1e-5)


def test_serving_resolver_pool_correctness(rng):
    params = _params(rng)
    srv = _server(_linear_apply, params, max_batch=4, max_wait_ms=0.0,
                  example_ndim=2, resolver_threads=4)
    xs = [np.full((3, 4), float(i), np.float32) for i in range(64)]
    futs = [srv.submit(x) for x in xs]
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=60),
                                   _ref(params, xs[i][None])[0],
                                   rtol=1e-5, atol=1e-5)
    srv.close()


def test_serving_resolver_pool_error_propagates(rng):
    """A resolver dying (a failure while reading a bucket back) fails every
    outstanding future, and close() reports it."""
    params = _params(rng)
    srv = _server(_linear_apply, params, max_batch=4, max_wait_ms=0.0,
                  example_ndim=2, resolver_threads=3)

    def exploding_split(out, start, stop):
        raise RuntimeError('injected readback failure')

    srv._split_outputs = exploding_split
    futs = [srv.submit(np.ones((3, 4), np.float32)) for _ in range(8)]
    for f in futs:
        with pytest.raises(RuntimeError, match='injected readback'):
            f.result(timeout=60)
    with pytest.raises(RuntimeError):
        srv.close()
    assert srv._pending == 0        # exactly-once accounting held


def test_serving_cancelled_future_does_not_kill_server(rng):
    gate = threading.Event()

    def gated_apply(params, x):
        gate.wait(30)
        return _linear_apply(params, x)

    params = _params(rng)
    srv = _server(gated_apply, params, max_batch=2, max_wait_ms=0.0,
                  example_ndim=2, max_queue=8)
    try:
        x = rng.randn(3, 4).astype(np.float32)
        first = srv.submit(x)        # occupies the batcher at the gate
        victim = srv.submit(x)       # still queued
        assert victim.cancel()
        gate.set()
        first.result(timeout=60)
        y = srv.submit(x).result(timeout=60)
        assert y.shape == (5,)
        deadline = time.monotonic() + 10
        while srv._pending != 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._pending == 0
    finally:
        gate.set()
        srv.close()


def test_serving_single_resolver_still_works(rng):
    params = _params(rng)
    with _server(_linear_apply, params, max_batch=8, max_wait_ms=2.0,
                 example_ndim=2, resolver_threads=1) as srv:
        x = rng.randn(3, 4).astype(np.float32)
        np.testing.assert_allclose(srv(x), _ref(params, x[None])[0],
                                   rtol=1e-5, atol=1e-5)


def test_serving_error_propagates(rng):
    params = _params(rng)

    def bad_apply(params, x):
        return x.reshape(x.shape[0], -1) @ params['w'][:2]  # shape bug

    srv = _server(bad_apply, params, max_batch=4, max_wait_ms=0.0,
                  example_ndim=2)
    fut = srv.submit(np.zeros((3, 4), np.float32))
    with pytest.raises(RuntimeError):
        fut.result(timeout=60)
    with pytest.raises(RuntimeError, match='died'):
        srv.close()                 # a dead batcher is fatal and loud
    with pytest.raises(RuntimeError, match='closed'):
        srv.submit(np.zeros((3, 4), np.float32))


def test_serving_rejects_oversized_and_closed(rng):
    params = _params(rng)
    srv = _server(_linear_apply, params, max_batch=4, example_ndim=2)
    with pytest.raises(ValueError, match='max_batch'):
        srv.submit(np.zeros((5, 3, 4), np.float32))
    srv.close()
    with pytest.raises(RuntimeError, match='closed'):
        srv.submit(np.zeros((3, 4), np.float32))


def test_serving_rejects_mismatched_request_not_kills_server(rng):
    params = _params(rng)
    with _server(_linear_apply, params, max_batch=8, max_wait_ms=1.0,
                 example_ndim=2) as srv:
        good = srv.submit(rng.randn(3, 4).astype(np.float32))
        with pytest.raises(ValueError, match='signature'):
            srv.submit(rng.randn(3, 5).astype(np.float32))   # wrong shape
        with pytest.raises(ValueError, match='signature'):
            srv.submit(rng.randn(3, 4).astype(np.float64))   # wrong dtype
        assert good.result(timeout=60).shape == (5,)
        again = srv.submit(rng.randn(3, 4).astype(np.float32))
        assert again.result(timeout=60).shape == (5,)


def test_serving_rejects_empty_batch(rng):
    params = _params(rng)
    with _server(_linear_apply, params, max_batch=8, max_wait_ms=1.0,
                 example_ndim=2) as srv:
        with pytest.raises(ValueError, match='empty batch'):
            srv.submit(np.empty((0, 3, 4), np.float32))
        assert srv.submit(rng.randn(3, 4).astype(np.float32)) \
            .result(timeout=60).shape == (5,)


def test_serving_pinned_signature(rng):
    params = _params(rng)
    with _server(_linear_apply, params, max_batch=8, max_wait_ms=1.0,
                 example_ndim=2, example_shape=(3, 4),
                 example_dtype=np.float32) as srv:
        with pytest.raises(ValueError, match='signature'):
            srv.submit(rng.randn(3, 5).astype(np.float32))  # wrong 1st req
        assert srv.submit(rng.randn(3, 4).astype(np.float32)) \
            .result(timeout=60).shape == (5,)


def test_serving_close_retry_joins_again(rng):
    params = _params(rng)
    srv = _server(_linear_apply, params, max_batch=4, max_wait_ms=1.0,
                  example_ndim=2)
    srv.submit(rng.randn(3, 4).astype(np.float32)).result(timeout=60)
    srv.close(timeout=60)
    srv.close(timeout=60)      # idempotent; the second call must not raise
    assert not srv._thread.is_alive()


def test_serving_overload_shedding(rng):
    gate = threading.Event()

    def slow_apply(params, x):
        gate.wait(30)
        return _linear_apply(params, x)

    params = _params(rng)
    srv = _server(slow_apply, params, max_batch=2, max_wait_ms=0.0,
                  example_ndim=2, max_queue=2)
    try:
        xs = rng.randn(3, 4).astype(np.float32)
        futs = [srv.submit(xs) for _ in range(2)]          # fills max_queue
        with pytest.raises(ServerOverloaded):
            srv.submit(xs)
        gate.set()
        for f in futs:
            f.result(timeout=60)
        srv.submit(xs).result(timeout=60)                  # capacity freed
    finally:
        gate.set()
        srv.close()


def test_serving_request_timeout_expires_stale(rng):
    gate = threading.Event()

    def slow_apply(params, x):
        gate.wait(30)
        return _linear_apply(params, x)

    params = _params(rng)
    srv = _server(slow_apply, params, max_batch=2, max_wait_ms=0.0,
                  example_ndim=2, request_timeout_ms=150.0)
    try:
        xs = rng.randn(3, 4).astype(np.float32)
        first = srv.submit(xs)           # enters the batcher, waits at gate
        time.sleep(0.05)
        stale = srv.submit(xs)           # sits in the queue past 150 ms
        time.sleep(0.3)
        gate.set()
        first.result(timeout=60)
        with pytest.raises(TimeoutError):
            stale.result(timeout=60)
        np.testing.assert_allclose(srv.submit(xs).result(timeout=60),
                                   _ref(params, xs[None])[0], rtol=1e-5,
                                   atol=1e-5)
    finally:
        gate.set()
        srv.close()


def test_serving_needs_cuda_unless_told_cpu(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        InferenceServer(_linear_apply, _params(rng), example_ndim=2)
    model = pretorched_tpu_torch.resnet18(num_classes=3, pretrained=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_model(model)


# ------------------------------------------------------------ serve_model
SIZE = 64                 # crop; the default uint8 decode is floor(64/0.875)


@pytest.fixture(scope='module')
def pair():
    """(JAX resnet18, the port's resnet18 with its weights), 13 classes,
    every BN randomized, both with 64 px metadata."""
    jmodel = pretorched_tpu.resnet18(num_classes=13, pretrained=None).eval()
    jmodel.variables = randomize_bn(jmodel.variables, seed=2)
    model = pretorched_tpu_torch.resnet18(num_classes=13, pretrained=None)
    model.load_state_dict(port_state_dict(jmodel.variables), strict=True)
    for m in (jmodel, model):
        m.input_size = [3, SIZE, SIZE]
    return jmodel, model.eval()


def _jax_served(jmodel, requests, **kw):
    """The JAX serve_model's outputs for ``requests``, as numpy."""
    with jax_serve_model(jmodel, max_batch=4, max_wait_ms=1.0, **kw) as srv:
        return [np.asarray(srv(r)) for r in requests]


def test_serve_model_zoo_integration(pair):
    jmodel, model = pair
    x = np.random.RandomState(1).randn(3, 3, SIZE, SIZE).astype(np.float32)
    want = _jax_served(jmodel, [np.moveaxis(x[0], 0, -1),
                                np.moveaxis(x, 1, -1)])
    with serve_model(model, device='cpu', max_batch=4, max_wait_ms=1.0) as srv:
        y0 = srv(x[0])                                   # one example
        yb = srv(x)                                      # a batch
    assert srv.bucket_compiles == {1, 4}
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y0, ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(yb, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y0, want[0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(yb, want[1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize('mode', ['features', 'logits'])
def test_serve_model_modes(pair, mode):
    _, model = pair
    x = np.random.RandomState(2).randn(2, 3, SIZE, SIZE).astype(np.float32)
    if mode == 'logits':
        with torch.no_grad():
            x = model.features(torch.from_numpy(x)).numpy()
    with serve_model(model, device='cpu', mode=mode, max_batch=2) as srv:
        got = srv(x)
    with torch.no_grad():
        want = getattr(model, mode)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serving_uint8_payload(pair):
    """Raw uint8 frames, preprocessed inside the served program: equal to
    the offline fused_preprocess -> forward at 1e-4, and to JAX's served
    outputs at 2e-3; the default decode is the pre-crop size."""
    jmodel, model = pair
    raw = np.random.RandomState(3).randint(0, 256, (3, 96, 80, 3), np.uint8)
    with serve_model(model, device='cpu', max_batch=4, max_wait_ms=1.0,
                     payload='uint8', decode_shape=(96, 80, 3)) as srv:
        y0 = srv(raw[0])
        yb = srv(raw)
    with torch.no_grad():
        ref = model(fused_preprocess(raw, model, channels_last=False)).numpy()
    np.testing.assert_allclose(y0, ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(yb, ref, rtol=1e-4, atol=1e-4)
    want = _jax_served(jmodel, [raw], payload='uint8',
                       decode_shape=(96, 80, 3))[0]
    np.testing.assert_allclose(yb, want, rtol=2e-3, atol=2e-3)
    srv2 = serve_model(model, device='cpu', max_batch=4, payload='uint8')
    try:
        short = int(np.floor(SIZE / 0.875))
        assert srv2._example_shape == (short, short, 3)
        with pytest.raises(ValueError, match='signature'):
            srv2.submit(raw[0].astype(np.float32))   # refused at the caller
    finally:
        srv2.close()


def test_serving_uint8_payload_rejects_conflicting_signature():
    model = pretorched_tpu_torch.resnet18(num_classes=5, pretrained=None)
    with pytest.raises(ValueError, match='decode_shape'):
        serve_model(model, device='cpu', payload='uint8',
                    example_shape=(224, 224, 3))
    with pytest.raises(ValueError, match='uint8'):
        serve_model(model, device='cpu', payload='uint8',
                    example_dtype=np.float32)
    with pytest.raises(ValueError, match='preprocess_dtype'):
        serve_model(model, device='cpu', payload='uint8',
                    preprocess_dtype='float16')
    srv = serve_model(model, device='cpu', payload='uint8',
                      example_shape=(256, 256, 3), example_dtype=np.uint8)
    try:
        assert srv._example_shape == (256, 256, 3)
    finally:
        srv.close()


def _jpeg(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    a = 1 + seed
    img = np.stack([(yy * a) % 256, (xx * a) % 256, (yy + xx) // 2 % 256],
                   -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', quality=90)
    return buf.getvalue()


def test_serving_jpeg_payload(pair):
    """Encoded bytes in, logits out: equal to decode -> _fit_uint8 -> the
    uint8 path offline at 1e-4 and to JAX's served outputs at 2e-3."""
    jmodel, model = pair
    jpegs = [_jpeg(90, 120, 0), _jpeg(150, 100, 1)]
    with serve_model(model, device='cpu', max_batch=4, max_wait_ms=1.0,
                     payload='jpeg') as srv:
        y1 = srv(jpegs[0])                   # one encoded image
        y2 = srv(jpegs)                      # a batch of them
        shape = srv._example_shape
    fitted = np.stack([_fit_uint8(im, shape) for im in decode_jpeg_batch(jpegs)])
    with torch.no_grad():
        ref = model(fused_preprocess(fitted, model,
                                     channels_last=False)).numpy()
    np.testing.assert_allclose(y1, ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y2, ref, rtol=1e-4, atol=1e-4)
    want = _jax_served(jmodel, [jpegs], payload='jpeg')[0]
    np.testing.assert_allclose(y2, want, rtol=2e-3, atol=2e-3)


def test_serving_jpeg_payload_odd_geometry():
    model = pretorched_tpu_torch.resnet18(num_classes=5, pretrained=None)
    model.input_size = [3, SIZE, SIZE]
    with serve_model(model, device='cpu', max_batch=2, max_wait_ms=1.0,
                     payload='jpeg') as srv:
        y = srv(_jpeg(300, 200))
    assert y.shape == (5,) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize('hw', [(300, 200), (73, 73), (50, 90), (256, 256)])
def test_fit_uint8_geometry_matches_jax(hw):
    img = np.random.RandomState(4).randint(0, 256, hw + (3,), np.uint8)
    for shape in ((73, 73, 3), (96, 80, 3)):
        got = _fit_uint8(img, shape)
        want = jax_fit_uint8(img, shape)
        assert got.shape == shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    same = np.zeros((73, 73, 3), np.uint8)
    assert _fit_uint8(same, (73, 73, 3)) is same      # hot path: no copy


def test_serving_video_clips_uint8():
    """A clip model serves (T, H, W, 3) uint8 clips: each frame
    preprocessed, then (B, 3, T, S, S), as the offline preprocess_clip."""
    model = pretorched_tpu_torch.resnet3d10(num_classes=6, pretrained=None)
    model.input_size = [3, 32, 32]
    clips = np.random.RandomState(5).randint(0, 256, (2, 4, 40, 48, 3),
                                             np.uint8)
    with pytest.raises(ValueError, match='decode_shape'):
        serve_model(model, device='cpu', payload='uint8')
    with pytest.raises(ValueError, match='single images'):
        serve_model(model, device='cpu', payload='jpeg',
                    decode_shape=(4, 40, 48, 3))
    with serve_model(model, device='cpu', max_batch=2, payload='uint8',
                     decode_shape=(4, 40, 48, 3)) as srv:
        y0 = srv(clips[0])
        yb = srv(clips)
    x = torch.cat([preprocess_clip(c, model, channels_last=False)
                   for c in clips])
    assert x.shape == (2, 3, 4, 32, 32)
    with torch.no_grad():
        ref = model(x).numpy()
    np.testing.assert_allclose(y0, ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(yb, ref, rtol=1e-4, atol=1e-4)


def test_serving_stress_many_clients_exact_accounting(rng):
    """More client threads than cores with a short switch interval: every
    future gets its own rows and the admission count returns to 0."""
    import sys
    params = _params(rng)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv = _server(_linear_apply, params, max_batch=8, max_wait_ms=0.5,
                      example_ndim=2, max_queue=1000, resolver_threads=2)
        bad = []

        def client(i):
            for j in range(10):
                x = np.full((3, 4), float(i * 10 + j), np.float32)
                y = srv.submit(x).result(timeout=60)
                if not np.allclose(y, _ref(params, x[None])[0], atol=1e-4):
                    bad.append((i, j))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        srv.close(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not bad and srv._pending == 0


def test_serving_imports_no_jax():
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import sys, pretorched_tpu_torch.serving, '
            'pretorched_tpu_torch.transforms.utils, '
            'pretorched_tpu_torch.datasets.utils\n'
            'bad = sorted(m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "flax", "pretorched_tpu.")))\n'
            'assert not bad, bad\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=repo, text=True,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
