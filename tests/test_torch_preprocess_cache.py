"""The preprocess's device constants cache (``transforms.fused.CONSTS``):
a hit is the entry built cold, bit for bit, and copies nothing from the
host; each geometry, dtype and device has its own entry; the bound holds;
the callers that take an entry (the eval and train chains, bucketing) only
read it; an entry built in inference mode serves autograd. CPU only (the
card's twin, that a warm clip makes no synchronising call, is in
``test_torch_kernels_gpu.py``)."""

import sys
import threading

import numpy as np
import pytest
import torch

from pretorched_tpu_torch.transforms import fused
from pretorched_tpu_torch.utils import bucketing, profiling

from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

SETTINGS = {'input_size': [3, 16, 16], 'input_space': 'BGR',
            'input_range': [0, 1], 'mean': [0.4, 0.45, 0.5],
            'std': [0.2, 0.25, 0.3], 'scale': 0.875}
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def cold():
    fused.cache_clear()
    yield
    fused.cache_clear()


def _frames(t, h, w, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (t, h, w, 3), dtype=np.uint8))


def _delta(before, name):
    return profiling.counters().get(name, 0) - before.get(name, 0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('channels_last', [True, False])
def test_a_hit_equals_a_cold_build_bit_for_bit(dtype, channels_last):
    clip = _frames(4, 20, 30)
    cold = fused.preprocess_clip(clip, SETTINGS, channels_last, dtype)
    warm = fused.preprocess_clip(clip, SETTINGS, channels_last, dtype)
    assert warm.dtype == dtype
    assert torch.equal(warm, cold)
    entry = fused.resize_weights(20, 16, 18 / 20, -1.0, CPU, dtype)
    fused.cache_clear()
    assert torch.equal(fused.resize_weights(20, 16, 18 / 20, -1.0, CPU,
                                            dtype), entry)


def test_a_hit_copies_nothing_from_the_host():
    """20 x 30 frames: two resize matrices and the FMA's pair, three
    entries, each built once."""
    clip = _frames(4, 20, 30)
    before = profiling.counters()
    fused.preprocess_clip(clip, SETTINGS)
    assert _delta(before, 'preprocess.host_consts') == 6
    assert _delta(before, 'preprocess.const_cache.misses') == 3
    assert _delta(before, 'preprocess.const_cache.hits') == 0
    before = profiling.counters()
    for _ in range(4):
        fused.preprocess_clip(clip, SETTINGS)
    assert _delta(before, 'preprocess.host_consts') == 0
    assert _delta(before, 'preprocess.const_cache.misses') == 0
    assert _delta(before, 'preprocess.const_cache.hits') == 4 * 3
    assert _delta(before, 'preprocess.clips') == 4
    assert len(fused.CONSTS) == 3


BASE = dict(in_size=20, out_size=16, scale=0.9, translation=-1.0,
            device=CPU, dtype=torch.float32)


@pytest.mark.parametrize('change', [
    dict(in_size=21), dict(out_size=17), dict(scale=0.8),
    dict(translation=-2.0), dict(dtype=torch.bfloat16),
    dict(device=torch.device('meta'))])
def test_each_resize_argument_keys_its_own_entry(change):
    base = fused.resize_weights(**BASE)
    other = fused.resize_weights(**{**BASE, **change})
    assert len(fused.CONSTS) == 2
    assert other.shape == (change.get('out_size', 16),
                           change.get('in_size', 20))
    assert other.dtype == change.get('dtype', torch.float32)
    assert other.device == change.get('device', CPU)
    assert fused.resize_weights(**BASE) is base
    assert fused.resize_weights(**{**BASE, **change}) is other


@pytest.mark.parametrize('change', [
    dict(frame=(22, 30)), dict(frame=(20, 34)),
    dict(settings={'input_size': [3, 12, 12]}),
    dict(settings={'scale': 0.7}), dict(settings={'mean': [0.5] * 3}),
    dict(settings={'input_range': [0, 255]}), dict(dtype=torch.bfloat16)])
def test_each_clip_geometry_keys_its_own_entries(change):
    """Another frame size or crop takes new resize matrices; other
    normalize settings a new FMA pair; another dtype new entries of
    both."""
    def run(frame=(20, 30), settings=None, dtype=torch.float32):
        fused.preprocess_clip(_frames(2, *frame),
                              {**SETTINGS, **(settings or {})}, dtype=dtype)
    run()
    assert len(fused.CONSTS) == 3
    before = profiling.counters()
    run(**change)
    assert _delta(before, 'preprocess.const_cache.misses') >= 1
    assert len(fused.CONSTS) == 3 + _delta(before,
                                           'preprocess.const_cache.misses')
    before = profiling.counters()
    run()
    run(**change)
    assert _delta(before, 'preprocess.const_cache.misses') == 0


def test_the_bound_holds_and_the_least_recently_used_goes(monkeypatch):
    monkeypatch.setattr(fused.CONSTS, 'maxsize', 4)
    for n in range(20, 30):
        fused.resize_weights(n, 16, 16 / n, 0.0, CPU)
        assert len(fused.CONSTS) == min(n - 19, 4)
    fused.resize_weights(26, 16, 16 / 26, 0.0, CPU)   # refresh the oldest
    fused.resize_weights(30, 16, 16 / 30, 0.0, CPU)   # evicts 27, not 26
    before = profiling.counters()
    fused.resize_weights(26, 16, 16 / 26, 0.0, CPU)
    assert _delta(before, 'preprocess.const_cache.hits') == 1
    fused.resize_weights(27, 16, 16 / 27, 0.0, CPU)
    assert _delta(before, 'preprocess.const_cache.misses') == 1
    assert len(fused.CONSTS) == 4


def test_the_train_chain_and_bucketing_leave_the_entries_as_they_were():
    """The train chain takes the (nh, in) matrices of the resize to
    (nh, nw) = (18, 27) and gathers its rows; bucketing resizes 20 x 30 to
    the bucket 32 x 32 with the f32 matrices themselves."""
    raw = _frames(2, 20, 30).numpy()
    wh = fused.resize_weights(20, 18, 18 / 20, 0.0, CPU)
    ww = fused.resize_weights(30, 27, 27 / 30, 0.0, CPU)
    bh = fused.resize_weights(20, 32, 32 / 20, 0.0, CPU)
    bw = fused.resize_weights(30, 32, 32 / 30, 0.0, CPU)
    mul, add = fused._affine_consts((0, 1), (0.4, 0.45, 0.5),
                                    (0.2, 0.25, 0.3), torch.float32, CPU)
    kept = [t.clone() for t in (wh, ww, bh, bw, mul, add)]
    before = profiling.counters()
    fused.fused_train_apply(raw, SETTINGS, [0, 2], [11, 3], [True, False],
                            [False, True])
    out = bucketing.resize_to_bucket(torch.from_numpy(raw).float())
    assert out.shape == (2, 32, 32, 3)
    assert _delta(before, 'preprocess.const_cache.misses') == 0
    assert _delta(before, 'preprocess.const_cache.hits') == 5
    again = (fused.resize_weights(20, 18, 18 / 20, 0.0, CPU),
             fused.resize_weights(30, 27, 27 / 30, 0.0, CPU),
             fused.resize_weights(20, 32, 32 / 20, 0.0, CPU),
             fused.resize_weights(30, 32, 32 / 30, 0.0, CPU),
             *fused._affine_consts((0, 1), (0.4, 0.45, 0.5),
                                   (0.2, 0.25, 0.3), torch.float32, CPU))
    for entry, now, was in zip((wh, ww, bh, bw, mul, add), again, kept):
        assert now is entry
        assert torch.equal(now, was)


def test_an_entry_built_in_inference_mode_serves_autograd():
    with torch.inference_mode():
        w = fused.resize_weights(20, 16, 0.9, -1.0, CPU)
    assert not w.is_inference() and not w.requires_grad
    x = torch.randn(20, 5, requires_grad=True)
    (fused.resize_weights(20, 16, 0.9, -1.0, CPU) @ x).sum().backward()
    assert torch.allclose(x.grad, w.sum(0)[:, None].expand(20, 5))


def test_threads_sharing_the_cache_get_their_geometry_and_keep_the_bound(
        monkeypatch):
    """16 threads, 8 geometries, room for 4: every lookup counts once as a
    hit or a miss, every thread gets its geometry's matrix and the cache
    never holds more than its bound."""
    monkeypatch.setattr(fused.CONSTS, 'maxsize', 4)
    sizes = list(range(20, 28))
    want = {n: fused.resize_weights(n, 16, 16 / n, 0.0, CPU).clone()
            for n in sizes}
    fused.cache_clear()
    rounds, errors, sizes_seen = 200, [], []
    before = profiling.counters()

    def worker(k):
        try:
            for i in range(rounds):
                n = sizes[(k + i) % len(sizes)]
                got = fused.resize_weights(n, 16, 16 / n, 0.0, CPU)
                if not torch.equal(got, want[n]):
                    errors.append(n)
                sizes_seen.append(len(fused.CONSTS))
        except Exception as e:  # recorded, asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert max(sizes_seen) <= 4
    assert (_delta(before, 'preprocess.const_cache.hits')
            + _delta(before, 'preprocess.const_cache.misses')) == 16 * rounds
