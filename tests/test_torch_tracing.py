"""The port's spans and counters (``utils.profiling``): nothing recorded
without a profiler, the span tree and its self times under one, the spans
as ``pretorched.*`` ranges on the profiler's timeline, the preprocess
counters, and the train step's spans with remat. CPU only (host times:
the device times of the K1 and K2 spans are checked on a card, in
``test_torch_kernels_gpu.py``)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pretorched_tpu_torch.models.resnet3d import VideoResNet
from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
from pretorched_tpu_torch.parallel.evaluate import multi_clip_eval_step
from pretorched_tpu_torch.parallel.train import make_train_step
from pretorched_tpu_torch.transforms.fused import preprocess_clip
from pretorched_tpu_torch.utils import profiling

from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

SETTINGS = {'input_size': [3, 16, 16], 'input_space': 'RGB',
            'input_range': [0, 1], 'mean': [0.4, 0.45, 0.5],
            'std': [0.2, 0.25, 0.3], 'scale': 0.875}


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tiny_model():
    torch.manual_seed(0)
    return VideoResNet('basic', (2, 1, 1, 1), num_classes=3,
                       width_per_stage=(8, 8, 8, 8))


def test_off_records_nothing_and_counters_count():
    before = profiling.counters().get('test.off', 0)
    with profiling.span('a'):
        with profiling.span('b'):
            profiling.count('test.off', 3)
    assert profiling.recorded() == {}
    assert profiling.counters()['test.off'] == before + 3


def test_on_records_host_times_parents_and_self_time():
    @profiling.span('leaf')
    def leaf():
        time.sleep(0.002)

    with _cpu_profile():
        with profiling.span('root'):
            leaf()
            with profiling.span('mid'):
                leaf()
                leaf()
    got = profiling.recorded()
    assert set(got) == {'root', 'mid', 'leaf'}
    assert [got[n]['parent'] for n in ('root', 'mid', 'leaf')] == [
        None, 'root', 'root']
    assert len(got['leaf']['host_ms']) == 3
    assert min(got['leaf']['host_ms']) >= 2.0
    # the device lists stay empty where CUDA was never initialised
    assert got['root']['device_ms'] == [] == got['leaf']['self_device_ms']
    mid, = got['mid']['host_ms']
    assert got['mid']['self_host_ms'][0] == pytest.approx(
        mid - sum(got['leaf']['host_ms'][1:]))
    root, = got['root']['host_ms']
    assert got['root']['self_host_ms'][0] == pytest.approx(
        root - mid - got['leaf']['host_ms'][0])
    assert got['leaf']['self_host_ms'] == got['leaf']['host_ms']
    profiling.reset()
    assert profiling.recorded() == {}


def test_spans_are_ranges_inside_their_parents_on_one_timeline():
    with _cpu_profile() as prof:
        with profiling.span('outer'):
            torch.ones(32, 32) @ torch.ones(32, 32)
            with profiling.span('inner'):
                torch.ones(32, 32) @ torch.ones(32, 32)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            ranges[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns(),
                                e.start_thread_id())
    outer, inner = ranges['pretorched.outer'], ranges['pretorched.inner']
    assert outer[0] <= inner[0] < inner[1] <= outer[1]
    assert outer[2] == inner[2]
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == 'aten::mm']
    assert len(mm) == 2 and all(outer[0] <= e.start_ns() < outer[1]
                                for e in mm)
    assert sum(inner[0] <= e.start_ns() < inner[1] for e in mm) == 1


def test_thread_stacks_are_their_own():
    barrier = threading.Barrier(2, timeout=10)

    def work(name):
        with profiling.span(name):
            barrier.wait()
            with profiling.span('child'):
                barrier.wait()

    with _cpu_profile():
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ('t0', 't1')]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = profiling.recorded()
    assert len(got['child']['host_ms']) == 2
    assert got['t0']['parent'] is None and got['t1']['parent'] is None
    assert got['child']['parent'] in ('t0', 't1')
    for n in ('t0', 't1'):
        assert got[n]['self_host_ms'][0] < got[n]['host_ms'][0]


def test_counters_lose_no_update_across_threads():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = profiling.counters().get('test.threads', 0)

        def add():
            for _ in range(2000):
                profiling.count('test.threads')

        threads = [threading.Thread(target=add) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.counters()['test.threads'] == before + 16 * 2000


def test_counters_report_the_kernels_launches(monkeypatch):
    monkeypatch.setitem(na.nonlocal_attention_bwd_dkv_cuda.by_kernel,
                        'wgmma_wide', 3)
    monkeypatch.setitem(fb_cuda.fused_bottleneck_tail_cuda.by_kernel,
                        'tma', 6)
    got = profiling.counters()
    assert got['k1.dkv.wgmma_wide'] == 3 and got['k2.tma'] == 6


@pytest.mark.parametrize('frame,consts', [((20, 30), 6), ((18, 20), 2)])
def test_preprocess_counts_its_host_constants_per_clip(frame, consts):
    """Resizing 20 x 30 frames builds two resize matrices (a scale and a
    translation each) and the normalize FMA's two constants; 18 x 20
    frames, whose shorter side is already floor(crop / scale) = 18, only
    the latter."""
    clip = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (4,) + frame + (3,), dtype=np.uint8))
    before = profiling.counters()
    with _cpu_profile():
        for _ in range(3):
            out = preprocess_clip(clip, SETTINGS, channels_last=False)
    after = profiling.counters()
    assert out.shape == (1, 3, 4, 16, 16)
    assert after['preprocess.clips'] - before.get('preprocess.clips', 0) == 3
    assert after['preprocess.host_consts'] - before.get(
        'preprocess.host_consts', 0) == 3 * consts
    assert len(profiling.recorded()['preprocess.clip']['host_ms']) == 3


def test_eval_step_holds_the_stem():
    model = _tiny_model().eval()
    step = multi_clip_eval_step(model)
    clips = torch.randn(2, 2, 3, 4, 16, 16)
    step(clips, np.array([0, 1]))            # off: nothing
    assert profiling.recorded() == {}
    with _cpu_profile():
        step(clips, np.array([0, 1]))
    got = profiling.recorded()
    assert got['eval.step']['parent'] is None
    assert got['stem']['parent'] == 'eval.step'
    assert len(got['eval.step']['host_ms']) == len(got['stem']['host_ms']) == 1


def test_train_step_spans_and_one_recompute_per_checkpointed_block():
    model = _tiny_model()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, opt, remat=(0,))
    x, labels = torch.randn(2, 3, 4, 16, 16), torch.tensor([0, 2])
    with _cpu_profile():
        step(x, labels)
        step(x, labels)
    got = profiling.recorded()
    assert got['train.step']['parent'] is None
    for name in ('train.forward', 'train.backward', 'train.optimizer'):
        assert got[name]['parent'] == 'train.step'
        assert len(got[name]['host_ms']) == 2
    assert got['stem']['parent'] == 'train.forward'
    # layer1's two blocks, recomputed inside the backward of each step
    assert got['remat.recompute']['parent'] == 'train.backward'
    assert len(got['remat.recompute']['host_ms']) == 2 * 2
    step_ms = got['train.step']['host_ms']
    assert all(s >= f + b + o for s, f, b, o in zip(
        step_ms, got['train.forward']['host_ms'],
        got['train.backward']['host_ms'], got['train.optimizer']['host_ms']))
