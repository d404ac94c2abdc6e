"""The port's shape bucketing (``pretorched_tpu_torch/utils/bucketing.py``)
and the native-length video eval against the JAX package's, on the CPU.

The shape math equals JAX's exactly; the frame re-sampling picks the same
frames for every clip length up to 72 at multiple 8 and up to 24 at 4 (an index
selection: the clips are equal bitwise), and ``frame_indices`` equals
``round(jnp.linspace(0, t - 1, tb))`` for every t <= 512 that the odd
multiples 3, 5, 15 and 31 re-sample (where a position falls half-way
between two frames, XLA's float32 arithmetic decides which); the bucket resize uses JAX's
triangle weights and is held at 1e-4 of the values' range (the JAX resize
sums in another order on the CPU). ``BucketedModel`` against the JAX
wrapper on carried weights at 2e-3 (whole nets). ``video_eval_torch.py
--frames native`` prints the same batches and final line as
``video_eval.py --frames native`` on one hosted ``resnet3d10`` checkpoint
(BN randomized), with ragged lengths that share and split buckets.
"""

import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.utils import bucketing as jb
from pretorched_tpu_torch.utils import bucketing as tb

from torch_port_helpers import carry_model, randomize_bn, zeros_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shape_math_matches_jax():
    for n in range(1, 300, 7):
        for multiple in (1, 8, 32):
            assert tb.bucket_dim(n, multiple) == jb.bucket_dim(n, multiple)
        assert tb.bucket_frames(n) == jb.bucket_frames(n)
        assert tb.bucket_spatial(n, n + 5, 16) == jb.bucket_spatial(n, n + 5,
                                                                   16)
    ladder = [224, 256, 331]
    for n in (1, 224, 225, 300, 331):
        assert tb.bucket_dim(n, ladder=ladder) == jb.bucket_dim(n,
                                                                ladder=ladder)
    with pytest.warns(UserWarning, match='exceeds every ladder rung'):
        assert tb.bucket_dim(999, ladder=ladder) == 1024


@pytest.mark.parametrize('multiple,longest', [(8, 72), (4, 24)])
def test_frame_resampling_matches_jax(multiple, longest):
    clip = np.arange(longest, dtype=np.float32)[None, :, None]
    for t in range(1, longest + 1):
        want = np.asarray(jb.resample_frames_to_bucket(clip[:, :t], multiple))
        got = tb.resample_frames_to_bucket(torch.from_numpy(clip[:, :t]),
                                           multiple)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(t))
    x = torch.randn(2, 3, 16, 4, 4)
    assert tb.resample_frames_to_bucket(x, 8, time_axis=2) is x
    video = torch.randn(2, 3, 13, 4, 4)
    got = tb.resample_frames_to_bucket(video, 8, time_axis=2)
    want = np.asarray(jb.resample_frames_to_bucket(
        np.moveaxis(video.numpy(), 1, -1), 8))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


@pytest.mark.parametrize('multiple', [3, 5, 15, 31])
def test_frame_indices_match_jax_at_odd_multiples(multiple):
    """Every t <= 512 that ``bucket_frames`` re-samples at this multiple:
    the indices of ``resample_frames_to_bucket`` (round half to even of
    ``jnp.linspace`` in float32, clipped) equal the port's."""
    checked = 0
    for t in range(1, 513):
        b = tb.bucket_frames(t, multiple)
        if b == t:
            continue
        # jnp.linspace compiles once per b; round and clip as JAX does
        want = np.clip(np.round(np.asarray(jax.numpy.linspace(0, t - 1, b)))
                       .astype(np.int64), 0, t - 1)
        np.testing.assert_array_equal(tb.frame_indices(t, b), want,
                                      err_msg=f't={t} tb={b}')
        checked += 1
    assert checked > 100


@pytest.mark.parametrize('shape', [(2, 230, 300, 3), (1, 20, 33, 2)])
def test_resize_to_bucket_matches_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jb.resize_to_bucket(x, 32))
    got = tb.resize_to_bucket(torch.from_numpy(x), 32)
    assert got.shape == want.shape
    span = float(want.max() - want.min())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * span)
    x224 = torch.zeros(1, 224, 224, 3)
    assert tb.resize_to_bucket(x224, 32) is x224


def test_bucketed_model_matches_jax():
    """Images snap to 32-pixel buckets; clips also re-sample T; other
    attributes pass through to the model."""
    x = np.random.RandomState(1).randn(1, 3, 40, 50).astype(np.float32)
    jmodel, model, _ = carry_model('resnet18', x)
    want = np.asarray(jb.BucketedModel(jmodel)(x))
    got = tb.BucketedModel(model)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-3,
                               atol=2e-3)
    clip = np.random.RandomState(2).randn(1, 3, 5, 30, 30).astype(np.float32)
    jvideo, video, _ = carry_model('resnet3d10', np.zeros((1, 3, 8, 32, 32),
                                                          np.float32))
    bucketed = tb.BucketedModel(video, frame_multiple=4)
    want = np.asarray(jb.BucketedModel(jvideo, frame_multiple=4)(clip))
    with torch.no_grad():
        got = bucketed(torch.from_numpy(clip)).numpy()
        feats = bucketed.features(torch.from_numpy(clip))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert feats.shape[2] == 1 and bucketed.input_ndim == 5


def _run_cli(script, argv, capsys):
    old = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(os.path.join(REPO, 'examples', script),
                       run_name='__main__')
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _batches_and_final(out):
    return ([line.split('\t')[0] for line in out.splitlines()
             if line.startswith('Test:')],
            [line for line in out.splitlines() if line.startswith(' * Acc@1')])


def test_native_frames_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """Videos of 3, 9 and 12 frames in two classes at --max-frames 12
    --frame-multiple 4: buckets 4 (2 videos) and 12 (4), batches of 3, so
    bucket 12 runs one full batch and each bucket a remainder, in order."""
    home = tmp_path / 'zoo'
    jmodel = pretorched_tpu.resnet3d10(num_classes=400, pretrained=None)
    jmodel.variables = randomize_bn(jmodel.variables, seed=5)
    (home / 'weights').mkdir(parents=True)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jmodel.export_torch_state_dict().items()},
               home / 'weights' / 'resnet3d10-kinetics.pth')
    monkeypatch.setenv('PRETORCHED_HOME', str(home))
    # resnet3d10 has no hosted file: both packages are pointed at this one
    for pkg in (pretorched_tpu, pretorched_tpu_torch):
        settings = pkg.pretrained_settings['resnet3d10']['kinetics-400']
        monkeypatch.setitem(settings, 'input_size', [3, 64, 64])
        monkeypatch.setitem(settings, 'url', 'file:///resnet3d10-kinetics.pth')
    rng = np.random.RandomState(0)
    for cls in ('applauding', 'boxing'):
        for vid, n in (('v0', 3), ('v1', 9), ('v2', 12)):
            d = tmp_path / 'val' / cls / vid
            d.mkdir(parents=True)
            for f in range(n):
                Image.fromarray(rng.randint(0, 255, (60, 80, 3),
                                            np.uint8)).save(
                    d / f'frame_{f:05d}.jpg')
    argv = [str(tmp_path / 'val'), '-a', 'resnet3d10', '--pretrained',
            'kinetics-400', '--frames', 'native', '--max-frames', '12',
            '--frame-multiple', '4', '--clips', '2', '--batch-size', '3',
            '-j', '1', '--print-freq', '1']
    # the JAX CLI on one device, as the port runs (the suite's 8 virtual
    # devices compile a sharded program for the same numbers), its factory
    # from zeros on a template that the file overwrites
    from pretorched_tpu import parallel as jparallel
    from pretorched_tpu.core import factory as jfactory
    monkeypatch.setattr(jfactory, 'init_variables', zeros_init)
    one_device = jparallel.make_mesh
    monkeypatch.setattr(jparallel, 'make_mesh', lambda: one_device(
        devices=jax.devices()[:1]))
    want = _batches_and_final(_run_cli('video_eval.py', argv, capsys))
    cli = runpy.run_path(os.path.join(REPO, 'examples',
                                      'video_eval_torch.py'))
    summary = cli['main'](argv + ['--device', 'cpu'])
    got = _batches_and_final(capsys.readouterr().out)
    assert got == want and len(got[0]) == 3, (got, want)
    assert summary['buckets'] == {4: 2, 12: 4}
