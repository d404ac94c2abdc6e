"""The port's first slice as a whole, against the JAX package: factory ->
hosted ``.pth`` -> preprocess -> ``nonlocalresnet3d50`` -> multi-clip
metrics -> the eval CLI.

The hosted checkpoint is fabricated by the JAX exporter from a model whose
BN (the non-local blocks' zero-initialized ``W.1`` included) is randomized,
and saved DataParallel-wrapped, as the reference's training scripts save.
"""

import os
import runpy
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.parallel.evaluate import \
    multi_clip_eval_step as jax_multi_clip_eval_step
from pretorched_tpu.transforms.fused import fused_preprocess as jax_fused
from pretorched_tpu_torch.parallel.evaluate import multi_clip_eval_step
from pretorched_tpu_torch.transforms.fused import fused_preprocess
from pretorched_tpu_torch.zoo import io

from torch_port_helpers import port_state_dict, randomize_bn, zeros_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME, TAG = 'nonlocalresnet3d50', 'kinetics-400'


def _pth_name():
    return pretorched_tpu_torch.pretrained_settings[NAME][TAG]['url'].rsplit(
        '/', 1)[-1]


@pytest.fixture(scope='module')
def hosted(tmp_path_factory):
    """(jax_model, PRETORCHED_HOME): the JAX nonlocalresnet3d50 with BN
    randomized, exported as the DataParallel-wrapped hosted .pth."""
    home = tmp_path_factory.mktemp('zoo')
    jmodel = pretorched_tpu.nonlocalresnet3d50(num_classes=400,
                                               pretrained=None)
    jmodel.variables = randomize_bn(jmodel.variables, seed=3)
    sd = jmodel.export_torch_state_dict()
    wrapped = {'state_dict': {f'module.{k}': torch.from_numpy(np.array(v))
                              for k, v in sd.items()}}
    (home / 'weights').mkdir()
    torch.save(wrapped, home / 'weights' / _pth_name())
    return jmodel, home


def test_import_pulls_in_no_jax():
    new = ', '.join(f'pretorched_tpu_torch.models.{m}' for m in (
        'inception_v3', 'inceptionv4', 'inceptionresnetv2', 'bninception',
        'xception', 'dpn', 'mobilenet', 'pnasnet', 'polynet', 'vggm',
        'wideresnet'))
    code = ('import sys, pretorched_tpu_torch, pretorched_tpu_torch.gan\n'
            f'import pretorched_tpu_torch.ops.lrn, {new}\n'
            'import pretorched_tpu_torch.zoo.io\n'
            'bad = sorted(m for m in sys.modules\n'
            "             if m == 'jax' or m.startswith(('jax.', 'flax', \n"
            "                                            'pretorched_tpu.')))\n"
            'assert not bad, bad\n'
            "assert 'h5py' not in sys.modules   # only an .hkl read needs it\n"
            "print('NO-JAX')\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, text=True,
                       capture_output=True, timeout=300)
    assert r.returncode == 0 and 'NO-JAX' in r.stdout, r.stdout + r.stderr


def test_model_contract():
    model = pretorched_tpu_torch.resnet3d10(num_classes=5, pretrained=None)
    assert model.settings is None            # nothing loaded ...
    assert model.input_size == [3, 224, 224]  # ... but metadata stamped
    assert model.input_space == 'RGB' and model.input_range == [0, 1]
    assert model.mean == [0.485, 0.456, 0.406]
    assert model.std == [0.229, 0.224, 0.225]
    x = torch.randn(2, 3, 8, 32, 32)
    model.eval()
    assert not model.training
    with torch.no_grad():
        f = model.features(x)
        assert f.shape == (2, 512, 1, 1, 1)
        y = model(x)
        torch.testing.assert_close(model.logits(f), y)
        assert y.shape == (2, 5)
        model.bfloat16()
        assert model(x).dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
        model.float()
        torch.testing.assert_close(model(x), y)
        model.last_linear = pretorched_tpu_torch.Identity()
        assert model(x).shape == (2, 512)
        model.reset_classifier(7)
        assert model(x).shape == (2, 7) and model.num_classes == 7
    assert model.train().training


def test_factory_loads_hosted_pth(hosted, monkeypatch):
    jmodel, home = hosted
    monkeypatch.setenv('PRETORCHED_HOME', str(home))
    with warnings.catch_warnings():
        warnings.simplefilter('error')     # every key present: no warning
        model = pretorched_tpu_torch.__dict__[NAME](num_classes=400,
                                                    pretrained=TAG).eval()
    assert model.settings['num_classes'] == 400
    want_sd = port_state_dict(jmodel.variables, {'last_linear': 'last_linear'})
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0)
    x = np.random.RandomState(0).randn(1, 3, 8, 32, 32).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel(x)), rtol=2e-3,
                               atol=2e-3)


def test_strict_false_names_the_dropped_downsample_keys(tmp_path, monkeypatch):
    """The hosted Kinetics checkpoint is the plain resnet3d50 (shortcut B);
    nonlocalresnet3d50 defaults to shortcut A, so its ``downsample.*``
    weights are dropped, and the non-local weights keep their init."""
    donor = pretorched_tpu_torch.resnet3d50(num_classes=400, pretrained=None)
    sd = {('fc' + k[len('last_linear'):] if k.startswith('last_linear') else k): v
          for k, v in donor.state_dict().items()}
    (tmp_path / 'weights').mkdir()
    torch.save(sd, tmp_path / 'weights' / _pth_name())
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    downsample = sorted(k for k in sd if '.downsample.' in k)
    assert downsample
    with pytest.warns(UserWarning, match='non-strict load') as rec:
        model = pretorched_tpu_torch.__dict__[NAME](num_classes=400,
                                                    pretrained=TAG)
    message = ' '.join(str(w.message) for w in rec)
    assert all(k in message for k in downsample)
    with pytest.warns(UserWarning, match='non-strict load'):
        missing, unexpected = io.load_state_dict_into(
            model, sd, torch_renames={'last_linear': 'fc'}, strict=False)
    assert unexpected == downsample
    assert missing and all('.nonlocalblock.' in k for k in missing)
    torch.testing.assert_close(model.layer1[0].conv1.weight,
                               sd['layer1.0.conv1.weight'])


SETTINGS = {'input_size': [3, 224, 224], 'input_space': 'RGB',
            'input_range': [0, 1], 'mean': [0.485, 0.456, 0.406],
            'std': [0.229, 0.224, 0.225]}
BGR255 = dict(SETTINGS, input_space='BGR', input_range=[0, 255],
              mean=[104, 117, 128], std=[1, 1, 1])


@pytest.mark.parametrize('hw,settings', [
    ((240, 320), SETTINGS),       # downscale: the resize runs
    ((300, 200), BGR255),         # portrait, BGR in [0, 255]
    ((256, 340), SETTINGS),       # short side = floor(224/0.875): crop only
    ((100, 150), SETTINGS),       # upscale
])
def test_fused_preprocess_matches_jax(hw, settings):
    raw = np.random.RandomState(0).randint(0, 256, (2,) + hw + (3,), np.uint8)
    want = np.asarray(jax_fused(raw, settings))
    got = fused_preprocess(raw, settings)
    assert got.dtype == torch.float32 and got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    nchw = fused_preprocess(raw, settings, channels_last=False)
    torch.testing.assert_close(nchw, got.permute(0, 3, 1, 2))


def test_multi_clip_eval_step_matches_jax(hosted, monkeypatch):
    jmodel, home = hosted
    monkeypatch.setenv('PRETORCHED_HOME', str(home))
    model = pretorched_tpu_torch.__dict__[NAME](num_classes=400,
                                                pretrained=TAG).eval()
    clips = np.random.RandomState(4).randn(3, 2, 3, 8, 32, 32).astype(
        np.float32)
    jstep = jax_multi_clip_eval_step(jmodel.module)
    # label video 0 with the JAX consensus's top class (top1 hit), video 1
    # with its 3rd (top5 hit only); video 2 is padding (label -1)
    flat = clips.reshape((6,) + clips.shape[2:])
    probs = jax_softmax_mean(np.asarray(jmodel(flat)).reshape(3, 2, -1))
    ranks = np.argsort(-probs, axis=1)
    labels = np.array([ranks[0, 0], ranks[1, 2], -1])
    want = {k: float(v) for k, v in jstep(
        jmodel.variables, jnp.asarray(np.moveaxis(clips, 2, -1)),
        jnp.asarray(labels)).items()}
    got = {k: float(v) for k, v in multi_clip_eval_step(model)(
        torch.from_numpy(clips), torch.from_numpy(labels)).items()}
    assert (want['top1'], want['top5'], want['count']) == (1, 2, 2)
    for k in ('top1', 'top5', 'count'):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)


def jax_softmax_mean(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).mean(1)


def _frame_folder(root, n_frames=10, n_videos=2, size=40):
    rng = np.random.RandomState(0)
    for cls in ('applauding', 'boxing'):
        for v in range(n_videos):
            d = root / cls / f'v{v}'
            d.mkdir(parents=True)
            for f in range(n_frames):
                arr = rng.randint(0, 255, (size, size, 3), np.uint8)
                Image.fromarray(arr).save(d / f'frame_{f:05d}.jpg')


def _run_cli(script, argv, capsys):
    old = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(os.path.join(REPO, 'examples', script),
                       run_name='__main__')
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_eval_cli_matches_jax_cli(hosted, tmp_path, monkeypatch, capsys):
    """Both CLIs on one frame folder and one checkpoint print the same
    final ``* Acc@1 ... Acc@5 ...`` line (clips at 32 px for CPU cost).
    The JAX CLI runs on one device, as the port does (the suite's 8
    virtual devices compile a sharded program and pad each batch to 8
    videos, for the same numbers), and its factory starts from zeros on a
    ``jax.eval_shape`` template, which the hosted file (every variable of
    the exporting model) overwrites."""
    from pretorched_tpu import parallel as jparallel
    from pretorched_tpu.core import factory as jfactory
    _, home = hosted
    monkeypatch.setattr(jfactory, 'init_variables', zeros_init)
    one_device = jparallel.make_mesh
    monkeypatch.setattr(jparallel, 'make_mesh', lambda: one_device(
        devices=jax.devices()[:1]))
    monkeypatch.setenv('PRETORCHED_HOME', str(home / 'jax'))
    (home / 'jax' / 'weights').mkdir(parents=True, exist_ok=True)
    pth = home / 'jax' / 'weights' / _pth_name()
    if not pth.exists():      # the JAX loader caches a converted copy there
        pth.symlink_to(home / 'weights' / _pth_name())
    for pkg in (pretorched_tpu, pretorched_tpu_torch):
        monkeypatch.setitem(pkg.pretrained_settings[NAME][TAG], 'input_size',
                            [3, 32, 32])
    _frame_folder(tmp_path / 'val')
    argv = [str(tmp_path / 'val'), '-a', NAME, '--pretrained', TAG,
            '--num-classes', '400', '--frames', '8', '--clips', '2',
            '--batch-size', '2', '-j', '1']
    want = _run_cli('video_eval.py', argv, capsys)
    got = _run_cli('video_eval_torch.py', argv + ['--device', 'cpu'], capsys)
    assert 'JPEG decoder' in got
    final = [line for line in got.splitlines() if line.startswith(' * Acc@1')]
    assert final and final == [line for line in want.splitlines()
                               if line.startswith(' * Acc@1')], (got, want)


@pytest.mark.parametrize('n,multiple', [(5, 4), (8, 4), (3, 1)])
def test_pad_batch_matches_jax(n, multiple):
    from pretorched_tpu.parallel.evaluate import pad_batch as jax_pad_batch
    from pretorched_tpu_torch.parallel.evaluate import pad_batch
    x = np.random.RandomState(5).randn(n, 3).astype(np.float32)
    labels = np.arange(n)
    want_x, want_labels = jax_pad_batch(x, labels, multiple)
    got_x, got_labels = pad_batch(torch.from_numpy(x), labels, multiple)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_labels, want_labels)


def test_device_running_sums_one_snapshot():
    from pretorched_tpu_torch.utils import DeviceRunningSums
    meters = DeviceRunningSums()
    assert not meters
    for i in range(3):
        meters.update({'top1': torch.tensor(i), 'loss': torch.tensor(0.5 * i)})
    last, totals = meters.snapshot()
    assert last == {'top1': 2.0, 'loss': 1.0}
    assert totals == meters.totals() == {'top1': 3.0, 'loss': 1.5}


@pytest.mark.parametrize('scale_denom', [1, 2])
def test_jpeg_decode_matches_jax(tmp_path, scale_denom):
    """The port builds its own copy of the JAX package's decoder.cpp; both
    give the same pixels (native or, without libjpeg, the same PIL fallback)."""
    from pretorched_tpu.datasets.native import \
        decode_jpeg_files as jax_decode
    from pretorched_tpu_torch.datasets.native import (decode_jpeg_files,
                                                      decoder_name)
    _frame_folder(tmp_path, n_frames=3, n_videos=1, size=48)
    paths = sorted(str(p) for p in tmp_path.rglob('*.jpg'))
    got = decode_jpeg_files(paths, threads=2, scale_denom=scale_denom)
    want = jax_decode(paths, threads=2, scale_denom=scale_denom)
    assert decoder_name()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == (48 // scale_denom, 48 // scale_denom, 3)
        np.testing.assert_array_equal(g, w)


def test_masked_metrics_ties_rank_like_jax():
    """Rows tied at the consensus clamp (one class at log 1, 399 at
    log(1e-30)): both rank tied classes lowest index first, so labels 0-3
    are all in the top 5."""
    from pretorched_tpu.parallel.evaluate import \
        _masked_metrics as jax_masked_metrics
    from pretorched_tpu_torch.parallel.evaluate import _masked_metrics
    logp = np.full((4, 400), np.log(1e-30), np.float32)
    logp[:, 399] = 0.0
    labels = np.arange(4)
    want = {k: float(v) for k, v in jax_masked_metrics(
        jnp.asarray(logp), jnp.asarray(labels), (1, 5)).items()}
    got = {k: float(v) for k, v in _masked_metrics(
        torch.from_numpy(logp), torch.from_numpy(labels), (1, 5)).items()}
    assert want['top5'] == 4 and want['top1'] == 0
    assert got == pytest.approx(want, rel=1e-6)


def test_reset_classifier_zeroes_the_bias_like_jax():
    """The new head's bias starts at zero, as the JAX package's
    ``reset_classifier`` sets it (``pretorched_tpu/core/wrapper.py:197``)."""
    model = pretorched_tpu_torch.resnet3d10(num_classes=5, pretrained=None)
    model.reset_classifier(7, torch.Generator().manual_seed(1))
    head = model.last_linear
    assert head.weight.shape == (7, 512) and not head.bias.any()
    bound = 512 ** -0.5
    assert 0.9 * bound < head.weight.abs().max() <= bound


@pytest.mark.parametrize('name,ndim,jax', [('resnet3d10', 5, True),
                                           ('nonlocalresnet3d18', 5, False),
                                           ('slowfast_resnet18', 5, False),
                                           ('resnet18', 4, True)])
def test_factories_stamp_input_ndim_like_jax(name, ndim, jax):
    kw = {} if name.startswith('slowfast') else {'pretrained': None}
    assert pretorched_tpu_torch.__dict__[name](**kw).input_ndim == ndim
    if jax:
        assert pretorched_tpu.__dict__[name](**kw).input_ndim == ndim
