"""The port's ImageNet eval and train chain against the JAX package's, on
the CPU: ``ten_crop``, the train preprocessing fed JAX's draws, the image
folder loader (order, shards, ``drop_last``, failures), the fast eval
pipeline on local JPEGs, the one-crop eval step with padded rows, and
``examples/imagenet_eval_torch.py`` against ``examples/imagenet_eval.py``.

Preprocessing is held at 1e-4 (``tests/test_full_network_parity.py:26``),
relative to the normalized values' range where inputs are [0, 255]
(BGR-255): the JAX resize sums in another order on the CPU. The CLIs run
``nasnetamobile`` from one seeded hosted ``.pth`` (the port's init, every
BN randomized); the JAX factory's init (a 30 s compile on the CPU) is
replaced by zeros of ``jax.eval_shape``'s template, which the hosted
checkpoint then fills, so only the forward compiles. The train mode
(one epoch, checkpoint, ``.meta``, ``model_best``, ``--resume``) runs on
``resnet18`` at small images: the JAX CLI's train test is slow-gated.
"""

import os
import runpy
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pretorched_tpu_torch
from pretorched_tpu.datasets import folder as jfolder
from pretorched_tpu.parallel.evaluate import sharded_accuracy_step
from pretorched_tpu.transforms import fused as jfused
from pretorched_tpu_torch.datasets import folder
from pretorched_tpu_torch.parallel.evaluate import make_eval_step
from pretorched_tpu_torch.transforms import fused

from torch_port_helpers import carry_model, randomize_port_bn
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {'input_space': 'RGB', 'input_size': [3, 224, 224],
            'input_range': [0, 1], 'mean': [0.485, 0.456, 0.406],
            'std': [0.229, 0.224, 0.225]}
BGR255 = dict(SETTINGS, input_space='BGR', input_range=[0, 255],
              mean=[104, 117, 128], std=[1, 1, 1])


@pytest.mark.parametrize('hw', [(256, 256), (250, 300)])
def test_ten_crop_matches_jax(hw):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jfused.ten_crop(x, 224))
    got = fused.ten_crop(torch.from_numpy(x), 224)
    assert got.shape == (2, 10, 224, 224, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    nchw = fused.ten_crop(torch.from_numpy(x).permute(0, 3, 1, 2), 224,
                          channels_last=False)
    torch.testing.assert_close(nchw, got.permute(0, 1, 4, 2, 3), rtol=0,
                               atol=0)
    # crop 4 is the center crop, crop 9 its mirror
    t, l = (hw[0] - 224) // 2, (hw[1] - 224) // 2
    torch.testing.assert_close(got[:, 4], torch.from_numpy(
        x[:, t:t + 224, l:l + 224]), rtol=0, atol=0)
    torch.testing.assert_close(got[:, 9], got[:, 4].flip(2), rtol=0, atol=0)


def _jax_draws(key, b, nh, nw, crop, vflip):
    """The offsets and flips ``_fused_train`` draws (fused.py:165-173)."""
    kt, kl, kh, kv = jax.random.split(key, 4)
    return (np.asarray(jax.random.randint(kt, (b,), 0, nh - crop + 1)),
            np.asarray(jax.random.randint(kl, (b,), 0, nw - crop + 1)),
            np.asarray(jax.random.bernoulli(kh, 0.5, (b,))),
            np.asarray(jax.random.bernoulli(kv, 0.5, (b,))) if vflip
            else None)


@pytest.mark.parametrize('shape,settings,vflip', [
    ((8, 280, 350, 3), SETTINGS, False),       # resize, then the windows
    ((6, 224, 224, 3), dict(SETTINGS, scale=1.0), True),   # identity resize
    ((4, 300, 260, 3), BGR255, True),          # portrait, BGR in [0, 255]
])
def test_train_preprocess_given_jax_draws_matches_jax(shape, settings,
                                                      vflip):
    raw = np.random.RandomState(1).randint(0, 255, shape, np.uint8)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jfused.fused_train_preprocess(raw, settings, key,
                                                    random_vflip=vflip))
    nh, nw = fused._resize_target(shape[1], shape[2], 224,
                                  settings.get('scale', 0.875), True,
                                  settings['input_size'])
    draws = _jax_draws(key, shape[0], nh, nw, 224, vflip)
    got = fused.fused_train_apply(raw, settings, *draws).numpy()
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    span = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * span)
    nchw = fused.fused_train_apply(raw, settings, *draws,
                                   channels_last=False)
    torch.testing.assert_close(nchw, torch.from_numpy(got).permute(
        0, 3, 1, 2))


def test_train_preprocess_draws_from_its_generator():
    """The same seed gives the same batch, another seed another; with no
    room to crop, each sample is the eval chain's, mirrored or not."""
    raw = np.random.RandomState(2).randint(0, 255, (8, 280, 350, 3),
                                           np.uint8)

    def run(seed, s=SETTINGS, x=raw):
        return fused.fused_train_preprocess(
            x, s, torch.Generator().manual_seed(seed)).numpy()

    np.testing.assert_array_equal(run(0), run(0))
    assert np.abs(run(0) - run(7)).max() > 1e-3
    s = dict(SETTINGS, scale=1.0)
    square = raw[:, :224, :224]
    ev = fused.fused_preprocess(square, s).numpy()
    tr = run(3, s, square)
    same = np.abs(tr - ev).max(axis=(1, 2, 3)) < 1e-5
    mirrored = np.abs(tr - ev[:, :, ::-1]).max(axis=(1, 2, 3)) < 1e-5
    assert np.all(same | mirrored) and same.any() and mirrored.any()
    with pytest.raises(ValueError, match='tops'):
        fused.fused_train_apply(raw, SETTINGS, [0] * 7 + [999], [0] * 8,
                                [False] * 8)


class Indices:
    """A dataset whose items are their own indices."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), i


@pytest.mark.parametrize('kw', [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=5, shuffle=True, seed=1, drop_last=True),
    dict(batch_size=2, shuffle=True, seed=2, shard_id=1, num_shards=3),
    dict(batch_size=3, shuffle=True, seed=0, shard_id=2, num_shards=3,
         drop_last=True),
])
def test_batch_iterator_order_matches_jax(kw):
    want = [(x.tolist(), y.tolist()) for x, y in
            jfolder.batch_iterator(Indices(), num_workers=2, **kw)]
    got = [(x.tolist(), y.tolist()) for x, y in
           folder.batch_iterator(Indices(), num_workers=2, **kw)]
    assert got == want and got


def test_batch_iterator_failures():
    """A raising item surfaces to the consumer; an abandoned iterator lets
    its producer thread go; a bad shard raises."""

    class Bad(Indices):
        def __getitem__(self, i):
            if i == 5:
                raise OSError('corrupt image')
            return super().__getitem__(i)

    with pytest.raises(OSError, match='corrupt image'):
        for _ in folder.batch_iterator(Bad(), 4, num_workers=2):
            pass
    before = threading.active_count()
    it = folder.batch_iterator(Indices(), batch_size=2, num_workers=2,
                               prefetch=1)
    next(it)
    it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= before
    with pytest.raises(ValueError, match='shard'):
        next(folder.batch_iterator(Indices(), 2, shard_id=3, num_shards=3))


def _jpegs(root, sizes, classes=('a', 'b'), seed=0):
    rng = np.random.RandomState(seed)
    for cls in classes:
        d = root / cls
        d.mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
                d / f'{i}.jpg', quality=90)


def test_image_folder_matches_jax(tmp_path):
    _jpegs(tmp_path, [(40, 50), (30, 60)], classes=('b', 'a', 'c'))
    (tmp_path / 'a' / 'notes.txt').write_text('not an image')
    want = jfolder.ImageFolder(str(tmp_path))
    got = folder.ImageFolder(str(tmp_path))
    assert got.classes == want.classes == ['a', 'b', 'c']
    assert got.samples == want.samples and len(got) == 6
    img, label = got[3]
    assert label == 1 and img.size == (60, 30)       # b/1.jpg


@pytest.mark.parametrize('sizes', [
    [(200, 260), (210, 260), (200, 260)],      # two decoded sizes a chunk
    [(620, 700), (600, 640)],                  # DCT scale 1/2
])
def test_fast_eval_batches_match_jax(tmp_path, sizes):
    _jpegs(tmp_path, sizes)
    want = [(np.asarray(x), y) for x, y in
            jfolder.fast_eval_batches(str(tmp_path), SETTINGS, 4,
                                      num_threads=2)]
    got = list(folder.fast_eval_batches(str(tmp_path), SETTINGS, 4,
                                        num_threads=2, device='cpu'))
    assert [x.shape for x, _ in got] == [x.shape for x, _ in want]
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_allclose(gx.numpy(), wx, rtol=1e-4, atol=1e-4)
    nchw = next(folder.fast_eval_batches(str(tmp_path), SETTINGS, 4,
                                         num_threads=2, channels_last=False,
                                         dtype=torch.bfloat16, device='cpu'))
    assert nchw[0].dtype == torch.bfloat16 and nchw[0].shape[1] == 3


def test_eval_step_with_padded_rows_matches_jax():
    """Rows labelled -1 count nowhere; top-1, top-5, the loss sum and the
    count equal the JAX step's."""
    x = np.random.RandomState(5).randn(5, 3, 32, 32).astype(np.float32)
    jmodel, model, logits = carry_model('resnet18', x)
    ranks = np.argsort(-logits, axis=1)
    labels = np.array([ranks[0, 0], ranks[1, 3], ranks[2, 7], -1, -1])
    want = {k: float(v) for k, v in sharded_accuracy_step(jmodel.module)(
        jmodel.variables, jnp.asarray(np.moveaxis(x, 1, -1)),
        jnp.asarray(labels)).items()}
    got = {k: float(v) for k, v in make_eval_step(model)(
        torch.from_numpy(x), torch.from_numpy(labels)).items()}
    assert (want['top1'], want['top5'], want['count']) == (1, 2, 3)
    for k in ('top1', 'top5', 'count'):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)


def _run_jax_cli(argv, capsys):
    old = sys.argv
    sys.argv = ['imagenet_eval.py'] + argv
    try:
        runpy.run_path(os.path.join(REPO, 'examples', 'imagenet_eval.py'),
                       run_name='__main__')
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _load_cli():
    return runpy.run_path(os.path.join(REPO, 'examples',
                                       'imagenet_eval_torch.py'))


def _metric_lines(out):
    """The ``Test:`` lines without their times, and the final line."""
    lines = []
    for line in out.splitlines():
        if line.startswith('Test:'):
            fields = line.split('\t')
            lines.append('\t'.join(f for f in fields
                                   if not f.startswith('Time')))
        elif line.startswith(' * Acc@1'):
            lines.append(line)
    return lines


@pytest.fixture(scope='module')
def hosted_nasnet(tmp_path_factory):
    """PRETORCHED_HOME holding a seeded ``nasnetamobile`` imagenet .pth, and
    a val folder of 2 classes x 2 JPEGs."""
    home = tmp_path_factory.mktemp('zoo')
    model = randomize_port_bn(pretorched_tpu_torch.nasnetamobile(
        num_classes=1000, pretrained=None), seed=6)
    url = pretorched_tpu_torch.pretrained_settings['nasnetamobile'][
        'imagenet']['url']
    (home / 'weights').mkdir()
    torch.save(model.state_dict(), home / 'weights' / url.rsplit('/', 1)[-1])
    data = tmp_path_factory.mktemp('imagenet')
    _jpegs(data / 'val', [(230, 300), (260, 240)], seed=7)
    return home, data


def _zeros_init(module, input_shape, seed=0, **call_kwargs):
    shapes = jax.eval_shape(module.init, jax.random.key(seed),
                            jax.ShapeDtypeStruct(input_shape, np.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))


@pytest.mark.parametrize('extra', [[], ['--ten-crop']])
def test_eval_cli_matches_jax_cli(hosted_nasnet, extra, monkeypatch, capsys):
    """``-e`` and ``-e --ten-crop`` print the same metric lines (times
    aside) as the JAX CLI, on one checkpoint, in batches of 2. The JAX CLI
    runs on a one-device mesh, as the port runs on one device: on the
    suite's 8 virtual devices it compiles a sharded program, several times
    slower on a loaded CPU, for the same numbers."""
    from pretorched_tpu import parallel as jparallel
    from pretorched_tpu.core import factory as jfactory
    home, data = hosted_nasnet
    monkeypatch.setenv('PRETORCHED_HOME', str(home))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    monkeypatch.setattr(jfactory, 'init_variables', _zeros_init)
    one_device = jparallel.make_mesh
    monkeypatch.setattr(jparallel, 'make_mesh', lambda: one_device(
        devices=jax.devices()[:1]))
    argv = [str(data), '-a', 'nasnetamobile', '-b', '2', '-e', '-j', '2',
            '-p', '1'] + extra
    want = _metric_lines(_run_jax_cli(argv, capsys))
    summary = _load_cli()['main'](argv + ['--device', 'cpu'])
    got = _metric_lines(capsys.readouterr().out)
    assert len(got) == 3 and got == want, (got, want)
    assert summary['totals']['count'] == 4


@pytest.fixture(scope='module')
def hosted_mobilenet(tmp_path_factory):
    """PRETORCHED_HOME holding a seeded ``mobilenetv2`` imagenet .pth."""
    home = tmp_path_factory.mktemp('zoo_mobilenet')
    model = randomize_port_bn(pretorched_tpu_torch.mobilenetv2(
        num_classes=1000, pretrained=None), seed=8)
    url = pretorched_tpu_torch.pretrained_settings['mobilenetv2'][
        'imagenet']['url']
    (home / 'weights').mkdir()
    torch.save(model.state_dict(), home / 'weights' / url.rsplit('/', 1)[-1])
    return home


def test_eval_cli_matches_jax_cli_on_mobilenetv2(hosted_mobilenet,
                                                 hosted_nasnet, monkeypatch,
                                                 capsys):
    """A net of the rest of the 2D zoo through both CLIs (``-e``, batches
    of 2, the JAX CLI on a one-device mesh): the same metric lines, times
    aside, at 224 px."""
    from pretorched_tpu import parallel as jparallel
    from pretorched_tpu.core import factory as jfactory
    _, data = hosted_nasnet
    monkeypatch.setenv('PRETORCHED_HOME', str(hosted_mobilenet))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    monkeypatch.setattr(jfactory, 'init_variables', _zeros_init)
    one_device = jparallel.make_mesh
    monkeypatch.setattr(jparallel, 'make_mesh', lambda: one_device(
        devices=jax.devices()[:1]))
    argv = [str(data), '-a', 'mobilenetv2', '-b', '2', '-e', '-j', '2',
            '-p', '1']
    want = _metric_lines(_run_jax_cli(argv, capsys))
    summary = _load_cli()['main'](argv + ['--device', 'cpu'])
    got = _metric_lines(capsys.readouterr().out)
    assert len(got) == 3 and got == want, (got, want)
    assert summary['totals']['count'] == 4


@pytest.mark.parametrize('arch,size,scale', [('dpn68b', 224, 0.875),
                                             ('vggm', 221, 0.875),
                                             ('xception', 299, 0.8975)])
def test_cli_takes_new_names_at_their_own_size(arch, size, scale, tmp_path,
                                               monkeypatch):
    """``-a`` with ``--pretrained none`` resizes to the model's own
    ``input_size`` and ``scale``: ``dpn68b``'s settings have only
    ``imagenet+5k``, ``vggm`` is outside ``pretrained_settings``."""
    from pretorched_tpu_torch import transforms
    _jpegs(tmp_path / 'val', [(120, 150)])
    seen = []
    real = transforms.TransformImage

    def spy(settings, **kw):
        seen.append((list(settings['input_size']), kw['scale']))
        return real(settings, **kw)

    monkeypatch.setattr(transforms, 'TransformImage', spy)
    summary = _load_cli()['main']([str(tmp_path), '-a', arch, '--pretrained',
                                   'none', '-e', '-b', '2', '-j', '1',
                                   '--device', 'cpu'])
    assert seen == [([3, size, size], scale)]
    assert summary['totals']['count'] == 2


def test_train_mode_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """One epoch of ``resnet18`` at 64 x 80 px JPEGs, batches of 2: the
    ``Epoch:`` lines, ``checkpoint.pth`` with its ``.meta`` and
    ``model_best.pth``; ``-e --resume`` evaluates the saved weights exactly;
    ``--resume`` restores the epoch, best_prec1 and the optimizer, then
    trains the next epoch."""
    _jpegs(tmp_path / 'data' / 'train', [(64, 80)] * 2)
    _jpegs(tmp_path / 'data' / 'val', [(70, 80)], seed=1)
    monkeypatch.chdir(tmp_path)
    cli = _load_cli()
    base = [str(tmp_path / 'data'), '-a', 'resnet18', '--pretrained', 'none',
            '-b', '2', '-j', '1', '-p', '1', '--lr', '0.01', '--device',
            'cpu']
    first = cli['main'](base + ['--epochs', '1'])
    out = capsys.readouterr().out
    assert 'Epoch: [0][0]' in out and 'Epoch: [0][1]' in out, out
    assert first['train_steps'] == 2 and first['epochs'] == 1
    meta = cli['read_meta']('checkpoint.pth.meta')
    assert meta == {'epoch': 0, 'arch': 'resnet18',
                    'best_prec1': first['best_prec1']}
    assert os.path.isfile('model_best.pth') == (first['prec1'] > 0)
    state = torch.load('checkpoint.pth', weights_only=True)
    assert sorted(state) == ['model', 'optimizer']

    again = cli['main'](base + ['-e', '--resume', 'checkpoint.pth'])
    assert again['totals'] == first['totals']
    resumed = cli['main'](base + ['--epochs', '2', '--resume',
                                  'checkpoint.pth'])
    out = capsys.readouterr().out
    assert ('=> resumed epoch 1 (best_prec1 '
            f"{first['best_prec1']:.3f})") in out
    assert 'Epoch: [1][0]' in out and 'Epoch: [0]' not in out
    assert resumed['train_steps'] == 2
    assert cli['read_meta']('checkpoint.pth.meta')['epoch'] == 1


def test_cli_refuses_zero_and_fast_ten_crop(tmp_path):
    cli = _load_cli()
    with pytest.raises(SystemExit):      # ZeRO is '1' or 'fsdp'
        cli['main']([str(tmp_path), '--zero', '2', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='ten-crop'):
        cli['main']([str(tmp_path), '-a', 'resnet18', '--pretrained', 'none',
                     '-e', '--fast-pipeline', '--ten-crop', '--device',
                     'cpu'])


def test_cli_imports_no_jax():
    """Run in a fresh interpreter: the CLI module pulls in no JAX."""
    import subprocess
    code = ('import runpy, sys\n'
            "runpy.run_path('examples/imagenet_eval_torch.py')\n"
            'import pretorched_tpu_torch.datasets.folder\n'
            'import pretorched_tpu_torch.utils.bucketing\n'
            "bad = [m for m in sys.modules if m == 'jax' or\n"
            "       m.startswith(('jax.', 'flax', 'pretorched_tpu.'))]\n"
            'assert not bad, bad\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, text=True,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr
