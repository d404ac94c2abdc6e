"""The port's VOC2007 dataset and transfer example, the AP meter, the misc
helpers, ``SizeEstimator``, profiling and debugging, and the
architecture demo, against the JAX package's, on the CPU.

A fabricated VOC2007 folder (seeded crops of ``data/*.jpg``, seeded labels
in {-1, 0, 1}, the four sentinel paths) gives the same names, targets,
images and CSV cache in both packages, with ``urlretrieve`` made to raise:
nothing is fetched. Both transfer examples extract features of one hosted
``resnet18`` file (within 2e-3), and both ``train_multilabel`` functions
print the same AP lines on the same features.
"""

import os
import runpy
import shutil
import subprocess
import sys
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import pretorched_tpu_torch
from pretorched_tpu.datasets import utils as jutils
from pretorched_tpu.datasets import voc as jvoc
from pretorched_tpu.utils import misc as jmisc
from pretorched_tpu.utils.size import SizeEstimator as JaxSizeEstimator
from pretorched_tpu_torch.datasets import utils as dutils
from pretorched_tpu_torch.datasets import voc
from pretorched_tpu_torch.utils import debugging, misc, profiling
from pretorched_tpu_torch.utils.size import SizeEstimator

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import randomize_port_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(REPO, 'data', f) for f in ('cat.jpg', 'croco.jpg')]


def fabricate_voc(root, per_split=4, seed=0):
    """``root/VOC2007`` in the VOC layout: ``per_split`` JPEGs a split cut
    from ``data/*.jpg`` with seeded crops and sizes, per-class label files
    (in the train split each class has a positive and a negative row), and
    the download sentinels. Returns the VOC2007 root."""
    rng = np.random.RandomState(seed)
    base = os.path.join(str(root), 'VOC2007')
    dev = os.path.join(base, 'VOCdevkit', 'VOC2007')
    os.makedirs(os.path.join(dev, 'JPEGImages'))
    os.makedirs(os.path.join(dev, 'ImageSets', 'Main'))
    sources = [Image.open(p).convert('RGB') for p in SOURCES]
    names = {}
    for s, split in enumerate(('train', 'val')):
        names[split] = [f'{1 + s * per_split + i:06d}'
                        for i in range(per_split)]
        for name in names[split]:
            src = sources[rng.randint(len(sources))]
            w, h = rng.randint(60, 140), rng.randint(60, 140)
            x0 = rng.randint(0, src.width - w)
            y0 = rng.randint(0, src.height - h)
            src.crop((x0, y0, x0 + w, y0 + h)).save(
                os.path.join(dev, 'JPEGImages', name + '.jpg'), quality=90)
    for c in voc.object_categories:
        for split in ('train', 'val'):
            labels = rng.choice([-1, 0, 1], len(names[split]))
            if split == 'train':
                labels[:2] = (1, -1)
            with open(os.path.join(dev, 'ImageSets', 'Main',
                                   f'{c}_{split}.txt'), 'w') as f:
                for name, label in zip(names[split], labels):
                    f.write(f'{name} {label:2d}\n')
    open(os.path.join(dev, 'ImageSets', 'Main', 'aeroplane_test.txt'),
         'w').close()
    assert os.path.exists(os.path.join(dev, 'JPEGImages', '000001.jpg'))
    return base


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f'a download was attempted: {args}')
    monkeypatch.setattr(urllib.request, 'urlretrieve', refuse)


def test_voc2007_items_match_jax(tmp_path, no_network):
    """Names, targets in {-1, 0, 1}, images and the CSV cache equal
    JAX's, each package on its own copy of the folder; the cached CSV is
    read back on the next build."""
    root = fabricate_voc(tmp_path / 'port')
    jroot = shutil.copytree(root, str(tmp_path / 'jax' / 'VOC2007'))
    for split in ('train', 'val'):
        got = voc.Voc2007Classification(root, split)
        want = jvoc.Voc2007Classification(jroot, split)
        assert len(got) == len(want) == 4
        assert got.classes == want.classes and got.get_number_classes() == 20
        for i in range(len(got)):
            img, name, target = got[i]
            jimg, jname, jtarget = want[i]
            assert name == jname
            assert target.dtype == torch.float32
            np.testing.assert_array_equal(target.numpy(), jtarget)
            np.testing.assert_array_equal(np.asarray(img), np.asarray(jimg))
        assert set(np.unique(np.stack([t for _, t in got.images]))) <= {
            -1.0, 0.0, 1.0}
        csv = os.path.join('files', 'VOC2007', f'classification_{split}.csv')
        with open(os.path.join(root, csv)) as a, \
                open(os.path.join(jroot, csv)) as b:
            assert a.read() == b.read()
    os.remove(os.path.join(root, 'VOCdevkit', 'VOC2007', 'ImageSets', 'Main',
                           'aeroplane_val.txt'))
    again = voc.Voc2007Classification(root, 'val')       # from the CSV
    assert [n for n, _ in again.images] == [n for n, _ in got.images]
    with pytest.raises(AssertionError, match='download was attempted'):
        voc.Voc2007Classification(str(tmp_path / 'empty'), 'val')


def test_average_precision_meter_matches_jax():
    """Tied scores (the stable sort keeps their order of arrival) and
    difficult rows, skipped or counted as negatives; tensors in, two
    batches."""
    rng = np.random.RandomState(3)
    scores = np.round(rng.randn(40, 6), 1).astype(np.float32)
    scores[:, 0] = 0.5                                   # all tied
    targets = rng.choice([-1, 0, 1], (40, 6)).astype(np.float32)
    for difficult in (True, False):
        got = dutils.AveragePrecisionMeter(difficult_examples=difficult)
        want = jutils.AveragePrecisionMeter(difficult_examples=difficult)
        for lo, hi in ((0, 25), (25, 40)):
            got.add(torch.from_numpy(scores[lo:hi]),
                    torch.from_numpy(targets[lo:hi]))
            want.add(scores[lo:hi], targets[lo:hi])
        np.testing.assert_allclose(got.value(), want.value(), rtol=0,
                                   atol=1e-6)
    for c in range(6):
        assert dutils.AveragePrecisionMeter.average_precision(
            scores[:, c], targets[:, c]) == \
            jutils.AveragePrecisionMeter.average_precision(
                scores[:, c], targets[:, c])
    assert dutils.AveragePrecisionMeter().value().shape == (0,)
    with pytest.raises(ValueError):
        got.add(np.zeros((2, 3)), np.zeros((2, 3)))
    img = Image.new('RGB', (30, 20))
    assert dutils.Warp(16)(img).size == jutils.Warp(16)(img).size == (16, 16)
    assert str(dutils.Warp(16)) == str(jutils.Warp(16))


def test_misc_helpers_match_jax():
    rng = np.random.RandomState(4)
    scores = rng.randn(6, 5).astype(np.float32)
    np.testing.assert_array_equal(misc.softmax(scores), jmisc.softmax(scores))
    np.testing.assert_allclose(misc.softmax(torch.from_numpy(scores)),
                               jmisc.softmax(scores), rtol=1e-6)
    assert misc.log_add(0.5, 2.0) == jmisc.log_add(0.5, 2.0)
    pred, label = rng.randint(0, 4, 30), rng.randint(0, 4, 30)
    got, want = misc.class_accuracy(pred, label), jmisc.class_accuracy(pred,
                                                                      label)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert list(misc.chunks(list(range(7)), 3)) == \
        list(jmisc.chunks(list(range(7)), 3))
    assert list(misc.sort([3, 1, 2])) == list(jmisc.sort([3, 1, 2]))
    tied = np.zeros((4, 5), np.float32)
    tied[:, 2] = 1.0
    target = np.array([2, 0, 4, 1])
    for out in (scores[:4], tied):
        assert misc.topk_accuracy(torch.from_numpy(out),
                                  torch.from_numpy(target), (1, 3)) == \
            jmisc.topk_accuracy(out, target, (1, 3))
    items = [('a.jpg', 'cat 0.9'), ('b.mp4', 'dog 0.4')]
    assert misc.HTML.page(items) == jmisc.HTML.page(items)
    assert misc.HTML.element('p', 'x', 'i', 'c', 'a=1') == \
        jmisc.HTML.element('p', 'x', 'i', 'c', 'a=1')

    class Thing:
        calls = 0

        @misc.cache
        def once(self):
            Thing.calls += 1
            return 7

        @misc.lazy_property
        def lazy(self):
            Thing.calls += 1
            return 8

    t = Thing()
    assert (t.once, t.once, t.lazy, t.lazy, Thing.calls) == (7, 7, 8, 8, 2)


@pytest.mark.parametrize('name,jax_module', [
    ('densenet3d121', lambda: __import__(
        'pretorched_tpu.models.densenet3d', fromlist=['x']).DenseNet3D()),
    ('mvresnet18', lambda: __import__(
        'pretorched_tpu.models.multiview', fromlist=['x']).MVResNet(
            block='basic', layers=(2, 2, 2, 2), num_classes=400,
            expansion=1))])
def test_size_estimator_param_bits_match_jax(name, jax_module):
    """``param_bits`` equals JAX's on the same architecture (JAX's
    parameters from a ``jax.eval_shape`` template)."""
    module = jax_module()
    shapes = jax.eval_shape(module.init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 16, 112, 112, 3),
                                                 np.float32))
    want = JaxSizeEstimator(types.SimpleNamespace(variables=shapes))
    model = pretorched_tpu_torch.__dict__[name]()
    assert SizeEstimator(model).param_bits() == want.param_bits()
    got = SizeEstimator(model, (1, 3, 16, 112, 112), bits=16)
    assert got.param_bits() == want.param_bits() // 2


def test_size_estimator_counts_activations():
    """The estimate adds twice the leaf modules' outputs of one forward
    (forward hooks) and the input to the parameters."""
    model = pretorched_tpu_torch.mvresnet10(num_classes=5)
    est = SizeEstimator(model, (1, 3, 4, 32, 32))
    mb, total = est.estimate_size()
    acts = est._activation_elems()
    assert acts > 64 * 4 * 16 * 16          # the stem's output alone
    assert total == est.param_bits() + 2 * 32 * acts + 3 * 4 * 32 * 32 * 32
    assert mb == total / 8 / 1024 / 1024
    from pretorched_tpu_torch.models.utils import Identity
    from pretorched_tpu_torch.models.utils import SizeEstimator as alias
    assert alias is SizeEstimator and Identity is pretorched_tpu_torch.Identity


@pytest.fixture(scope='module')
def hosted_resnet18(tmp_path_factory):
    """PRETORCHED_HOME holding a seeded ``resnet18`` imagenet .pth in the
    torchvision keys (``fc``)."""
    home = tmp_path_factory.mktemp('zoo_resnet18')
    model = randomize_port_bn(pretorched_tpu_torch.resnet18(
        num_classes=1000, pretrained=None), seed=9)
    url = pretorched_tpu_torch.pretrained_settings['resnet18'][
        'imagenet']['url']
    (home / 'weights').mkdir()
    sd = {('fc' + k[len('last_linear'):] if k.startswith('last_linear')
           else k): v for k, v in model.state_dict().items()}
    torch.save(sd, home / 'weights' / url.rsplit('/', 1)[-1])
    return home


def _zeros_init(module, input_shape, seed=0, **call_kwargs):
    shapes = jax.eval_shape(module.init, jax.random.key(seed),
                            jax.ShapeDtypeStruct(input_shape, np.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))


def _ap_lines(out):
    return [line for line in out.splitlines() if 'AP' in line]


def test_voc_example_matches_jax(hosted_resnet18, tmp_path, monkeypatch,
                                 capsys, no_network):
    """Both examples on one fabricated folder and one hosted ``resnet18``
    file, ``-b 4``: the port's cached features within 2e-3 of JAX's, its
    targets equal, 20 AP lines and the mAP; a second run reads the cache.
    Then both ``train_multilabel`` on the port's features print the same
    lines."""
    from pretorched_tpu.core import factory as jfactory
    data = tmp_path / 'datasets'
    fabricate_voc(data)
    monkeypatch.setenv('PRETORCHED_HOME', str(hosted_resnet18))
    monkeypatch.setenv('PRETORCHED_STRICT_WEIGHTS', '1')
    monkeypatch.setattr(jfactory, 'init_variables', _zeros_init)
    common = ['--dir_datasets', str(data), '-a', 'resnet18', '-b', '4']
    monkeypatch.setattr(sys, 'argv', ['voc2007_extract.py', *common,
                                      '--dir_outputs', str(tmp_path / 'jax')])
    runpy.run_path(os.path.join(REPO, 'examples', 'voc2007_extract.py'),
                   run_name='__main__')
    capsys.readouterr()
    cli = runpy.run_path(os.path.join(REPO, 'examples',
                                      'voc2007_extract_torch.py'))
    argv = common + ['--dir_outputs', str(tmp_path / 'port'), '--device',
                     'cpu']
    cli['main'](argv)
    out = capsys.readouterr().out
    assert 'Extract features on train set' in out
    assert len(_ap_lines(out)) == 21 and 'mAP: ' in out
    feats = {}
    for split in ('train', 'val'):
        rel = os.path.join('data', 'voc2007_resnet18', f'{split}.npz')
        got = np.load(tmp_path / 'port' / rel)
        want = np.load(tmp_path / 'jax' / rel)
        assert got['features'].shape == (4, 512)
        np.testing.assert_allclose(got['features'], want['features'],
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(got['targets'], want['targets'])
        feats[split] = (got['features'], got['targets'])
    cli['main'](argv)
    again = capsys.readouterr().out
    assert 'Load features from' in again and 'Extract' not in again
    assert _ap_lines(again) == _ap_lines(out)
    jcli = runpy.run_path(os.path.join(REPO, 'examples', 'voc2007_extract.py'))
    features = {s: f for s, (f, _) in feats.items()}
    targets = {s: t for s, (_, t) in feats.items()}
    classes = voc.object_categories
    cli['train_multilabel'](features, targets, classes, 'train', 'val')
    got_lines = _ap_lines(capsys.readouterr().out)
    jcli['train_multilabel'](features, targets, classes, 'train', 'val')
    assert got_lines == _ap_lines(capsys.readouterr().out)


def test_visu_arch_writes_both_pngs(tmp_path, capsys):
    cli = runpy.run_path(os.path.join(REPO, 'examples', 'visu_arch_torch.py'))
    filters, activations = cli['main'](
        ['-a', 'resnet18', '--image', SOURCES[0], '--outdir', str(tmp_path),
         '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'conv1' in out and 'max_pool2d' in out and 'last_linear' in out
    assert 'features: (1, 512, 7, 7); logits: (1, 1000)' in out
    assert Image.open(filters).size == (8 * 8, 8 * 8)     # 64 7x7 filters
    assert Image.open(activations).size == (8 * 8, 8 * 8)


def test_op_shapes_and_flops():
    """The twin of ``tests/test_aux_subsystems.py``'s case: the matmul
    with its output shape; the FLOPs of the product."""
    a, b = torch.ones(64, 128), torch.ones(128, 32)

    def f(a, b):
        return (a @ b).sum()

    assert ('mm', (64, 32)) in profiling.op_shapes(f, a, b)
    assert profiling.flops_estimate(f, a, b) == 2 * 64 * 128 * 32
    conv = torch.nn.Conv2d(3, 4, 3)
    assert profiling.op_shapes(conv, torch.ones(1, 3, 8, 8)) == [
        ('convolution', (1, 4, 6, 6))]


def test_step_timer_and_trace(tmp_path):
    """``trace`` writes the profiler's trace, the program's spans in it as
    ``pretorched.*`` ranges."""
    with profiling.trace(str(tmp_path / 'trace')) as logdir:
        with profiling.span('test.trace'):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(logdir) if f.endswith('.pt.trace.json')]
    assert files
    with open(os.path.join(logdir, files[0])) as f:
        assert '"pretorched.test.trace"' in f.read()
    assert 'test.trace' in profiling.recorded()
    profiling.reset()


@pytest.mark.parametrize('case', ['log', 'log0', 'div0', 'nan_in', 'mul_nan'])
def test_checked_raises_where_jax_checkify_does(case):
    """``checked`` raises where JAX's ``checkify.float_checks`` raises on the
    same function and input (the twin of ``tests/test_aux_subsystems.py``'s
    ``log(-1)`` case), and returns the value where it does not."""
    from pretorched_tpu.utils.debugging import checked as jax_checked
    jlog = jax.numpy.log
    fns = {'log': (jlog, torch.log, [-1.0]),
           'log0': (jlog, torch.log, [0.0, 2.0]),
           'div0': (lambda x: x / 0.0, lambda x: x / 0.0, [1.0]),
           'nan_in': (jlog, torch.log, [float('nan')]),
           'mul_nan': (lambda x: x * np.nan, lambda x: x * float('nan'),
                       [1.0])}
    jfn, fn, x = fns[case]
    try:
        want = np.asarray(jax_checked(lambda a: jfn(a))(
            jax.numpy.asarray(x, np.float32)))
    except Exception:                    # noqa: BLE001 (JAX's error type)
        want = None
    if want is None:
        with pytest.raises(FloatingPointError):
            debugging.checked(fn)(torch.tensor(x))
    else:
        np.testing.assert_array_equal(
            debugging.checked(fn)(torch.tensor(x)).numpy(), want)
    np.testing.assert_array_equal(
        debugging.checked(torch.log)(torch.tensor([1.0, 2.0])).numpy(),
        np.log([1.0, 2.0]).astype(np.float32))


def test_grad_stats_and_assert_finite():
    grads = {'layer1': {'w': torch.ones(2, 2) * 3}, 'fc': {'b': torch.ones(2)}}
    stats = debugging.grad_stats(grads)
    from pretorched_tpu.utils.debugging import grad_stats as jax_grad_stats
    assert stats == jax_grad_stats({k: {n: v.numpy() for n, v in d.items()}
                                    for k, d in grads.items()})
    assert any('layer1' in k for k in stats)
    net = torch.nn.Sequential(torch.nn.Linear(3, 2))
    net(torch.ones(4, 3)).sum().backward()
    assert set(debugging.grad_stats(net)) == {'0.weight', '0.bias'}
    debugging.assert_finite(grads)
    debugging.assert_finite(net)
    with pytest.raises(FloatingPointError):
        debugging.assert_finite({'x': torch.tensor([float('nan')])})


def test_new_modules_import_no_jax():
    """The new modules and both new examples import neither JAX nor the
    JAX package."""
    code = ('import sys, runpy\n'
            'import pretorched_tpu_torch.models.densenet3d\n'
            'import pretorched_tpu_torch.models.multiview\n'
            'import pretorched_tpu_torch.models.soundnet\n'
            'import pretorched_tpu_torch.models.utils\n'
            'import pretorched_tpu_torch.datasets.audio\n'
            'import pretorched_tpu_torch.datasets.voc\n'
            'import pretorched_tpu_torch.utils\n'
            'import pretorched_tpu_torch.__version__ as v\n'
            "assert v.__title__ == 'pretorched_tpu_torch'\n"
            "runpy.run_path('examples/voc2007_extract_torch.py')\n"
            "runpy.run_path('examples/visu_arch_torch.py')\n"
            'bad = sorted(m for m in sys.modules\n'
            "             if m == 'jax' or m.startswith(('jax.', 'flax', \n"
            "                                            'pretorched_tpu.')))\n"
            'assert not bad, bad\n'
            "print('NO-JAX')\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, text=True,
                       capture_output=True, timeout=300)
    assert r.returncode == 0 and 'NO-JAX' in r.stdout, r.stdout + r.stderr
