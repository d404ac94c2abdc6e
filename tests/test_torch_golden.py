"""The port's golden-accuracy workflow (``zoo/golden.py``,
``tools/convert_weights_torch.py``) against the JAX package's, on the CPU.

The twins of ``tests/test_golden_workflow.py``: ``parse_baseline`` equals
the JAX table exactly; one fabricated hosted ``resnet18`` file (random
weights, every BN randomized, torchvision's keys) and a 2 x 2-image val
folder go through both tools, whose top-1 and top-5 counts must be equal
(the two forwards agree to ~1e-5 of a logit; the counts are integers); the
PASS / FAIL verdicts of ``accuracy_row``, the tool's exit code 1 on a FAIL,
and a video model's fixed-seed-clip golden logits.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from pretorched_tpu.zoo import golden as jax_golden
import pretorched_tpu_torch as pretorched
from pretorched_tpu_torch.zoo import golden

from torch_port_helpers import randomize_port_bn
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAT = os.path.join(REPO, 'data', 'cat.jpg')
ROW = re.compile(r'^\* resnet18/imagenet: Acc@1 ([\d.]+) .*Acc@5 ([\d.]+) '
                 r'.*\(n=(\d+)\) (PASS|FAIL)$', re.M)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fabricate_hosted(model, name, tag, weights_dir, renames=()):
    """``model``'s weights as the hosted file of (name, tag): its
    checkpoint keys (``renames``: port prefix -> file prefix), no BN
    batch counters."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith('num_batches_tracked'):
            continue
        for ours, theirs in renames:
            if k.startswith(ours + '.'):
                k = theirs + k[len(ours):]
        sd[k] = v
    url = pretorched.pretrained_settings[name][tag]['url']
    weights_dir.mkdir(parents=True, exist_ok=True)
    torch.save(sd, weights_dir / url.rsplit('/', 1)[-1])


def _fabricate_val_folder(valdir, n_classes=2, per_class=2):
    rng = np.random.RandomState(1)
    for c in range(n_classes):
        cdir = valdir / f'n{c:08d}'
        cdir.mkdir(parents=True)
        for i in range(per_class):
            arr = rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(cdir / f'img_{i}.jpg')


def test_parse_baseline_equals_jax():
    table = golden.parse_baseline()
    assert table == jax_golden.parse_baseline()
    assert table['resnet18'] == (70.142, 89.274)
    assert table['dpn68b'] == (77.034, 93.590)
    assert len(table) >= 40


@pytest.mark.parametrize('display', [
    'SE-ResNeXt50_32x4d', 'DualPathNet68b_5k', 'NASNet-A-Large', 'ResNet152',
    'InceptionV4', 'nonexistent-net'])
def test_display_to_registry_equals_jax(display):
    assert golden.display_to_registry(display) == \
        jax_golden.display_to_registry(display)


def test_golden_workflow_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path / 'zoo'))
    monkeypatch.delenv('PRETORCHED_STRICT_WEIGHTS', raising=False)
    torch.manual_seed(0)
    donor = randomize_port_bn(pretorched.resnet18(num_classes=1000,
                                                  pretrained=None))
    _fabricate_hosted(donor, 'resnet18', 'imagenet', tmp_path / 'zoo' /
                      'weights', renames=(('last_linear', 'fc'),))
    _fabricate_val_folder(tmp_path / 'val')
    argv = ['--eval', str(tmp_path / 'val'), '--limit', '4', '-b', '2',
            '--image', CAT, 'resnet18']

    rc = _load_tool('convert_weights_torch').main(
        argv + ['--device', 'cpu', '--golden-dir', str(tmp_path / 'g')])
    out = capsys.readouterr().out
    assert 'PRETORCHED_STRICT_WEIGHTS' not in os.environ
    assert 'resnet18/imagenet: loaded' in out
    assert 'accuracy vs BASELINE.md' in out and 'images/s' in out
    golden_logits = np.load(tmp_path / 'g' / 'resnet18-imagenet.npy')
    assert golden_logits.shape == (1000,) and np.isfinite(golden_logits).all()
    got = ROW.search(out)
    assert got and 'ref 70.142' in got.group(0) and got.group(3) == '4'
    # random weights are not within 0.1% of the published number
    assert got.group(4) == 'FAIL' and rc == 1

    rc_jax = _load_tool('convert_weights').main(
        argv + ['--golden-dir', str(tmp_path / 'gj')])
    want = ROW.search(capsys.readouterr().out)
    assert rc_jax == 1 and want
    assert got.groups() == want.groups()
    np.testing.assert_allclose(
        golden_logits, np.load(tmp_path / 'gj' / 'resnet18-imagenet.npy'),
        rtol=2e-3, atol=2e-3)


def test_golden_workflow_pass_verdict():
    base = {'resnet18': (70.142, 89.274)}
    for args in (('resnet18', 'imagenet', 70.10, 89.30, 50000, base),
                 ('resnet18', 'imagenet', 69.0, 89.27, 50000, base),
                 ('mysterynet', 'imagenet', 50.0, 70.0, 10, {})):
        assert golden.accuracy_row(*args) == jax_golden.accuracy_row(*args)
    assert golden.accuracy_row(
        'resnet18', 'imagenet', 70.10, 89.30, 50000, base).endswith('PASS')
    assert golden.accuracy_row(
        'resnet18', 'imagenet', 69.0, 89.27, 50000, base).endswith('FAIL')
    assert 'no published baseline' in golden.accuracy_row(
        'mysterynet', 'imagenet', 50.0, 70.0, 10, {})


def test_golden_workflow_video_model(tmp_path, monkeypatch, capsys):
    """A video checkpoint takes the fixed-seed-clip path (16 frames at the
    settings' size, shrunk here to 64 px), not the cat.jpg one."""
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path / 'zoo'))
    settings = pretorched.pretrained_settings['resnet3d18']['kinetics-400']
    monkeypatch.setitem(settings, 'input_size', [3, 64, 64])
    torch.manual_seed(0)
    donor = randomize_port_bn(pretorched.resnet3d18(num_classes=400,
                                                    pretrained=None)).eval()
    _fabricate_hosted(donor, 'resnet3d18', 'kinetics-400',
                      tmp_path / 'zoo' / 'weights',
                      renames=(('last_linear', 'fc'),))
    rc = _load_tool('convert_weights_torch').main(
        ['--golden-dir', str(tmp_path / 'g'), '--image', CAT, '--device',
         'cpu', 'resnet3d18'])
    out = capsys.readouterr().out
    assert 'fixed-seed video golden logits saved' in out, out
    assert rc == 0
    clip = np.random.RandomState(0).rand(1, 3, 16, 64, 64).astype(np.float32)
    with torch.no_grad():
        want = donor(torch.from_numpy(clip)).numpy()[0]
    np.testing.assert_allclose(
        np.load(tmp_path / 'g' / 'resnet3d18-kinetics-400.npy'), want,
        rtol=1e-5, atol=1e-5)

