"""Serving export of the port (``zoo/export.py``) and the kernels' registered
operators (``ops/library.py``), against the JAX package, on the CPU.

The twins of ``tests/test_export.py``: a ``resnet18`` round trip at a fixed
batch of 2 (64 px), ``alexnet`` with a symbolic batch called at B = 1 and
3, and ``squeezenet1_1``'s program text. Each reloaded program's logits are
held to the JAX model's on the same weights at 2e-3 (the whole-net parity
tolerance of ``ROADMAP.md``) and to the port's eager forward at 1e-5 (the
same arithmetic, traced).

The kernels' operators: ``nonlocalresnet3d18`` at 8 frames x 32 px
exported on the CPU records ``pretorched.nonlocal_attention_fwd`` (and no
decomposed softmax), and reloaded in a subprocess that builds no model and
imports no JAX (this slice's modules, tools and CLIs imported there too)
it matches JAX at 2e-3; a reduced-depth SlowFast with ``fused_blocks=32``
records ``pretorched.fused_bottleneck_tail``. Each operator's CPU
implementation equals its plain version exactly, and its fake
implementation gives the output shapes for Cv != C and B > 1.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pretorched_tpu.models.alexnet import AlexNet as JaxAlexNet
from pretorched_tpu.models.nonlocalnet import NonLocalResNet3D as JaxNL
from pretorched_tpu.models.resnet import ResNet as JaxResNet
import pretorched_tpu_torch as pretorched
from pretorched_tpu_torch.models import slowfast
from pretorched_tpu_torch.ops import fused_block as fb
from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
from pretorched_tpu_torch.zoo.export import (export_model,
                                             exported_program_text,
                                             load_exported)

from torch_port_helpers import (jax_variables_from_port, randomize_port_bn,
                                to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTENTION = 'pretorched.nonlocal_attention_fwd'
TAIL = 'pretorched.fused_bottleneck_tail'


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_carried(jmod, model, input_shape, seed=1):
    """``model`` with every BN randomized, its weights as ``jmod``'s
    variables (on a ``jax.eval_shape`` template: no init compiles)."""
    randomize_port_bn(model, seed)
    return jax_variables_from_port(jmod, model.state_dict(), input_shape)


def _eager(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def test_export_roundtrip_fixed_batch(tmp_path):
    x = _x((2, 3, 64, 64))
    jmod = JaxResNet(block='basic', layers=(2, 2, 2, 2), num_classes=10)
    model = pretorched.resnet18(num_classes=10, pretrained=None)
    variables = _jax_carried(jmod, model, (1, 64, 64, 3))
    path = str(tmp_path / 'resnet18.pt2')
    export_model(model, path, (3, 64, 64), batch='2', device='cpu')
    call, params = load_exported(path)
    got = call(params, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jmod.apply)(variables, to_nt(x)))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, _eager(model, x), rtol=1e-5, atol=1e-5)
    # the program's own weights, replaced by name, move its output
    zeroed = dict(params, **{'model.last_linear.bias':
                             params['model.last_linear.bias'] + 1})
    np.testing.assert_allclose(call(zeroed, torch.from_numpy(x)).numpy(),
                               got + 1, rtol=1e-5, atol=1e-5)


def test_export_symbolic_batch(tmp_path):
    jmod = JaxAlexNet(num_classes=7)
    model = pretorched.alexnet(num_classes=7, pretrained=None)
    variables = _jax_carried(jmod, model, (1, 224, 224, 3))
    path = str(tmp_path / 'alexnet.pt2')
    export_model(model, path, (3, 224, 224), batch='b', device='cpu')
    call, params = load_exported(path)
    apply = jax.jit(jmod.apply)
    for b in (1, 3):
        x = _x((b, 3, 224, 224), seed=b)
        got = call(params, torch.from_numpy(x)).numpy()
        assert got.shape == (b, 7)
        np.testing.assert_allclose(got, np.asarray(apply(variables, to_nt(x))),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got, _eager(model, x), rtol=1e-5,
                                   atol=1e-5)


def test_program_text_holds_the_graph():
    """The counterpart of ``stablehlo_text``: the exported graph as text."""
    model = pretorched.squeezenet1_1(num_classes=5, pretrained=None)
    txt = exported_program_text(model, (3, 64, 64), device='cpu')
    assert 'def forward' in txt and 'torch.ops.aten.conv2d' in txt


def test_export_modes(tmp_path):
    """``features`` and ``logits`` export the model's own methods."""
    x = _x((2, 3, 64, 64))
    model = pretorched.resnet18(num_classes=10, pretrained=None).eval()
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x))
    export_model(model, str(tmp_path / 'f.pt2'), (3, 64, 64), batch='2',
                 device='cpu', mode='features')
    call, params = load_exported(str(tmp_path / 'f.pt2'))
    np.testing.assert_allclose(call(params, torch.from_numpy(x)).numpy(),
                               feats.numpy(), rtol=1e-5, atol=1e-5)
    export_model(model, str(tmp_path / 'l.pt2'), tuple(feats.shape[1:]),
                 batch='2', device='cpu', mode='logits')
    call, params = load_exported(str(tmp_path / 'l.pt2'))
    np.testing.assert_allclose(call(params, feats).numpy(), _eager(model, x),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='mode'):
        export_model(model, str(tmp_path / 'm.pt2'), (3, 64, 64),
                     device='cpu', mode='train')


def test_export_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the export would run')
    model = pretorched.resnet18(num_classes=10, pretrained=None)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        export_model(model, 'unused.pt2', (3, 64, 64))


_RELOAD = '''
import runpy, sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
from pretorched_tpu_torch.zoo.export import load_exported
call, params = load_exported({path!r})
# this slice's modules, tools and CLIs import no JAX, flax, optax or the
# JAX package
import pretorched_tpu_torch.zoo.golden, pretorched_tpu_torch.parallel.zero
for script in ('tools/convert_weights_torch.py',
               'tools/port_export_reload.py',
               'examples/imagenet_eval_torch.py',
               'examples/video_eval_torch.py'):
    runpy.run_path({repo!r} + '/' + script)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'flax', 'optax', 'pretorched_tpu'))
assert not bad, bad
np.save({out!r}, call(params, torch.from_numpy(np.load({x!r}))).numpy())
program = torch.export.load({path!r})
ops = [n for m in program.graph_module.modules()
       if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
       if n.target is torch.ops.pretorched.nonlocal_attention_fwd.default]
print('ATTENTION-NODES', len(ops))
'''


def test_nonlocal_export_records_the_operator(tmp_path):
    """The attention is one operator node in the program; reloaded in a
    process that builds no model (and imports no JAX: the modules, tools
    and CLIs of this slice are imported there too), the program matches
    JAX."""
    x = _x((2, 3, 8, 32, 32), seed=1)
    torch.manual_seed(0)
    model = randomize_port_bn(pretorched.nonlocalresnet3d18(
        num_classes=5, pretrained=None)).eval()
    jmod = JaxNL(block='basic', layers=(2, 2, 2, 2), num_classes=5,
                 expansion=1, shortcut_type='A', nonlocal_layers=(0, 2, 3, 0))
    variables = jax_variables_from_port(jmod, model.state_dict(),
                                        (1, 8, 32, 32, 3))
    want = np.asarray(jax.jit(jmod.apply)(variables, to_nt(x)))

    txt = exported_program_text(model, (3, 8, 32, 32), device='cpu',
                                batch='2')
    blocks = sum(1 for m in model.modules()
                 if type(m).__name__ == 'NonLocalBlock')
    assert blocks == 2 and txt.count(ATTENTION) == blocks
    assert 'logsumexp' not in txt and 'softmax' not in txt

    path = str(tmp_path / 'nl.pt2')
    export_model(model, path, (3, 8, 32, 32), batch='2', device='cpu')
    np.save(tmp_path / 'x.npy', x)
    code = _RELOAD.format(repo=REPO, path=path, x=str(tmp_path / 'x.npy'),
                          out=str(tmp_path / 'y.npy'))
    run = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert f'ATTENTION-NODES {blocks}' in run.stdout
    got = np.load(tmp_path / 'y.npy')
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, _eager(model, x), rtol=1e-5, atol=1e-5)
    # the attention reaches the logits: the W.1 scales zeroed move them
    with torch.no_grad():
        for m in model.modules():
            if type(m).__name__ == 'NonLocalBlock':
                m.W[1].weight.zero_()
    assert np.abs(_eager(model, x) - got).max() > 1e-3


def test_fused_slowfast_export_records_the_tail(tmp_path):
    """A reduced-depth SlowFast (layers (1, 2, 2, 1), fused_blocks=32):
    the tails of fast res2.0, res3.1 and res4.1 are operator nodes."""
    x = _x((1, 3, 16, 32, 32), seed=2)
    torch.manual_seed(0)
    model = randomize_port_bn(slowfast.SlowFast(
        layers=(1, 2, 2, 1), num_classes=5, fused_blocks=32)).eval()
    fused = sum(1 for m in model.modules()
                if isinstance(m, slowfast.Bottleneck) and m.fuse)
    txt = exported_program_text(model, (3, 16, 32, 32), device='cpu')
    assert fused == 3 and txt.count(TAIL) == fused
    path = str(tmp_path / 'sf.pt2')
    export_model(model, path, (3, 16, 32, 32), device='cpu')
    call, params = load_exported(path)
    got = call(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _eager(model, x), rtol=1e-5, atol=1e-5)
    model.fused_blocks = 0
    np.testing.assert_allclose(got, _eager(model, x), rtol=1e-4, atol=1e-4)


def test_operators_on_the_cpu_are_the_plain_versions():
    rng = np.random.RandomState(3)
    q, k = (torch.from_numpy(rng.randn(3, 40, 16).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.randn(3, 40, 24).astype(np.float32))
    out, lse = torch.ops.pretorched.nonlocal_attention_fwd(q, k, v, 0.5)
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(q, k, v, 0.5)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def affine(c):
        return torch.stack([t(c).abs() + 0.5, t(c) * 0.1])

    args = (t(2, 8, 3, 5, 5), t(2, 16, 3, 5, 5), t(8, 8, 3, 3), affine(8),
            t(32, 8), affine(32), t(32, 16), affine(32))
    with torch.no_grad():
        got = torch.ops.pretorched.fused_bottleneck_tail(*args)
        assert torch.equal(got, fb.fused_bottleneck_tail_reference(*args))
        assert torch.equal(fb.fused_bottleneck_tail(*args), got)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fake_implementations_give_the_output_shapes(dtype):
    """out sized by Cv, not C, and lse with one row per query of every
    batch; the tail's output by w3's rows."""
    with FakeTensorMode():
        q = torch.empty(3, 50, 16, dtype=dtype)
        k = torch.empty(3, 20, 16, dtype=dtype)
        v = torch.empty(3, 20, 40, dtype=dtype)
        out, lse = torch.ops.pretorched.nonlocal_attention_fwd(q, k, v, 1.0)
        assert (out.shape, out.dtype) == ((3, 50, 40), dtype)
        assert (lse.shape, lse.dtype) == ((3, 50), torch.float32)
        tail = torch.ops.pretorched.fused_bottleneck_tail(
            torch.empty(2, 8, 3, 5, 5, dtype=dtype),
            torch.empty(2, 32, 3, 5, 5, dtype=dtype), torch.empty(8, 8, 3, 3),
            torch.empty(2, 8), torch.empty(32, 8), torch.empty(2, 32), None,
            None)
        assert (tail.shape, tail.dtype) == ((2, 32, 3, 5, 5), dtype)


def test_operators_have_no_decomposition():
    """Nothing but the CPU and CUDA kernels (and the fake one) runs them:
    no composite or autograd kernel that could decompose them."""
    for name in ('pretorched::nonlocal_attention_fwd',
                 'pretorched::fused_bottleneck_tail'):
        for key in ('CompositeImplicitAutograd', 'CompositeExplicitAutograd',
                    'Autograd'):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(name,
                                                                      key)
        for key in ('CPU', 'CUDA', 'Meta'):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key)
