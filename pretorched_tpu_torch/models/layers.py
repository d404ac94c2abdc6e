"""Leaf layers and the seeded init rules of the port.

Counterpart of ``pretorched_tpu/models/layers.py``. Layers are plain
``torch.nn`` modules in channels-first layout; what this file adds is the
init rules, applied from an explicit ``torch.Generator`` so that a factory
build is reproducible from its seed:

* ``kaiming_normal_out``: normal with std ``sqrt(2 / fan_out)`` (the JAX
  package's ``variance_scaling(2.0, 'fan_out', 'normal')``, layers.py:43),
  used by the ResNet convs (resnet3D.py:195-201);
* ``torch_conv_init``: the JAX package's conv and dense init,
  ``variance_scaling(1/3, 'fan_in', 'uniform')`` (layers.py:39-43, 111),
  which is uniform in ``+-1/sqrt(fan_in)``, with a zero bias as flax's;
  used by the layers ``conv2d`` and ``linear`` make (the 2D ResNet);
* everything else gets torch's own default: weight and bias uniform in
  ``+-1/sqrt(fan_in)`` for convs and linears, BN scale 1 and shift 0.

``BatchNorm`` is the port's batch norm: torch's, except that its train-mode
update of ``running_var`` uses the biased batch variance, as flax does.

``SpaceToDepthConv`` is the stride-(.,2,2) stem conv evaluated through the
exact space-to-depth fold of ``ops/space_to_depth.py``: it stores the plain
torch-shaped ``weight`` and folds it at every call.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import space_to_depth as s2d

_CONV_TYPES = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
# per thread: the recompute runs on the autograd engine's thread
_bn_state = threading.local()


@contextlib.contextmanager
def frozen_bn_stats():
    """Within (on this thread): train-mode ``BatchNorm`` normalizes with the
    batch statistics but leaves its running statistics alone.
    ``torch.utils.checkpoint``'s recompute runs under this, so a
    rematerialized block updates them once, in its forward, as flax's
    ``nn.remat`` does."""
    depth = getattr(_bn_state, 'frozen', 0)
    _bn_state.frozen = depth + 1
    try:
        yield
    finally:
        _bn_state.frozen = depth


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Batch norm over dim 1 of an (N, C, ...) input, with the state-dict
    keys and eval behaviour of ``nn.BatchNorm1d/2d/3d``. In train mode the
    running variance moves toward the BIASED batch variance, as flax's
    ``nn.BatchNorm`` (``pretorched_tpu/models/layers.py:91-108``) and not as
    torch's, which uses the unbiased one (they differ by n / (n - 1)).

    With a ``process_group`` (``set_bn_group``; the data-parallel train
    step sets it), train mode normalizes over the batch of every rank of
    the group, as the JAX package's sharded step does over its global
    batch: per-channel sum, sum of squares and count, all-reduced with a
    differentiable all-reduce, the variance as flax computes it
    (``E[x^2] - E[x]^2``). The same code runs on the CPU and the card
    (``nn.SyncBatchNorm`` takes CUDA tensors only)."""

    process_group = None

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'expected an (N, C, ...) input, got {x.dim()}D')

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.process_group is not None:
            y, mean, var = self._cross_rank(x)
        else:
            # one pass: the output and the batch mean and 1 / sqrt(var + eps)
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = None
        if not getattr(_bn_state, 'frozen', 0):
            with torch.no_grad():
                dt = self.running_var.dtype
                if var is None:
                    var = invstd.to(dt).pow(-2) - self.eps
                self.running_mean.lerp_(mean.to(dt), self.momentum)
                self.running_var.lerp_(var.to(dt), self.momentum)
                self.num_batches_tracked.add_(1)
        return y

    def _cross_rank(self, x):
        """(y, mean, biased var) over the batches of every rank of
        ``process_group``, in f32."""
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        with torch.autocast(x.device.type, enabled=False):
            xf = x.float()
            stats = torch.cat([xf.sum(dims), xf.square().sum(dims),
                               xf.new_full((1,), x.numel() // c)])
            stats = all_reduce(stats, group=self.process_group)
            mean = stats[:c] / stats[-1]
            var = (stats[c:2 * c] / stats[-1] - mean.square()).clamp(min=0)
            scale = torch.rsqrt(var + self.eps)
            shift = -mean * scale
            if self.affine:
                scale = scale * self.weight.float()
                shift = shift * self.weight.float() + self.bias.float()
            y = xf * scale.reshape(shape) + shift.reshape(shape)
        return y.to(x.dtype), mean.detach(), var.detach()


def set_bn_group(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` normalizes in train mode over the
    ranks of ``group`` (None: over its own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group


def batch_norm(channels: int, eps: float = 1e-5, momentum: float = 0.1,
               affine: bool = True):
    return BatchNorm(channels, eps=eps, momentum=momentum, affine=affine)


class Identity(nn.Module):
    """No-op module, for the ``last_linear = Identity()`` feature-extraction
    trick (reference: models/utils.py:81-87, voc2007_extract.py:147)."""

    def forward(self, x):
        return x


def register_features(model: nn.Module, module: nn.Module) -> None:
    """Register ``module`` as ``model``'s submodule ``features`` (the
    torchvision key prefix ``features.``) without hiding the model's
    ``features()`` method, which attribute lookup finds first."""
    model._modules['features'] = module


def conv3d_kaiming_out(in_ch, out_ch, kernel_size, stride=1, padding=0,
                       groups=1):
    """Bias-free Conv3d that ``init_parameters`` fills kaiming-normal fan_out."""
    conv = nn.Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding, groups=groups, bias=False)
    conv.kaiming_normal_out = True
    return conv


class SpaceToDepthConv(nn.Module):
    """Bias-free stride-(1, 2, 2) (``ndim=3``) or stride-2 (``ndim=2``) stem
    conv with padding k // 2, evaluated through the exact space-to-depth
    fold (``ops/space_to_depth.py``). The stored ``weight`` keeps the plain
    conv's shape ``(O, C, [kt,] k, k)``, so checkpoints stay interchangeable
    with the plain stem; the fold is a re-indexing done at every call.

    The rules of ``pretorched_tpu/models/layers.py:126-205``:
    * ``fold=4`` (``ndim=3``, spatial kernel 7, H and W multiples of 4): a
      4x4 space-to-depth of the input, the output computed in its 2x2 parity
      layout (4 O channels) and put back by ``depth_to_space_2``;
    * otherwise fold 2: a stride-1 conv over 4 C channels;
    * an odd padded size cannot be tiled by 2x2 cells: the plain strided
      conv on the same weight runs instead.

    Under autocast the input is cast to the autocast dtype before it is
    folded, as the JAX module casts it to its compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=7,
                 ndim: int = 3, fold: int = 2):
        super().__init__()
        ks = ((kernel_size,) * ndim if isinstance(kernel_size, int)
              else tuple(kernel_size))
        if ndim not in (2, 3) or len(ks) != ndim:
            raise ValueError(f'kernel {ks} for ndim={ndim}')
        if ks[-2] != ks[-1] or ks[-1] % 2 == 0:
            raise ValueError('space-to-depth folding needs a square odd '
                             f'spatial kernel, got {ks}')
        if fold not in (2, 4):
            raise ValueError(f'fold must be 2 or 4, got {fold}')
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.ndim, self.fold = ks, ndim, fold
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *ks))
        # torch's conv default until ``init_parameters`` (kaiming-normal
        # fan-out, the JAX module's init) runs
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.kaiming_normal_out = True

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, '
                f'kernel_size={self.kernel_size}, fold={self.fold}')

    def forward(self, x):
        if torch.is_autocast_enabled(x.device.type):
            x = x.to(torch.get_autocast_dtype(x.device.type))
        k = self.kernel_size[-1]
        h, w = x.shape[-2:]
        conv = F.conv3d if self.ndim == 3 else F.conv2d
        tpad = (self.kernel_size[0] // 2,) if self.ndim == 3 else ()
        if (self.fold == 4 and self.ndim == 3 and k == 7 and h % 4 == 0
                and w % 4 == 0):
            y = conv(s2d.space_to_depth_4(x),
                     s2d.fold4_stem_kernel_3d(self.weight),
                     padding=tpad + (0, 0))
            return s2d.depth_to_space_2(y)
        lpad, rpad = k // 2 + 1, k // 2 - 1
        if (h + lpad + rpad) % 2 or (w + lpad + rpad) % 2:
            return conv(x, self.weight, stride=(1,) * len(tpad) + (2, 2),
                        padding=tpad + (k // 2, k // 2))
        return conv(s2d.space_to_depth_2d(x, lpad, rpad),
                    s2d.fold_stem_kernel_3d(self.weight) if self.ndim == 3
                    else s2d.fold_stem_kernel_2d(self.weight),
                    padding=tpad + (0, 0))


def conv2d(in_ch, out_ch, kernel_size, stride=1, padding=0, bias=False,
           groups=1):
    """Conv2d that ``init_parameters`` fills with ``torch_conv_init``."""
    conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding, bias=bias, groups=groups)
    conv.jax_init = True
    return conv


class BasicConv2d(nn.Module):
    """Bias-free conv -> BN -> ReLU under the keys ``conv`` and ``bn``: the
    ``BasicConv2d`` of the Inception nets and PolyNet (BN eps 1e-3 in the
    TF ports, torch's 1e-5 in PolyNet; PolyNet's block outputs skip the
    ReLU, ``relu=False``)."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0,
                 eps=1e-3, relu=True):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel_size, stride, padding)
        self.bn = batch_norm(cout, eps=eps)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def conv_seq(cin, specs, eps=1e-3):
    """A Sequential of ``BasicConv2d`` from (cout, kernel, stride, padding)
    rows, each on the one before."""
    layers = []
    for cout, k, stride, padding in specs:
        layers.append(BasicConv2d(cin, cout, k, stride, padding, eps=eps))
        cin = cout
    return nn.Sequential(*layers)


class Concat(nn.Module):
    """Its branches on one input, concatenated along the channels, and a
    3x3/2 max pool of the input last with ``pool``. The branches keep the
    hosted files' keys, ``{prefix}0``, ``{prefix}1``, ... (the Inception
    nets' ``branch``, PolyNet's ``path``)."""

    def __init__(self, *branches, prefix='branch', pool=False):
        super().__init__()
        self.names = [f'{prefix}{i}' for i in range(len(branches))]
        for name, branch in zip(self.names, branches):
            setattr(self, name, branch)
        self.pool = pool

    def forward(self, x):
        outs = [getattr(self, name)(x) for name in self.names]
        if self.pool:
            outs.append(F.max_pool2d(x, 3, 2))
        return torch.cat(outs, dim=1)


def linear(in_features, out_features):
    """Linear that ``init_parameters`` fills with ``torch_conv_init``."""
    layer = nn.Linear(in_features, out_features)
    layer.jax_init = True
    return layer


def _fans(weight):
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def kaiming_normal_out(weight, generator):
    _, fan_out = _fans(weight)
    weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def _uniform_fan_in(weight, generator) -> float:
    """Fill ``weight`` uniform in +-1/sqrt(fan_in); returns the bound."""
    fan_in, _ = _fans(weight)
    bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.0
    weight.uniform_(-bound, bound, generator=generator)
    return bound


def torch_conv_init(weight, bias, generator):
    """The JAX package's ``torch_conv_init``: ``variance_scaling(1/3,
    'fan_in', 'uniform')``, i.e. uniform in +-sqrt(3 * (1/3) / fan_in); the
    bias is zero, as flax's ``nn.Conv`` and ``nn.Dense`` start it."""
    _uniform_fan_in(weight, generator)
    if bias is not None:
        bias.zero_()


def torch_default_init(weight, bias, generator):
    """torch's ``reset_parameters`` for conv/linear: kaiming_uniform(a=sqrt(5))
    is uniform in +-1/sqrt(fan_in), and so is the bias."""
    bound = _uniform_fan_in(weight, generator)
    if bias is not None:
        bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every parameter of ``module`` from ``generator``, in
    module registration order. A layer tagged ``zero_init`` starts at zero
    scale: the non-local block's output BN (or its output conv when it has
    no BN), so that a fresh block is the identity (nonlocalnet.py:115-124)."""
    for m in module.modules():
        if isinstance(m, _CONV_TYPES) and getattr(m, 'zero_init', False):
            m.weight.zero_()
            if m.bias is not None:
                m.bias.zero_()
        elif (isinstance(m, _CONV_TYPES + (SpaceToDepthConv,))
              and getattr(m, 'kaiming_normal_out', False)):
            kaiming_normal_out(m.weight, generator)
            if getattr(m, 'bias', None) is not None:
                m.bias.zero_()
        elif isinstance(m, _CONV_TYPES + (nn.Linear,)):
            init = (torch_conv_init if getattr(m, 'jax_init', False)
                    else torch_default_init)
            init(m.weight, m.bias, generator)
        elif getattr(m, 'jax_init', False):     # MultiViewConv's own weight
            torch_conv_init(m.weight, m.bias, generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
            if m.affine:
                m.weight.fill_(0.0 if getattr(m, 'zero_init', False) else 1.0)
                m.bias.zero_()
