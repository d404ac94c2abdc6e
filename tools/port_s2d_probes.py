#!/usr/bin/env python3
"""Probes behind the checks of the port's space-to-depth stems, on one CUDA
card (``pretorched_tpu_torch``; no JAX).

    python3 tools/port_s2d_probes.py f32
    python3 tools/port_s2d_probes.py train CHECKOUT LABEL

* ``f32`` (this checkout's port): with TF32 off, the f32 output of each
  folded stem against the plain stem on the same weights, and the logits
  of the two models:
  ``r2plus1d50`` from its factory (20 clips x 16 x 112), then SlowFast-R50
  and a non-local ResNet3D-50 built from their classes, so with torch's
  default init (4 clips x 64 and x 32 frames x 224 px), the latter also
  with every ``W.1`` zeroed (the attention off).
* ``train``: the port found under ``CHECKOUT`` (a checkout's root, put
  first on ``sys.path``), ``nonlocalresnet3d50`` with every BN randomized,
  22 bf16 train steps of 8 synthetic clips x 32 x 224 px at ``remat=(0,)``
  (the median of steps 3-22 by CUDA events) and the median of 7 bf16 eval
  forwards of 20 clips; one line tagged ``LABEL``. Run it in turns on two
  checkouts (parent, change, change, parent) inside one call to compare
  them.

It exits nonzero without CUDA. Every line of ``f32`` is a rel L2.
"""

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def randomize_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)


def rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def twin(plain, folded):
    """``folded`` with ``plain``'s weights, both on the card in eval."""
    folded.load_state_dict(plain.state_dict())
    return plain.cuda().eval(), folded.cuda().eval()


def f32():
    sys.path.insert(0, str(REPO))
    import pretorched_tpu_torch as pt
    from pretorched_tpu_torch.models import nonlocalnet, slowfast
    from pretorched_tpu_torch.models.resnet3d import VideoResNet

    g = torch.Generator(device='cuda').manual_seed(0)
    with torch.inference_mode():
        m = pt.r2plus1d50(num_classes=400, pretrained=None)
        randomize_bn(m, 1)
        m, f = twin(m, VideoResNet('bottleneck', (3, 4, 6, 3),
                                   num_classes=400, factored=True,
                                   s2d_stem=True))
        x = torch.randn(20, 3, 16, 112, 112, device='cuda', generator=g)
        print('r2p1d stem', rel(f.conv1.spatial_conv(x),
                                m.conv1.spatial_conv(x)),
              'logits', rel(f(x), m(x)))
        del m, f
        m = slowfast.SlowFast(num_classes=400)
        randomize_bn(m, 1)
        m, f = twin(m, slowfast.SlowFast(num_classes=400, s2d_stem=True))
        x = torch.randn(4, 3, 64, 224, 224, device='cuda', generator=g)
        print('sf fast stem', rel(f.fast.conv1(x[:, :, ::2]),
                                  m.fast.conv1(x[:, :, ::2])),
              'slow stem', rel(f.slow.conv1(x[:, :, ::16]),
                               m.slow.conv1(x[:, :, ::16])),
              'logits', rel(f(x), m(x)))
        del m, f
        m = nonlocalnet.NonLocalResNet3D('bottleneck', (3, 4, 6, 3),
                                         num_classes=400)
        randomize_bn(m, 1)
        m, f = twin(m, nonlocalnet.NonLocalResNet3D(
            'bottleneck', (3, 4, 6, 3), num_classes=400, s2d_stem=True))
        x = torch.randn(4, 3, 32, 224, 224, device='cuda', generator=g)
        print('nl stem', rel(f.conv1(x), m.conv1(x)),
              'logits', rel(f(x), m(x)))
        for mod in (m, f):
            for b in mod.modules():
                if isinstance(b, nonlocalnet.NonLocalBlock):
                    b.W[1].weight.zero_()
        print('nl logits with W.1 zeroed', rel(f(x), m(x)))


def train(checkout, label):
    sys.path.insert(0, checkout)
    import pretorched_tpu_torch as pt
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay)

    model = pt.nonlocalresnet3d50(num_classes=400, pretrained=None)
    randomize_bn(model, 1)
    model.cuda().bfloat16()
    g = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn(8, 3, 32, 224, 224, device='cuda', generator=g)
    labels = torch.arange(8, device='cuda') % 2
    opt, sched = sgd_step_decay(model.parameters(), lr=1e-3, momentum=0.9,
                                weight_decay=1e-4)
    step = make_train_step(model, opt, sched, remat=(0,))
    dev = []
    for _ in range(22):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        step(x, labels)
        e1.record()
        torch.cuda.synchronize()
        dev.append(e0.elapsed_time(e1))
    d = sorted(dev[2:])
    model.eval()
    xe = torch.randn(20, 3, 32, 224, 224, device='cuda', generator=g)
    with torch.inference_mode():
        model(xe)
        torch.cuda.synchronize()
        ev = []
        for _ in range(7):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            model(xe)
            e1.record()
            torch.cuda.synchronize()
            ev.append(e0.elapsed_time(e1))
    print(f'{label}: train step median {d[len(d) // 2]:.2f} ms (steps 3-22 '
          f'{d[0]:.2f}-{d[-1]:.2f}), eval forward median '
          f'{sorted(ev)[3]:.3f} ms', flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print('port_s2d_probes: needs a CUDA card', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    if argv[:1] == ['f32']:
        f32()
    elif argv[:1] == ['train'] and len(argv) == 3:
        train(argv[1], argv[2])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
