#!/usr/bin/env python
"""Architecture introspection demo on the PyTorch port.

The twin of ``examples/visu_arch.py`` (reference: examples/visu_arch.py):
one forward of an image on ``--device`` prints the output shape of every
conv and linear module (forward hooks, as the reference's
visu_arch.py:75-92) and of every pooling op (the port pools through
``torch.nn.functional``, so those are caught by
``utils.profiling.op_shapes``), then the features' and logits' shapes;
it writes the first 4-D conv weight, averaged over its input channels,
to ``filters.png`` and the first 64 feature maps to ``activations.png``.

Usage:
    python examples/visu_arch_torch.py -a resnet18 --image data/cat.jpg
    python examples/visu_arch_torch.py -a resnet18 --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the ATen names of the pools (without autograd, a max pool stays
# ``max_pool2d``; with it, it becomes ``max_pool2d_with_indices``)
POOL_OPS = ('max_pool2d', 'max_pool3d', 'max_pool2d_with_indices',
            'max_pool3d_with_indices', 'avg_pool2d', 'avg_pool3d',
            'adaptive_avg_pool2d', '_adaptive_avg_pool2d',
            'adaptive_max_pool2d', 'mean')


def save_grid(arr, path, pad=1):
    """(n, h, w) maps, each scaled to [0, 1], tiled in a square grid."""
    from PIL import Image

    n, h, w = arr.shape[:3]
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * (h + pad), cols * (w + pad)), np.float32)
    for i in range(n):
        r, c = divmod(i, cols)
        a = arr[i]
        a = (a - a.min()) / max(a.max() - a.min(), 1e-6)
        grid[r*(h+pad):r*(h+pad)+h, c*(w+pad):c*(w+pad)+w] = a
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)


def main(argv=None):
    """Prints the shapes and writes both PNGs; returns their paths."""
    p = argparse.ArgumentParser(description='architecture introspection')
    p.add_argument('--arch', '-a', default='resnet18')
    p.add_argument('--image', default='data/cat.jpg')
    p.add_argument('--outdir', default=os.path.join(tempfile.gettempdir(),
                                                    'visu'))
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --device cpu to run '
                           'on the CPU')

    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.transforms import LoadImage, TransformImage
    from pretorched_tpu_torch.utils.profiling import op_shapes

    model = pretorched.__dict__[args.arch](num_classes=1000, pretrained=None)
    model.to(device).eval()
    x = TransformImage(model.metadata)(LoadImage()(args.image))[None]
    x = x.to(device)

    rows = []
    kinds = (torch.nn.modules.conv._ConvNd, torch.nn.Linear,
             torch.nn.modules.pooling._MaxPoolNd,
             torch.nn.modules.pooling._AvgPoolNd)
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: rows.append(
            (name, type(m).__name__, tuple(o.shape))))
        for name, m in model.named_modules() if isinstance(m, kinds)]
    with torch.inference_mode():
        try:
            pools = op_shapes(model, x, ops=POOL_OPS)
        finally:
            for h in hooks:
                h.remove()
        feats = model.features(x).float().cpu().numpy()
        logits = model(x)
    print(f'== {args.arch}: conv, linear and pooling output shapes ==')
    for name, kind, shape in rows:
        print(f'{name:32s} {kind:12s} -> {list(shape)}')
    for op, shape in pools:
        print(f'{"(functional)":32s} {op:12s} -> {list(shape)}')
    print(f'features: {feats.shape}; logits: {tuple(logits.shape)}')

    os.makedirs(args.outdir, exist_ok=True)
    filters = os.path.join(args.outdir, 'filters.png')
    first = next(((n, w) for n, w in model.state_dict().items()
                  if n.endswith('weight') and w.dim() == 4), None)
    if first:
        name, w = first
        save_grid(w.float().mean(1).cpu().numpy(), filters)
        print(f'saved first-layer filters ({name}) to {filters}')
    activations = os.path.join(args.outdir, 'activations.png')
    save_grid(feats[0][:64], activations)
    print(f'saved feature activations to {activations}')
    return filters, activations


if __name__ == '__main__':
    main()
