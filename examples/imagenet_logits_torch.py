#!/usr/bin/env python
"""Single-image ImageNet prediction CLI on the PyTorch port.

The twin of ``examples/imagenet_logits.py``: load a model from the factory
registry, derive the preprocessing from its metadata (``TransformImage``,
the PIL path), run it on one image and print the argmax class (the
reference's "cat.jpg -> 'tiger cat'" check, README.md:188-191, which needs
the hosted weights).

Usage:
    python examples/imagenet_logits_torch.py data/cat.jpg -a resnet50
    python examples/imagenet_logits_torch.py data/cat.jpg -a resnet18 \
        --pretrained none --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import torch  # noqa: E402


def main(argv=None):
    """Prints the prediction; returns (class index, class name, logit)."""
    parser = argparse.ArgumentParser(
        description='ImageNet single-image logits (PyTorch)')
    parser.add_argument('path_img', help='path to an image')
    parser.add_argument('--arch', '-a', default='resnet18',
                        help='model architecture name')
    parser.add_argument('--pretrained', default='imagenet',
                        help="pretrained dataset tag, or 'none'")
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --device cpu to run '
                           'on the CPU')

    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.datasets.utils import load_imagenet_classes
    from pretorched_tpu_torch.transforms import LoadImage, TransformImage

    pretrained = (None if args.pretrained in ('none', 'None', '')
                  else args.pretrained)
    print(f"=> creating model '{args.arch}' (pretrained={pretrained})")
    model = pretorched.__dict__[args.arch](num_classes=1000,
                                           pretrained=pretrained)
    model.to(device).eval()

    # the loaded dataset's settings, else the factory's default dataset's
    # (dpn68b has only 'imagenet+5k'; vggm is not in pretrained_settings)
    settings = model.metadata
    x = TransformImage(settings)(LoadImage()(args.path_img))[None]
    with torch.inference_mode():
        logits = model(x.to(device))[0].float().cpu()
    idx = int(logits.argmax())

    data_dir = os.path.join(os.path.dirname(__file__), '..', 'data')
    classes = load_imagenet_classes(
        os.path.join(data_dir, 'imagenet_synsets.txt'),
        os.path.join(data_dir, 'imagenet_classes.txt'))
    print(f"'{args.arch}': '{args.path_img}' is a '{classes[idx]}' "
          f'(class {idx}, logit {logits[idx]:.3f}) on {device}')
    return idx, classes[idx], float(logits[idx])


if __name__ == '__main__':
    main()
