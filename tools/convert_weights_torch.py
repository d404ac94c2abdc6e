#!/usr/bin/env python
"""Golden-logit capture and accuracy check for the PyTorch port.

Counterpart of ``tools/convert_weights.py``. For every hosted ``.pth``
present in the weight cache (``$PRETORCHED_HOME/weights``) this tool:

1. builds the matching model with ``pretrained=<tag>`` (the port loads the
   ``.pth`` itself; there is no converted cache to write);
2. runs data/cat.jpg through the model's own metadata-derived transform
   (a video model: a fixed-seed clip; an audio model: a fixed-seed
   waveform);
3. stores the logits to ``<golden-dir>/<name>-<tag>.npy``;
4. with ``--eval VALDIR``: evaluates ImageNet center-crop accuracy on the
   folder (``zoo.golden.evaluate_imagenet``) and prints measured vs
   published (BASELINE.md) Acc@1 / Acc@5 with PASS / FAIL at
   |delta| <= --tol, and the images/s of the evaluation. It returns 1 when
   any row fails.

Usage:
    python tools/convert_weights_torch.py                  # every model
    python tools/convert_weights_torch.py resnet50 alexnet # these models
    python tools/convert_weights_torch.py --eval /data/imagenet/val \\
        --limit 5000 resnet50                              # accuracy
    ... --device cpu                                       # no card

Missing weights are an error for the tool's own run
(``PRETORCHED_STRICT_WEIGHTS``, restored on exit).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402

# reference-documented per-model eval protocol deviations (BASELINE.md
# "Measurement caveats": polynet resizes square 378 -> 331 center crop,
# README.md:276; xception's 0.8975 scale comes from its own settings)
EVAL_OVERRIDES = {
    'polynet': {'preserve_aspect_ratio': False},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('models', nargs='*', help='model names (default: all)')
    ap.add_argument('--golden-dir', default='golden')
    ap.add_argument('--image', default='data/cat.jpg')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    ap.add_argument('--eval', dest='valdir', default=None, metavar='VALDIR',
                    help='ImageNet val folder: evaluate each model with '
                         'local weights and compare to BASELINE.md')
    ap.add_argument('--limit', type=int, default=None,
                    help='eval at most N images (subset runs)')
    ap.add_argument('-b', '--batch-size', type=int, default=64)
    ap.add_argument('--tol', type=float, default=0.1,
                    help='PASS threshold on |measured - published| (%%)')
    ap.add_argument('--baseline', default=None,
                    help='path to BASELINE.md (default: repo root)')
    args = ap.parse_args(argv)
    # strict weights for the duration of the tool only, restored on exit so
    # an in-process caller does not keep the setting
    prior_strict = os.environ.get('PRETORCHED_STRICT_WEIGHTS')
    os.environ['PRETORCHED_STRICT_WEIGHTS'] = '1'
    try:
        return _run(args)
    finally:
        if prior_strict is None:
            os.environ.pop('PRETORCHED_STRICT_WEIGHTS', None)
        else:
            os.environ['PRETORCHED_STRICT_WEIGHTS'] = prior_strict


def _golden_input(model, settings, img):
    """(input batch of one, what it is): a fixed-seed clip for a video
    model, a fixed-seed waveform for an audio one, else the image through
    the model's transform."""
    import torch

    from pretorched_tpu_torch.transforms import TransformImage

    shape = settings['input_size']
    ndim = getattr(model, 'input_ndim', 4)
    if ndim == 5:
        t = shape[1] if len(shape) == 4 else 16
        x = np.random.RandomState(0).rand(
            1, shape[0], t, shape[-2], shape[-1]).astype(np.float32)
        what = 'video'
    elif ndim == 3:
        x = (np.random.RandomState(0).rand(1, shape[0], shape[-1])
             .astype(np.float32) * 2 - 1)
        what = 'audio'
    else:
        x = np.asarray(TransformImage(settings)(img))[None]
        what = 'image'
    return torch.from_numpy(np.ascontiguousarray(x)), what


def _run(args):
    import torch

    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.transforms import LoadImage
    from pretorched_tpu_torch.zoo import golden as zoo_golden
    from pretorched_tpu_torch.zoo import io as zoo_io

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --device cpu to run '
                           'on the CPU')
    names = args.models or pretorched.model_names
    os.makedirs(args.golden_dir, exist_ok=True)
    img = LoadImage()(args.image)
    baseline = zoo_golden.parse_baseline(args.baseline) if args.valdir else {}
    loaded, skipped, table, failures = [], [], [], 0
    for name in names:
        for tag, settings in pretorched.pretrained_settings.get(name,
                                                                {}).items():
            url = settings.get('url')
            if not url or zoo_io.find_torch_checkpoint(url) is None:
                skipped.append(f'{name}/{tag}')
                continue
            try:
                model = pretorched.__dict__[name](
                    num_classes=settings['num_classes'], pretrained=tag)
            except Exception as e:  # noqa: BLE001  (one model's failure)
                print(f'!! {name}/{tag}: {type(e).__name__}: {e}')
                continue
            model.to(device).eval()
            x, what = _golden_input(model, settings, img)
            with torch.inference_mode():
                logits = model(x.to(device)).float().cpu().numpy()[0]
            np.save(os.path.join(args.golden_dir, f'{name}-{tag}.npy'),
                    logits)
            top = int(logits.argmax())
            if what != 'image':
                print(f'{name}/{tag}: loaded ({what}; fixed-seed {what} '
                      f'golden logits saved, argmax={top})')
            else:
                print(f'{name}/{tag}: loaded; cat.jpg argmax={top} '
                      f'logit={logits[top]:.3f}')
                if args.valdir:
                    t0 = time.perf_counter()
                    top1, top5, n = zoo_golden.evaluate_imagenet(
                        model, args.valdir, batch_size=args.batch_size,
                        limit=args.limit, **EVAL_OVERRIDES.get(name, {}))
                    seconds = time.perf_counter() - t0
                    row = zoo_golden.accuracy_row(
                        name, tag, top1, top5, n, baseline, tol=args.tol)
                    failures += row.endswith('FAIL')
                    table.append(row)
                    print('* ' + row, flush=True)
                    print(f'  {n} images in {seconds:.3f} s = '
                          f'{n / seconds:.1f} images/s (load, transform and '
                          f'forward on {device})', flush=True)
            loaded.append(f'{name}/{tag}')
    print(f'\nloaded {len(loaded)}; '
          f'skipped (no local weights): {len(skipped)}')
    if table:
        print('\n== accuracy vs BASELINE.md '
              f'(tol {args.tol}, limit {args.limit}) ==')
        for row in table:
            print(row)
        print(f'{len(table) - failures}/{len(table)} within tolerance')
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
