#!/usr/bin/env python
"""VOC2007 feature extraction and linear SVM transfer on the PyTorch port.

The twin of ``examples/voc2007_extract.py`` (reference:
examples/voc2007_extract.py): drop the model's head with the
``last_linear = Identity()`` trick, extract features of the train and test
splits on ``--device`` in batches of ``-b`` (the PIL ``TransformImage`` of
the model's metadata), cache them to ``<split>.npz`` and reload them from
there, then fit a linear SVM per class on the host (sklearn, imported
only there) and print each class's AP and the mAP.

Usage:
    python examples/voc2007_extract_torch.py --dir_datasets DATA -a resnet50
    python examples/voc2007_extract_torch.py --dir_datasets DATA \
        -a resnet18 --pretrained none --device cpu

``DATA/VOC2007`` is downloaded and extracted unless its sentinel files
exist (``VOCdevkit/VOC2007/ImageSets/Main/aeroplane_test.txt`` and
``JPEGImages/000001.jpg`` among them).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='VOC2007 feature extraction + SVM (PyTorch)')
    p.add_argument('--dir_outputs',
                   default=os.path.join(tempfile.gettempdir(), 'outputs'))
    p.add_argument('--dir_datasets',
                   default=os.path.join(tempfile.gettempdir(), 'datasets'))
    p.add_argument('--C', default=1.0, type=float)
    p.add_argument('--batch_size', '-b', default=64, type=int)
    p.add_argument('--arch', '-a', default='alexnet')
    p.add_argument('--train_split', default='train')
    p.add_argument('--test_split', default='val')
    p.add_argument('--pretrained', default='imagenet')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default), 'cuda:N' or 'cpu'")
    return p.parse_args(argv)


def extract_features_targets(model, path_file, loader, split, device):
    """Cached feature extraction (reference: voc2007_extract.py:27-57):
    the features of every batch of ``loader`` on ``device``, saved to
    ``path_file``, or read back from it when it exists."""
    if os.path.isfile(path_file):
        print(f'Load features from {path_file}')
        data = np.load(path_file)
        return data['features'], data['targets']
    print(f'Extract features on {split} set')
    feats, targets = [], []
    with torch.inference_mode():
        for i, (imgs, _names, tgts) in enumerate(loader):
            out = model(torch.stack(imgs).to(device)).float().cpu().numpy()
            feats.append(out.reshape(out.shape[0], -1))
            targets.append(torch.stack(tgts).numpy())
            if i % 10 == 0:
                print(f'  batch {i}')
    features = np.concatenate(feats)
    targets = np.concatenate(targets)
    os.makedirs(os.path.dirname(path_file), exist_ok=True)
    np.savez(path_file, features=features, targets=targets)
    print(f'Save features to {path_file}')
    return features, targets


def train_multilabel(features, targets, classes, train_split, test_split,
                     C=1.0):
    """Per-class LinearSVC and AP (reference: voc2007_extract.py:59-114):
    the rows difficult for a class (target 0) are left out of its fit and
    its AP; positives are the targets equal to 1."""
    from sklearn.svm import LinearSVC

    from pretorched_tpu_torch.datasets.utils import AveragePrecisionMeter

    aps = []
    for ic, c in enumerate(classes):
        tr_mask = targets[train_split][:, ic] != 0
        te_mask = targets[test_split][:, ic] != 0
        train_t = (targets[train_split][tr_mask, ic] == 1).astype(int)
        test_t = (targets[test_split][te_mask, ic] == 1).astype(int)
        clf = LinearSVC(C=C)
        clf.fit(features[train_split][tr_mask], train_t)
        scores = clf.decision_function(features[test_split][te_mask])
        ap = AveragePrecisionMeter.average_precision(
            scores, test_t, difficult_examples=False)
        aps.append(ap)
        print(f'{c}: AP {100*ap:.2f}')
    print(f'mAP: {100*np.mean(aps):.2f}')
    return np.mean(aps)


def extract(args):
    """Both splits' features and targets, cached under ``--dir_outputs``.
    Returns (features, targets, classes, {split: seconds}) by split."""
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.datasets.voc import Voc2007Classification
    from pretorched_tpu_torch.transforms import TransformImage
    from pretorched_tpu_torch.utils import chunks

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --device cpu to run '
                           'on the CPU')
    pretrained = (None if args.pretrained in ('none', 'None', '')
                  else args.pretrained)
    model = pretorched.__dict__[args.arch](num_classes=1000,
                                           pretrained=pretrained)
    model.last_linear = pretorched.Identity()   # feature extraction trick
    model.to(device).eval()
    tf_img = TransformImage(model.metadata)

    features, targets, seconds = {}, {}, {}
    dir_root = os.path.join(args.dir_datasets, 'VOC2007')
    dir_feats = os.path.join(args.dir_outputs, 'data', f'voc2007_{args.arch}')
    for split in (args.train_split, args.test_split):
        ds = Voc2007Classification(dir_root, split, transform=tf_img)

        def loader(ds=ds):
            for batch in chunks(list(range(len(ds))), args.batch_size):
                items = [ds[i] for i in batch]
                yield ([x for x, _, _ in items], [n for _, n, _ in items],
                       [t for _, _, t in items])

        t0 = time.perf_counter()
        features[split], targets[split] = extract_features_targets(
            model, os.path.join(dir_feats, f'{split}.npz'), loader(), split,
            device)
        seconds[split] = time.perf_counter() - t0
    return features, targets, ds.classes, seconds


def main(argv=None):
    """Prints the AP lines; returns the mAP."""
    args = parse_args(argv)
    features, targets, classes, _ = extract(args)
    return train_multilabel(features, targets, classes, args.train_split,
                            args.test_split, C=args.C)


if __name__ == '__main__':
    main()
