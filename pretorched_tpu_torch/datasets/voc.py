"""Pascal VOC 2007 multilabel classification dataset.

Counterpart of ``pretorched_tpu/datasets/voc.py`` (reference:
pretorched/datasets/voc.py): download and untar on first use (skipped for
each archive whose sentinel path exists), per-class labels in {-1, 0, 1}
read from ``ImageSets/Main/<class>_<split>.txt`` and cached to
``files/VOC2007/classification_<split>.csv``; items are ``(img, name,
target)``, the image as PIL (or what ``transform`` makes of it), the
target a float32 tensor of the 20 labels.
"""

from __future__ import annotations

import csv
import os
import tarfile
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from .utils import download_url

object_categories = ['aeroplane', 'bicycle', 'bird', 'boat',
                     'bottle', 'bus', 'car', 'cat', 'chair',
                     'cow', 'diningtable', 'dog', 'horse',
                     'motorbike', 'person', 'pottedplant',
                     'sheep', 'sofa', 'train', 'tvmonitor']

urls = {
    'devkit': 'http://host.robots.ox.ac.uk/pascal/VOC/voc2012/VOCdevkit_18-May-2011.tar',
    'trainval_2007': 'http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtrainval_06-Nov-2007.tar',
    'test_images_2007': 'http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtest_06-Nov-2007.tar',
    'test_anno_2007': 'http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtestnoimgs_06-Nov-2007.tar',
}


def read_image_label(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = int(parts[-1])
    return out


def read_object_labels(root: str, dataset: str, split: str) -> dict:
    path_labels = os.path.join(root, 'VOCdevkit', dataset, 'ImageSets', 'Main')
    labeled = {}
    for i, cat in enumerate(object_categories):
        data = read_image_label(os.path.join(path_labels, f'{cat}_{split}.txt'))
        for name, label in data.items():
            labeled.setdefault(name, np.zeros(len(object_categories)))[i] = label
    return labeled


def write_object_labels_csv(path: str, labeled_data: dict) -> None:
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['name'] + object_categories)
        for name, labels in labeled_data.items():
            writer.writerow([name] + [int(v) for v in labels])


def read_object_labels_csv(path: str, header: bool = True
                           ) -> List[Tuple[str, np.ndarray]]:
    images = []
    with open(path) as f:
        reader = csv.reader(f)
        for rownum, row in enumerate(reader):
            if header and rownum == 0:
                continue
            if row:
                images.append((row[0], np.asarray(row[1:21], np.float32)))
    return images


def _extract(tar_path: str, dest: str) -> None:
    with tarfile.open(tar_path) as tar:
        tar.extractall(dest)


def download_voc2007(root: str) -> None:
    """Download and extract each archive whose sentinel path is missing
    (reference: voc.py:114-212)."""
    os.makedirs(root, exist_ok=True)
    tmpdir = os.path.join(root, 'tmp')
    os.makedirs(tmpdir, exist_ok=True)
    targets = {
        'devkit': os.path.join(root, 'VOCdevkit', 'VOC2007'),
        'trainval_2007': os.path.join(root, 'VOCdevkit', 'VOC2007', 'JPEGImages'),
        'test_anno_2007': os.path.join(root, 'VOCdevkit', 'VOC2007', 'ImageSets',
                                       'Main', 'aeroplane_test.txt'),
        'test_images_2007': os.path.join(root, 'VOCdevkit', 'VOC2007',
                                         'JPEGImages', '000001.jpg'),
    }
    for key in ('devkit', 'trainval_2007', 'test_anno_2007', 'test_images_2007'):
        if os.path.exists(targets[key]):
            continue
        url = urls[key]
        cached = os.path.join(tmpdir, url.rsplit('/', 1)[-1])
        download_url(url, cached)
        print(f'[dataset] extracting {cached} to {root}')
        _extract(cached, root)


class Voc2007Classification:
    """Multilabel VOC2007, targets in {-1, 0, 1} (reference:
    voc.py:215-261)."""

    def __init__(self, root: str, split: str,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 download: bool = True):
        self.root = root
        self.path_devkit = os.path.join(root, 'VOCdevkit')
        self.path_images = os.path.join(root, 'VOCdevkit', 'VOC2007', 'JPEGImages')
        self.set = split
        self.transform = transform
        self.target_transform = target_transform

        if download:
            download_voc2007(root)

        path_csv = os.path.join(root, 'files', 'VOC2007')
        file_csv = os.path.join(path_csv, f'classification_{split}.csv')
        if not os.path.exists(file_csv):
            os.makedirs(path_csv, exist_ok=True)
            labeled_data = read_object_labels(root, 'VOC2007', split)
            write_object_labels_csv(file_csv, labeled_data)
        self.classes = object_categories
        self.images = read_object_labels_csv(file_csv)
        print(f'[dataset] VOC 2007 classification set={split} '
              f'number of classes={len(self.classes)} '
              f'number of images={len(self.images)}')

    def __getitem__(self, index):
        name, target = self.images[index]
        img = Image.open(os.path.join(
            self.path_images, name + '.jpg')).convert('RGB')
        if self.transform is not None:
            img = self.transform(img)
        target = torch.from_numpy(target.copy())
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, name, target

    def __len__(self):
        return len(self.images)

    def get_number_classes(self):
        return len(self.classes)
