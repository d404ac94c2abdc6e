"""Golden-accuracy workflow: hosted weights -> accuracy table against
BASELINE.md.

Counterpart of ``pretorched_tpu/zoo/golden.py``. The reference's value is
hosted weights reproducing a published accuracy table (reference
README.md:203-282). With the weights in the cache, one command checks it:

    python tools/convert_weights_torch.py --eval /path/to/imagenet/val

For every model with a local checkpoint the tool evaluates the val folder
with the model's own metadata-derived transform (center crop, reference
imagenet_eval.py:112) and prints measured against published Acc@1 / Acc@5
with a PASS / FAIL at |delta| <= 0.1. The port loads the hosted ``.pth``
directly (no converted cache, unlike the JAX package).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

# Table display name -> registry name, where pure normalization (lowercase,
# strip non-alphanumerics) is not enough. DualPathNet rows carry the
# reference's "_5k" pretrain marker (imagenet+5k heads, dpn.py:98-206).
_SPECIAL = {
    'dualpathnet68': 'dpn68', 'dualpathnet68b5k': 'dpn68b',
    'dualpathnet925k': 'dpn92', 'dualpathnet98': 'dpn98',
    'dualpathnet1075k': 'dpn107', 'dualpathnet131': 'dpn131',
    'nasnetalarge': 'nasnetalarge', 'nasnetamobile': 'nasnetamobile',
    'pnasnet5large': 'pnasnet5large',
}


def _norm(display: str) -> str:
    return re.sub(r'[^a-z0-9]', '', display.lower())


def _registry_by_norm() -> Dict[str, str]:
    """{normalized name: registry spelling} for every registered model."""
    from ..core.registry import model_names
    return {_norm(n): n for n in model_names}


def display_to_registry(display: str) -> Optional[str]:
    """Map a BASELINE.md display name to a registry model name (registry
    spelling, e.g. 'SE-ResNeXt50_32x4d' -> 'se_resnext50_32x4d')."""
    n = _norm(display)
    n = _SPECIAL.get(n, n)
    return _registry_by_norm().get(n, n or None)


def parse_baseline(path: Optional[str] = None
                   ) -> Dict[str, Tuple[float, float]]:
    """{registry_name: (top1, top5)} from BASELINE.md's markdown table (at
    the repository root by default). The reference's own measured numbers
    ("Our porting") win over upstream-quoted rows for the same model."""
    if path is None:
        path = Path(__file__).resolve().parents[2] / 'BASELINE.md'
    table: Dict[str, Tuple[float, float]] = {}
    ours: Dict[str, bool] = {}
    for line in Path(path).read_text().splitlines():
        cells = [c.strip() for c in line.strip().strip('|').split('|')]
        if len(cells) < 4 or cells[0] in ('Model', ':---', '---'):
            continue
        try:
            top1, top5 = float(cells[2]), float(cells[3])
        except ValueError:
            continue
        name = display_to_registry(cells[0])
        if name is None:
            continue
        is_ours = 'our porting' in cells[1].lower()
        if name not in table or (is_ours and not ours.get(name)):
            table[name] = (top1, top5)
            ours[name] = is_ours
    return table


def evaluate_imagenet(model, valdir: str, batch_size: int = 64,
                      limit: Optional[int] = None,
                      scale: Optional[float] = None,
                      preserve_aspect_ratio: bool = True,
                      num_workers: int = 0) -> Tuple[float, float, int]:
    """Center-crop top-1 / top-5 (%) and the image count of ``model`` over
    an ImageFolder val dir, on the model's device.

    Uses the model's own metadata-derived PIL transform and the masked
    metrics of ``parallel.evaluate.sharded_accuracy_step``; ``limit``
    bounds the number of images for subset runs."""
    from ..datasets.folder import ImageFolder, batch_iterator
    from ..parallel.evaluate import sharded_accuracy_step
    from ..transforms import TransformImage

    tf = TransformImage(model.metadata or model.settings or model,
                        scale=scale,
                        preserve_aspect_ratio=preserve_aspect_ratio)
    ds = ImageFolder(valdir, transform=tf)
    if limit is not None and limit < len(ds):
        ds.samples = ds.samples[:limit]
    device = next(model.parameters()).device
    step = sharded_accuracy_step(model)
    tot = {'top1': 0, 'top5': 0, 'count': 0}
    for images, labels in batch_iterator(ds, batch_size, shuffle=False,
                                         num_workers=num_workers):
        m = step(torch.from_numpy(images).to(device),
                 torch.from_numpy(labels))
        for k in tot:
            tot[k] += int(m[k])
    n = max(tot['count'], 1)
    return 100.0 * tot['top1'] / n, 100.0 * tot['top5'] / n, tot['count']


def accuracy_row(name: str, tag: str, top1: float, top5: float, count: int,
                 baseline: Dict[str, Tuple[float, float]],
                 tol: float = 0.1) -> str:
    """One formatted table line: measured vs published, PASS/FAIL at tol."""
    ref = baseline.get(name)
    if ref is None:
        return (f'{name}/{tag}: Acc@1 {top1:.3f} Acc@5 {top5:.3f} '
                f'(n={count}) [no published baseline]')
    d1, d5 = top1 - ref[0], top5 - ref[1]
    ok = abs(d1) <= tol and abs(d5) <= tol
    return (f'{name}/{tag}: Acc@1 {top1:.3f} (ref {ref[0]:.3f}, '
            f'{d1:+.3f}) Acc@5 {top5:.3f} (ref {ref[1]:.3f}, {d5:+.3f}) '
            f'(n={count}) {"PASS" if ok else "FAIL"}')
