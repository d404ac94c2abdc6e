"""WideResNet3D.

Counterpart of ``pretorched_tpu/models/wideresnet3d.py`` (reference:
pretorched/models/wideresnet3D.py): bottleneck expansion 2 with the widths
multiplied by ``k`` (default 2); hosted Kinetics weights for
``wideresnet3d50``.
"""

from __future__ import annotations

from ..core.registry import register_model, register_settings
from .resnet3d import _KINETICS, TORCH_RENAMES, VideoResNet, video_settings

pretrained_settings = video_settings(['wideresnet3d50'])


@register_model
def wideresnet3d50(num_classes: int = 400, pretrained: str = _KINETICS,
                   shortcut_type: str = 'B', k: int = 2):
    """WideResNet3D-50 (width x k, expansion 2)."""
    from ..core.factory import build_model
    model = VideoResNet('bottleneck', (3, 4, 6, 3), num_classes=num_classes,
                        expansion=2, shortcut_type=shortcut_type,
                        width_per_stage=(64 * k, 128 * k, 256 * k, 512 * k))
    return build_model('wideresnet3d50', model, pretrained_settings,
                       num_classes, pretrained, torch_renames=TORCH_RENAMES,
                       video=True)


register_settings(pretrained_settings)
