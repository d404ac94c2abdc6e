"""Model families of the port (flat factory namespace)."""

from .layers import Identity  # noqa: F401
from .resnet3d import (resnet3d10, resnet3d18, resnet3d34, resnet3d50,  # noqa: F401
                       resnet3d101, resnet3d152, resnet3d200)
from .nonlocalnet import (nonlocalresnet3d18, nonlocalresnet3d34,  # noqa: F401
                          nonlocalresnet3d50, nonlocalresnet3d101,
                          nonlocalresnet3d152)
from . import slowfast  # noqa: F401  (the reference's pretorched.slowfast)
from .slowfast import SlowFastV0  # noqa: F401
