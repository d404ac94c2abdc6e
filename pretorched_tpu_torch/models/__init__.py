"""Model families of the port (flat factory namespace)."""

from .layers import Identity  # noqa: F401
from .resnet import (resnet18, resnet34, resnet50, resnet101,  # noqa: F401
                     resnet152)
from .resnet3d import (resnet3d10, resnet3d18, resnet3d34, resnet3d50,  # noqa: F401
                       resnet3d101, resnet3d152, resnet3d200, resneti3d50)
from .resnext3d import (resnext3d10, resnext3d18, resnext3d34,  # noqa: F401
                        resnext3d50, resnext3d101, resnext3d152, resnext3d200)
from .wideresnet3d import wideresnet3d50  # noqa: F401
from .preact_resnet3d import (preact_resnet3d10, preact_resnet3d18,  # noqa: F401
                              preact_resnet3d34, preact_resnet3d50,
                              preact_resnet3d101, preact_resnet3d152,
                              preact_resnet3d200)
from .r2plus1d import (r2plus1d10, r2plus1d18, r2plus1d34, r2plus1d50,  # noqa: F401
                       r2plus1d101, r2plus1d152, r2plus1d200)
from .nonlocalnet import (MNISTNonLocalNet, NonLocalBlock,  # noqa: F401
                          NonLocalBlock1D, NonLocalBlock2D, NonLocalBlock3D,
                          nonlocalresnet3d18, nonlocalresnet3d34,
                          nonlocalresnet3d50, nonlocalresnet3d101,
                          nonlocalresnet3d152)
from .senet import (senet154, se_resnet50, se_resnet101,  # noqa: F401
                    se_resnet152, se_resnext50_32x4d, se_resnext101_32x4d)
from .nasnet import nasnetalarge, nasnetamobile  # noqa: F401
from .resnext import resnext101_32x4d, resnext101_64x4d  # noqa: F401
from .fbresnet import (fbresnet18, fbresnet34, fbresnet50,  # noqa: F401
                       fbresnet101, fbresnet152)
from .cafferesnet import cafferesnet101  # noqa: F401
from .densenet import (densenet121, densenet161, densenet169,  # noqa: F401
                       densenet201)
from .vgg import (vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,  # noqa: F401
                  vgg16_bn, vgg19, vgg19_bn)
from .alexnet import alexnet  # noqa: F401
from .squeezenet import squeezenet1_0, squeezenet1_1  # noqa: F401
from .inception_v3 import inceptionv3  # noqa: F401
from .inceptionv4 import inceptionv4  # noqa: F401
from .inceptionresnetv2 import inceptionresnetv2  # noqa: F401
from .bninception import bninception  # noqa: F401
from .xception import xception  # noqa: F401
from .dpn import dpn68, dpn68b, dpn92, dpn98, dpn107, dpn131  # noqa: F401
from .mobilenet import mobilenetv2  # noqa: F401
from .pnasnet import pnasnet5large  # noqa: F401
from .polynet import polynet  # noqa: F401
from .vggm import vggm  # noqa: F401
from .wideresnet import wideresnet50  # noqa: F401
from . import slowfast  # noqa: F401  (the reference's pretorched.slowfast)
from .slowfast import SlowFastV0  # noqa: F401
from .trn import TRN, trn  # noqa: F401
from .densenet3d import (densenet3d121, densenet3d169,  # noqa: F401
                         densenet3d201, densenet3d264)
from .multiview import (MultiViewConv, MVResNet, mvresnet10,  # noqa: F401
                        mvresnet18, mvresnet34, mvresnet50)
from .soundnet import BranchedSoundNet, SoundNet, soundnet8  # noqa: F401
