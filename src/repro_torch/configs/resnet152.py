"""resnet-152 [arXiv:1512.03385]: depths 3-8-36-3, width 64, bottleneck."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.resnet import ResNetConfig

FULL = ResNetConfig(name="resnet-152", depths=(3, 8, 36, 3), width=64,
                    bottleneck=True, img_res=224, dtype=torch.bfloat16)

SMOKE = ResNetConfig(name="r152-smoke", depths=(1, 1, 1, 1), width=8,
                     bottleneck=True, n_classes=10, img_res=32)

SPEC = ArchSpec(arch_id="resnet-152", family="vision", full=FULL,
                smoke=SMOKE, source="arXiv:1512.03385; paper")
