"""resnet-18 — paper baseline (Table 3 subject, best cut res4a)."""
from repro_torch.configs import ArchSpec
from repro_torch.models.resnet import ResNetConfig

FULL = ResNetConfig(name="resnet-18", depths=(2, 2, 2, 2), width=64,
                    bottleneck=False, img_res=224)

SMOKE = ResNetConfig(name="r18-smoke", depths=(1, 1, 1, 1), width=8,
                     bottleneck=False, n_classes=10, img_res=32)

SPEC = ArchSpec(arch_id="resnet-18", family="vision", full=FULL, smoke=SMOKE,
                source="arXiv:1512.03385; paper", assigned=False)
