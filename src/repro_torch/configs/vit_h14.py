"""vit-h14 [arXiv:2010.11929]: 224/14, 32L d=1280 16H d_ff=5120."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.vit import ViTConfig

FULL = ViTConfig(name="vit-h14", img_res=224, patch=14, n_layers=32,
                 d_model=1280, n_heads=16, d_ff=5120, dtype=torch.bfloat16)

SMOKE = ViTConfig(name="vit-h-smoke", img_res=28, patch=7, n_layers=2,
                  d_model=32, n_heads=4, d_ff=64, n_classes=10, remat=False)

SPEC = ArchSpec(arch_id="vit-h14", family="vision", full=FULL, smoke=SMOKE,
                source="arXiv:2010.11929; paper")
