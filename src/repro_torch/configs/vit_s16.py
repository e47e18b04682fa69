"""vit-s16 [arXiv:2010.11929]: 224/16, 12L d=384 6H d_ff=1536."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.vit import ViTConfig

FULL = ViTConfig(name="vit-s16", img_res=224, patch=16, n_layers=12,
                 d_model=384, n_heads=6, d_ff=1536, dtype=torch.bfloat16)

SMOKE = ViTConfig(name="vit-s-smoke", img_res=32, patch=8, n_layers=2,
                  d_model=32, n_heads=4, d_ff=64, n_classes=10, remat=False)

SPEC = ArchSpec(arch_id="vit-s16", family="vision", full=FULL, smoke=SMOKE,
                source="arXiv:2010.11929; paper")
