"""deit-b [arXiv:2012.12877]: 224/16, 12L d=768 12H d_ff=3072 + distill
token."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.vit import ViTConfig

FULL = ViTConfig(name="deit-b", img_res=224, patch=16, n_layers=12,
                 d_model=768, n_heads=12, d_ff=3072, distill_token=True,
                 dtype=torch.bfloat16)

SMOKE = ViTConfig(name="deit-smoke", img_res=32, patch=8, n_layers=2,
                  d_model=32, n_heads=4, d_ff=64, n_classes=10,
                  distill_token=True, remat=False)

SPEC = ArchSpec(arch_id="deit-b", family="vision", full=FULL, smoke=SMOKE,
                source="arXiv:2012.12877; paper")
