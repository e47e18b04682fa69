"""flux-dev [BFL tech report]: MMDiT rectified-flow, 19 double + 38 single
blocks, d=3072, 24 heads, ~12B params, img 1024 (latent 128)."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.mmdit import MMDiTConfig

FULL = MMDiTConfig(name="flux-dev", n_double=19, n_single=38, d_model=3072,
                   n_heads=24, img_res=1024, dtype=torch.bfloat16)

SMOKE = MMDiTConfig(name="flux-smoke", n_double=2, n_single=3, d_model=32,
                    n_heads=4, img_res=64, txt_len=4, txt_dim=24, vec_dim=12,
                    in_ch=8, remat=False)

SPEC = ArchSpec(arch_id="flux-dev", family="diffusion", full=FULL,
                smoke=SMOKE, source="BFL tech report; unverified")
