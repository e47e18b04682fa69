"""unet-sd15 [arXiv:2112.10752]: ch=320 mult 1-2-4-4, 2 res blocks,
cross-attn at ds 1-2-4, ctx_dim=768, img 512 (latent 64)."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.unet import UNetConfig

FULL = UNetConfig(name="unet-sd15", ch=320, ch_mult=(1, 2, 4, 4),
                  n_res_blocks=2, attn_stages=(0, 1, 2), ctx_dim=768,
                  img_res=512, dtype=torch.bfloat16)

SMOKE = UNetConfig(name="sd15-smoke", ch=8, ch_mult=(1, 2, 2),
                   n_res_blocks=1, attn_stages=(0, 1), ctx_dim=16, ctx_len=4,
                   n_heads=2, img_res=64)

SPEC = ArchSpec(arch_id="unet-sd15", family="diffusion", full=FULL,
                smoke=SMOKE, source="arXiv:2112.10752; paper")
