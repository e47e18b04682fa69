"""phi3-medium-14b [arXiv:2404.14219]: 40L d=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352 — RoPE SwiGLU GQA."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(name="phi3-medium-14b", n_layers=40, d_model=5120,
                n_heads=40, n_kv=10, d_ff=17920, vocab=100352,
                dtype=torch.bfloat16)

SMOKE = LMConfig(name="phi3-medium-14b-smoke", n_layers=2, d_model=64,
                 n_heads=4, n_kv=1, d_ff=224, vocab=256,
                 remat=False)

SPEC = ArchSpec(arch_id="phi3-medium-14b", family="lm", full=FULL,
                smoke=SMOKE, source="arXiv:2404.14219; unverified")
