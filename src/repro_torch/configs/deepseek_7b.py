"""deepseek-7b [arXiv:2401.02954]: 30L d=4096 32H (kv=32) d_ff=11008
vocab=102400 — llama-arch."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
                n_kv=32, d_ff=11008, vocab=102400,
                dtype=torch.bfloat16)

SMOKE = LMConfig(name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
                 n_kv=4, d_ff=172, vocab=256, remat=False)

SPEC = ArchSpec(arch_id="deepseek-7b", family="lm", full=FULL, smoke=SMOKE,
                source="arXiv:2401.02954; hf")
