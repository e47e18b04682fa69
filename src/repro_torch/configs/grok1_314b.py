"""grok-1-314b [hf:xai-org/grok-1]: 64L d=6144 48H (kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig, MoESpec

FULL = LMConfig(name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
                n_kv=8, d_ff=32768, vocab=131072,
                moe=MoESpec(n_experts=8, top_k=2), dtype=torch.bfloat16)

SMOKE = LMConfig(name="grok1-smoke", n_layers=2, d_model=48, n_heads=4,
                 n_kv=2, d_ff=128, vocab=256,
                 moe=MoESpec(n_experts=4, top_k=2), remat=False)

SPEC = ArchSpec(arch_id="grok-1-314b", family="lm", full=FULL, smoke=SMOKE,
                source="hf:xai-org/grok-1; unverified")
