"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (kv=4,
head_dim=128) expert d_ff=768 vocab=151936, MoE 128 experts top-8."""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig, MoESpec

FULL = LMConfig(name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048,
                n_heads=32, n_kv=4, head_dim=128, d_ff=768, vocab=151936,
                moe=MoESpec(n_experts=128, top_k=8), dtype=torch.bfloat16)

SMOKE = LMConfig(name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
                 n_kv=2, head_dim=16, d_ff=32, vocab=256,
                 moe=MoESpec(n_experts=8, top_k=2), remat=False)

SPEC = ArchSpec(arch_id="qwen3-moe-30b-a3b", family="lm", full=FULL,
                smoke=SMOKE, source="hf:Qwen/Qwen3-30B-A3B; hf")
