"""alexnet — paper baseline (Table 3 subject), single-tower (ungrouped),
227 × 227 input."""
from repro_torch.configs import ArchSpec
from repro_torch.models.legacy import CNNConfig

FULL = CNNConfig(name="alexnet", img_res=227)
SMOKE = FULL

SPEC = ArchSpec(arch_id="alexnet", family="vision", full=FULL, smoke=SMOKE,
                source="arXiv:1404.5997-era; paper", assigned=False)
