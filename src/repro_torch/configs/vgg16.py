"""vgg16 — paper baseline (Table 3 subject), 224 × 224 input."""
from repro_torch.configs import ArchSpec
from repro_torch.models.legacy import CNNConfig

FULL = CNNConfig(name="vgg16", img_res=224)
SMOKE = FULL

SPEC = ArchSpec(arch_id="vgg16", family="vision", full=FULL, smoke=SMOKE,
                source="arXiv:1409.1556; paper", assigned=False)
