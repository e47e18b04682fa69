"""googlenet — paper baseline (Table 3 subject), 9 inception modules,
224 × 224 input."""
from repro_torch.configs import ArchSpec
from repro_torch.models.legacy import CNNConfig

FULL = CNNConfig(name="googlenet", img_res=224)
SMOKE = FULL

SPEC = ArchSpec(arch_id="googlenet", family="vision", full=FULL,
                smoke=SMOKE, source="arXiv:1409.4842; paper",
                assigned=False)
