"""Architecture registry of the port: ``--arch <id>`` → ``ArchSpec``.

Each config module defines ``FULL`` (the published numbers) and
``SMOKE`` (a reduced same-family config for CPU tests), as in
``repro.configs``; the port's registry holds the archs whose path is
ported: the LMs of the serving path (dense and mixture-of-experts), the
paper's CNNs (their ``SMOKE``
is ``FULL``: the graphs are exact only at the published resolution),
and the ResNets and ViTs (``family="vision"``, their ``SMOKE`` the
reference's reduced one)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

__all__ = ["ArchSpec", "get_arch", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | vision
    full: Any
    smoke: Any
    source: str = ""


def _registry() -> Dict[str, ArchSpec]:
    from repro_torch.configs import (alexnet, deepseek_7b, deit_b,
                                     googlenet, grok1_314b, phi3_medium_14b,
                                     qwen3_moe_30b_a3b, resnet18,
                                     resnet152, vgg16, vit_h14, vit_s16)
    return {s.arch_id: s for s in (deepseek_7b.SPEC, phi3_medium_14b.SPEC,
                                   qwen3_moe_30b_a3b.SPEC, grok1_314b.SPEC,
                                   alexnet.SPEC, vgg16.SPEC,
                                   googlenet.SPEC, resnet18.SPEC,
                                   resnet152.SPEC, vit_s16.SPEC,
                                   deit_b.SPEC, vit_h14.SPEC)}


def get_arch(arch_id: str) -> ArchSpec:
    reg = _registry()
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(reg)}")
    return reg[arch_id]


def list_archs() -> List[str]:
    return sorted(_registry())
