"""Architecture registry of the port: ``--arch <id>`` → ``ArchSpec``.

Each config module defines ``FULL`` (the published numbers) and
``SMOKE`` (a reduced same-family config for CPU tests), as in
``repro.configs``; the port's registry holds the archs whose path is
ported: the LMs of the serving path and the paper's CNNs (their
``SMOKE`` is ``FULL``: the graphs are exact only at the published
resolution)."""
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
    from repro_torch.configs import (alexnet, deepseek_7b, googlenet,
                                     phi3_medium_14b, vgg16)
    return {s.arch_id: s for s in (deepseek_7b.SPEC, phi3_medium_14b.SPEC,
                                   alexnet.SPEC, vgg16.SPEC,
                                   googlenet.SPEC)}


def get_arch(arch_id: str) -> ArchSpec:
    reg = _registry()
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(reg)}")
    return reg[arch_id]


def list_archs() -> List[str]:
    return sorted(_registry())
