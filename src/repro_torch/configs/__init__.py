"""Architecture registry of the port: ``--arch <id>`` → ``ArchSpec``.

Each config module defines ``FULL`` (the published numbers) and
``SMOKE`` (a reduced same-family config for CPU tests), as in
``repro.configs``; the port's registry holds the archs whose path is
ported: the LMs of the serving path (dense and mixture-of-experts), the
paper's CNNs (their ``SMOKE``
is ``FULL``: the graphs are exact only at the published resolution),
and the ResNets and ViTs (``family="vision"``, their ``SMOKE`` the
reference's reduced one).

Each family's input shapes (``ShapeSpec``: the reference's LM and
vision tables) and ``input_specs``, which gives a cell's inputs as
``TensorSpec`` (shape and dtype, no storage) where the reference gives
``jax.ShapeDtypeStruct``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

__all__ = ["ArchSpec", "ShapeSpec", "TensorSpec", "LM_SHAPES",
           "VISION_SHAPES", "get_arch", "list_archs", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train | prefill | decode | infer
    seq_len: int = 0             # LM
    global_batch: int = 0
    img_res: int = 0             # vision (global_batch reused)
    steps: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096,
                          global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288,
                           global_batch=1),
}

VISION_SHAPES = {
    "cls_224": ShapeSpec("cls_224", "train", img_res=224, global_batch=256),
    "cls_384": ShapeSpec("cls_384", "train", img_res=384, global_batch=64),
    "serve_b1": ShapeSpec("serve_b1", "infer", img_res=224, global_batch=1),
    "serve_b128": ShapeSpec("serve_b128", "infer", img_res=224,
                            global_batch=128),
}

_FAMILY_SHAPES = {"lm": LM_SHAPES, "vision": VISION_SHAPES}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, without storage."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | vision
    full: Any
    smoke: Any
    source: str = ""

    @property
    def shapes(self) -> Dict[str, ShapeSpec]:
        return _FAMILY_SHAPES.get(self.family, {})


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


def shape_inputs(family: str, sh: ShapeSpec) -> Dict[str, TensorSpec]:
    """The inputs of a ``family`` cell at shape ``sh`` (which may be a
    smoke-reduced copy of a table entry)."""
    f32, i32 = torch.float32, torch.int32
    b = sh.global_batch
    if family == "lm":
        s = sh.seq_len
        if sh.kind == "train":
            return {"tokens": TensorSpec((b, s), i32),
                    "labels": TensorSpec((b, s), i32)}
        if sh.kind == "prefill":
            return {"tokens": TensorSpec((b, s), i32)}
        return {"token": TensorSpec((b,), i32),
                "cache_index": TensorSpec((), i32)}
    r = sh.img_res
    base = {"image": TensorSpec((b, r, r, 3), f32)}
    if sh.kind == "train":
        base["label"] = TensorSpec((b,), i32)
    return base


def input_specs(arch_id: str, shape_name: str) -> Dict[str, TensorSpec]:
    """Abstract inputs of the (arch, shape) step function."""
    spec = get_arch(arch_id)
    return shape_inputs(spec.family, spec.shapes[shape_name])
