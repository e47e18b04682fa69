"""Architecture registry of the port: ``--arch <id>`` → ``ArchSpec``.

Each config module defines ``FULL`` (the published numbers) and
``SMOKE`` (a reduced same-family config for CPU tests), as in
``repro.configs``; the port's registry holds every arch of the
reference's: the LMs (dense and mixture-of-experts), the diffusion
models (``unet-sd15``, ``flux-dev``), the ResNets and ViTs
(``family="vision"``, their ``SMOKE`` the reference's reduced one) and
the paper's own baselines (``assigned=False``: AlexNet, VGG16,
GoogLeNet — their ``SMOKE`` is ``FULL``, the graphs being exact only at
the published resolution — and ResNet-18).

Each family's input shapes (``ShapeSpec``: the reference's LM,
diffusion and vision tables), ``list_cells`` (the 40 assigned
(arch, shape) cells in the reference's order) and ``input_specs``,
which gives a cell's inputs as ``TensorSpec`` (shape and dtype, no
storage) where the reference gives ``jax.ShapeDtypeStruct``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

__all__ = ["ArchSpec", "ShapeSpec", "TensorSpec", "LM_SHAPES",
           "DIFFUSION_SHAPES", "VISION_SHAPES", "get_arch", "list_archs",
           "list_cells", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train | prefill | decode | denoise | infer
    seq_len: int = 0             # LM
    global_batch: int = 0
    img_res: int = 0             # diffusion and vision
    steps: int = 0               # diffusion


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

DIFFUSION_SHAPES = {
    "train_256": ShapeSpec("train_256", "train", img_res=256,
                           global_batch=256, steps=1000),
    "gen_1024": ShapeSpec("gen_1024", "denoise", img_res=1024,
                          global_batch=4, steps=50),
    "gen_fast": ShapeSpec("gen_fast", "denoise", img_res=512,
                          global_batch=16, steps=4),
    "train_1024": ShapeSpec("train_1024", "train", img_res=1024,
                            global_batch=32, steps=1000),
}

VISION_SHAPES = {
    "cls_224": ShapeSpec("cls_224", "train", img_res=224, global_batch=256),
    "cls_384": ShapeSpec("cls_384", "train", img_res=384, global_batch=64),
    "serve_b1": ShapeSpec("serve_b1", "infer", img_res=224, global_batch=1),
    "serve_b128": ShapeSpec("serve_b128", "infer", img_res=224,
                            global_batch=128),
}

_FAMILY_SHAPES = {"lm": LM_SHAPES, "diffusion": DIFFUSION_SHAPES,
                  "vision": VISION_SHAPES}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, without storage."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | diffusion | vision
    full: Any
    smoke: Any
    source: str = ""
    assigned: bool = True        # False for the paper's own baselines

    @property
    def shapes(self) -> Dict[str, ShapeSpec]:
        return _FAMILY_SHAPES.get(self.family, {})


def _registry() -> Dict[str, ArchSpec]:
    """Every arch, in the reference's registration order."""
    from repro_torch.configs import (alexnet, deepseek_7b, deit_b,
                                     flux_dev, googlenet, grok1_314b,
                                     phi3_medium_14b, qwen3_moe_30b_a3b,
                                     resnet18, resnet152, unet_sd15, vgg16,
                                     vit_h14, vit_s16)
    return {s.arch_id: s for s in (phi3_medium_14b.SPEC, deepseek_7b.SPEC,
                                   qwen3_moe_30b_a3b.SPEC, grok1_314b.SPEC,
                                   flux_dev.SPEC, unet_sd15.SPEC,
                                   deit_b.SPEC, vit_s16.SPEC, vit_h14.SPEC,
                                   resnet152.SPEC, alexnet.SPEC, vgg16.SPEC,
                                   resnet18.SPEC, googlenet.SPEC)}


def get_arch(arch_id: str) -> ArchSpec:
    reg = _registry()
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(reg)}")
    return reg[arch_id]


def list_archs(*, assigned_only: bool = False) -> List[str]:
    """Arch ids in the reference's order; only the assigned ones with
    ``assigned_only``."""
    return [a for a, s in _registry().items()
            if s.assigned or not assigned_only]


def list_cells() -> List[Tuple[str, str]]:
    """The 40 assigned (arch × shape) cells, in the reference's order
    (registration order, then each family's shape table)."""
    return [(a, sh) for a, s in _registry().items() if s.assigned
            for sh in s.shapes]


def shape_inputs(family: str, sh: ShapeSpec, cfg: Any = None
                 ) -> Dict[str, TensorSpec]:
    """The inputs of a ``family`` cell at shape ``sh`` (which may be a
    smoke-reduced copy of a table entry); a diffusion cell's also need
    its config ``cfg``: MMDiT latent patches ``[B, (r/16)², in_ch]``,
    text, pooled vector and an f32 ``t``; U-Net latents
    ``[B, r/8, r/8, in_ch]``, context and an int32 ``t``."""
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
    if family == "diffusion":
        if cfg is None:
            raise ValueError("a diffusion cell's inputs need its config")
        if type(cfg).__name__ == "MMDiTConfig":
            lat = TensorSpec((b, (r // 16) ** 2, cfg.in_ch), f32)
            base = {"latent": lat,
                    "txt": TensorSpec((b, cfg.txt_len, cfg.txt_dim), f32),
                    "vec": TensorSpec((b, cfg.vec_dim), f32),
                    "t": TensorSpec((b,), f32)}
        else:
            lat = TensorSpec((b, r // 8, r // 8, cfg.in_ch), f32)
            base = {"latent": lat,
                    "ctx": TensorSpec((b, cfg.ctx_len, cfg.ctx_dim), f32),
                    "t": TensorSpec((b,), i32)}
        if sh.kind == "train":        # the step's noise, from the batch
            base["noise"] = lat
        return base
    base = {"image": TensorSpec((b, r, r, 3), f32)}
    if sh.kind == "train":
        base["label"] = TensorSpec((b,), i32)
    return base


def input_specs(arch_id: str, shape_name: str, *,
                smoke: bool = False) -> Dict[str, TensorSpec]:
    """Abstract inputs of the (arch, shape) step function (a diffusion
    cell's widths come from ``FULL``, or ``SMOKE`` with ``smoke``)."""
    spec = get_arch(arch_id)
    return shape_inputs(spec.family, spec.shapes[shape_name],
                        spec.smoke if smoke else spec.full)
