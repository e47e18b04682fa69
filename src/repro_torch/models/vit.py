"""Vision Transformers: vit-s16, vit-h14 and deit-b (distillation token).

Counterpart of ``repro.models.vit``: pre-LN blocks with learned position
embeddings and a GELU MLP; DeiT adds a distillation token next to [CLS]
and its head averages the cls- and distill-token logits (arXiv:2012.12877).
Block parameters are stacked on a leading ``[L]`` axis, as JAX's
``vmap`` init gives them, so the weight bridge is a plain map; the
reference's ``lax.scan`` over blocks is a Python loop over the views.

Every block names its activations as the reference's do (``attn/q/in``
... ``mlp/wo/in``, the same in every block), so a calibrated edge keeps
one static range per name across its blocks, as the reference's does.
The candidate cuts include ``blk{i}/attn``, but segments end only at
``blk{i}/ffn`` (a whole block): an engine cuts at ``input`` or a
segment.  The patch embedding, each block and the head run inside
``full_f32`` (an f32 product on the card in true f32).  With
``remat`` each block is recomputed in the backward pass while autograd
records (the reference's ``jax.checkpoint``); ``scan_unroll`` is inert
here, kept so that configs read alike.  ``cls_loss`` is the training
loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import tree_map
from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantCtx, full_f32
from repro_torch.models.transformer import (layer_views, remat_active,
                                            token_nll)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    distill_token: bool = False
    dtype: Any = torch.float32
    remat: bool = True
    scan_unroll: int = 1

    @property
    def n_patches(self) -> int:
        return (self.img_res // self.patch) ** 2

    @property
    def n_tokens(self) -> int:
        return self.n_patches + 1 + (1 if self.distill_token else 0)

    @property
    def extra(self) -> int:
        """Class tokens: [CLS], and DeiT's distillation token."""
        return 2 if self.distill_token else 1

    def param_count(self) -> int:
        d = self.d_model
        block = 4 * d * d + 2 * d * self.d_ff + self.d_ff + d + 4 * d
        return (self.patch ** 2 * 3 * d + d            # patch embed
                + self.extra * d + self.n_tokens * d   # cls/distill + pos
                + self.n_layers * block
                + 2 * d                                # final ln
                + self.extra * (d * self.n_classes + self.n_classes))


def _true_f32(x: torch.Tensor):
    return full_f32(x.is_cuda and x.dtype == torch.float32)


def init_block(gen: torch.Generator, cfg: ViTConfig, *,
               device: DeviceLike = None,
               layers: Optional[int] = None) -> Params:
    """One block's parameters, or ``layers`` blocks' stacked on a
    leading axis."""
    dev = resolve_device(device)
    d = cfg.d_model
    kw = dict(dtype=cfg.dtype, device=dev, layers=layers)
    return {"ln1": L.norm_init(d, bias=True, **kw),
            "attn": L.attention_init(gen, d, cfg.n_heads, cfg.n_heads,
                                     **kw),
            "ln2": L.norm_init(d, bias=True, **kw),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, **kw)}


def init_vit(gen: torch.Generator, cfg: ViTConfig, *,
             device: DeviceLike = None) -> Params:
    """Random weights with the reference's distributions (fan-in scaled
    projections, zero biases, unit norms; tokens and positions normal ×
    0.02), drawn from ``gen`` — which must live on ``device``."""
    dev = resolve_device(device)
    d = cfg.d_model
    kw = dict(dtype=cfg.dtype, device=dev)

    def normal(shape):
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (t * 0.02).to(cfg.dtype)
    return {
        "patch": L.patch_embed_init(gen, cfg.patch, 3, d, **kw),
        "cls": normal((cfg.extra, d)),
        "pos": normal((cfg.n_tokens, d)),
        "blocks": init_block(gen, cfg, device=dev, layers=cfg.n_layers),
        "final_ln": L.norm_init(d, bias=True, **kw),
        "head": L.dense_init(gen, d, cfg.extra * cfg.n_classes, bias=True,
                             **kw),
    }


def block_params(params: Params, i: int) -> Params:
    """Block ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda v: v[i], params["blocks"])


def _patch_apply(p: Params, img: torch.Tensor, cfg: ViTConfig, *,
                 qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    with _true_f32(img):
        x = L.patch_embed(p["patch"], img.to(cfg.dtype), patch=cfg.patch,
                          qctx=qctx)
    tok = p["cls"][None].expand((x.shape[0],) + p["cls"].shape)
    dt = torch.promote_types(tok.dtype, x.dtype)
    return torch.cat([tok.to(dt), x.to(dt)], dim=1) + p["pos"][None]


def block_apply(p: Params, x: torch.Tensor, cfg: ViTConfig, *,
                qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    with _true_f32(x):
        h, _ = L.attention(p["attn"], L.layernorm(p["ln1"], x),
                           n_heads=cfg.n_heads, n_kv=cfg.n_heads,
                           causal=False, qctx=qctx)
        x = x + h
        return x + L.mlp(p["mlp"], L.layernorm(p["ln2"], x), qctx=qctx)


def _head_apply(p: Params, x: torch.Tensor, cfg: ViTConfig, *,
                qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """Final LN, the head on the class tokens → [B, extra, extra, C],
    and the mean of its diagonal (DeiT averages the two tokens' own
    logits)."""
    b, extra = x.shape[0], cfg.extra
    with _true_f32(x):
        x = L.layernorm(p["final_ln"], x)
        heads = L.dense(p["head"], x[:, :extra], qctx=qctx, name="head")
    heads = heads.reshape(b, extra, extra, cfg.n_classes)
    return torch.mean(torch.stack([heads[:, i, i] for i in range(extra)],
                                  dim=1), dim=1)


def forward(params: Params, img: torch.Tensor, cfg: ViTConfig, *,
            qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """img [B, H, W, 3] → logits [B, n_classes].  ``params["blocks"]``
    is the stacked tree or a list of per-layer trees."""
    x = _patch_apply(params, img, cfg, qctx=qctx)

    def block(layer, x):
        return block_apply(layer, x, cfg, qctx=qctx)

    for layer in layer_views(params["blocks"]):
        x = (checkpoint(block, layer, x, use_reentrant=False)
             if remat_active(cfg.remat, x, layer) else block(layer, x))
    return _head_apply(params, x, cfg, qctx=qctx)


def cls_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ViTConfig) -> torch.Tensor:
    """Mean cross-entropy of ``batch["image"]`` against
    ``batch["label"]``, in f32."""
    return token_nll(forward(params, batch["image"], cfg), batch["label"])


def make_graph(cfg: ViTConfig, *, batch: int) -> LayerGraph:
    g = LayerGraph(cfg.name)
    d, t = cfg.d_model, cfg.n_tokens
    g.add("input", "input", [], (batch, cfg.img_res, cfg.img_res, 3))
    g.add("patch", "conv", ["input"], (batch, t, d),
          flops=2 * batch * cfg.n_patches * cfg.patch ** 2 * 3 * d,
          param_elems=cfg.patch ** 2 * 3 * d + d + (t + 2) * d)
    prev = "patch"
    attn_flops = (2 * batch * t * d * d * 4 + 2 * batch * cfg.n_heads
                  * t * t * (d // cfg.n_heads) * 2)
    mlp_flops = 2 * batch * t * d * cfg.d_ff * 2
    for i in range(cfg.n_layers):
        a = g.add(f"blk{i}/attn", "attention", [prev], (batch, t, d),
                  flops=attn_flops, param_elems=4 * d * d + 6 * d)
        add1 = g.add(f"blk{i}/add1", "add", [a, prev], (batch, t, d))
        f = g.add(f"blk{i}/ffn", "mlp", [add1], (batch, t, d),
                  flops=mlp_flops, param_elems=2 * d * cfg.d_ff + cfg.d_ff + d)
        prev = g.add(f"blk{i}/add2", "add", [f, add1], (batch, t, d))
    extra = cfg.extra
    g.add("head", "dense", [prev], (batch, cfg.n_classes),
          flops=2 * batch * d * extra * cfg.n_classes,
          param_elems=d * extra * cfg.n_classes + extra * cfg.n_classes + 2 * d)
    g.validate()
    return g


def make_segments(params: Params, cfg: ViTConfig):
    from repro_torch.core.collab import Segment, SegmentedModel

    def patch_apply(p, img, *, qctx=None):
        return _patch_apply(p, img, cfg, qctx=qctx)

    def block(p, x, *, qctx=None):
        return block_apply(p, x, cfg, qctx=qctx)

    def head_apply(p, x, *, qctx=None):
        return _head_apply(p, x, cfg, qctx=qctx)

    segs = [Segment("patch", patch_apply,
                    {k: params[k] for k in ("patch", "cls", "pos")})]
    segs += [Segment(f"blk{i}/ffn", block, block_params(params, i))
             for i in range(cfg.n_layers)]
    segs.append(Segment("head", head_apply,
                        {k: params[k] for k in ("final_ln", "head")}))
    return SegmentedModel(name=cfg.name, graph=make_graph(cfg, batch=1),
                          segments=segs)
