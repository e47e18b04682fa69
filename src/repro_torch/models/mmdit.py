"""Flux-dev-style MM-DiT rectified-flow transformer (BFL tech report).

Counterpart of ``repro.models.mmdit``: 19 double-stream blocks
(separate image and text streams, joint attention) and 38
single-stream blocks (fused stream), d_model=3072, 24 heads, ~12B
parameters; the conditioning vector (timestep ⊕ pooled text) drives
adaLN modulation.  Inputs are precomputed latent patches
[B, N_img, 64] and text embeddings [B, N_txt, 4096] (the reference's
stub frontend); 2D sin-cos embeddings on the image tokens, none on the
text.

The ``double`` and ``single`` leaves are stacked ``[L, ...]`` as the
reference's ``jax.vmap`` init builds them, so the weight bridge maps
them as they are; ``init_mmdit`` draws them a layer at a time (the
stacked f32 draw of the single blocks' ``in`` weights alone would be
10 GB).  The reference's ``lax.scan`` over blocks is a Python loop over
the views, each block recomputed in the backward pass with ``remat``
while autograd records.  ``scan_unroll`` and ``act_pspec`` are inert
here, kept so that configs read alike.  The layer norms are the
reference's: population variance, moments of a bf16 stream taken in
f32 (``layers._moments``); ``gelu`` is the tanh form.  Attention is the
eager ``einsum`` / f32 softmax / ``einsum`` of the reference, which
runs it outside any Pallas kernel.

Partition-analysis view: the double blocks carry two live residual
streams, so no interior single-blob cut exists; with ``max_blobs=2``
the double-block boundaries become candidates, and after the streams
merge the single blocks are ordinary 1-blob boundaries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import tree_flatten
from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantCtx
from repro_torch.models.transformer import layer_views, remat_active
from repro_torch.models.unet import timestep_embed

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    name: str
    n_double: int = 19
    n_single: int = 38
    d_model: int = 3072
    n_heads: int = 24
    img_res: int = 1024           # pixel; latent = /8, patch 2x2 of 16ch
    txt_len: int = 512
    txt_dim: int = 4096
    vec_dim: int = 768
    in_ch: int = 64               # 16 latent channels x 2x2 patch
    mlp_ratio: int = 4
    dtype: Any = torch.float32
    remat: bool = True
    scan_unroll: int = 1
    act_pspec: Optional[tuple] = None

    @property
    def n_img_tokens(self) -> int:
        return (self.img_res // 16) ** 2     # /8 VAE, /2 patch

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        d, m = self.d_model, self.mlp_ratio
        dbl = 2 * (4 * d * d + 4 * d + 2 * m * d * d + m * d + d
                   + 6 * d * d + 6 * d)          # per stream: attn+mlp+mod
        sgl = (3 + m) * d * d + (3 + m) * d + (d * (1 + m) * d) + d \
            + 3 * d * d + 3 * d                  # fused qkv+mlp_in, out, mod
        return (self.in_ch * d + d + self.txt_dim * d + d
                + self.vec_dim * d + d + 256 * d + d + d * d + d
                + self.n_double * dbl + self.n_single * sgl
                + d * 2 + 2 * d * self.in_ch + self.in_ch + self.in_ch)


def pos_embed_2d(n: int, d: int, dtype=torch.float32,
                 device: DeviceLike = "cpu") -> torch.Tensor:
    """Axial sin-cos embedding for an n-token square grid → [n, d]."""
    side = int(math.sqrt(n))
    half = d // 2
    quarter = half // 2
    freqs = 1.0 / (10000 ** (torch.arange(quarter, dtype=torch.float32,
                                          device=device) / quarter))
    pos = torch.arange(side, dtype=torch.float32, device=device)
    ang = torch.outer(pos, freqs)
    emb1d = torch.cat([torch.sin(ang), torch.cos(ang)], -1)   # [side, half]
    row = emb1d[:, None, :].expand(side, side, half)
    col = emb1d[None, :, :].expand(side, side, half)
    return torch.cat([row, col], -1).reshape(n, d).to(dtype)


def _mod_init(gen, vec_dim: int, d: int, n_mod: int, **kw) -> Params:
    return L.dense_init(gen, vec_dim, n_mod * d, bias=True, **kw)


def _mod(p: Params, vec: torch.Tensor, n_mod: int, d: int):
    """The ``n_mod`` modulation vectors [B, 1, d] of ``vec``."""
    m = L.dense(p, F.silu(vec))
    return torch.chunk(m[:, None, :], n_mod, dim=-1)


def double_block_init(gen, cfg: MMDiTConfig, *, device: DeviceLike = None
                      ) -> Params:
    d = cfg.d_model
    kw = dict(dtype=cfg.dtype, device=resolve_device(device))

    def stream():
        return {"attn": L.attention_init(gen, d, cfg.n_heads, cfg.n_heads,
                                         **kw),
                "mlp": L.mlp_init(gen, d, cfg.mlp_ratio * d, **kw),
                "mod": _mod_init(gen, d, d, 6, **kw)}
    return {"img": stream(), "txt": stream()}


def single_block_init(gen, cfg: MMDiTConfig, *, device: DeviceLike = None
                      ) -> Params:
    d, m = cfg.d_model, cfg.mlp_ratio
    kw = dict(dtype=cfg.dtype, device=resolve_device(device))
    return {"in": L.dense_init(gen, d, (3 + m) * d, bias=True, **kw),
            "out": L.dense_init(gen, (1 + m) * d, d, bias=True, **kw),
            "mod": _mod_init(gen, d, d, 3, **kw)}


def _stacked(init_one: Callable[[], Params], n: int) -> Params:
    """``n`` draws of ``init_one`` stacked on a leading ``[n]`` axis,
    one layer's tree alive at a time."""
    first = init_one()
    out = {}

    def alloc(tree, node):
        for k, v in tree.items():
            if isinstance(v, dict):
                alloc(v, node.setdefault(k, {}))
            else:
                node[k] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                      device=v.device)
                node[k][0] = v
    alloc(first, out)
    del first
    for i in range(1, n):
        layer = dict(tree_flatten(init_one()))
        for path, leaf in tree_flatten(out):
            leaf[i] = layer[path]
    return out


def init_mmdit(gen: torch.Generator, cfg: MMDiTConfig, *,
               device: DeviceLike = None) -> Params:
    """Random weights with the reference's distributions (fan-in scaled
    projections, zero biases), drawn from ``gen`` — which must live on
    ``device`` (default the card) — the stacked blocks a layer at a
    time."""
    dev = resolve_device(device)
    d = cfg.d_model
    kw = dict(dtype=cfg.dtype, device=dev)
    return {
        "img_in": L.dense_init(gen, cfg.in_ch, d, bias=True, **kw),
        "txt_in": L.dense_init(gen, cfg.txt_dim, d, bias=True, **kw),
        "vec_in": L.dense_init(gen, cfg.vec_dim, d, bias=True, **kw),
        "t_in": L.dense_init(gen, 256, d, bias=True, **kw),
        "t_in2": L.dense_init(gen, d, d, bias=True, **kw),
        "double": _stacked(lambda: double_block_init(gen, cfg, device=dev),
                           cfg.n_double),
        "single": _stacked(lambda: single_block_init(gen, cfg, device=dev),
                           cfg.n_single),
        "final_mod": _mod_init(gen, d, d, 2, **kw),
        "final": L.dense_init(gen, d, cfg.in_ch, bias=True, **kw),
    }


def _ln(x: torch.Tensor) -> torch.Tensor:
    """The reference's scale-free layer norm (eps 1e-6)."""
    mu, var = L._moments(x, (-1,))
    return (x - mu) * torch.rsqrt(var + 1e-6)


def _attend(qh, kh, vh, dtype) -> torch.Tensor:
    """[B, S, H, hd] each → [B, S, H·hd]; softmax in f32, probabilities
    cast to ``dtype``."""
    b, s, nh, hd = qh.shape
    att = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
    att = torch.softmax(att.to(torch.float32), -1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att, vh).reshape(b, s, nh * hd)


def _joint_attn(pi: Params, pt: Params, img: torch.Tensor,
                txt: torch.Tensor, vec: torch.Tensor, cfg: MMDiTConfig,
                qctx: Optional[QuantCtx], name: str):
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.hd
    b, _, _ = img.shape
    nt = txt.shape[1]
    (i_a, i_b, i_g, i_d, i_e, i_f) = _mod(pi["mod"], vec, 6, d)
    (t_a, t_b, t_g, t_d, t_e, t_f) = _mod(pt["mod"], vec, 6, d)
    zi = _ln(img) * (1 + i_a) + i_b
    zt = _ln(txt) * (1 + t_a) + t_b

    def qkv(p, z, nm):
        return [L.dense(p["attn"][w], z, qctx=qctx,
                        name=f"{nm}/{w[1]}").reshape(b, -1, nh, hd)
                for w in ("wq", "wk", "wv")]

    qi, ki, vi = qkv(pi, zi, f"{name}/img")
    qt, kt, vt = qkv(pt, zt, f"{name}/txt")
    o = _attend(torch.cat([qt, qi], 1), torch.cat([kt, ki], 1),
                torch.cat([vt, vi], 1), img.dtype)
    ot, oi = o[:, :nt], o[:, nt:]
    img = img + i_g * L.dense(pi["attn"]["wo"], oi, qctx=qctx,
                              name=f"{name}/img/o")
    txt = txt + t_g * L.dense(pt["attn"]["wo"], ot, qctx=qctx,
                              name=f"{name}/txt/o")
    img = img + i_f * L.mlp(pi["mlp"], _ln(img) * (1 + i_d) + i_e,
                            qctx=qctx, name=f"{name}/img/mlp")
    txt = txt + t_f * L.mlp(pt["mlp"], _ln(txt) * (1 + t_d) + t_e,
                            qctx=qctx, name=f"{name}/txt/mlp")
    return img, txt


def _single_block(p: Params, x: torch.Tensor, vec: torch.Tensor,
                  cfg: MMDiTConfig, qctx: Optional[QuantCtx], name: str
                  ) -> torch.Tensor:
    d, nh, hd, m = cfg.d_model, cfg.n_heads, cfg.hd, cfg.mlp_ratio
    b, n, _ = x.shape
    (a, bb, g) = _mod(p["mod"], vec, 3, d)
    z = _ln(x) * (1 + a) + bb
    h = L.dense(p["in"], z, qctx=qctx, name=f"{name}/in")
    qh, kh, vh, mlp_h = torch.split(h, [d, d, d, m * d], dim=-1)
    o = _attend(qh.reshape(b, n, nh, hd), kh.reshape(b, n, nh, hd),
                vh.reshape(b, n, nh, hd), x.dtype)
    fused = torch.cat([o, L._ACTS["gelu"](mlp_h)], dim=-1)
    return x + g * L.dense(p["out"], fused, qctx=qctx, name=f"{name}/out")


def mmdit_forward(params: Params, img_patches: torch.Tensor,
                  t: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor,
                  cfg: MMDiTConfig, *, qctx: Optional[QuantCtx] = None
                  ) -> torch.Tensor:
    """img_patches [B, N_img, 64], t [B], txt [B, N_txt, 4096],
    vec [B, 768] → velocity [B, N_img, 64] in ``cfg.dtype``.
    ``params["double"]`` and ``["single"]`` are stacked trees or lists
    of per-layer trees."""
    _, ni, _ = img_patches.shape
    d = cfg.d_model
    img = L.dense(params["img_in"], img_patches.to(cfg.dtype))
    img = img + pos_embed_2d(ni, d, cfg.dtype, img.device)[None]
    txt_h = L.dense(params["txt_in"], txt.to(cfg.dtype))
    temb = L.dense(params["t_in"], timestep_embed(t, 256).to(cfg.dtype))
    vec_h = L.dense(params["vec_in"], vec.to(cfg.dtype)) \
        + L.dense(params["t_in2"], F.silu(temb))

    def dbl(bp, img, txt_h):
        return _joint_attn(bp["img"], bp["txt"], img, txt_h, vec_h, cfg,
                           qctx, "dbl")

    for bp in layer_views(params["double"]):
        if remat_active(cfg.remat, img, bp):
            img, txt_h = checkpoint(dbl, bp, img, txt_h, use_reentrant=False)
        else:
            img, txt_h = dbl(bp, img, txt_h)

    x = torch.cat([txt_h, img], dim=1)

    def sgl(bp, x):
        return _single_block(bp, x, vec_h, cfg, qctx, "sgl")

    for bp in layer_views(params["single"]):
        x = (checkpoint(sgl, bp, x, use_reentrant=False)
             if remat_active(cfg.remat, x, bp) else sgl(bp, x))
    img = x[:, txt_h.shape[1]:]

    (sa, sb) = _mod(params["final_mod"], vec_h, 2, d)
    z = _ln(img) * (1 + sa) + sb
    return L.dense(params["final"], z)


def rf_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: MMDiTConfig, *, generator: torch.Generator
            ) -> torch.Tensor:
    """Rectified-flow velocity matching: v = x1 - x0 at
    x_t = (1-t)·x0 + t·x1, ``t`` and ``x1`` drawn from ``generator`` (on
    the latent's device); MSE in f32."""
    x0 = batch["latent"]                       # clean patches [B, N, 64]
    b = x0.shape[0]
    t = torch.rand((b,), generator=generator, device=x0.device)
    x1 = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                     device=x0.device)
    x_t = (1 - t[:, None, None]) * x0 + t[:, None, None] * x1
    v_pred = mmdit_forward(params, x_t, t * 1000, batch["txt"], batch["vec"],
                           cfg)
    v_true = x1 - x0
    return torch.mean(torch.square(v_pred.to(torch.float32)
                                   - v_true.to(torch.float32)))


def rf_step(params: Params, x_t: torch.Tensor, t: torch.Tensor,
            dt: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor,
            cfg: MMDiTConfig, *, qctx: Optional[QuantCtx] = None
            ) -> torch.Tensor:
    """One Euler step of the rectified-flow ODE (the denoise cell's
    unit)."""
    v = mmdit_forward(params, x_t, t * 1000, txt, vec, cfg, qctx=qctx)
    return x_t - dt[:, None, None] * v


def make_graph(cfg: MMDiTConfig, *, batch: int) -> LayerGraph:
    """Dual-stream region (double blocks) then single-stream region."""
    g = LayerGraph(cfg.name)
    d, ni, nt = cfg.d_model, cfg.n_img_tokens, cfg.txt_len
    n_all = ni + nt
    g.add("input", "input", [], (batch, ni, cfg.in_ch))
    g.add("img_in", "dense", ["input"], (batch, ni, d),
          flops=2 * batch * ni * cfg.in_ch * d, param_elems=cfg.in_ch * d + d)
    g.add("txt_in", "dense", ["input"], (batch, nt, d),
          flops=2 * batch * nt * cfg.txt_dim * d,
          param_elems=cfg.txt_dim * d + d, parametric=True)
    img_prev, txt_prev = "img_in", "txt_in"
    dbl_flops_stream = (2 * batch * ni * d * d * 4
                        + 2 * batch * ni * d * cfg.mlp_ratio * d * 2
                        + 2 * batch * cfg.n_heads * n_all * n_all * cfg.hd)
    dbl_params_stream = (4 * d * d + 2 * cfg.mlp_ratio * d * d + 6 * d * d)
    for i in range(cfg.n_double):
        ni_ = g.add(f"dbl{i}/img", "attention", [img_prev, txt_prev],
                    (batch, ni, d), flops=dbl_flops_stream,
                    param_elems=dbl_params_stream)
        nt_ = g.add(f"dbl{i}/txt", "attention", [txt_prev, img_prev],
                    (batch, nt, d), flops=dbl_flops_stream * nt // ni,
                    param_elems=dbl_params_stream)
        img_prev, txt_prev = ni_, nt_
    prev = g.add("merge", "concat", [txt_prev, img_prev], (batch, n_all, d))
    sgl_flops = (2 * batch * n_all * d * (3 + cfg.mlp_ratio) * d
                 + 2 * batch * n_all * (1 + cfg.mlp_ratio) * d * d
                 + 2 * batch * cfg.n_heads * n_all * n_all * cfg.hd)
    sgl_params = (3 + cfg.mlp_ratio) * d * d + (1 + cfg.mlp_ratio) * d * d \
        + 3 * d * d
    for i in range(cfg.n_single):
        prev = g.add(f"sgl{i}", "attention", [prev], (batch, n_all, d),
                     flops=sgl_flops, param_elems=sgl_params)
    g.add("final", "dense", [prev], (batch, ni, cfg.in_ch),
          flops=2 * batch * ni * d * cfg.in_ch,
          param_elems=d * cfg.in_ch + cfg.in_ch + 2 * d * d)
    g.validate()
    return g
