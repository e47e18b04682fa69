"""SD-1.5-style latent-diffusion U-Net (arXiv:2112.10752).

Counterpart of ``repro.models.unet``: ch=320, ch_mult=(1,2,4,4), 2 res
blocks per stage, cross-attention transformer blocks at downsample
factors 1, 2, 4 (not the deepest stage), epsilon-prediction, NHWC
activations and HWIO kernels, the same parameter names
(``down{s}_{b}/res``, ``mid/attn``, ``up{s}/us`` ...) and the same
``QuantCtx`` names (``{name}/c1``, ``/t``, ``/pi``, ``/q`` ...), so a
calibrated context keys the reference's ranges.

Kept from the reference, quirks included: each transformer block's
self-attention is built with 8 heads (``attention_init(c, 8, 8)``)
whatever ``n_heads`` is, and run with ``n_heads`` (equal in every
config); GroupNorm over ``min(32, c)`` groups; nearest 2× upsampling
(``jax.image.resize(..., "nearest")`` at exactly twice the size repeats
each cell); the cross-attention softmax in f32, cast back to the
activation dtype; ``q_chunk`` tiles the self-attention's queries.
With ``remat`` each res and transformer block is recomputed in the
backward pass while autograd records (the reference's
``jax.checkpoint``).  The attention here is the eager ``einsum`` /
softmax / ``einsum`` of the reference, which runs it outside any Pallas
kernel.

The noise schedule (``ddpm_schedule``) is torch's ``linspace`` and
``cumprod`` in f32: within 3e-7 of JAX's, not bit for bit (the two
round the product in other orders).

Partition-analysis view (paper §2.2 applied to a U-Net): the encoder's
long skip connections keep every interior encoder cut multi-blob, so
the only single-blob candidates are {conv_in, the post-bottleneck
points after each skip has been consumed, conv_out}.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantCtx
from repro_torch.models.transformer import remat_active

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    ch: int = 320
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    attn_stages: Tuple[int, ...] = (0, 1, 2)     # cross-attn at these stages
    ctx_dim: int = 768
    ctx_len: int = 77
    in_ch: int = 4
    n_heads: int = 8
    img_res: int = 512            # pixel space; latent = img_res // 8
    dtype: Any = torch.float32
    q_chunk: Optional[int] = None  # q-tiled self-attn for hi-res latents
    remat: bool = True             # checkpoint each res/attn block

    @property
    def latent_res(self) -> int:
        return self.img_res // 8

    @property
    def t_dim(self) -> int:
        return self.ch * 4


def timestep_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] timesteps → [B, dim] f32: cos then sin of ``t`` at ``dim / 2``
    geometric frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# -- res block ---------------------------------------------------------------


def res_block_init(gen, c_in: int, c_out: int, t_dim: int, *, dtype,
                   device) -> Params:
    kw = dict(dtype=dtype, device=device)
    p = {"n1": L.norm_init(c_in, bias=True, **kw),
         "conv1": L.conv2d_init(gen, 3, c_in, c_out, **kw),
         "temb": L.dense_init(gen, t_dim, c_out, bias=True, **kw),
         "n2": L.norm_init(c_out, bias=True, **kw),
         "conv2": L.conv2d_init(gen, 3, c_out, c_out, **kw)}
    if c_in != c_out:
        p["skip"] = L.conv2d_init(gen, 1, c_in, c_out, **kw)
    return p


def res_block(p: Params, x: torch.Tensor, temb: torch.Tensor, *,
              qctx: Optional[QuantCtx] = None, name: str = "res"
              ) -> torch.Tensor:
    h = L.conv2d(p["conv1"], F.silu(L.groupnorm(p["n1"], x)), qctx=qctx,
                 name=f"{name}/c1")
    h = h + L.dense(p["temb"], F.silu(temb), qctx=qctx,
                    name=f"{name}/t")[:, None, None, :]
    h = L.conv2d(p["conv2"], F.silu(L.groupnorm(p["n2"], h)), qctx=qctx,
                 name=f"{name}/c2")
    sc = x if "skip" not in p else L.conv2d(p["skip"], x, qctx=qctx,
                                            name=f"{name}/s")
    return sc + h


# -- cross-attn transformer block ---------------------------------------------


def xattn_block_init(gen, c: int, ctx_dim: int, *, dtype, device) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "gn": L.norm_init(c, bias=True, **kw),
        "proj_in": L.dense_init(gen, c, c, bias=True, **kw),
        "ln1": L.norm_init(c, bias=True, **kw),
        # the reference's 8 heads, whatever the config's n_heads
        "self": L.attention_init(gen, c, 8, 8, **kw),
        "ln2": L.norm_init(c, bias=True, **kw),
        "q": L.dense_init(gen, c, c, **kw),
        "k": L.dense_init(gen, ctx_dim, c, **kw),
        "v": L.dense_init(gen, ctx_dim, c, **kw),
        "xo": L.dense_init(gen, c, c, bias=True, **kw),
        "ln3": L.norm_init(c, bias=True, **kw),
        "ff": L.mlp_init(gen, c, 4 * c, **kw),
        "proj_out": L.dense_init(gen, c, c, bias=True, **kw),
    }


def xattn_block(p: Params, x: torch.Tensor, ctx: torch.Tensor, *,
                n_heads: int = 8, qctx: Optional[QuantCtx] = None,
                name: str = "tr", q_chunk: Optional[int] = None
                ) -> torch.Tensor:
    b, h, w, c = x.shape
    res = x
    z = L.groupnorm(p["gn"], x).reshape(b, h * w, c)
    z = L.dense(p["proj_in"], z, qctx=qctx, name=f"{name}/pi")
    sa, _ = L.attention(p["self"], L.layernorm(p["ln1"], z),
                        n_heads=n_heads, n_kv=n_heads, causal=False,
                        qctx=qctx, name=f"{name}/sa", q_chunk=q_chunk)
    z = z + sa
    # cross attention to the text context
    zq = L.layernorm(p["ln2"], z)
    hd = c // n_heads
    qh = L.dense(p["q"], zq, qctx=qctx, name=f"{name}/q").reshape(
        b, -1, n_heads, hd)
    kh = L.dense(p["k"], ctx, qctx=qctx, name=f"{name}/k").reshape(
        b, -1, n_heads, hd)
    vh = L.dense(p["v"], ctx, qctx=qctx, name=f"{name}/v").reshape(
        b, -1, n_heads, hd)
    att = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
    att = torch.softmax(att.to(torch.float32), -1).to(x.dtype)
    xa = torch.einsum("bhqk,bkhd->bqhd", att, vh).reshape(b, -1, c)
    z = z + L.dense(p["xo"], xa, qctx=qctx, name=f"{name}/xo")
    z = z + L.mlp(p["ff"], L.layernorm(p["ln3"], z), qctx=qctx,
                  name=f"{name}/ff")
    z = L.dense(p["proj_out"], z, qctx=qctx, name=f"{name}/po")
    return res + z.reshape(b, h, w, c)


# -- full U-Net ----------------------------------------------------------------


def _stage_ch(cfg: UNetConfig) -> List[int]:
    return [cfg.ch * m for m in cfg.ch_mult]


def init_unet(gen: torch.Generator, cfg: UNetConfig, *,
              device: DeviceLike = None) -> Params:
    """Random weights with the reference's distributions (fan-in scaled
    kernels, zero biases, unit norms), drawn from ``gen`` — which must
    live on ``device`` (default the card)."""
    dev = resolve_device(device)
    chs = _stage_ch(cfg)
    kw = dict(dtype=cfg.dtype, device=dev)
    p: Params = {
        "temb1": L.dense_init(gen, cfg.ch, cfg.t_dim, bias=True, **kw),
        "temb2": L.dense_init(gen, cfg.t_dim, cfg.t_dim, bias=True, **kw),
        "conv_in": L.conv2d_init(gen, 3, cfg.in_ch, cfg.ch, **kw),
    }
    c = cfg.ch
    for s, c_out in enumerate(chs):                       # encoder
        for b in range(cfg.n_res_blocks):
            p[f"down{s}_{b}/res"] = res_block_init(gen, c, c_out, cfg.t_dim,
                                                   **kw)
            c = c_out
            if s in cfg.attn_stages:
                p[f"down{s}_{b}/attn"] = xattn_block_init(gen, c,
                                                          cfg.ctx_dim, **kw)
        if s < len(chs) - 1:
            p[f"down{s}/ds"] = L.conv2d_init(gen, 3, c, c, **kw)
    p["mid/res1"] = res_block_init(gen, c, c, cfg.t_dim, **kw)
    p["mid/attn"] = xattn_block_init(gen, c, cfg.ctx_dim, **kw)
    p["mid/res2"] = res_block_init(gen, c, c, cfg.t_dim, **kw)
    # decoder: n_res_blocks + 1 per stage, consuming the skips
    for s in reversed(range(len(chs))):
        c_out = chs[s]
        for b in range(cfg.n_res_blocks + 1):
            c_skip = chs[s] if b < cfg.n_res_blocks else \
                (chs[s - 1] if s > 0 else cfg.ch)
            p[f"up{s}_{b}/res"] = res_block_init(gen, c + c_skip, c_out,
                                                 cfg.t_dim, **kw)
            c = c_out
            if s in cfg.attn_stages:
                p[f"up{s}_{b}/attn"] = xattn_block_init(gen, c,
                                                        cfg.ctx_dim, **kw)
        if s > 0:
            p[f"up{s}/us"] = L.conv2d_init(gen, 3, c, c, **kw)
    p["out_n"] = L.norm_init(c, bias=True, **kw)
    p["conv_out"] = L.conv2d_init(gen, 3, c, cfg.in_ch, **kw)
    return p


def _upsample2(h: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsampling of NHWC ``h``: cell (i, j) of the output is
    cell (i // 2, j // 2) of the input."""
    return h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def unet_forward(params: Params, x: torch.Tensor, t: torch.Tensor,
                 ctx: torch.Tensor, cfg: UNetConfig, *,
                 qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """x: [B, h, w, in_ch] latent; t: [B] timesteps; ctx: [B, 77, 768]
    → the predicted noise [B, h, w, in_ch] in ``cfg.dtype``."""
    chs = _stage_ch(cfg)
    temb = timestep_embed(t, cfg.ch).to(cfg.dtype)
    temb = L.dense(params["temb2"], F.silu(L.dense(params["temb1"], temb)))
    ctx = ctx.to(cfg.dtype)

    def res(p, h):
        return res_block(p, h, temb, qctx=qctx)

    def xattn(p, h):
        return xattn_block(p, h, ctx, n_heads=cfg.n_heads, qctx=qctx,
                           q_chunk=cfg.q_chunk)

    def run(fn, p, h):
        # recompute the block's interior (attention probabilities, GN
        # statistics) in the backward pass instead of keeping it
        if remat_active(cfg.remat, h, p):
            return checkpoint(fn, p, h, use_reentrant=False)
        return fn(p, h)

    h = L.conv2d(params["conv_in"], x.to(cfg.dtype), qctx=qctx,
                 name="conv_in")
    skips = [h]
    for s in range(len(chs)):
        for b in range(cfg.n_res_blocks):
            h = run(res, params[f"down{s}_{b}/res"], h)
            if s in cfg.attn_stages:
                h = run(xattn, params[f"down{s}_{b}/attn"], h)
            skips.append(h)
        if s < len(chs) - 1:
            h = L.conv2d(params[f"down{s}/ds"], h, stride=2, qctx=qctx,
                         name=f"down{s}/ds")
            skips.append(h)
    h = run(res, params["mid/res1"], h)
    h = run(xattn, params["mid/attn"], h)
    h = run(res, params["mid/res2"], h)
    for s in reversed(range(len(chs))):
        for b in range(cfg.n_res_blocks + 1):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = run(res, params[f"up{s}_{b}/res"], h)
            if s in cfg.attn_stages:
                h = run(xattn, params[f"up{s}_{b}/attn"], h)
        if s > 0:
            h = L.conv2d(params[f"up{s}/us"], _upsample2(h), qctx=qctx,
                         name=f"up{s}/us")
    h = F.silu(L.groupnorm(params["out_n"], h))
    return L.conv2d(params["conv_out"], h, qctx=qctx, name="conv_out")


# -- DDPM training / DDIM sampling ---------------------------------------------


def ddpm_schedule(n_steps: int = 1000, *, device: DeviceLike = "cpu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(betas, cumulative alphas), f32, on ``device``."""
    betas = torch.linspace(1e-4, 0.02, n_steps, dtype=torch.float32,
                           device=device)
    return betas, torch.cumprod(1.0 - betas, dim=0)


def diffusion_loss(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: UNetConfig, *, generator: torch.Generator
                   ) -> torch.Tensor:
    """batch: {latent [B, h, w, 4], ctx [B, 77, 768]}; eps-prediction MSE
    in f32, ``t`` and the noise drawn from ``generator`` (on the
    latent's device)."""
    x0 = batch["latent"]
    b = x0.shape[0]
    _, alphas = ddpm_schedule(device=x0.device)
    t = torch.randint(0, alphas.shape[0], (b,), generator=generator,
                      device=x0.device)
    eps = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                      device=x0.device)
    a = alphas[t][:, None, None, None]
    x_t = torch.sqrt(a) * x0 + torch.sqrt(1 - a) * eps
    pred = unet_forward(params, x_t, t, batch["ctx"], cfg)
    return torch.mean(torch.square(pred.to(torch.float32)
                                   - eps.to(torch.float32)))


def ddim_step(params: Params, x_t: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor, ctx: torch.Tensor, cfg: UNetConfig, *,
              qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """One deterministic DDIM sampler step (the denoise cell's unit); a
    negative ``t_prev`` steps to the clean sample (alpha 1)."""
    _, alphas = ddpm_schedule(device=x_t.device)
    eps = unet_forward(params, x_t, t, ctx, cfg, qctx=qctx)
    a_t = alphas[t.long()][:, None, None, None]
    a_p = torch.where(t_prev >= 0, alphas[torch.clamp(t_prev, min=0).long()],
                      torch.ones((), dtype=alphas.dtype, device=x_t.device)
                      )[:, None, None, None]
    x0 = (x_t - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_p) * x0 + torch.sqrt(1 - a_p) * eps


# -- partition graph -------------------------------------------------------------


def make_graph(cfg: UNetConfig, *, batch: int,
               latent_res: Optional[int] = None) -> LayerGraph:
    """Stage-level graph with explicit long skips (encoder→decoder)."""
    r = latent_res or cfg.latent_res
    chs = _stage_ch(cfg)
    g = LayerGraph(cfg.name)
    g.add("input", "input", [], (batch, r, r, cfg.in_ch))
    prev = g.add("conv_in", "conv", ["input"], (batch, r, r, cfg.ch),
                 flops=2 * batch * r * r * 9 * cfg.in_ch * cfg.ch,
                 param_elems=9 * cfg.in_ch * cfg.ch + cfg.ch)
    skip_nodes = []
    c = cfg.ch
    for s, c_out in enumerate(chs):
        n_attn = 1 if s in cfg.attn_stages else 0
        flops = (2 * batch * r * r * (9 * c * c_out + 9 * c_out * c_out)
                 * cfg.n_res_blocks
                 + n_attn * 2 * batch * (r * r) ** 2 * c_out * 2)
        pcount = cfg.n_res_blocks * (9 * c * c_out + 9 * c_out ** 2
                                     + cfg.t_dim * c_out) \
            + n_attn * (8 * c_out ** 2 + 2 * c_out * cfg.ctx_dim
                        + 8 * c_out ** 2)
        prev = g.add(f"down{s}", "conv", [prev], (batch, r, r, c_out),
                     flops=flops, param_elems=int(pcount))
        skip_nodes.append(prev)      # one skip edge per stage (stage-level IR)
        c = c_out
        if s < len(chs) - 1:
            r //= 2
            prev = g.add(f"down{s}/ds", "conv", [prev], (batch, r, r, c),
                         flops=2 * batch * r * r * 9 * c * c,
                         param_elems=9 * c * c + c)
    prev = g.add("mid", "conv", [prev], (batch, r, r, c),
                 flops=2 * batch * r * r * (18 * c * c) + 2 * batch
                 * (r * r) ** 2 * c * 2,
                 param_elems=18 * c * c + 16 * c * c)
    for s in reversed(range(len(chs))):
        c_out = chs[s]
        sk = skip_nodes.pop() if skip_nodes else None
        inputs = [prev] + ([sk] if sk else [])
        flops = (2 * batch * r * r * (9 * 2 * c * c_out + 9 * c_out ** 2)
                 * (cfg.n_res_blocks + 1))
        prev = g.add(f"up{s}", "conv", inputs, (batch, r, r, c_out),
                     flops=flops,
                     param_elems=(cfg.n_res_blocks + 1)
                     * (18 * c * c_out + cfg.t_dim * c_out))
        c = c_out
        if s > 0:
            r *= 2
    g.add("conv_out", "conv", [prev], (batch, r, r, cfg.in_ch),
          flops=2 * batch * r * r * 9 * c * cfg.in_ch,
          param_elems=9 * c * cfg.in_ch + cfg.in_ch)
    g.validate()
    return g
