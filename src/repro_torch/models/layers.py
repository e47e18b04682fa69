"""LM layer library of the port (plain functions on tensors).

Counterpart of the LM subset of ``repro.models.layers``: every
parametric layer threads an optional ``QuantCtx`` so the edge prefix
runs the paper's mixed-precision mode — weights on the per-channel INT8
lattice, input activations fake-quantized per row (``act_axis=0``) —
while the cloud passes ``qctx=None`` and stays full precision.

Dtypes follow the JAX reference operation by operation: torch promotes
mixed operands the way JAX does (bf16 with f32 gives f32; a Python
scalar keeps the tensor's dtype), and where JAX's ``einsum`` promotes
its operands implicitly, ``dense`` does so explicitly.

Only the paged KV cache form of ``attention`` is ported; the dense
caches, ``_sdpa``, MoE and the vision layers come with later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.quant import compute_qparams, fake_quant
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_multiquery_attention)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Quantization context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantCtx:
    """Dynamic-mode quantization context: per-output-channel INT8
    weights, ``a_bits`` activations with ranges computed per call (the
    reference's static/calibration modes come with training).
    ``act_axis=0`` gives every batch row its own activation range —
    batched serving must use it, or one request's Eq.(1) lattice would
    depend on its neighbours.  ``quantize_weights=False`` means the
    weights already sit on the deployment lattice
    (``serve.policy._CutBank``)."""
    a_bits: int = 8
    act_axis: Optional[int] = None
    quantize_weights: bool = True

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if not self.quantize_weights:
            return w
        return fake_quant(w, compute_qparams(w, axis=w.ndim - 1, bits=8))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        qp = compute_qparams(x, axis=self.act_axis, bits=self.a_bits)
        return fake_quant(x, qp)


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX reference; torch's RNG, so
# not the same numbers — the tests bridge JAX weights instead)
# ---------------------------------------------------------------------------


def _fan_in_init(gen: torch.Generator, shape, fan_in: int,
                 dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def dense_init(gen, d_in: int, d_out: int, *, dtype, device,
               layers: Optional[int] = None) -> Params:
    """Bias-free dense layer (the LM uses no biases); ``layers`` stacks a
    leading ``[L]`` axis."""
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    return {"w": _fan_in_init(gen, shape, d_in, dtype, device)}


def norm_init(dim: int, *, dtype, device,
              layers: Optional[int] = None) -> Params:
    shape = (dim,) if layers is None else (layers, dim)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def embed_init(gen, vocab: int, dim: int, *, dtype, device) -> Params:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return {"emb": (w * 0.02).to(dtype)}


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------


def dense(p: Params, x: torch.Tensor, *,
          qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """Bias-free ``x @ w`` in the promoted dtype of the two (the LM has
    no biases), on the edge's lattice when ``qctx`` is given."""
    w = p["w"]
    if qctx is not None:
        x, w = qctx.act(x), qctx.weight(w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1,
                     keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["scale"]


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["emb"][ids]


def rope_table(seq_len: int, head_dim: int, *, base: float = 10000.0,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)                               # [S, half]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [S, D/2] shared across the batch, or
    [B, S, D/2] per row (half-split layout)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def swiglu(p: Params, x: torch.Tensor, *,
           qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    h = dense(p["wi"], x, qctx=qctx)
    g = F.silu(dense(p["wg"], x, qctx=qctx))
    return dense(p["wo"], h * g, qctx=qctx)


# -- attention (paged KV cache) -----------------------------------------------


def attention(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
              rope: Tuple[torch.Tensor, torch.Tensor],
              kv_cache: Dict[str, torch.Tensor],
              cache_index: Union[int, torch.Tensor],
              block_tables: torch.Tensor,
              qctx: Optional[QuantCtx] = None,
              calibrate_kv: bool = False,
              kv_lengths: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal GQA attention over a paged KV cache (``"k_pages"`` key):
    the new K/V are written into the block-table pages, then every query
    reads the pages back through the paged-attention front door.
    ``cache_index`` is an int position shared by the batch (prefill) or
    a [B] tensor of per-slot positions (decode).  The dense caches come
    with a later slice (ROADMAP A5)."""
    b, s, _ = x.shape
    hd = p["wq"]["w"].shape[1] // n_heads
    qh = dense(p["wq"], x, qctx=qctx).reshape(b, s, n_heads, hd)
    kh = dense(p["wk"], x, qctx=qctx).reshape(b, s, n_kv, hd)
    vh = dense(p["wv"], x, qctx=qctx).reshape(b, s, n_kv, hd)
    vec_index = torch.is_tensor(cache_index) and cache_index.ndim == 1
    cos, sin = rope
    if vec_index:
        tpos = cache_index[:, None] + torch.arange(s, device=x.device)[None]
        # an idle slot's stale position plus a verify block can run past
        # the table; JAX clamps such gather indices, and so does this
        tpos = torch.clamp(tpos, max=cos.shape[0] - 1)
        cos_q, sin_q = cos[tpos], sin[tpos]                    # [B, S, ·]
    else:
        i0 = int(cache_index)
        cos_q, sin_q = cos[i0:i0 + s], sin[i0:i0 + s]
    qh = apply_rope(qh, cos_q, sin_q)
    kh = apply_rope(kh, cos_q, sin_q)

    out, new_cache = _paged_cache_attention(
        kv_cache, qh, kh, vh, block_tables=block_tables,
        cache_index=cache_index, vec_index=vec_index,
        calibrate_kv=calibrate_kv, kv_lengths=kv_lengths, dtype=x.dtype)
    out = out.reshape(b, s, n_heads * hd)
    return dense(p["wo"], out, qctx=qctx), new_cache


def _paged_cache_attention(cache: Dict[str, torch.Tensor], qh, kh, vh, *,
                           block_tables: torch.Tensor,
                           cache_index: torch.Tensor, vec_index: bool,
                           calibrate_kv: bool,
                           kv_lengths: Optional[torch.Tensor], dtype
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Write new K/V into block-table pages, then attend.

    qh/kh/vh: [B, S, H(, kv), D] post-RoPE.  The pages of ``cache`` are
    updated in place (the JAX reference returns updated copies and
    donates the old buffers); the returned dict carries the same page
    tensors plus the scales used."""
    b, s = kh.shape[:2]
    page_size = cache["k_pages"].shape[1]
    quantized = "k_scale" in cache
    dev = kh.device

    if quantized:
        if calibrate_kv:
            # per-slot Eq.(1) symmetric calibration from the prompt's own
            # K/V range, [B, n_kv]; bucket padding is masked out of it
            ak, av = torch.abs(kh), torch.abs(vh)
            if kv_lengths is not None:
                valid = (torch.arange(s, device=dev)[None, :]
                         < kv_lengths[:, None])[:, :, None, None]
                ak = torch.where(valid, ak, torch.zeros_like(ak))
                av = torch.where(valid, av, torch.zeros_like(av))
            ks = torch.clamp(torch.amax(ak, dim=(1, 3)), min=1e-6) / 127.0
            vs = torch.clamp(torch.amax(av, dim=(1, 3)), min=1e-6) / 127.0
        else:
            ks, vs = cache["k_scale"], cache["v_scale"]
        k_w = torch.clamp(torch.round(kh / ks[:, None, :, None]),
                          -127, 127).to(cache["k_pages"].dtype)
        v_w = torch.clamp(torch.round(vh / vs[:, None, :, None]),
                          -127, 127).to(cache["v_pages"].dtype)
    else:
        k_w = kh.to(cache["k_pages"].dtype)
        v_w = vh.to(cache["v_pages"].dtype)

    # logical position of every written token, [B, S]
    ar = torch.arange(s, device=dev)
    if vec_index:
        t = cache_index[:, None] + ar[None]
    else:
        t = (cache_index + ar)[None].expand(b, s)
    idx = t // page_size
    # an idle slot's stale position may point past the trimmed table; the
    # JAX scatter drops such writes, here they go to the dump page 0
    oob = idx >= block_tables.shape[1]
    idx = torch.clamp(idx, max=block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, idx.long())
    page = torch.where(oob, torch.zeros_like(page), page)
    off = (t % page_size).long()
    # in-place scatter into the pool: only idle slots repeat a target, and
    # they all write the dump page 0, which no live row ever reads — so
    # the order among repeated writes cannot matter
    cache["k_pages"].index_put_((page, off), k_w)
    cache["v_pages"].index_put_((page, off), v_w)

    new_cache = {"k_pages": cache["k_pages"], "v_pages": cache["v_pages"]}
    if quantized:
        new_cache["k_scale"], new_cache["v_scale"] = ks, vs
    kscale = ks if quantized else None
    vscale = vs if quantized else None

    if s == 1:
        # decode: lengths include the token just written
        vec = cache_index if vec_index else torch.full(
            (b,), int(cache_index), dtype=torch.int32, device=dev)
        out = paged_attention(qh[:, 0].to(torch.float32), cache["k_pages"],
                              cache["v_pages"], block_tables, vec + 1,
                              kscale, vscale)
        return out[:, None].to(dtype), new_cache

    # q-block read (multi-token prefill): query i of row b sits at
    # q_start[b] + i; ``kv_lengths`` (true prompt lengths) keeps bucket
    # padding out of the read
    start = cache_index if vec_index else torch.full(
        (b,), int(cache_index), dtype=torch.int32, device=dev)
    lengths = (start + s) if kv_lengths is None else kv_lengths
    out = paged_multiquery_attention(qh.to(torch.float32), cache["k_pages"],
                                     cache["v_pages"], block_tables,
                                     lengths.to(torch.int32), start, kscale,
                                     vscale)
    return out.to(dtype), new_cache
