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

Tensor parallelism: ``attention`` and ``swiglu`` take either one
parameter dict or a list with one per tensor-parallel shard
(``serve.sharding``): each shard computes its heads' (or FFN columns')
share of the output from the whole input on its own device, and the
shards' partial outputs are summed by ``all_reduce_sum`` onto the
input's device.  One dict is the tp = 1 case of the same code.  Shards
run the fp cloud only: the edge's fake-quant lattice is computed over
whole weights and whole activations, which a shard does not see.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.quant import compute_qparams, fake_quant
from repro_torch.kernels.paged_attention import (paged_flash_mq_per_shard,
                                                 paged_multiquery_attention)
from repro_torch.serve.sharding import all_reduce_sum

Params = Dict[str, Any]
Sharded = Union[Params, List[Params]]


def shards(p: Any) -> list:
    """A tensor-parallel group's per-shard entries: a list as it is, one
    unsplit dict as the list of its single shard."""
    return p if isinstance(p, list) else [p]


def _shard_inputs(p: Sharded, qctx) -> list:
    parts = shards(p)
    if qctx is not None and len(parts) > 1:
        raise ValueError("tensor-parallel shards run the fp cloud only: "
                         "the fake-quant lattice needs whole weights")
    return parts


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


def swiglu(p: Sharded, x: torch.Tensor, *,
           qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """SwiGLU FFN; with a list of shards, each holds a slice of the
    ``wi``/``wg`` columns and the matching ``wo`` rows."""
    parts = []
    for sp in _shard_inputs(p, qctx):
        xs = x.to(sp["wi"]["w"].device)
        h = dense(sp["wi"], xs, qctx=qctx)
        g = F.silu(dense(sp["wg"], xs, qctx=qctx))
        parts.append(dense(sp["wo"], h * g, qctx=qctx))
    return all_reduce_sum(parts)[0]


# -- attention (paged KV cache) -----------------------------------------------


def attention(p: Sharded, x: torch.Tensor, *, n_heads: int, n_kv: int,
              rope: Tuple[torch.Tensor, torch.Tensor],
              kv_cache: Union[Dict[str, torch.Tensor],
                              List[Dict[str, torch.Tensor]]],
              cache_index: Union[int, torch.Tensor],
              block_tables: torch.Tensor,
              qctx: Optional[QuantCtx] = None,
              calibrate_kv: bool = False,
              kv_lengths: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Any]:
    """Causal GQA attention over a paged KV cache (``"k_pages"`` key):
    the new K/V are written into the block-table pages, then every query
    reads the pages back through the paged-attention kernel.
    ``cache_index`` is an int position shared by the batch (prefill) or
    a [B] tensor of per-slot positions (decode).  With a list of ``tp``
    shards, shard i holds the ``wq``/``wk``/``wv`` columns and ``wo``
    rows of kv heads ``[i·n_kv/tp, (i+1)·n_kv/tp)`` (and their query
    groups) and ``kv_cache`` is the list of the shards' own pools.  The
    dense caches come with a later slice (ROADMAP A5)."""
    parts = _shard_inputs(p, qctx)
    caches = shards(kv_cache)
    tp = len(parts)
    if len(caches) != tp:
        raise ValueError(f"{tp} attention shards but {len(caches)} caches")
    b, s, _ = x.shape
    n_heads, n_kv = n_heads // tp, n_kv // tp
    hd = parts[0]["wq"]["w"].shape[1] // n_heads
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
    qs, ks, vs = [], [], []
    for sp in parts:
        dev = sp["wq"]["w"].device
        xs, c, sn = x.to(dev), cos_q.to(dev), sin_q.to(dev)
        qh = dense(sp["wq"], xs, qctx=qctx).reshape(b, s, n_heads, hd)
        kh = dense(sp["wk"], xs, qctx=qctx).reshape(b, s, n_kv, hd)
        qs.append(apply_rope(qh, c, sn))
        ks.append(apply_rope(kh, c, sn))
        vs.append(dense(sp["wv"], xs, qctx=qctx).reshape(b, s, n_kv, hd))

    outs, new_caches = _paged_cache_attention(
        caches, qs, ks, vs, block_tables=block_tables,
        cache_index=cache_index, vec_index=vec_index,
        calibrate_kv=calibrate_kv, kv_lengths=kv_lengths, dtype=x.dtype)
    out = all_reduce_sum([dense(sp["wo"], o.reshape(b, s, n_heads * hd),
                                qctx=qctx)
                          for sp, o in zip(parts, outs)])[0]
    return out, (new_caches if isinstance(kv_cache, list)
                 else new_caches[0])


def _paged_cache_attention(caches: List[Dict[str, torch.Tensor]], qhs, khs,
                           vhs, *, block_tables: torch.Tensor,
                           cache_index: Union[int, torch.Tensor],
                           vec_index: bool, calibrate_kv: bool,
                           kv_lengths: Optional[torch.Tensor], dtype
                           ) -> Tuple[List[torch.Tensor],
                                      List[Dict[str, torch.Tensor]]]:
    """Write new K/V into block-table pages, then attend — per shard.

    ``qhs``/``khs``/``vhs``: one [B, S, H(, kv), D] post-RoPE tensor per
    shard, on that shard's device, beside its cache in ``caches``.  The
    pages are updated in place (the JAX reference returns updated
    copies and donates the old buffers); the returned dicts carry the
    same page tensors plus the scales used.  One shard reads through the
    front door (the reference's ``paged_attention`` path); several read
    through one tensor-parallel call, each shard launching the kernel
    over its own pool (the reference's ``paged_flash_mq_sharded``)."""
    reads, new_caches = [], []
    for cache, qh, kh, vh in zip(caches, qhs, khs, vhs):
        dev = kh.device
        bt = block_tables.to(dev)
        index = cache_index.to(dev) if vec_index else cache_index
        kv_len = None if kv_lengths is None else kv_lengths.to(dev)
        ks, vs, new_cache = _write_pages(cache, kh, vh, bt, index,
                                         vec_index, calibrate_kv, kv_len)
        # query i of row b sits at q_start[b] + i; ``kv_lengths`` (true
        # prompt lengths) keeps bucket padding out of a prefill's read,
        # and at decode the lengths include the token just written
        b, s = kh.shape[:2]
        start = index if vec_index else torch.full(
            (b,), int(index), dtype=torch.int32, device=dev)
        lengths = (start + s) if kv_len is None else kv_len
        reads.append((qh.to(torch.float32), cache["k_pages"],
                      cache["v_pages"], bt, lengths.to(torch.int32), start,
                      ks, vs))
        new_caches.append(new_cache)
    if len(reads) == 1:
        outs = [paged_multiquery_attention(*reads[0])]
    else:
        outs = paged_flash_mq_per_shard(*(list(a) for a in zip(*reads)))
    return [o.to(dtype) for o in outs], new_caches


def _write_pages(cache: Dict[str, torch.Tensor], kh, vh, block_tables,
                 cache_index, vec_index: bool, calibrate_kv: bool,
                 kv_lengths: Optional[torch.Tensor]):
    """Quantize (INT8 pages) and scatter one shard's new K/V into its
    pool → (k scale, v scale — None for fp pages — and the new cache
    dict)."""
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
    if not quantized:
        return None, None, new_cache
    new_cache["k_scale"], new_cache["v_scale"] = ks, vs
    return ks, vs, new_cache
