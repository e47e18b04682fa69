"""Decoder-only LM (llama-arch) of the port: RoPE + GQA attention +
SwiGLU blocks, RMSNorm, untied LM head.

Counterpart of the dense-LM part of ``repro.models.transformer``.  Block
parameters stay stacked (every leaf carries a leading ``[L]`` axis) so
the weight bridge is a plain map and block sub-ranges are views; the
JAX ``lax.scan`` over layers becomes a Python loop that writes each
layer's slice of the paged KV cache in place.  Only the paged cache
layouts (INT8 or fp pages) are ported; MoE blocks and the dense caches
come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.bridge import tree_map
from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantCtx

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_base: float = 10000.0
    dtype: torch.dtype = torch.float32      # params + compute dtype

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        return attn + 3 * d * self.d_ff + 2 * d


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_lm(cfg: LMConfig, generator: torch.Generator,
            device: DeviceLike = None) -> Params:
    """Random weights with the reference's distributions (normal ×
    1/√fan_in, unit norms, no biases; embedding normal × 0.02), drawn
    from ``generator`` — which must live on ``device``."""
    dev = resolve_device(device)
    d, hd, n = cfg.d_model, cfg.hd, cfg.n_layers
    kw = dict(dtype=cfg.dtype, device=dev)
    g = generator
    blocks = {
        "ln1": L.norm_init(d, layers=n, **kw),
        "attn": {"wq": L.dense_init(g, d, cfg.n_heads * hd, layers=n, **kw),
                 "wk": L.dense_init(g, d, cfg.n_kv * hd, layers=n, **kw),
                 "wv": L.dense_init(g, d, cfg.n_kv * hd, layers=n, **kw),
                 "wo": L.dense_init(g, cfg.n_heads * hd, d, layers=n, **kw)},
        "ln2": L.norm_init(d, layers=n, **kw),
        "mlp": {"wi": L.dense_init(g, d, cfg.d_ff, layers=n, **kw),
                "wg": L.dense_init(g, d, cfg.d_ff, layers=n, **kw),
                "wo": L.dense_init(g, cfg.d_ff, d, layers=n, **kw)},
    }
    return {"embed": L.embed_init(g, cfg.vocab, d, **kw),
            "blocks": blocks,
            "final_norm": L.norm_init(d, **kw),
            "lm_head": L.dense_init(g, d, cfg.vocab, **kw)}


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def block_apply(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                rope: Tuple[torch.Tensor, torch.Tensor],
                cache: Dict[str, torch.Tensor],
                cache_index: Union[int, torch.Tensor],
                block_tables: torch.Tensor,
                qctx: Optional[QuantCtx] = None,
                calibrate_kv: bool = False,
                kv_lengths: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h, new_cache = L.attention(
        p["attn"], L.rmsnorm(p["ln1"], x), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, rope=rope, kv_cache=cache, cache_index=cache_index,
        block_tables=block_tables, qctx=qctx, calibrate_kv=calibrate_kv,
        kv_lengths=kv_lengths)
    x = x + h
    z = L.rmsnorm(p["ln2"], x)
    return x + L.swiglu(p["mlp"], z, qctx=qctx), new_cache


# ---------------------------------------------------------------------------
# Serving: prefill + decode with a paged KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, *,
               quantized: bool = False, layers: Optional[int] = None,
               paged: bool = False, page_size: int = 16,
               num_pages: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Allocate a paged KV cache: ``{"k_pages", "v_pages"}`` of shape
    ``[L, num_pages, page_size, n_kv, hd]`` — INT8 with per-slot scales
    ``[L, batch, n_kv]`` when ``quantized``, else ``dtype`` (default
    ``cfg.dtype``).  Page 0 is the dump page idle slots write into."""
    if not paged:
        raise NotImplementedError(
            "dense KV caches are not ported yet (ROADMAP A6); pass "
            "paged=True")
    dev = resolve_device(device)
    n_layers = cfg.n_layers if layers is None else layers
    n_pages = num_pages if num_pages is not None else (
        batch * ((max_len + page_size - 1) // page_size) + 1)
    pdtype = torch.int8 if quantized else (dtype or cfg.dtype)
    shape = (n_layers, n_pages, page_size, cfg.n_kv, cfg.hd)
    c = {"k_pages": torch.zeros(shape, dtype=pdtype, device=dev),
         "v_pages": torch.zeros(shape, dtype=pdtype, device=dev)}
    if quantized:
        c["k_scale"] = torch.full((n_layers, batch, cfg.n_kv), 0.05,
                                  dtype=torch.float32, device=dev)
        c["v_scale"] = torch.full_like(c["k_scale"], 0.05)
    return c


def _n_layers(blocks: Params) -> int:
    return blocks["ln1"]["scale"].shape[0]


def run_blocks(blocks: Params, x: torch.Tensor, cfg: LMConfig, *,
               rope: Tuple[torch.Tensor, torch.Tensor],
               cache: Dict[str, torch.Tensor],
               cache_index: Union[int, torch.Tensor],
               block_tables: torch.Tensor,
               qctx: Optional[QuantCtx] = None,
               calibrate_kv: bool = False,
               kv_lengths: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run a sub-range of stacked blocks over hidden states, layer by
    layer, updating ``cache`` (one slice per layer) in place.  Returns
    ``(x, cache)``; the cache dict is the one passed in."""
    quantized = "k_scale" in cache
    for i in range(_n_layers(blocks)):
        bp = tree_map(lambda v: v[i], blocks)
        c = {k: v[i] for k, v in cache.items()}
        x, new_c = block_apply(bp, x, cfg, rope=rope, cache=c,
                               cache_index=cache_index,
                               block_tables=block_tables, qctx=qctx,
                               calibrate_kv=calibrate_kv,
                               kv_lengths=kv_lengths)
        if quantized and calibrate_kv:
            cache["k_scale"][i].copy_(new_c["k_scale"])
            cache["v_scale"][i].copy_(new_c["v_scale"])
    return x, cache


def lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final-norm + untied head over hidden states [B, S, D]."""
    return L.dense(params["lm_head"], L.rmsnorm(params["final_norm"], x))


def _rope_for(cfg: LMConfig, cache, block_tables, device):
    span = block_tables.shape[1] * cache["k_pages"].shape[2]
    return L.rope_table(span, cfg.hd, base=cfg.rope_base, dtype=cfg.dtype,
                        device=device)


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig, *,
            cache: Dict[str, torch.Tensor], block_tables: torch.Tensor,
            qctx: Optional[QuantCtx] = None,
            last_pos: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the full prompt; returns (last-token logits, cache).
    ``last_pos`` [B] is each row's last real token (bucket-padded
    prompts); an INT8 cache calibrates its per-slot scales here."""
    b, _ = tokens.shape
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    rope = _rope_for(cfg, cache, block_tables, tokens.device)
    x, cache = run_blocks(params["blocks"], x, cfg, rope=rope, cache=cache,
                          cache_index=0, block_tables=block_tables,
                          qctx=qctx, calibrate_kv=True,
                          kv_lengths=None if last_pos is None
                          else last_pos + 1)
    if last_pos is not None:
        x = x[torch.arange(b, device=x.device), last_pos.long()][:, None]
    else:
        x = x[:, -1:]
    return lm_head(params, x)[:, 0], cache


def decode_step(params: Params, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: torch.Tensor,
                cfg: LMConfig, *, block_tables: torch.Tensor,
                qctx: Optional[QuantCtx] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One autoregressive step: token [B] → logits [B, V]; ``cache_index``
    is the [B] vector of per-slot positions."""
    x = L.embed(params["embed"], token[:, None]).to(cfg.dtype)
    rope = _rope_for(cfg, cache, block_tables, token.device)
    x, cache = run_blocks(params["blocks"], x, cfg, rope=rope, cache=cache,
                          cache_index=cache_index, block_tables=block_tables,
                          qctx=qctx)
    return lm_head(params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Partition-analysis graph (paper §2.2 applied to a decoder stack)
# ---------------------------------------------------------------------------


def make_graph(cfg: LMConfig, *, batch: int, seq: int) -> LayerGraph:
    """Block-interior nodes carry the residual structure so the shortcut
    rule excludes them; block boundaries survive as candidates."""
    g = LayerGraph(cfg.name)
    d, hd = cfg.d_model, cfg.hd
    tok = batch * seq
    g.add("input", "input", [], (batch, seq))
    g.add("embed", "embed", ["input"], (batch, seq, d),
          param_elems=cfg.vocab * d, flops=0)
    prev = "embed"
    attn_proj_flops = 2 * tok * d * (cfg.n_heads * hd) * 2 \
        + 2 * tok * d * (cfg.n_kv * hd) * 2
    attn_sdpa_flops = 2 * batch * cfg.n_heads * seq * seq * hd * 2
    ffn_flops = 2 * tok * 3 * d * cfg.d_ff
    ffn_params = 3 * d * cfg.d_ff
    for i in range(cfg.n_layers):
        a = g.add(f"blk{i}/attn", "attention", [prev], (batch, seq, d),
                  flops=attn_proj_flops + attn_sdpa_flops,
                  param_elems=cfg.block_param_count() - ffn_params - 2 * d)
        add1 = g.add(f"blk{i}/add1", "add", [a, prev], (batch, seq, d))
        f = g.add(f"blk{i}/ffn", "mlp", [add1], (batch, seq, d),
                  flops=ffn_flops, param_elems=ffn_params + 2 * d)
        prev = g.add(f"blk{i}/add2", "add", [f, add1], (batch, seq, d))
    g.add("lm_head", "dense", [prev], (batch, seq, cfg.vocab),
          flops=2 * tok * d * cfg.vocab, param_elems=d * cfg.vocab + d)
    g.validate()
    return g
