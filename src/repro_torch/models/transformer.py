"""Decoder-only LM (llama-arch) of the port: RoPE + GQA attention +
SwiGLU or mixture-of-experts blocks, RMSNorm, untied LM head.

Counterpart of ``repro.models.transformer``.  Block parameters stay
stacked (every leaf carries a leading ``[L]`` axis) so the weight
bridge is a plain map and block sub-ranges are views; the JAX
``lax.scan`` over layers becomes a Python loop that writes each layer's
slice of the KV cache in place.  An MoE block (``LMConfig.moe``) holds
``"moe"`` where a dense block holds ``"mlp"``, the reference's tree;
``forward`` returns the blocks' summed balance loss beside the logits.
The cache layouts are the reference's: dense (fp, or INT8 with
per-(layer, kv-head) scales) and paged (fp or INT8 pages with per-slot
scales); ``forward`` is the cacheless causal pass, and ``make_segments``
the block-granular view the paper's ``CollaborativeEngine`` splits.
``lm_loss`` is the training loss; with ``LMConfig.remat`` the forward
recomputes each block in the backward pass (the reference's
``jax.checkpoint``), only while autograd records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import tree_leaves, tree_map
from repro_torch.core.collab import Segment, SegmentedModel
from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantCtx

Params = Dict[str, Any]
# a dense or paged KV cache, or the list of a tensor-parallel cloud's
# paged shard caches
Cache = Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


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
    moe: Optional[MoESpec] = None
    rope_base: float = 10000.0
    dtype: torch.dtype = torch.float32      # params + compute dtype
    q_chunk: Optional[int] = None   # query-block tiling of long prefills
    remat: bool = True              # recompute blocks in the backward pass

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def _attn_param_count(self) -> int:
        d, hd = self.d_model, self.hd
        return d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2

    def _ffn_param_count(self, experts: int) -> int:
        if not self.moe:
            return 3 * self.d_model * self.d_ff
        return (experts * 3 * self.d_model * self.d_ff
                + self.d_model * self.moe.n_experts)

    def block_param_count(self) -> int:
        e = self.moe.n_experts if self.moe else 1
        return self._attn_param_count() + self._ffn_param_count(e) \
            + 2 * self.d_model

    def block_active_param_count(self) -> int:
        """A block's parameters one token uses: the routed ``top_k``
        experts of an MoE block (the router whole)."""
        e = self.moe.top_k if self.moe else 1
        return self._attn_param_count() + self._ffn_param_count(e) \
            + 2 * self.d_model

    def param_count(self) -> int:
        return (self.vocab * self.d_model * 2 + self.d_model
                + self.n_layers * self.block_param_count())

    def active_param_count(self) -> int:
        return (self.vocab * self.d_model * 2 + self.d_model
                + self.n_layers * self.block_active_param_count())


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_lm(cfg: LMConfig, generator: torch.Generator,
            device: DeviceLike = None) -> Params:
    """Random weights with the reference's distributions (normal ×
    1/√fan_in, unit norms, no biases; embedding normal × 0.02), drawn
    from ``generator`` — which must live on ``device``.  An MoE block's
    expert leaves are drawn one layer at a time (``layers.moe_init``)."""
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
    }
    if cfg.moe:
        blocks["moe"] = L.moe_init(g, d, cfg.d_ff, cfg.moe.n_experts,
                                   layers=n, **kw)
    else:
        blocks["mlp"] = {"wi": L.dense_init(g, d, cfg.d_ff, layers=n, **kw),
                         "wg": L.dense_init(g, d, cfg.d_ff, layers=n, **kw),
                         "wo": L.dense_init(g, cfg.d_ff, d, layers=n, **kw)}
    return {"embed": L.embed_init(g, cfg.vocab, d, **kw),
            "blocks": blocks,
            "final_norm": L.norm_init(d, **kw),
            "lm_head": L.dense_init(g, d, cfg.vocab, **kw)}


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def block_apply(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                rope: Tuple[torch.Tensor, torch.Tensor],
                cache: Optional[Cache] = None,
                cache_index: Union[int, torch.Tensor, None] = None,
                block_tables: Optional[torch.Tensor] = None,
                qctx: Optional[QuantCtx] = None,
                kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                calibrate_kv: bool = False,
                kv_lengths: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """One block → (x, the cache, the block's balance loss: the MoE
    block's, a 0-dim f32 zero for a dense one)."""
    h, new_cache = L.attention(
        p["attn"], L.rmsnorm(p["ln1"], x), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, rope=rope, kv_cache=cache, cache_index=cache_index,
        block_tables=block_tables, qctx=qctx, calibrate_kv=calibrate_kv,
        kv_lengths=kv_lengths, kv_scales=kv_scales, q_chunk=cfg.q_chunk)
    x = x + h
    z = L.rmsnorm(p["ln2"], x)
    if cfg.moe:
        h, aux = L.moe(p["moe"], z, top_k=cfg.moe.top_k,
                       capacity_factor=cfg.moe.capacity_factor, qctx=qctx)
    else:
        h = L.swiglu(p["mlp"], z, qctx=qctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, new_cache, aux


def layer_views(blocks: Union[Params, List[Params]]) -> List[Params]:
    """Each block's parameters: views into the stacked ``[L]`` leaves
    (``unbind``, so a backward pass stacks the layers' gradients once
    instead of scattering each into a zeroed whole-stack tensor), or
    ``blocks`` itself when it is already a list of per-layer trees (the
    train cell's gradient-routing views, ``train.grads``)."""
    if isinstance(blocks, list):
        return blocks
    unbound = tree_map(lambda v: v.unbind(0), blocks)
    return [tree_map(lambda t, i=i: t[i], unbound)
            for i in range(tree_leaves(blocks)[0].shape[0])]


def remat_active(remat: bool, x: torch.Tensor, layer: Params) -> bool:
    """Whether to checkpoint a block: with ``remat``, and only while
    autograd records a gradient through it (serving runs it plainly)."""
    return (remat and torch.is_grad_enabled()
            and (x.requires_grad
                 or any(t.requires_grad for t in tree_leaves(layer))))


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig, *,
            qctx: Optional[QuantCtx] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward, no cache → (logits [B, S, V], aux loss).  The
    aux loss is the sum of the MoE blocks' balance terms, layer by layer
    from 0 (a 0-dim f32 tensor, as the reference's scan carries it; 0
    for dense blocks).  ``params["blocks"]`` is the stacked tree or a
    list of per-layer trees (``layer_views``)."""
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    rope = L.rope_table(s, cfg.hd, base=cfg.rope_base, dtype=cfg.dtype,
                        device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(layer, x):
        y, _, a = block_apply(layer, x, cfg, rope=rope, qctx=qctx)
        return y, a

    for layer in layer_views(params["blocks"]):
        if remat_active(cfg.remat, x, layer):
            x, a = checkpoint(block, layer, x, use_reentrant=False)
        else:
            x, a = block(layer, x)
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.dense(params["lm_head"], x, name="lm_head")
    return logits, aux


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[label]`` over every position,
    in f32 (the reference's cross-entropy)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig,
            *, aux_weight: float = 0.01,
            qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """Next-token loss: ``nll + aux_weight * aux / n_layers`` in f32
    (``batch``: ``tokens`` and ``labels`` [B, S])."""
    logits, aux = forward(params, batch["tokens"], cfg, qctx=qctx)
    return token_nll(logits, batch["labels"]) + aux_weight * aux \
        / cfg.n_layers


# ---------------------------------------------------------------------------
# Serving: prefill + decode with a KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, *,
               quantized: bool = False, layers: Optional[int] = None,
               paged: bool = False, page_size: int = 16,
               num_pages: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Allocate a KV cache in one of the reference's layouts:

    * **dense** (default): ``{"k", "v"}`` of shape
      ``[L, batch, max_len, n_kv, hd]`` at ``dtype`` (default
      ``cfg.dtype``) — every slot holds ``max_len`` positions;
    * **dense + ``quantized``**: the same shape at INT8 with
      per-(layer, kv-head) symmetric ``k_scale``/``v_scale`` ``[L, n_kv]``
      (0.05 each: nothing calibrates them, as in the reference);
    * **``paged``**: ``{"k_pages", "v_pages"}`` of shape
      ``[L, num_pages, page_size, n_kv, hd]`` — INT8 with per-slot
      scales ``[L, batch, n_kv]`` when ``quantized`` (calibrated from
      each prompt at prefill), else ``dtype``.  Page 0 is the dump page
      idle slots write into.

    ``layers`` overrides the leading layer axis (the edge prefix and the
    cloud suffix each cache only their own blocks)."""
    dev = resolve_device(device)
    n_layers = cfg.n_layers if layers is None else layers
    if not paged:
        shape = (n_layers, batch, max_len, cfg.n_kv, cfg.hd)
        kdtype = torch.int8 if quantized else (dtype or cfg.dtype)
        c = {"k": torch.zeros(shape, dtype=kdtype, device=dev),
             "v": torch.zeros(shape, dtype=kdtype, device=dev)}
        if quantized:
            c["k_scale"] = torch.full((n_layers, cfg.n_kv), 0.05,
                                      dtype=torch.float32, device=dev)
            c["v_scale"] = torch.full_like(c["k_scale"], 0.05)
        return c
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
               cache: Optional[Cache] = None,
               cache_index: Union[int, torch.Tensor, None] = None,
               block_tables: Optional[torch.Tensor] = None,
               qctx: Optional[QuantCtx] = None,
               calibrate_kv: bool = False,
               kv_lengths: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Run a sub-range of stacked blocks over hidden states, layer by
    layer.  With no ``cache``: the cacheless causal pass (positions
    ``0 .. S-1``); returns ``(x, None)``.  With a cache, each layer's
    slice is updated in place and the cache passed in is returned:
    a dense cache at a scalar ``cache_index`` (prefill) or a [B] one
    (decode, verify: row b's S tokens at ``cache_index[b] + i``), its
    INT8 scales handed to the layer as ``kv_scales`` (the reference
    pops them out of the scanned slice); a paged cache with
    ``block_tables``, calibrating its per-slot INT8 scales when
    ``calibrate_kv``.  Tensor-parallel blocks
    (``serve.sharding.shard_suffix_blocks``: ``attn``/``mlp`` lists of
    shards) take the list of the shards' paged caches; the norms and
    the residual stream stay on ``x``'s device."""
    for i in range(_n_layers(blocks)):
        bp = tree_map(lambda v: v[i], blocks)
        c = None if cache is None else tree_map(lambda v: v[i], cache)
        scales = None
        if isinstance(c, dict) and "k" in c and "k_scale" in c:
            scales = (c.pop("k_scale"), c.pop("v_scale"))
        x, new_c, _ = block_apply(bp, x, cfg, rope=rope, cache=c,
                                  cache_index=cache_index,
                                  block_tables=block_tables, qctx=qctx,
                                  kv_scales=scales,
                                  calibrate_kv=calibrate_kv,
                                  kv_lengths=kv_lengths)
        if calibrate_kv:
            for full, new in zip(L.shards(cache), L.shards(new_c)):
                if "k_scale" in full:
                    full["k_scale"][i].copy_(new["k_scale"])
                    full["v_scale"][i].copy_(new["v_scale"])
    return x, cache


def lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final-norm + untied head over hidden states [B, S, D].  A
    vocab-split head (a list of shards) gives each shard's logits on its
    device, concatenated in shard order on ``x``'s device, so an argmax
    breaks ties as over the whole head."""
    z = L.rmsnorm(params["final_norm"], x)
    return torch.cat([L.dense(h, z.to(h["w"].device)).to(x.device)
                      for h in L.shards(params["lm_head"])], dim=-1)


def _cache_span(cache: Cache,
                block_tables: Optional[torch.Tensor]) -> int:
    """Longest position the cache layout can address (the RoPE table's
    length)."""
    c = L.shards(cache)[0]
    if "k" in c:
        return c["k"].shape[2]
    return block_tables.shape[1] * c["k_pages"].shape[2]


def _rope_for(cfg: LMConfig, cache, block_tables, device):
    return L.rope_table(_cache_span(cache, block_tables), cfg.hd,
                        base=cfg.rope_base, dtype=cfg.dtype, device=device)


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig, *,
            cache: Cache, block_tables: Optional[torch.Tensor] = None,
            qctx: Optional[QuantCtx] = None,
            last_pos: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Cache]:
    """Process the full prompt; returns (last-token logits, cache).
    ``last_pos`` [B] is each row's last real token (bucket-padded
    prompts).  A paged cache needs ``block_tables`` and calibrates its
    per-slot INT8 scales here; a dense INT8 cache keeps its scales."""
    b, _ = tokens.shape
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    rope = _rope_for(cfg, cache, block_tables, tokens.device)
    x, cache = run_blocks(params["blocks"], x, cfg, rope=rope, cache=cache,
                          cache_index=0, block_tables=block_tables,
                          qctx=qctx,
                          calibrate_kv="k_pages" in L.shards(cache)[0],
                          kv_lengths=None if last_pos is None
                          else last_pos + 1)
    if last_pos is not None:
        x = x[torch.arange(b, device=x.device), last_pos.long()][:, None]
    else:
        x = x[:, -1:]
    return lm_head(params, x)[:, 0], cache


def decode_step(params: Params, token: torch.Tensor,
                cache: Cache, cache_index: Union[int, torch.Tensor],
                cfg: LMConfig, *,
                block_tables: Optional[torch.Tensor] = None,
                qctx: Optional[QuantCtx] = None,
                ) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step: token [B] → logits [B, V]; ``cache_index``
    is a scalar position shared by the batch or the [B] vector of
    per-slot positions (a paged cache takes the vector)."""
    x = L.embed(params["embed"], token[:, None]).to(cfg.dtype)
    rope = _rope_for(cfg, cache, block_tables, token.device)
    x, cache = run_blocks(params["blocks"], x, cfg, rope=rope, cache=cache,
                          cache_index=cache_index, block_tables=block_tables,
                          qctx=qctx)
    return lm_head(params, x)[:, 0], cache


def split_blocks(params: Params, cfg: LMConfig, cut_layer: int
                 ) -> Tuple[Params, Params]:
    """Split the stacked block params at the paper's partition point:
    (edge prefix = blocks[0..cut], cloud suffix = blocks[cut+1..L)), as
    views."""
    if not 0 <= cut_layer < cfg.n_layers:
        raise ValueError(f"cut_layer {cut_layer} outside [0, "
                         f"{cfg.n_layers})")

    def take(lo, hi):
        return tree_map(lambda v: v[lo:hi], params["blocks"])

    return take(0, cut_layer + 1), take(cut_layer + 1, cfg.n_layers)


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
    if cfg.moe:
        ffn_flops = 2 * tok * 3 * d * cfg.d_ff * cfg.moe.top_k \
            * cfg.moe.capacity_factor
    else:
        ffn_flops = 2 * tok * 3 * d * cfg.d_ff
    ffn_params = cfg._ffn_param_count(cfg.moe.n_experts if cfg.moe else 1)
    for i in range(cfg.n_layers):
        a = g.add(f"blk{i}/attn", "attention", [prev], (batch, seq, d),
                  flops=attn_proj_flops + attn_sdpa_flops,
                  param_elems=cfg.block_param_count() - ffn_params - 2 * d)
        add1 = g.add(f"blk{i}/add1", "add", [a, prev], (batch, seq, d))
        f = g.add(f"blk{i}/ffn", "moe" if cfg.moe else "mlp", [add1],
                  (batch, seq, d), flops=ffn_flops,
                  param_elems=ffn_params + 2 * d)
        prev = g.add(f"blk{i}/add2", "add", [f, add1], (batch, seq, d))
    g.add("lm_head", "dense", [prev], (batch, seq, cfg.vocab),
          flops=2 * tok * d * cfg.vocab, param_elems=d * cfg.vocab + d)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Collaborative-serving segments (block granularity)
# ---------------------------------------------------------------------------


def make_segments(params: Params, cfg: LMConfig, *, seq: int
                  ) -> SegmentedModel:
    """``SegmentedModel`` view for the paper's ``CollaborativeEngine``:
    embed → one segment per block → final norm and head, each cacheless
    (``forward``'s math, split).  A block's residual ``add2`` fuses into
    its ffn node (§2.2 rule 1), so the candidate point carrying the
    block boundary, and the segment's name, is ``blk{i}/ffn``.  Token
    ids stay integer through the embed segment; the RoPE table
    (``seq`` positions) follows each block's input to its device."""
    rope_const = L.rope_table(seq, cfg.hd, base=cfg.rope_base,
                              dtype=cfg.dtype,
                              device=params["embed"]["emb"].device)

    def embed_apply(p, tokens, *, qctx=None):
        return L.embed(p, tokens).to(cfg.dtype)

    def block_seg_apply(p, x, *, qctx=None):
        rope = tuple(t.to(x.device) for t in rope_const)
        return block_apply(p, x, cfg, rope=rope, qctx=qctx)[0]

    def head_apply(p, x, *, qctx=None):
        x = L.rmsnorm(p["final_norm"], x)
        return L.dense(p["lm_head"], x, qctx=qctx, name="lm_head")

    segs = [Segment("embed", embed_apply, params["embed"])]
    for i in range(cfg.n_layers):
        bp = tree_map(lambda v, i=i: v[i], params["blocks"])
        segs.append(Segment(f"blk{i}/ffn", block_seg_apply, bp))
    segs.append(Segment("lm_head", head_apply,
                        {"final_norm": params["final_norm"],
                         "lm_head": params["lm_head"]}))
    return SegmentedModel(name=cfg.name,
                          graph=make_graph(cfg, batch=1, seq=seq),
                          segments=segs)
