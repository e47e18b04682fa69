"""Layer library of the port (plain functions on tensors).

Counterpart of ``repro.models.layers``: every parametric layer threads
an optional ``QuantCtx`` so the edge prefix runs the paper's
mixed-precision mode — weights on the per-channel INT8 lattice, input
activations fake-quantized (per tensor, per row with ``act_axis=0``, or
at thresholds calibrated off-line) — while the cloud passes
``qctx=None`` and stays full precision.

Dtypes follow the JAX reference operation by operation: torch promotes
mixed operands the way JAX does (bf16 with f32 gives f32; a Python
scalar keeps the tensor's dtype), and where JAX's ``einsum`` promotes
its operands implicitly, ``dense`` does so explicitly.

The vision layers are NHWC with HWIO kernels, as in the reference:
``conv2d``, ``maxpool2d`` and ``avgpool2d`` pad explicitly where JAX's
``"SAME"`` pads more at the end, and ``conv2d`` and ``cnn_dense`` run an
f32 product on the card in true f32 (TF32 switched off for the call
only, ``full_f32``); the LM's ``dense`` and ``_sdpa`` leave the flags
alone, so the vision models call them inside ``full_f32``.
``groupnorm`` and ``layernorm`` write out the reference's arithmetic
(biased variance, moments of a bf16 tensor taken in f32 as ``jnp.mean``
and ``jnp.var`` take them).  ``attention`` has the LM's paged and dense
KV cache forms and the no-cache form of ViT and of the LM's forward.
``moe`` is the reference's token-choice top-k mixture of experts (the
static-capacity sort layout), with its ties, capacity drops and combine
order kept (see ``moe``).

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

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.quant import (MinMaxCalibrator, QuantParams,
                                    compute_qparams, fake_quant)
from repro_torch.kernels.paged_attention import (paged_flash_mq_per_shard,
                                                 paged_multiquery_attention)
from repro_torch.serve.sharding import all_reduce_sum

Params = Dict[str, Any]
Sharded = Union[Params, List[Params]]
_ACTS = {None: lambda x: x, "relu": F.relu, "tanh": torch.tanh,
         # jax.nn.gelu defaults to the tanh approximation
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


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
    """Edge quantization context: per-output-channel ``w_bits`` weights
    and ``a_bits`` activations whose ranges come from one of three
    modes, each activation keyed by the name its layer gives it:

    * ``"dynamic"`` — computed per call (the name is ignored).
      ``act_axis=0`` gives every batch row its own range — batched
      serving must use it, or one request's Eq.(1) lattice would depend
      on its neighbours;
    * ``"calib"`` — nothing is quantized; each named activation's
      min/max is recorded in ``recorder`` (the paper's off-line
      profiling step), and ``finalize_calibration`` turns them into
      thresholds;
    * ``"static"`` — the calibrated ``scales`` are replayed; a name
      with no threshold passes through unquantized.

    ``quantize_weights=False`` means the weights already sit on the
    deployment lattice (``serve.policy._CutBank``)."""
    a_bits: int = 8
    act_axis: Optional[int] = None
    quantize_weights: bool = True
    mode: str = "dynamic"
    w_bits: int = 8
    per_channel: bool = True
    scales: Optional[Dict[str, QuantParams]] = None
    recorder: Optional[Dict[str, MinMaxCalibrator]] = None

    def __post_init__(self):
        if self.mode not in ("dynamic", "static", "calib"):
            raise ValueError(f"unknown QuantCtx mode {self.mode!r}")

    def weight(self, w: torch.Tensor, name: Optional[str] = None
               ) -> torch.Tensor:
        if not self.quantize_weights:
            return w
        axis = w.ndim - 1 if self.per_channel else None
        return fake_quant(w, compute_qparams(w, axis=axis,
                                             bits=self.w_bits))

    def act(self, x: torch.Tensor, name: Optional[str] = None
            ) -> torch.Tensor:
        if self.mode == "calib":
            self.recorder.setdefault(
                name, MinMaxCalibrator(bits=self.a_bits)).observe(x)
            return x
        if self.mode == "static":
            qp = self.scales.get(name)
            if qp is None:
                return x
        else:
            qp = compute_qparams(x, axis=self.act_axis, bits=self.a_bits)
        return fake_quant(x, qp)

    def finalize_calibration(self) -> Dict[str, QuantParams]:
        if self.mode != "calib":
            raise ValueError("finalize_calibration needs mode='calib'")
        return {k: c.qparams() for k, c in self.recorder.items()}


def make_calib_ctx(**kw) -> QuantCtx:
    return QuantCtx(mode="calib", recorder={}, **kw)


def q(qctx: Optional[QuantCtx], name: str, x: torch.Tensor) -> torch.Tensor:
    return x if qctx is None else qctx.act(x, name)


def qw(qctx: Optional[QuantCtx], name: str, w: torch.Tensor
       ) -> torch.Tensor:
    return w if qctx is None else qctx.weight(w, name)


@contextlib.contextmanager
def full_f32(active: bool):
    """Switch TF32 off for cuDNN convolutions and for matmuls inside the
    block (when ``active``: an f32 product of the CNN path on the card)
    and restore the caller's settings afterwards, so no call changes the
    precision of later products in the process.  The flags are
    process-wide: a product on another thread meanwhile sees them off."""
    if not active:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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
               layers: Optional[int] = None, bias: bool = False) -> Params:
    """Dense layer, bias-free unless ``bias`` (the LM uses no biases, the
    CNNs do); ``layers`` stacks a leading ``[L]`` axis."""
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    p = {"w": _fan_in_init(gen, shape, d_in, dtype, device)}
    if bias:
        p["b"] = torch.zeros(shape[:-2] + (d_out,), dtype=dtype,
                             device=device)
    return p


def conv2d_init(gen, k: int, c_in: int, c_out: int, *, bias: bool = True,
                dtype=torch.float32, device) -> Params:
    """HWIO ``k × k`` kernel, fan-in scaled, and a zero bias."""
    p = {"w": _fan_in_init(gen, (k, k, c_in, c_out), k * k * c_in, dtype,
                           device)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def norm_init(dim: int, *, dtype, device, layers: Optional[int] = None,
              bias: bool = False) -> Params:
    """Unit ``scale``, and a zero ``b`` where ``bias`` (the LM's norms
    have none, the vision models' do: the reference's default)."""
    shape = (dim,) if layers is None else (layers, dim)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def attention_init(gen, d_model: int, n_heads: int, n_kv: int,
                   head_dim: Optional[int] = None, *, bias: bool = False,
                   dtype, device, layers: Optional[int] = None) -> Params:
    hd = head_dim or d_model // n_heads
    kw = dict(bias=bias, dtype=dtype, device=device, layers=layers)
    return {"wq": dense_init(gen, d_model, n_heads * hd, **kw),
            "wk": dense_init(gen, d_model, n_kv * hd, **kw),
            "wv": dense_init(gen, d_model, n_kv * hd, **kw),
            "wo": dense_init(gen, n_heads * hd, d_model, **kw)}


def _expert_init(gen, shape, fan_in: int, dtype, device,
                 layers: Optional[int]) -> torch.Tensor:
    """An expert leaf ``shape`` (``[E, a, b]``), stacked ``[L, ...]``
    where ``layers`` is given and drawn one layer at a time: a full-size
    stacked expert leaf is tens of GB, and drawing it whole in f32 first
    would need twice that again."""
    if layers is None:
        return _fan_in_init(gen, shape, fan_in, dtype, device)
    out = torch.empty((layers,) + tuple(shape), dtype=dtype, device=device)
    for i in range(layers):
        out[i] = _fan_in_init(gen, shape, fan_in, dtype, device)
    return out


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, *, dtype,
             device, layers: Optional[int] = None) -> Params:
    """The reference's MoE tree: ``router: {"w": [D, E]}``, ``wi``/``wg``
    ``[E, D, F]`` and ``wo`` ``[E, F, D]`` (each with a leading ``[L]``
    axis where ``layers`` is given); normal × 1/√D for the router and
    ``wi``/``wg``, × 1/√F for ``wo``."""
    kw = dict(dtype=dtype, device=device)
    return {"router": dense_init(gen, d_model, n_experts, layers=layers,
                                 **kw),
            "wi": _expert_init(gen, (n_experts, d_model, d_ff), d_model,
                               layers=layers, **kw),
            "wg": _expert_init(gen, (n_experts, d_model, d_ff), d_model,
                               layers=layers, **kw),
            "wo": _expert_init(gen, (n_experts, d_ff, d_model), d_ff,
                               layers=layers, **kw)}


def mlp_init(gen, d_model: int, d_ff: int, *, bias: bool = True, dtype,
             device, layers: Optional[int] = None) -> Params:
    kw = dict(bias=bias, dtype=dtype, device=device, layers=layers)
    return {"wi": dense_init(gen, d_model, d_ff, **kw),
            "wo": dense_init(gen, d_ff, d_model, **kw)}


def patch_embed_init(gen, patch: int, c_in: int, d_model: int, *,
                     dtype=torch.float32, device) -> Params:
    return conv2d_init(gen, patch, c_in, d_model, dtype=dtype, device=device)


def embed_init(gen, vocab: int, dim: int, *, dtype, device) -> Params:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return {"emb": (w * 0.02).to(dtype)}


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------


def dense(p: Params, x: torch.Tensor, *, qctx: Optional[QuantCtx] = None,
          name: str = "dense", act: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, plus ``b`` where the
    layer has one and then ``act``, on the edge's lattice when ``qctx``
    is given (activation ``{name}/in``, weight ``{name}/w``; a dynamic
    context keys nothing)."""
    w = p["w"]
    if qctx is not None:
        if qctx.mode == "dynamic":
            x, w = qctx.act(x), qctx.weight(w)
        else:
            x, w = qctx.act(x, f"{name}/in"), qctx.weight(w, f"{name}/w")
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt))
    if "b" in p:
        y = y + p["b"]
    return y if act is None else _ACTS[act](y)


def cnn_dense(p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    """``dense`` of the CNN path: an f32 product on the card in true f32
    (``full_f32``), as its convolutions."""
    with full_f32(x.is_cuda and x.dtype == torch.float32):
        return dense(p, x, **kw)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX's ``"SAME"``: ceil(size / stride) outputs, the odd pad cell at
    the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: Tuple[int, int], stride: int, padding: str
          ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """NHWC ``x`` → ((top, bottom), (left, right)) for ``"SAME"`` or
    ``"VALID"``."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', not "
                         f"{padding!r}")
    return (_same_pads(x.shape[1], k[0], stride),
            _same_pads(x.shape[2], k[1], stride))


def conv2d(p: Params, x: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME", qctx: Optional[QuantCtx] = None,
           name: str = "conv", act: Optional[str] = None,
           groups: int = 1) -> torch.Tensor:
    """NHWC input, HWIO kernel → NHWC, plus ``b`` and ``act``.  The
    NCHW view torch convolves is the channels-last layout of the same
    memory, so no copy is made; an uneven ``"SAME"`` pad is applied as
    explicit zeros."""
    x, w = q(qctx, f"{name}/in", x), qw(qctx, f"{name}/w", p["w"])
    (top, bottom), (left, right) = _pads(x, w.shape[:2], stride, padding)
    xn = x.permute(0, 3, 1, 2)
    pad = (top, left)
    if (top, left) != (bottom, right):
        xn = F.pad(xn, (left, right, top, bottom))
        pad = (0, 0)
    with full_f32(x.is_cuda and x.dtype == torch.float32):
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                     groups=groups)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"]
    return _ACTS[act](y)


def maxpool2d(x: torch.Tensor, *, window: int, stride: int,
              padding: str = "SAME") -> torch.Tensor:
    """NHWC max pool; pad cells are −inf (``reduce_window``'s init), an
    uneven ``"SAME"`` pad applied explicitly."""
    (top, bottom), (left, right) = _pads(x, (window, window), stride,
                                         padding)
    xn = x.permute(0, 3, 1, 2)
    pad = (top, left)
    if (top, left) != (bottom, right):
        xn = F.pad(xn, (left, right, top, bottom), value=-math.inf)
        pad = (0, 0)
    return F.max_pool2d(xn, window, stride, padding=pad).permute(0, 2, 3, 1)


def avgpool2d(x: torch.Tensor, *, window: int, stride: int,
              padding: str = "SAME") -> torch.Tensor:
    """NHWC average pool over the cells that are not padding: the
    window sums and the counts of real cells, each summed as the
    reference's two ``reduce_window`` calls sum them (pad cells are 0 in
    the first, absent from the second)."""
    (top, bottom), (left, right) = _pads(x, (window, window), stride,
                                         padding)
    pad = (left, right, top, bottom)

    def window_sums(t):                      # NCHW → [N, C, Ho, Wo]
        t = F.pad(t, pad).unfold(2, window, stride).unfold(3, window,
                                                           stride)
        return t.sum(dim=(-2, -1))
    s = window_sums(x.permute(0, 3, 1, 2))
    c = window_sums(torch.ones((1, 1) + x.shape[1:3], dtype=x.dtype,
                               device=x.device))
    return (s / c).permute(0, 2, 3, 1)


def _moments(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over ``dims`` (kept), in ``x``'s dtype;
    a half-precision ``x`` is reduced in f32, as ``jnp.mean`` and
    ``jnp.var`` do."""
    xf = x.to(torch.float32) if x.dtype in (torch.bfloat16,
                                            torch.float16) else x
    mu = torch.mean(xf, dim=dims, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=dims, keepdim=True)
    return mu.to(x.dtype), var.to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, *, eps: float = 1e-5
              ) -> torch.Tensor:
    mu, var = _moments(x, (-1,))
    y = (x - mu) * torch.rsqrt(var + eps) * p["scale"]
    return y + p["b"] if "b" in p else y


def groupnorm(p: Params, x: torch.Tensor, *, groups: int = 32,
              eps: float = 1e-5) -> torch.Tensor:
    """NHWC group norm over ``min(groups, c)`` contiguous channel
    groups."""
    n, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(n, h, w, g, c // g)
    mu, var = _moments(xg, (1, 2, 4))
    xg = (xg - mu) * torch.rsqrt(var + eps)
    y = xg.reshape(n, h, w, c) * p["scale"]
    return y + p["b"] if "b" in p else y


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
           qctx: Optional[QuantCtx] = None, name: str = "mlp"
           ) -> torch.Tensor:
    """SwiGLU FFN (projections named ``{name}/wi|wg|wo``); with a list of
    shards, each holds a slice of the ``wi``/``wg`` columns and the
    matching ``wo`` rows."""
    parts = []
    for sp in _shard_inputs(p, qctx):
        xs = x.to(sp["wi"]["w"].device)
        h = dense(sp["wi"], xs, qctx=qctx, name=f"{name}/wi")
        g = F.silu(dense(sp["wg"], xs, qctx=qctx, name=f"{name}/wg"))
        parts.append(dense(sp["wo"], h * g, qctx=qctx, name=f"{name}/wo"))
    return all_reduce_sum(parts)[0]


# -- mixture of experts ------------------------------------------------------


def _route(router: Params, xt: torch.Tensor, n_e: int, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice routing of ``xt`` [T, D] → (gates [T, K] renormalized
    over the top ``top_k``, expert indices [T, K], the Switch balance
    loss).  Logits in the promoted dtype of ``xt`` and the router (no
    ``QuantCtx``: the reference multiplies by ``router["w"]`` as it
    is), softmax in f32.  Ties go to the lower expert index, as
    ``lax.top_k`` breaks them: the first ``top_k`` of a stable
    descending sort (``torch.topk`` promises no order among ties)."""
    w = router["w"]
    dt = torch.promote_types(xt.dtype, w.dtype)
    logits = torch.matmul(xt.to(dt), w.to(dt))
    gates = torch.softmax(logits.float(), dim=-1)                 # [T, E]
    gate_s, idx_s = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_s[:, :top_k], idx_s[:, :top_k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(idx_k[:, 0], n_e).float().mean(0)
    aux = n_e * torch.sum(density * gates.mean(0))
    return gate_k, idx_k, aux


def moe_capacity(t: int, top_k: int, n_e: int,
                 capacity_factor: float) -> int:
    """Slots per expert for a call over ``t`` rows: the reference's
    Python expression (``t`` counts every row the call sees, idle slots
    and bucket padding included); the floor keeps small decode batches
    from dropping on routing collisions."""
    return max(int(capacity_factor * t * top_k / n_e), min(t * top_k, 32))


def moe_dispatch(idx_k: torch.Tensor, n_e: int,
                 cap: int) -> Dict[str, torch.Tensor]:
    """The reference's static-capacity layout of a routing ``idx_k``
    [T, K]: the (token, k) pairs sorted by expert with a stable sort,
    each expert's first ``cap`` of them in its ``cap`` slots.

    * ``tok_for_slot`` [E·C] — the token each slot gathers (a slot past
      its expert's group points where the reference's clipped index
      does; no token reads it back);
    * ``slot`` [E, C] — each slot's place in the sorted pairs,
      clipped to the last as the reference clips it;
    * ``order`` [T·K] — the stable sort;
    * ``pair_slot`` [T, K] — each pair's slot ``e·C + rank``, or -1
      where the pair fell past its expert's capacity (dropped).

    Group starts come from a ``searchsorted`` over the sorted experts:
    no atomics and no host sync."""
    t, k = idx_k.shape
    dev = idx_k.device
    flat_e = idx_k.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order].contiguous()
    experts = torch.arange(n_e, device=dev, dtype=sorted_e.dtype)
    starts = torch.searchsorted(sorted_e, experts)
    col = torch.arange(cap, device=dev)
    slot = torch.clamp(starts[:, None] + col[None, :], 0, t * k - 1)
    tok_for_slot = (order // k)[slot.reshape(-1)]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)
    rank = rank - starts[flat_e]
    pair_slot = torch.where(rank < cap, flat_e * cap + rank,
                            -1).reshape(t, k)
    return dict(tok_for_slot=tok_for_slot, order=order,
                pair_slot=pair_slot, slot=slot)


def _grouped_ffn(xt: torch.Tensor, gate_k: torch.Tensor,
                 idx_k: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                 wo: torch.Tensor, *, top_k: int,
                 capacity_factor: float) -> torch.Tensor:
    """Sort-based static-capacity grouped SwiGLU FFN, the reference's
    layout: each expert's first C pairs gathered into a dense
    [E, C, D] buffer, three batched products, gated, and combined per
    token.  The combine sums a token's contributions in slot order
    (expert-ascending) from zero in the output dtype, one
    elementwise add per k, as the reference's scatter-add into zeros
    runs on the CPU; no atomics, so a run repeats bit for bit on the
    card.  A dropped pair adds nothing (the reference gives its slot a
    gate of 0; here no token reads a slot past its expert's group)."""
    t, d = xt.shape
    n_e = wi.shape[0]
    cap = moe_capacity(t, top_k, n_e, capacity_factor)
    plan = moe_dispatch(idx_k, n_e, cap)
    gate_slot = gate_k.reshape(-1)[plan["order"][plan["slot"]]].to(xt.dtype)
    xe = xt[plan["tok_for_slot"]].reshape(n_e, cap, d)           # [E, C, D]
    dt = torch.promote_types(xe.dtype, wi.dtype)
    xe = xe.to(dt)
    h = torch.bmm(xe, wi.to(dt))
    g = F.silu(torch.bmm(xe, wg.to(dt)))
    ye = torch.bmm(h * g, wo.to(dt))                              # [E, C, D']
    ye = (ye * gate_slot[..., None]).reshape(n_e * cap, -1)
    # each token's pairs in slot order (its experts ascending), the
    # dropped ones (-1) first
    slots = torch.sort(plan["pair_slot"], dim=1).values
    parts = torch.where((slots >= 0)[..., None], ye[slots.clamp(min=0)], 0.0)
    out = torch.zeros_like(parts[:, 0])
    for j in range(top_k):
        out = out + parts[:, j]
    return out


def moe(p: Params, x: torch.Tensor, *, top_k: int,
        capacity_factor: float = 1.25, qctx: Optional[QuantCtx] = None,
        name: str = "moe") -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k mixture of experts, x [B, S, D] → ([B, S, D],
    the balance loss as a 0-dim f32 tensor).  The rows are routed
    together in ``B·S`` order, so at prefill a prompt's capacity drops
    depend on the other prompts of its call, as in the reference.  On
    the edge ``qctx`` puts ``wi``/``wg``/``wo`` on the weight lattice
    (the router and the expert inputs stay as they are, as in the
    reference).  The whole group runs on its weights' device: it is
    never split over tensor-parallel shards (``launch.shardings``)."""
    b, s, d = x.shape
    n_e = p["router"]["w"].shape[-1]
    xt = x.reshape(b * s, d)
    gate_k, idx_k, aux = _route(p["router"], xt, n_e, top_k)
    yt = _grouped_ffn(xt, gate_k, idx_k, qw(qctx, f"{name}/wi", p["wi"]),
                      qw(qctx, f"{name}/wg", p["wg"]),
                      qw(qctx, f"{name}/wo", p["wo"]), top_k=top_k,
                      capacity_factor=capacity_factor)
    return yt.reshape(b, s, -1), aux


def mlp(p: Params, x: torch.Tensor, *, act: str = "gelu",
        qctx: Optional[QuantCtx] = None, name: str = "mlp") -> torch.Tensor:
    h = dense(p["wi"], x, qctx=qctx, name=f"{name}/wi", act=act)
    return dense(p["wo"], h, qctx=qctx, name=f"{name}/wo")


def patch_embed(p: Params, img: torch.Tensor, *, patch: int,
                qctx: Optional[QuantCtx] = None,
                name: str = "patch") -> torch.Tensor:
    """A VALID ``patch × patch`` conv at stride ``patch`` → [B, HW, C]."""
    y = conv2d(p, img, stride=patch, padding="VALID", qctx=qctx, name=name)
    b, h, w, c = y.shape
    return y.reshape(b, h * w, c)


# -- attention ---------------------------------------------------------------


def _sdpa(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, *,
          causal: bool, q_offset: Union[int, torch.Tensor] = 0,
          q_chunk: Optional[int] = None) -> torch.Tensor:
    """q: [B, Sq, H, D], k/v: [B, Skv, H, D] (kv already head-repeated).
    With ``causal``, query i sits at ``q_offset + i`` (a scalar, or a
    [B] tensor of per-row offsets) and sees keys up to it.  The logits
    are softmaxed in f32 and the probabilities cast to ``v``'s dtype.

    ``q_chunk`` bounds the live score tensor to [B, H, chunk, Skv] by
    running the query blocks one after another (each at its own offset)
    when ``Sq`` is a multiple of it above it: the long-prefill shapes,
    whose whole [Sq, Skv] f32 scores would not fit device memory."""
    sq = qh.shape[1]
    if q_chunk is not None and sq > q_chunk and sq % q_chunk == 0:
        return torch.cat([_sdpa(qh[:, i:i + q_chunk], kh, vh, causal=causal,
                                q_offset=q_offset + i)
                          for i in range(0, sq, q_chunk)], dim=1)
    dt = torch.promote_types(qh.dtype, kh.dtype)
    scale = 1.0 / math.sqrt(qh.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.to(dt), kh.to(dt)) * scale
    if causal:
        sk = kh.shape[1]
        dev = qh.device
        qpos = torch.arange(sq, device=dev)
        kpos = torch.arange(sk, device=dev)
        if torch.is_tensor(q_offset) and q_offset.ndim == 1:
            qpos = qpos[None, :, None] + q_offset.to(dev)[:, None, None]
            mask = (kpos[None, None, :] <= qpos)[:, None]   # [B,1,Sq,Skv]
        else:
            mask = (kpos[None, :] <= qpos[:, None] + q_offset)[None, None]
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh)


def _rope_rows(rope, cache_index, s: int, device, cached: bool):
    """The cos/sin rows of ``s`` new tokens: from ``cache_index`` (an
    int or a 0-dim tensor shared by the batch, or a [B] tensor of
    per-row positions) when ``cached``, else positions ``0 .. s-1``."""
    cos, sin = rope
    if not cached:
        return cos[:s], sin[:s]
    if torch.is_tensor(cache_index) and cache_index.ndim == 1:
        tpos = cache_index[:, None] + torch.arange(s, device=device)[None]
        # an idle slot's stale position plus a verify block can run past
        # the table; JAX clamps such gather indices, and so does this
        tpos = torch.clamp(tpos, max=cos.shape[0] - 1)
        return cos[tpos], sin[tpos]                            # [B, S, ·]
    # ``dynamic_slice`` keeps the window inside the table
    rows = _window(cache_index, s, cos.shape[0], device)
    if isinstance(rows, slice):
        return cos[rows], sin[rows]
    return cos.index_select(0, rows), sin.index_select(0, rows)


def _window(cache_index, s: int, t_max: int, device):
    """The ``s`` positions from a scalar ``cache_index``, the start kept
    inside ``[0, t_max - s]`` as ``dynamic_slice`` keeps it: a slice for
    an int, an index tensor for a 0-dim tensor (no host read of it, so
    a decode step needs no sync and runs on the meta device)."""
    if torch.is_tensor(cache_index):
        i0 = torch.clamp(cache_index.to(device).long(), 0, t_max - s)
        return i0 + torch.arange(s, device=device)
    i0 = min(max(int(cache_index), 0), t_max - s)
    return slice(i0, i0 + s)


def _write_dense(cache: Dict[str, torch.Tensor], kh: torch.Tensor,
                 vh: torch.Tensor, cache_index, kv_scales, dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one layer's new K/V into its dense cache ``{"k", "v"}``
    ([B, T, n_kv, hd]) in place, then read the whole cache back at
    ``dtype`` → (k, v) over all T positions.

    An INT8 cache (``kv_scales``: the layer's per-kv-head scales [n_kv])
    quantizes on write, ``clip(round(k / scale), -127, 127)``, and
    dequantizes on read.  A scalar ``cache_index`` writes the S rows as
    one slice from it (``dynamic_update_slice``, whose start is kept
    inside the cache); a [B] one writes row b at ``cache_index[b] + i``.
    Positions past T (an idle slot's stale position plus a verify block)
    are dropped, as JAX's scatter drops them: such a write is sent to
    position T-1 carrying the value that position holds after the
    in-range writes, so it changes nothing (no host sync, no order
    among equal writes to depend on)."""
    if kv_scales is not None:
        ks, vs = kv_scales
        k_w = torch.clamp(torch.round(kh / ks[None, None, :, None]),
                          -127, 127).to(cache["k"].dtype)
        v_w = torch.clamp(torch.round(vh / vs[None, None, :, None]),
                          -127, 127).to(cache["v"].dtype)
    else:
        k_w, v_w = kh.to(cache["k"].dtype), vh.to(cache["v"].dtype)
    b, s = kh.shape[:2]
    t_max = cache["k"].shape[1]
    if torch.is_tensor(cache_index) and cache_index.ndim == 1:
        dev = kh.device
        ci = cache_index.to(dev).long()
        t = ci[:, None] + torch.arange(s, device=dev)[None]      # [B, S]
        oob = t >= t_max
        rows = torch.arange(b, device=dev)
        # the row's write that lands on T-1, where it has one
        last = torch.clamp(t_max - 1 - ci, 0, s - 1)
        reaches = (ci <= t_max - 1)[:, None, None]
        for name, new in (("k", k_w), ("v", v_w)):
            fill = torch.where(reaches, new[rows, last],
                               cache[name][:, t_max - 1])
            new = torch.where(oob[..., None, None], fill[:, None], new)
            cache[name].index_put_(
                (rows[:, None].expand(b, s), torch.clamp(t, max=t_max - 1)),
                new)
    else:
        rows = _window(cache_index, s, t_max, kh.device)
        if isinstance(rows, slice):
            cache["k"][:, rows] = k_w
            cache["v"][:, rows] = v_w
        else:
            cache["k"].index_copy_(1, rows, k_w)
            cache["v"].index_copy_(1, rows, v_w)
    if kv_scales is not None:
        return (cache["k"].to(dtype) * ks.to(dtype)[None, None, :, None],
                cache["v"].to(dtype) * vs.to(dtype)[None, None, :, None])
    return cache["k"].to(dtype), cache["v"].to(dtype)


def attention(p: Sharded, x: torch.Tensor, *, n_heads: int, n_kv: int,
              causal: bool = True,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_cache: Optional[Union[Dict[str, torch.Tensor],
                                       List[Dict[str, torch.Tensor]]]]
              = None,
              cache_index: Union[int, torch.Tensor, None] = None,
              block_tables: Optional[torch.Tensor] = None,
              qctx: Optional[QuantCtx] = None,
              calibrate_kv: bool = False,
              kv_lengths: Optional[torch.Tensor] = None,
              kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              q_chunk: Optional[int] = None,
              name: str = "attn",
              ) -> Tuple[torch.Tensor, Any]:
    """GQA attention → (output, new cache); projections named
    ``{name}/q|k|v|o`` (a calibrated edge keys its ranges by them).

    With no ``kv_cache`` (ViT, the LM's cacheless forward): ``_sdpa``
    over the sequence itself (``causal`` or not), RoPE at positions
    ``0 .. S-1`` when ``rope`` is given; the new cache is None.

    With a dense KV cache (``"k"`` key, [B, T, n_kv, hd]): the new K/V
    are written at ``cache_index`` (``_write_dense``; INT8 with the
    layer's ``kv_scales``), then every query attends over the whole
    cache through ``_sdpa`` with ``q_offset = cache_index``.

    With a paged KV cache (``"k_pages"`` key; the LM, always causal):
    the new K/V are written into the block-table pages, then every query
    reads the pages back through the paged-attention kernel.
    ``cache_index`` is an int position shared by the batch (prefill) or
    a [B] tensor of per-slot positions (decode).  With a list of ``tp``
    shards, shard i holds the ``wq``/``wk``/``wv`` columns and ``wo``
    rows of kv heads ``[i·n_kv/tp, (i+1)·n_kv/tp)`` (and their query
    groups) and ``kv_cache`` is the list of the shards' own pools; the
    dense forms take one unsplit dict (ROADMAP A16)."""
    if kv_cache is not None and "k_pages" in shards(kv_cache)[0]:
        return _paged_attention(p, x, n_heads=n_heads, n_kv=n_kv, rope=rope,
                                kv_cache=kv_cache, cache_index=cache_index,
                                block_tables=block_tables, qctx=qctx,
                                calibrate_kv=calibrate_kv,
                                kv_lengths=kv_lengths, name=name)
    parts = shards(p)
    if len(parts) != 1 or isinstance(kv_cache, list):
        raise NotImplementedError(
            "tensor-parallel shards over a dense KV cache or none are not "
            "ported (ROADMAP A16)")
    p = parts[0]
    b, s, _ = x.shape
    hd = p["wq"]["w"].shape[-1] // n_heads
    qh = dense(p["wq"], x, qctx=qctx, name=f"{name}/q").reshape(
        b, s, n_heads, hd)
    kh = dense(p["wk"], x, qctx=qctx, name=f"{name}/k").reshape(
        b, s, n_kv, hd)
    vh = dense(p["wv"], x, qctx=qctx, name=f"{name}/v").reshape(
        b, s, n_kv, hd)
    cached = kv_cache is not None and cache_index is not None
    if rope is not None:
        cos_q, sin_q = _rope_rows(rope, cache_index, s, x.device, cached)
        qh = apply_rope(qh, cos_q, sin_q)
        kh = apply_rope(kh, cos_q, sin_q)
    q_offset = 0
    if kv_cache is not None:
        kh, vh = _write_dense(kv_cache, kh, vh, cache_index, kv_scales,
                              x.dtype)
        q_offset = (cache_index.to(x.device) if torch.is_tensor(cache_index)
                    else int(cache_index))
    if n_kv != n_heads:
        kh = torch.repeat_interleave(kh, n_heads // n_kv, dim=2)
        vh = torch.repeat_interleave(vh, n_heads // n_kv, dim=2)
    out = _sdpa(qh, kh, vh, causal=causal, q_offset=q_offset,
                q_chunk=q_chunk).reshape(b, s, n_heads * hd)
    out = dense(p["wo"], out, qctx=qctx, name=f"{name}/o")
    return out, (None if kv_cache is None
                 else {"k": kv_cache["k"], "v": kv_cache["v"]})


def _paged_attention(p: Sharded, x: torch.Tensor, *, n_heads: int,
                     n_kv: int, rope, kv_cache, cache_index, block_tables,
                     qctx, calibrate_kv: bool, kv_lengths, name: str
                     ) -> Tuple[torch.Tensor, Any]:
    """``attention`` over a paged KV cache (see there), shard by shard."""
    parts = _shard_inputs(p, qctx)
    caches = shards(kv_cache)
    tp = len(parts)
    if len(caches) != tp:
        raise ValueError(f"{tp} attention shards but {len(caches)} caches")
    b, s, _ = x.shape
    n_heads, n_kv = n_heads // tp, n_kv // tp
    hd = parts[0]["wq"]["w"].shape[1] // n_heads
    vec_index = torch.is_tensor(cache_index) and cache_index.ndim == 1
    cos_q, sin_q = _rope_rows(rope, cache_index, s, x.device, True)
    qs, ks, vs = [], [], []
    for sp in parts:
        dev = sp["wq"]["w"].device
        xs, c, sn = x.to(dev), cos_q.to(dev), sin_q.to(dev)
        qh = dense(sp["wq"], xs, qctx=qctx, name=f"{name}/q").reshape(
            b, s, n_heads, hd)
        kh = dense(sp["wk"], xs, qctx=qctx, name=f"{name}/k").reshape(
            b, s, n_kv, hd)
        qs.append(apply_rope(qh, c, sn))
        ks.append(apply_rope(kh, c, sn))
        vs.append(dense(sp["wv"], xs, qctx=qctx, name=f"{name}/v").reshape(
            b, s, n_kv, hd))

    outs, new_caches = _paged_cache_attention(
        caches, qs, ks, vs, block_tables=block_tables,
        cache_index=cache_index, vec_index=vec_index,
        calibrate_kv=calibrate_kv, kv_lengths=kv_lengths, dtype=x.dtype)
    out = all_reduce_sum([dense(sp["wo"], o.reshape(b, s, n_heads * hd),
                                qctx=qctx, name=f"{name}/o")
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


@functools.lru_cache(maxsize=None)
def _inv127(device: torch.device) -> torch.Tensor:
    """f32 ``1/127`` as a 0-dim tensor on ``device``, made once a device."""
    return torch.tensor(1.0 / 127.0, dtype=torch.float32, device=device)


def _kv_scale(amax: torch.Tensor) -> torch.Tensor:
    """The INT8 KV pages' symmetric scale of a calibrated ``amax``.  The
    reference engines compute ``max(amax, 1e-6) / 127.0`` under
    ``jit``, where XLA takes an f32 quotient as the product with the f32
    reciprocal; so does this, on the card and on the CPU alike (torch's
    CPU divides, and would put an f32 scale one ulp off on a few rows).
    A bf16 ``amax`` keeps the division, which both devices' kernels
    already take as XLA does."""
    amax = torch.clamp(amax, min=1e-6)
    if amax.dtype == torch.float32:
        return amax * _inv127(amax.device)
    return amax / 127.0


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
            ks = _kv_scale(torch.amax(ak, dim=(1, 3)))
            vs = _kv_scale(torch.amax(av, dim=(1, 3)))
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
