"""AdamW, 8-bit AdamW and the cosine schedule, in PyTorch.

Counterpart of ``repro.train.optim`` with its arithmetic kept: moments
in f32 whatever the parameter dtype, bias corrections ``1 - b ** step``
in f32, ``lr=None`` meaning ``cfg.lr``, and the 8-bit state's int8
blocks of 128 along the last axis (one per-tensor scalar scale when the
last axis is not a multiple of 128), ``v`` rounded with the same signed
rule as ``m``.

Two departures, neither changing a number:

* **In place.**  The reference returns new trees (XLA reuses the
  donated buffers); here the updates write into ``params`` and the
  state's tensors and return them, since a full-width model cannot hold
  two copies of either.  The global-norm clip is folded into each
  leaf's update rather than materialized as a clipped copy of the
  gradients: ``(g.f32 * scale).to(g.dtype)`` per slice, as the
  reference's ``clip_by_global_norm`` computes it per leaf.
* **Layer at a time.**  A stacked ``[L, ...]`` leaf is updated one
  layer at a time, and a large rank-2 leaf in row blocks: the update is
  elementwise, and blockwise only along the last axis, so the slices
  give the whole leaf's numbers while the f32 temporaries stay one
  slice's size (deepseek-7b's ``mlp/wi`` is 1.35 G elements; one
  whole-leaf f32 temporary would be 5.4 GB).  A leaf whose 8-bit state
  has one per-tensor scale is updated whole.
  This is what the reference's disabled ``_maybe_layer_mapped`` meant
  to do.

Divisions by constants divide by a 0-dim tensor on the leaf's device:
on CUDA, torch turns a division by a Python number into a product with
its reciprocal, which the CPU and eager JAX do not.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Iterator, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.bridge import tree_leaves, tree_unflatten

Params = Any
LR = Union[float, torch.Tensor, None]

__all__ = ["AdamWState", "AdamWConfig", "AdamW8bitState", "adamw_init",
           "adamw_update", "adamw8bit_init", "adamw8bit_update",
           "global_norm", "clip_by_global_norm", "cosine_schedule"]

_QBLOCK = 128
_ROW_BLOCK_ELEMS = 1 << 26     # a large rank-2 leaf's row block


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32, 0-dim
    m: Params                  # f32, like params
    v: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamW8bitState(NamedTuple):
    step: torch.Tensor
    m_q: Params                # int8
    m_scale: Params            # f32, one per 128-block (or per tensor)
    v_q: Params
    v_scale: Params


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return _const(float(x), like.device)


def adamw_init(params: Params) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = lambda: tree_unflatten(params, [torch.zeros_like(
        p, dtype=torch.float32) for p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device),
                      m=zeros(), v=zeros())


def _slices(p: torch.Tensor) -> Iterator[Any]:
    """Leading-axis slices that partition ``p``: one per layer of a
    stacked leaf, row blocks of a large rank-2 leaf, else the whole."""
    if p.ndim >= 3:
        yield from range(p.shape[0])
    elif p.ndim == 2 and p.numel() > _ROW_BLOCK_ELEMS:
        rows = max(1, _ROW_BLOCK_ELEMS // p.shape[1])
        for r in range(0, p.shape[0], rows):
            yield slice(r, r + rows)
    else:
        yield ...


def _sumsq(leaf: torch.Tensor) -> torch.Tensor:
    """Σ leaf² in f32, slice by slice."""
    parts = [torch.sum(torch.square(leaf[s].to(torch.float32)))
             for s in _slices(leaf)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [_sumsq(l) for l in tree_leaves(tree)])))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(_f32(1.0, gnorm), _f32(max_norm, gnorm)
                         / torch.maximum(gnorm, _f32(1e-12, gnorm)))


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A gradient slice after the clip, in f32: the reference's clipped
    leaf ``(g.f32 * scale).astype(g.dtype)`` read back as f32."""
    return (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_unflatten(grads, [(g.to(torch.float32) * scale).to(g.dtype)
                                  for g in tree_leaves(grads)]), gnorm


def _corrections(step: torch.Tensor, cfg: AdamWConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    s = step.to(torch.float32)
    return (1.0 - torch.pow(_f32(cfg.b1, s), s),
            1.0 - torch.pow(_f32(cfg.b2, s), s))


def _begin(grads, state, cfg: AdamWConfig, lr: LR):
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state.step.add_(1)
    b1c, b2c = _corrections(state.step, cfg)
    return gnorm, scale, b1c, b2c, cfg.lr if lr is None else lr


def _new_param(p, m, v, b1c, b2c, lr, cfg: AdamWConfig) -> torch.Tensor:
    p32 = p.to(torch.float32)
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
        + cfg.weight_decay * p32
    return (p32 - lr * delta).to(p.dtype)


@torch.no_grad()
def adamw_update(grads: Params, state: AdamWState, params: Params,
                 cfg: AdamWConfig, lr: LR = None
                 ) -> Tuple[Params, AdamWState, torch.Tensor]:
    """One AdamW step, in place → (params, state, grad_norm)."""
    gnorm, scale, b1c, b2c, lr = _begin(grads, state, cfg, lr)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        for s in _slices(p):
            g32 = _clipped(g[s], scale)
            m[s] = cfg.b1 * m[s] + (1 - cfg.b1) * g32
            v[s] = cfg.b2 * v[s] + (1 - cfg.b2) * torch.square(g32)
            p[s] = _new_param(p[s], m[s], v[s], b1c, b2c, lr, cfg)
    return params, state, gnorm


# ---------------------------------------------------------------------------
# 8-bit AdamW (blockwise-quantized moments, Dettmers et al. 2021)
# ---------------------------------------------------------------------------


def _blockwise(shape) -> bool:
    return len(shape) > 0 and shape[-1] % _QBLOCK == 0


def _blockwise_quantize(x: torch.Tensor, *, signed: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 with one scale per 128-entry block of the last axis (scales
    shaped ``shape[:-1] + [n_blocks]``), or one 0-dim scale when the last
    axis is not a multiple of 128.  ``signed`` is unused, as in the
    reference: ``v`` rounds by the same rule as ``m``."""
    c127 = _f32(127.0, x)
    if not _blockwise(x.shape):
        scale = torch.amax(torch.abs(x)) / c127 + 1e-20
        return torch.round(x / scale).to(torch.int8), scale.reshape(())
    blocks = x.reshape(*x.shape[:-1], x.shape[-1] // _QBLOCK, _QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / c127 \
        + 1e-20
    q = torch.round(blocks / scale).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def _blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor
                          ) -> torch.Tensor:
    if scale.ndim == 0:
        return q.to(torch.float32) * scale
    blocks = q.reshape(*q.shape[:-1], q.shape[-1] // _QBLOCK, _QBLOCK)
    return (blocks.to(torch.float32) * scale[..., None]).reshape(q.shape)


def adamw8bit_init(params: Params) -> AdamW8bitState:
    """Zero moments: int8 zeros and scales of ``0 / 127 + 1e-20``, what
    the reference's quantization of zeros gives, made without the f32
    zeros."""
    leaves = tree_leaves(params)

    def q():
        return tree_unflatten(params, [torch.zeros_like(
            p, dtype=torch.int8) for p in leaves])

    def scales():
        return tree_unflatten(params, [torch.full(
            (*p.shape[:-1], p.shape[-1] // _QBLOCK) if _blockwise(p.shape)
            else (), 1e-20, dtype=torch.float32, device=p.device)
            for p in leaves])
    return AdamW8bitState(step=torch.zeros((), dtype=torch.int32,
                                           device=leaves[0].device),
                          m_q=q(), m_scale=scales(), v_q=q(),
                          v_scale=scales())


@torch.no_grad()
def adamw8bit_update(grads: Params, state: AdamW8bitState, params: Params,
                     cfg: AdamWConfig, lr: LR = None
                     ) -> Tuple[Params, AdamW8bitState, torch.Tensor]:
    """One 8-bit AdamW step, in place → (params, state, grad_norm)."""
    gnorm, scale, b1c, b2c, lr = _begin(grads, state, cfg, lr)
    for p, g, mq, ms, vq, vs in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.m_q),
            tree_leaves(state.m_scale), tree_leaves(state.v_q),
            tree_leaves(state.v_scale)):
        for s in (_slices(p) if _blockwise(p.shape) else [...]):
            g32 = _clipped(g[s], scale)
            m = cfg.b1 * _blockwise_dequantize(mq[s], ms[s]) \
                + (1 - cfg.b1) * g32
            v = cfg.b2 * _blockwise_dequantize(vq[s], vs[s]) \
                + (1 - cfg.b2) * torch.square(g32)
            p[s] = _new_param(p[s], m, v, b1c, b2c, lr, cfg)
            mq[s], ms[s] = _blockwise_quantize(m, signed=True)
            vq[s], vs[s] = _blockwise_quantize(v, signed=False)
    return params, state, gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``: ``lr(step)`` → a 0-dim f32 tensor on the step's
    device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = base_lr * s / _f32(max(warmup, 1), s)
        prog = torch.clamp((s - warmup) / _f32(max(total - warmup, 1), s),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr
