"""Gradients routed straight into accumulation buffers.

The reference differentiates a pure loss and adds each microbatch's
gradient tree into a carried buffer (``lax.scan``).  Here each parameter
leaf enters the loss through ``_Into``: its forward is a view of the
leaf, its backward adds the incoming gradient into the matching slice of
a buffer and gives the leaf none.  A stacked ``[L, ...]`` block leaf
enters one layer at a time (the model's forward takes ``blocks`` as a
list of per-layer trees, ``models.transformer.layer_views``), so each
layer's gradient is added as soon as the backward pass produces it and
freed (the MM-DiT's ``double`` and ``single`` groups alike): no second whole-model gradient tree is ever held, which is what
lets deepseek-7b's 13.8 GB of bf16 gradients accumulate over
microbatches in place.  A buffer in the parameter dtype accumulates in
it (the reference's train cell); an f32 buffer accumulates in f32 (its
``Trainer``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.bridge import tree_leaves, tree_unflatten

Params = Any

__all__ = ["zeros_like_tree", "value_and_grad_into"]


class _Into(torch.autograd.Function):

    @staticmethod
    def forward(ctx, leaf, acc, index):
        ctx.acc, ctx.index = acc, index
        return leaf[index]

    @staticmethod
    def backward(ctx, g):
        ctx.acc[ctx.index].add_(g)
        return None, None, None


def _route(leaf: torch.Tensor, acc: torch.Tensor, index) -> torch.Tensor:
    return _Into.apply(leaf.detach().requires_grad_(), acc, index)


_STACKED = ("blocks", "double", "single")


def _routed(params: Dict[str, Any], acc: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` with every leaf routing its gradient into ``acc``; a
    top-level group of stacked ``[L, ...]`` leaves (``_STACKED``)
    becomes a list of per-layer trees."""
    out = {}
    for key, group in params.items():
        pl, al = tree_leaves(group), tree_leaves(acc[key])
        if key in _STACKED and isinstance(group, dict):
            out[key] = [tree_unflatten(group, [_route(p, a, i)
                                               for p, a in zip(pl, al)])
                        for i in range(pl[0].shape[0])]
        else:
            out[key] = tree_unflatten(group, [_route(p, a, ...)
                                              for p, a in zip(pl, al)])
    return out


def zeros_like_tree(params: Params, dtype: Optional[torch.dtype] = None
                    ) -> Params:
    """A zero buffer per leaf, in ``dtype`` or the leaf's own."""
    return tree_unflatten(params, [torch.zeros_like(p, dtype=dtype)
                                   for p in tree_leaves(params)])


def value_and_grad_into(loss_fn: Callable[[Params, Any], torch.Tensor],
                        params: Dict[str, Any], batch: Any,
                        acc: Dict[str, Any]) -> torch.Tensor:
    """``loss_fn(params, batch)``, with the gradient of every leaf of
    ``params`` (a dict of groups) added into ``acc`` (same tree) →
    the loss, detached.  ``params`` itself gets no gradient."""
    with torch.enable_grad():
        loss = loss_fn(_routed(params, acc), batch)
        loss.backward()
    return loss.detach()
