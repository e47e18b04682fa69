"""INT8 gradient compression with error feedback (the paper's Eq.(1)/(2)
scalar quantization applied to the gradient all-reduce instead of the
activations).  Counterpart of ``repro.train.grad_compress``:

    c_t   = Q(g_t + e_t)            # int8 per leaf, symmetric, per tensor
    e_t+1 = (g_t + e_t) - Q⁻¹(c_t)  # residual carried to the next step

The all-reduce then moves 1 byte a gradient element instead of 4 (plus 8
bytes of scale a leaf); error feedback keeps SGD converging.  The
lattices are ``core.quant``'s, bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.bridge import tree_leaves, tree_unflatten
from repro_torch.core.quant import (QuantParams, compute_qparams,
                                    dequantize, quantize)

Params = Any

__all__ = ["init_error_feedback", "compress", "decompress",
           "compress_with_feedback", "compressed_allreduce_bytes"]


def init_error_feedback(params: Params) -> Params:
    return tree_unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                   for p in tree_leaves(params)])


def _compress_leaf(g: torch.Tensor, bits: int
                   ) -> Tuple[torch.Tensor, QuantParams]:
    g = g.to(torch.float32)
    qp = compute_qparams(g, bits=bits, symmetric=True)
    return quantize(g, qp), qp


def compress(tree: Params, *, bits: int = 8) -> Tuple[Params, Params]:
    """Per-leaf symmetric quantization → (int8 tree, qparams tree)."""
    pairs = [_compress_leaf(g, bits) for g in tree_leaves(tree)]
    return (tree_unflatten(tree, [q for q, _ in pairs]),
            tree_unflatten(tree, [qp for _, qp in pairs]))


def decompress(q_tree: Params, qp_tree: Params) -> Params:
    """Eq.(2) per leaf (a ``QuantParams`` is one leaf of ``qp_tree``)."""
    return tree_unflatten(q_tree, [dequantize(q, qp) for q, qp in zip(
        tree_leaves(q_tree), tree_leaves(qp_tree))])


@torch.no_grad()
def compress_with_feedback(grads: Params, error: Params, *, bits: int = 8
                           ) -> Tuple[Params, Params]:
    """→ (the gradients as transmitted, decompressed; the new error
    state), a leaf at a time."""
    sent, new_error = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        corrected = g.to(torch.float32) + e
        q, qp = _compress_leaf(corrected, bits)
        t = dequantize(q, qp)
        sent.append(t)
        new_error.append(corrected - t)
    return tree_unflatten(grads, sent), tree_unflatten(grads, new_error)


def compressed_allreduce_bytes(params: Params, *, bits: int = 8
                               ) -> Tuple[int, int]:
    """(fp32 all-reduce bytes, compressed bytes) for the wire model."""
    leaves = tree_leaves(params)
    n = sum(int(p.numel()) for p in leaves)
    return n * 4, n * bits // 8 + len(leaves) * 8
