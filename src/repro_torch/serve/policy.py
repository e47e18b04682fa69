"""The prequantized weight bank behind a collaborative cut.

Counterpart of ``_prequantize_blocks`` and ``_CutBank`` in
``repro.serve.policy``: the edge's INT8 deployment lattice is applied to
every weight leaf **once**, per layer (exactly the thresholds the
runtime would compute for each layer slice), so runtime contexts run
with ``QuantCtx(quantize_weights=False)``.  A bank built for
speculative rounds also holds the INT8 copy of every cut's cloud suffix,
which the edge drafts with.  The online ``AdaptivePolicy`` and the
admission policies come with the adaptive slice.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.bridge import tree_map
from repro_torch.models import transformer as TF

__all__ = ["_CutBank", "_prequantize_blocks"]


def _quantize_layers(leaf: torch.Tensor, deploy_qctx) -> torch.Tensor:
    """Apply ``deploy_qctx.weight`` to every ``[L]`` slice of a stacked
    leaf, writing into one preallocated stacked output."""
    out = None
    for i in range(leaf.shape[0]):
        w = deploy_qctx.weight(leaf[i])
        if out is None:
            out = torch.empty((leaf.shape[0],) + tuple(w.shape),
                              dtype=w.dtype, device=w.device)
        out[i] = w
    return leaf if out is None else out


def _prequantize_blocks(blocks: Dict[str, Any], deploy_qctx,
                        key: str = "") -> Dict[str, Any]:
    """Stacked block params → the same tree with every dense weight
    (the ``"w"`` leaves ``layers.dense`` routes through
    ``QuantCtx.weight``) on the deployment lattice (f32, as fake-quant
    returns it)."""
    if isinstance(blocks, dict):
        return {k: _prequantize_blocks(v, deploy_qctx, k)
                for k, v in blocks.items()}
    if key == "w":
        return _quantize_layers(blocks, deploy_qctx)
    return blocks


class _CutBank:
    """Prequantized weight bank for the cuts an engine may serve.

    The edge prefix of the deepest bank cut — with ``drafts``, the whole
    block stack — is quantized once (per block, so every cut shares the
    identical quantized blocks); every cut's (INT8-lattice edge prefix,
    fp cloud suffix, INT8-lattice draft suffix) is then views of the
    stacked leaves."""

    def __init__(self, params: Dict[str, Any], cfg: TF.LMConfig,
                 cuts: Iterable[int], deploy_qctx=None, *,
                 drafts: bool = False) -> None:
        self._cuts = tuple(sorted({int(c) for c in cuts}))
        if not all(0 <= c < cfg.n_layers for c in self._cuts):
            raise ValueError(f"cuts {self._cuts} outside [0, {cfg.n_layers})")
        self._fp = params["blocks"]
        self._drafts = drafts
        depth = cfg.n_layers if drafts else max(self._cuts) + 1
        quantized = tree_map(lambda v: v[:depth], self._fp)
        self._q = quantized if deploy_qctx is None \
            else _prequantize_blocks(quantized, deploy_qctx)

    def get(self, cut: int) -> Tuple[Dict[str, Any], Dict[str, Any],
                                      Optional[Dict[str, Any]]]:
        """(edge prefix @ INT8 lattice, cloud suffix @ fp, draft suffix
        copy @ INT8 lattice or None without ``drafts``) for ``cut``."""
        if cut not in self._cuts:
            raise KeyError(f"cut {cut} not in weight bank {self._cuts}")
        draft = (tree_map(lambda v: v[cut + 1:], self._q) if self._drafts
                 else None)
        return (tree_map(lambda v: v[:cut + 1], self._q),
                tree_map(lambda v: v[cut + 1:], self._fp), draft)
