"""Weight bridge and parameter-tree helpers.

Parameters are a nested dict of tensors with stacked ``[L, ...]`` block
leaves, exactly as ``repro.models.transformer.init_lm`` builds them, so
the bridge from the JAX pytree (converted to numpy by the caller) is a
plain map over leaves."""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.quant import QuantParams
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["params_from_numpy", "qparams_from_numpy", "tree_map"]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (lists — the
    per-shard entries of a tensor-parallel group — map element by
    element)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16: move the raw bits and reinterpret
        bits = torch.tensor(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """JAX parameter pytree, already converted to numpy
    (``jax.tree_util.tree_map(np.asarray, params)``) → the port's nested
    dict of tensors on ``device``, value for value."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _to_tensor(leaf, dev), tree)


def qparams_from_numpy(qp: Any, device: DeviceLike = None) -> QuantParams:
    """Quantization parameters of the JAX package (any object with
    ``scale``, ``zero_point``, ``axis``, ``bits`` and ``signed``) → the
    port's ``QuantParams`` on ``device``, value for value."""
    dev = resolve_device(device)
    return QuantParams(scale=_to_tensor(qp.scale, dev),
                       zero_point=_to_tensor(qp.zero_point, dev),
                       axis=qp.axis, bits=qp.bits, signed=qp.signed)
