"""Weight bridge and parameter-tree helpers.

Parameters are a nested dict of tensors with stacked ``[L, ...]`` block
leaves, exactly as ``repro.models.transformer.init_lm`` builds them, so
the bridge from the JAX pytree (converted to numpy by the caller) is a
plain map over leaves.

``tree_flatten`` walks a tree in JAX's order (dict keys sorted,
sequences and named-tuple fields in order, ``None`` no leaf) and names
each leaf by JAX's ``keystr`` path (``['blocks']['attn']['wq']``,
``.m['w']``), so a checkpoint's manifest and the optimizer's leaf order
are the reference's."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QuantParams
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["params_from_numpy", "qparams_from_numpy", "opt_state_from_numpy",
           "tree_map", "tree_flatten", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (lists — the
    per-shard entries of a tensor-parallel group — map element by
    element)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any):
    """(key string, child) pairs of an inner node in JAX's order, or
    ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def tree_flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for k, v in kids for pl in tree_flatten(v, prefix + k)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (an iterable, in
    ``tree_flatten``'s order)."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(like: Any, it: Iterator) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        built = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: built[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(getattr(like, f), it)
                            for f in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


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


def opt_state_from_numpy(state: Any, device: DeviceLike = None) -> Any:
    """A JAX optimizer state (``AdamWState`` or ``AdamW8bitState``, its
    leaves converted to numpy) → the port's state of the same name on
    ``device``, value for value."""
    from repro_torch.train import optim
    cls = getattr(optim, type(state).__name__)
    dev = resolve_device(device)
    return cls(*[params_from_numpy(getattr(state, f), dev)
                 for f in cls._fields])
