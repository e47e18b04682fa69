"""Tensor-parallel placement of the cloud side of a serving engine, and
its one collective.

Counterpart of ``repro.serve.sharding``.  The reference places every
array on a ``("data", "model")`` JAX mesh and lets GSPMD partition the
jitted phases.  The port is single-controller as JAX is, but explicit:
a split parameter group becomes a list with one entry per ``model``
shard, the page pool a list of per-shard pools, and the model layers
(``models.layers``) run each shard on its own device and sum the
shards' partial outputs with ``all_reduce_sum``.  Placement happens once
per partition (``place_collab_engine`` / ``place_cloud_engine``):

* **cloud suffix weights** — the role rules of
  ``launch.shardings.spec_for_param``: QKV and FFN-in column-split,
  attention and FFN out-projections row-split, attention only by whole
  kv-head groups;
* **lm_head** — vocab column-split when divisible; the shards' logits
  are concatenated in shard order before the argmax;
* **paged cloud KV pool** — one contiguous pool per shard holding its
  kv heads (``launch.shardings.paged_pool_spec``), so each shard stores,
  dequantizes and reads only its own INT8 slice;
* **everything edge-side** (embed, edge and draft blocks, edge and draft
  caches) — runs once, on the mesh's first device: that is what the
  reference's replication means with one controller.

A column split of a weight is a view of it and a row split a contiguous
view: on a shard that shares the original's device nothing is copied.
Shards on another device get a copy.  Only the mesh's first data row is
placed; the engines refuse ``data > 1`` (ROADMAP A16).

Why the committed streams survive (as in the reference): the edge math
is unchanged, so drafts and boundary blobs are too, and only the cloud
suffix's summation order moves, which can flip an argmax only at a
near-tie.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.launch.shardings import (paged_pool_spec, paged_scale_spec,
                                          spec_for_param)

__all__ = ["tp_size", "all_reduce_sum", "shard_suffix_blocks", "shard_tail",
           "shard_cloud_cache", "place_collab_engine", "place_cloud_engine"]


def tp_size(mesh) -> int:
    """The tensor-parallel degree a serve mesh gives the cloud suffix."""
    return 1 if mesh is None else int(mesh.model)


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum the shards' partial outputs in shard order on the first
    shard's device and hand each shard its copy (the same tensor where
    it shares that device).  The fixed order makes the sum the same from
    run to run; one part is returned as it is."""
    root = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(root)
    return [total.to(p.device) for p in parts]


def _split(t: torch.Tensor, spec, m: int, tp: int,
           dev: torch.device) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[dim] // tp
            t = t.narrow(dim, m * n, n)
    return t.to(dev)


def _leaves(tree: Any, path: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _map_path(fn, tree: Any, path: str) -> Any:
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, f"{path}/{k}") for k, v in tree.items()}
    return fn(path, tree)


def _place_group(group: Any, path: str, mesh,
                 n_kv: Optional[int]) -> Any:
    """One parameter group (``attn``, ``mlp``, ``lm_head`` ...): the list
    of its per-shard trees when some leaf splits over ``model``, else
    the group as it is, whole on the mesh's first device."""
    specs = {p: spec_for_param(p, tuple(t.shape), mesh, n_kv=n_kv)
             for p, t in _leaves(group, path)}
    devs = mesh.model_devices(0)
    if len(devs) == 1 or not any("model" in s for s in specs.values()):
        return _map_path(lambda p, t: t.to(devs[0]), group, path)
    return [_map_path(lambda p, t: _split(t, specs[p], m, len(devs), dev),
                      group, path)
            for m, dev in enumerate(devs)]


def shard_suffix_blocks(blocks: Dict[str, Any], mesh, *,
                        n_kv: int) -> Dict[str, Any]:
    """TP-split a stacked ``[L, ...]`` block tree group by group (paths
    under a ``blocks/`` root, so the layer axis stays whole)."""
    return {k: _place_group(v, f"blocks/{k}", mesh, n_kv)
            for k, v in blocks.items()}


def shard_tail(tail: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Place the head: ``lm_head`` vocab-column-split when divisible,
    the final norm whole."""
    return {k: _place_group(v, k, mesh, None) for k, v in tail.items()}


def shard_cloud_cache(cache: Dict[str, torch.Tensor],
                      mesh) -> Any:
    """A paged cloud cache → the list of per-shard caches, each a
    contiguous pool ``[L, n_pages, page, n_kv / tp, hd]`` with its scale
    rows ``[L, B, n_kv / tp]`` on its shard's device; the cache whole on
    the first device when the pool's kv heads do not split."""
    _, n_pages, _, n_kv, hd = cache["k_pages"].shape
    pool = paged_pool_spec(mesh, n_pages=n_pages, n_kv=n_kv, head_dim=hd)
    devs = mesh.model_devices(0)
    if pool[3] != "model" or len(devs) == 1:
        return {k: v.to(devs[0]) for k, v in cache.items()}
    shards = []
    for m, dev in enumerate(devs):
        shard = {}
        for k, v in cache.items():
            spec = pool if k.endswith("_pages") else paged_scale_spec(
                mesh, batch=v.shape[1], n_kv=n_kv)
            shard[k] = _split(v, spec, m, len(devs), dev).contiguous()
        shards.append(shard)
    return shards


def place_collab_engine(eng) -> None:
    """Place a ``CollaborativeServingEngine``'s cloud half on its mesh:
    the cloud suffix, head and cache TP-split; the edge half stays on
    the mesh's first device, where the engine built it.  Called from
    ``_set_cut``, so a future cut switch re-places the new suffix."""
    mesh = eng.mesh
    if mesh is None:
        return
    eng.cloud_blocks = shard_suffix_blocks(eng.cloud_blocks, mesh,
                                           n_kv=eng.cfg.n_kv)
    eng.cloud_tail = shard_tail(eng.tail, mesh)
    eng._cloud_cache = shard_cloud_cache(eng._cloud_cache, mesh)


def place_cloud_engine(eng) -> None:
    """Mesh placement for the cloud-only ``ServingEngine``: the whole
    parameter stack TP-split (``embed`` whole), the KV cache like the
    collaborative cloud cache."""
    mesh = eng.mesh
    if mesh is None:
        return
    p = eng.params
    eng.params = {"embed": p["embed"],
                  "blocks": shard_suffix_blocks(p["blocks"], mesh,
                                                n_kv=eng.cfg.n_kv),
                  **shard_tail({"final_norm": p["final_norm"],
                                "lm_head": p["lm_head"]}, mesh)}
    eng._cache = shard_cloud_cache(eng._cache, mesh)
