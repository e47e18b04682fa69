"""Role-based tensor-parallel rules for serving (path-driven).

Counterpart of the serving half of ``repro.launch.shardings``: the rules
``spec_for_param(zero1=True)`` gives a serving engine (parameters
replicated over ``data``, tensor-parallel over ``model``) and the page
pool's ``paged_pool_spec`` / ``paged_scale_spec``.  A spec is a tuple
with one entry per dim, an axis name or ``None``, as a JAX
``PartitionSpec`` reads:

* ``wq``/``wk``/``wv`` and the MLP's ``wi``/``wg`` split by columns over
  ``model``; ``wo`` (attention and MLP) by rows, so each block costs two
  all-reduces of its partial outputs (Megatron);
* ``lm_head`` splits by vocab columns when ``vocab % tp == 0``;
* norms and ``embed`` are replicated;
* a stacked ``[L, ...]`` leading layer axis is never split.

Every rule is divisibility-guarded: a dim that does not divide its mesh
axis stays whole.

One deliberate difference from the reference: GSPMD may split ``wk``'s
columns across a head when ``n_kv * hd % tp == 0`` but ``n_kv % tp !=
0``, because it can gather the pieces back.  Explicit tensor
parallelism cannot: a shard's attention needs whole heads, and its
queries' whole GQA groups.  So attention splits by whole kv-head groups
when ``n_kv % tp == 0`` (which, with ``n_heads`` a multiple of ``n_kv``,
makes ``n_heads % tp == 0`` too) and otherwise stays whole on shard 0 —
the same guard as ``paged_flash_mq_sharded``'s fallback and
``paged_pool_spec``'s replication of the pool.  The MLP splits when
``d_ff % tp == 0``.  ``embed`` stays whole where the reference's
parameter rule splits its vocab rows: a row split would turn every
lookup into a masked lookup plus an all-reduce, and the collaborative
engine's edge owns the embedding anyway (the reference replicates it
there too).
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["spec_for_param", "attention_splits", "paged_pool_spec",
           "paged_scale_spec"]

Spec = Tuple[Optional[str], ...]

_STACKED_ROOTS = ("blocks",)
_OUT_PROJ_TOKENS = ("wo", "proj_out", "out", "xo")


def _fit(dim: int, mesh, axis: str) -> Optional[str]:
    """``axis`` if ``dim`` divides its size, else None."""
    if axis not in mesh.axis_names:
        return None
    return axis if dim % int(mesh.shape[axis]) == 0 else None


def attention_splits(n_kv: int, tp: int) -> bool:
    """Whether attention splits over ``tp`` shards by whole kv-head
    groups (see the module docstring); trivially true at tp = 1, as
    every divisibility guard is."""
    return n_kv % tp == 0


def spec_for_param(path_str: str, shape: Tuple[int, ...], mesh, *,
                   n_kv: Optional[int] = None) -> Spec:
    """The serving spec of the parameter at ``path_str`` (``"blocks/attn/
    wq/w"``, ``"lm_head/w"`` ...).  Attention leaves (a path through
    ``attn``) split only when ``n_kv`` is given and
    ``attention_splits(n_kv, tp)``."""
    toks = path_str.split("/")
    dims = list(shape)
    lead: list = []
    if toks[0] in _STACKED_ROOTS and dims:
        lead = [None]                      # [L, ...] layer axis unsplit
        dims = dims[1:]
    whole = tuple(lead + [None] * len(dims))
    tp = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1
    if (len(dims) != 2 or toks[-1] == "emb"
            or ("attn" in toks and not (n_kv is not None
                                        and attention_splits(n_kv, tp)))):
        return whole
    d_in, d_out = dims
    if any(t in _OUT_PROJ_TOKENS for t in toks[-2:]):
        return tuple(lead + [_fit(d_in, mesh, "model"), None])
    return tuple(lead + [None, _fit(d_out, mesh, "model")])


def paged_pool_spec(mesh, *, n_pages: int, n_kv: int,
                    head_dim: int) -> Spec:
    """Spec of a paged pool ``[L, n_pages, page_size, n_kv, head_dim]``:
    kv heads over ``model`` — each shard stores, dequantizes and attends
    only its own KV slice — and pages over ``data`` when divisible; the
    pool stays whole over ``model`` when ``n_kv`` does not divide it."""
    return (None, _fit(n_pages, mesh, "data"), None,
            _fit(n_kv, mesh, "model"), None)


def paged_scale_spec(mesh, *, batch: int, n_kv: int) -> Spec:
    """Spec of the per-slot INT8 scale rows ``[L, B, n_kv]``: split like
    the pool they calibrate — kv heads over ``model``, slots over
    ``data`` — under the same guards."""
    return (None, _fit(batch, mesh, "data"), _fit(n_kv, mesh, "model"))
