"""Paged flash attention over a block-table KV pool: the CUDA kernel, its
plain PyTorch version, and the front doors the model layers call.

Counterpart of ``repro.kernels.paged_attention``.  The pool is
``[n_pages, page_size, n_kv, hd]`` (int8, or fp for the unquantized
variant); each sequence owns a row of a block table mapping its logical
page index to a physical page.  Query i of row b sits at absolute
position ``q_start[b] + i`` and attends KV positions ``<= q_start[b] + i``
that are also ``< lengths[b]`` — one read path for decode (S = 1,
``q_start = lengths - 1``), multi-token prefill (``q_start = 0``) and
speculative verify.

* ``paged_flash_mq`` launches the hand-written Hopper kernel
  (``csrc/paged_attention.cu``) on CUDA tensors and counts its launches
  in ``paged_flash_mq.launches``.
* ``paged_attention_mq_ref`` / ``paged_attention_ref`` are the plain
  PyTorch versions: the oracle the kernel is held against, and the path
  CPU tensors take.
* ``paged_attention`` / ``paged_multiquery_attention`` dispatch on the
  tensor's device alone: a CPU tensor takes the plain version, a CUDA
  tensor launches the kernel or raises — nothing falls back.
* ``paged_flash_mq_sharded`` / ``paged_flash_decode_sharded`` are the
  tensor-parallel form (the reference's ``shard_map`` over kv heads):
  each shard launches the same kernel, on its own device, over its own
  contiguous kv-head slice of the pool.  ``paged_flash_mq_per_shard`` is
  that launch for shards whose tensors already live apart (the model
  layers' path); ``set_tp_mesh`` routes both front doors through the
  sharded form.

The plain version re-masks the softmax weights and divides by
``max(l, 1e-30)`` like the kernel, so a row with no valid position gives
0 (the JAX gather oracle gives the mean of V there; the JAX kernel gives
0).  Every row with at least one valid position — all the engines ever
produce — computes the same softmax as both JAX functions.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["paged_attention", "paged_multiquery_attention",
           "paged_flash_mq", "paged_attention_ref", "paged_attention_mq_ref",
           "paged_flash_mq_sharded", "paged_flash_decode_sharded",
           "paged_flash_mq_per_shard", "set_tp_mesh"]

# finite stand-in for -inf: (-1e30) - (-1e30) = 0 keeps exp() NaN-free on
# fully-masked rows, where a true -inf would poison the running max
_MASKED = -1e30

_PAGE_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _norm_scales(scale: Optional[torch.Tensor], batch: int, n_kv: int,
                 device: torch.device) -> torch.Tensor:
    """Broadcast per-cache scales to the kernel's [B, n_kv] layout.

    Accepts None (fp pages: identity), [n_kv] (per-(layer, head)
    calibration) or [B, n_kv] (per-slot calibration at prefill)."""
    if scale is None:
        return torch.ones((batch, n_kv), dtype=torch.float32, device=device)
    scale = scale.to(torch.float32)
    if scale.ndim == 1:
        scale = scale[None].expand(batch, n_kv)
    return scale


def paged_attention_mq_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, q_start: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain gather-based version of the q-block kernel →
    [B, S, n_heads, hd] in ``q.dtype``.  On a CUDA tensor both einsums
    run in full f32: TF32 matmuls are switched off for this call only."""
    with _full_f32_matmul(q.is_cuda):
        return _paged_attention_mq_plain(q, k_pages, v_pages, block_tables,
                                         lengths, q_start, k_scale, v_scale)


@contextlib.contextmanager
def _full_f32_matmul(active: bool):
    """Switch TF32 matmuls off inside the block (when ``active``) and
    restore the caller's setting afterwards, so the oracle's precision
    never leaks into later f32 matmuls of the process."""
    saved = torch.backends.cuda.matmul.allow_tf32
    if active:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _paged_attention_mq_plain(q, k_pages, v_pages, block_tables, lengths,
                              q_start, k_scale, v_scale) -> torch.Tensor:
    b, s, n_heads, hd = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    group = n_heads // n_kv
    span = block_tables.shape[1] * page_size
    bt = block_tables.long()

    k = k_pages[bt].reshape(b, span, n_kv, hd).to(torch.float32)
    v = v_pages[bt].reshape(b, span, n_kv, hd).to(torch.float32)
    k = k * _norm_scales(k_scale, b, n_kv, q.device)[:, None, :, None]
    v = v * _norm_scales(v_scale, b, n_kv, q.device)[:, None, :, None]

    qg = q.reshape(b, s, n_kv, group, hd).to(torch.float32) / math.sqrt(hd)
    logits = torch.einsum("bsngd,blnd->bnsgl", qg, k)
    pos = torch.arange(span, device=q.device)
    qpos = q_start.long()[:, None] + torch.arange(s, device=q.device)[None]
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (pos[None, None, :] < lengths.long()[:, None, None]))
    mask = mask[:, None, :, None, :]                          # [B,1,S,1,L]
    logits = torch.where(mask, logits, torch.full_like(logits, _MASKED))
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    den = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bnsgl,blnd->bsngd", w / den, v)
    return out.reshape(b, s, n_heads, hd).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """S = 1 plain version (decode): the query sits at the last valid
    position."""
    out = paged_attention_mq_ref(q[:, None], k_pages, v_pages, block_tables,
                                 lengths, lengths - 1, k_scale, v_scale)
    return out[:, 0]


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded on first use."""
    fn = _build.load("paged_attention").paged_flash_mq_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_flash_mq(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, block_tables: torch.Tensor,
                   lengths: torch.Tensor, q_start: torch.Tensor,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper kernel: q f32 [B, S, n_heads, hd]; pages int8,
    bf16 or f32 [n_pages, page_size, n_kv, hd]; block tables, lengths and
    q_start int32; scales None, [n_kv] or [B, n_kv] → f32 [B, S, n_heads,
    hd].  Block-table entries must lie in [0, n_pages)."""
    b, s, n_heads, hd = q.shape
    n_pages, page_size, n_kv, hd_k = k_pages.shape
    _check(q, "q", torch.float32, 4)
    _check(k_pages, "k_pages", None, 4)
    _check(v_pages, "v_pages", k_pages.dtype, 4)
    _check(block_tables, "block_tables", torch.int32, 2)
    _check(lengths, "lengths", torch.int32, 1)
    _check(q_start, "q_start", torch.int32, 1)
    if k_pages.dtype not in _PAGE_DTYPES:
        raise ValueError(f"page dtype {k_pages.dtype} not supported")
    if (v_pages.shape != k_pages.shape or hd_k != hd or n_heads % n_kv
            or not 1 <= hd <= 256 or block_tables.shape[0] != b
            or lengths.shape[0] != b or q_start.shape[0] != b):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, table {tuple(block_tables.shape)}")
    ks = _norm_scales(k_scale, b, n_kv, q.device).contiguous()
    vs = _norm_scales(v_scale, b, n_kv, q.device).contiguous()
    _check(ks, "k_scale", torch.float32, 2)
    _check(vs, "v_scale", torch.float32, 2)
    if ks.shape != (b, n_kv) or vs.shape != (b, n_kv):
        raise ValueError(f"scales must broadcast to {(b, n_kv)}")
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), q_start.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
        b, s, n_heads, n_kv, hd, page_size, block_tables.shape[1],
        _PAGE_DTYPES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_mq launch failed (code {rc})")
    paged_flash_mq.launches += 1
    return out


paged_flash_mq.launches = 0


def _local(q, k_pages, v_pages, block_tables, lengths, q_start,
           k_scale=None, v_scale=None) -> torch.Tensor:
    """One device's read: the plain version for a CPU tensor, the kernel
    for a CUDA tensor."""
    if not q.is_cuda:
        return paged_attention_mq_ref(q, k_pages, v_pages, block_tables,
                                      lengths, q_start, k_scale, v_scale)
    return paged_flash_mq(q.contiguous(), k_pages, v_pages,
                          block_tables.to(torch.int32).contiguous(),
                          lengths.to(torch.int32).contiguous(),
                          q_start.to(torch.int32).contiguous(),
                          k_scale, v_scale)


# ---------------------------------------------------------------------------
# Tensor parallelism (the reference's ``paged_flash_mq_sharded``)
# ---------------------------------------------------------------------------
#
# Replaces src/repro/kernels/paged_attention.py:304-375, a ``shard_map``
# of the Pallas kernel over kv heads with no collective.  Attention is
# independent per kv head, so each shard launches the hand-written kernel
# of csrc/paged_attention.cu over its own contiguous pool
# [n_pages, page, n_kv / tp, hd] and scales [B, n_kv / tp]: at decode a
# shard moves 1/tp of the pool's bytes, so its bound is the unsharded
# bound / tp.  A decode shard's grid is (B, n_kv / tp, 1) CTAs.


def paged_flash_mq_per_shard(qs, k_pages, v_pages, block_tables, lengths,
                             q_start, k_scales, v_scales):
    """Launch the kernel once per shard, each on its own device's
    tensors: ``qs[i]`` [B_i, S, H_i, hd] over pool ``k_pages[i]`` /
    ``v_pages[i]`` with scales ``k_scales[i]`` / ``v_scales[i]`` (None,
    [n_kv_i] or [B_i, n_kv_i]) → the list of shard outputs.  Every
    argument is a list with one entry per shard.  Counts one call in
    ``paged_flash_mq_sharded.calls`` and one launch per CUDA shard in
    ``paged_flash_mq_sharded.launches``; a CPU shard takes the plain
    version."""
    paged_flash_mq_sharded.calls += 1
    outs = []
    for args in zip(qs, k_pages, v_pages, block_tables, lengths, q_start,
                    k_scales, v_scales):
        dev = args[0].device
        q, kp, vp, bt, ln, q0, ks, vs = (
            None if t is None else t.to(dev) for t in args)
        outs.append(_local(q, kp, vp, bt, ln, q0, ks, vs))
        if q.is_cuda:
            paged_flash_mq_sharded.launches += 1
    return outs


def paged_flash_mq_sharded(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, q_start: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           mesh) -> torch.Tensor:
    """Tensor-parallel ``paged_flash_mq`` with the reference's signature:
    whole tensors in, the whole [B, S, n_heads, hd] out on ``q``'s
    device.  Query heads, the pool's kv heads and the scales split over
    the mesh's ``model`` axis, batch rows over ``data`` when ``B``
    divides it (shard ``(d, m)`` on ``mesh.devices[d * model + m]``);
    each shard's slice is copied into a contiguous tensor on its device,
    the kernel runs once per shard (``paged_flash_mq_per_shard``), and
    the outputs are put back together in shard order.  With ``tp == 1``
    or ``n_kv % tp != 0`` this is the unsharded read, as in the
    reference, and counts no sharded call."""
    b, s, n_heads, _ = q.shape
    n_kv = k_pages.shape[2]
    tp = mesh.model
    if tp == 1 or n_kv % tp != 0:
        return _local(q, k_pages, v_pages, block_tables, lengths, q_start,
                      k_scale, v_scale)
    ks = _norm_scales(k_scale, b, n_kv, q.device)
    vs = _norm_scales(v_scale, b, n_kv, q.device)
    dp = mesh.data if b % mesh.data == 0 else 1
    rows, hq, hk = b // dp, n_heads // tp, n_kv // tp
    shards = []
    for d in range(dp):
        r = slice(d * rows, (d + 1) * rows)
        for m, dev in enumerate(mesh.model_devices(d)):
            h, kv = slice(m * hq, (m + 1) * hq), slice(m * hk, (m + 1) * hk)
            shards.append(tuple(t.contiguous().to(dev) for t in (
                q[r, :, h], k_pages[:, :, kv], v_pages[:, :, kv],
                block_tables[r], lengths[r], q_start[r], ks[r, kv],
                vs[r, kv])))
    outs = paged_flash_mq_per_shard(*(list(a) for a in zip(*shards)))
    outs = [o.to(q.device) for o in outs]
    return torch.cat([torch.cat(outs[d * tp:(d + 1) * tp], dim=2)
                      for d in range(dp)], dim=0)


paged_flash_mq_sharded.calls = 0
paged_flash_mq_sharded.launches = 0


def paged_flash_decode_sharded(q, k_pages, v_pages, block_tables, lengths,
                               k_scale=None, v_scale=None, *, mesh
                               ) -> torch.Tensor:
    """Tensor-parallel decode step (the S = 1 case of
    ``paged_flash_mq_sharded``, ``q`` [B, n_heads, hd])."""
    out = paged_flash_mq_sharded(q[:, None], k_pages, v_pages, block_tables,
                                 lengths, lengths - 1, k_scale, v_scale,
                                 mesh=mesh)
    return out[:, 0]


# Deployment hook: a deployment sets its serving mesh once and both front
# doors below route every call through the sharded form.  The engines do
# not set it — they hold per-shard pools and call
# ``paged_flash_mq_per_shard`` themselves — since a module-wide mesh
# would also shard the unsharded engines of the same process.
_TP_MESH = None


def set_tp_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh the front doors shard
    over."""
    global _TP_MESH
    _TP_MESH = mesh


def paged_multiquery_attention(q, k_pages, v_pages, block_tables, lengths,
                               q_start, k_scale=None, v_scale=None
                               ) -> torch.Tensor:
    """Front door for an S-query block: the plain version for a CPU
    tensor, the kernel for a CUDA tensor; under ``set_tp_mesh``, the
    sharded form."""
    if _TP_MESH is not None:
        return paged_flash_mq_sharded(q, k_pages, v_pages, block_tables,
                                      lengths, q_start, k_scale, v_scale,
                                      mesh=_TP_MESH)
    return _local(q, k_pages, v_pages, block_tables, lengths, q_start,
                  k_scale, v_scale)


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Front door for decode (q [B, n_heads, hd]): same dispatch rule."""
    out = paged_multiquery_attention(q[:, None], k_pages, v_pages,
                                     block_tables, lengths, lengths - 1,
                                     k_scale, v_scale)
    return out[:, 0]
