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
           "paged_flash_mq", "paged_attention_ref", "paged_attention_mq_ref"]

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


def paged_multiquery_attention(q, k_pages, v_pages, block_tables, lengths,
                               q_start, k_scale=None, v_scale=None
                               ) -> torch.Tensor:
    """Front door for an S-query block: the plain version for a CPU
    tensor, the kernel for a CUDA tensor."""
    if not q.is_cuda:
        return paged_attention_mq_ref(q, k_pages, v_pages, block_tables,
                                      lengths, q_start, k_scale, v_scale)
    return paged_flash_mq(q.contiguous(), k_pages, v_pages,
                          block_tables.to(torch.int32).contiguous(),
                          lengths.to(torch.int32).contiguous(),
                          q_start.to(torch.int32).contiguous(),
                          k_scale, v_scale)


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Front door for decode (q [B, n_heads, hd]): same dispatch rule."""
    out = paged_multiquery_attention(q[:, None], k_pages, v_pages,
                                     block_tables, lengths, lengths - 1,
                                     k_scale, v_scale)
    return out[:, 0]
