"""Launchers of the fused INT8 GEMM kernels (``csrc/int8_matmul.cu``).

Counterpart of ``repro.kernels.int8_matmul.int8_matmul_pallas``: int8
``a_q`` [M, K] @ int8 ``b_q`` [K, N] with an int32 accumulator, the exact
asymmetric zero-point correction and a fused activation / requant
epilogue (see the CUDA source).  Unlike the TPU kernel it takes any
shape: the kernels predicate their loads and stores, so nothing is padded
on the host and ``true_k`` is simply K.

* ``int8_matmul_cuda`` dispatches on shape alone.  At M <=
  ``_SPLITK_MAX_M`` (decode steps and small drafts) it launches the
  split-K kernel over the plan of ``_plan_splitk``: a thread-block cluster
  per 64-column tile, its CTAs over K slices, merged in distributed shared
  memory.  Larger M takes the first port's tiled kernel (64 x 64 output
  tiles).  Its launches are counted in ``int8_matmul_cuda.launches``, the
  split-K ones also in ``int8_matmul_cuda.splitk_launches``.
* ``int8_matmul_splitk`` runs the split-K kernel (with another plan, if
  asked) and ``int8_matmul_tiled`` the tiled kernel at any shape, each
  counting its own launches, to time and check the two designs side by
  side; the front doors do not call them.

The front doors that dispatch on the tensor's device are in
``kernels.ops``; the plain version is ``kernels.ref.int8_matmul_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["int8_matmul_cuda", "int8_matmul_splitk", "int8_matmul_tiled"]

_ACT_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3}
_OUT_CODES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3}


@functools.cache
def _launcher():
    """The tiled kernel's C entry point, built and loaded on first use."""
    fn = _build.load("int8_matmul").int8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _splitk_launcher():
    """The split-K kernel's C entry point."""
    fn = _build.load("int8_matmul").int8_matmul_splitk_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Split-K planning (M <= _SPLITK_MAX_M)
# ---------------------------------------------------------------------------
#
# The split-K kernel runs a grid of (cluster, ceil(N / 64)) CTAs: each
# cluster owns one 64-column tile for all M rows, and its CTAs take
# contiguous K slices of ``slice_k`` bytes (whole 128-deep ring stages).
# B streams through a ring of 4 such stages per CTA, each slot with its
# stage's M rows of A.  The plan comes from (M, K, N) alone.

# the kernel's rows (two 16-row fragments), and the front door's split-K
# threshold: on an H100 the split-K kernel beat the tiled one at every M
# in {1, 4, 8, 16, 32} of deepseek-7b's three edge GEMM shapes (PERF.md,
# chip_smoke.py's int8_threshold phase)
_SPLITK_MAX_M = 32
_SK_BN = 64               # output columns per cluster
_SK_BK = 128              # K depth of one ring stage
_SK_STAGES = 4            # ring slots per CTA (compile-time in the kernel)
_SK_WARPS = 4
_SK_MAX_CLUSTER = 8       # the portable cluster size
_SK_MAX_SMEM = 232448     # the most shared memory an H100 CTA may have
_SMS = 132                # streaming multiprocessors of an H100 SXM


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _splitk_smem_bytes(m: int, slice_k: int) -> int:
    """Dynamic shared memory of one split-K CTA (``SplitkSmem::total`` in
    the CUDA source): the ring, a stage of B and the stage's M rows of A
    per slot (reused for the warps' partials), the CTA's partials that
    rank 0 reads, rank 0's totals."""
    mf = 1 if m <= 16 else 2
    slot = _SK_BK * _SK_BN + _round16(m * (_SK_BK + 16))
    ring = min(slice_k // _SK_BK, _SK_STAGES) * slot
    staging = 4 * _SK_WARPS * (16 * mf * _SK_BN + _SK_BN + _SPLITK_MAX_M)
    part = _round16(4 * (m * _SK_BN + _SK_BN + _SPLITK_MAX_M))
    return max(ring, staging) + part + 4 * (_SK_BN + _SPLITK_MAX_M)


@functools.lru_cache(maxsize=None)
def _plan_splitk(m: int, k: int, n: int,
                 cluster: Optional[int] = None) -> Optional[tuple]:
    """(cluster, slice_k, smem_bytes) of a split-K launch, or None
    where the kernel does not take the shape (M outside [1, 32], K or N
    0).  The cluster gives the grid about one CTA per SM and splits K at
    least in two, at most 8 ways and at most one way per ring stage of K
    (on an H100 within 7 % of the best cluster size at every shape of
    chip_smoke.py's int8_threshold sweep); the slices are whole stages,
    as even as whole stages allow, each non-empty, together exactly K.
    ``cluster`` asks for another size (clipped to what K allows), for
    measuring the choice."""
    if not 1 <= m <= _SPLITK_MAX_M or k < 1 or n < 1:
        return None
    tiles = -(-n // _SK_BN)
    steps = -(-k // _SK_BK)
    if tiles > 65535:
        return None
    if cluster is None:
        cluster = max(2, int(_SMS / tiles + 0.5))
    per = -(-steps // max(1, min(cluster, _SK_MAX_CLUSTER, steps)))
    return (-(-steps // per), per * _SK_BK,     # no empty slice
            _splitk_smem_bytes(m, per * _SK_BK))


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _validated(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype):
    """Check a kernel call's arguments; returns (m, k, n)."""
    if a_q.ndim != 2 or b_q.ndim != 2:
        raise ValueError("a_q and b_q must be 2-D")
    m, k = a_q.shape
    n = b_q.shape[1]
    _check(a_q, "a_q", torch.int8, (m, k))
    _check(b_q, "b_q", torch.int8, (k, n))
    for name, v in (("sa", sa), ("za", za)):
        _check(v, name, torch.float32, v.shape)
        if v.numel() != 1:
            raise ValueError(f"{name} must hold one value (per-tensor)")
    for name, v in (("sb", sb), ("zb", zb), ("bias", bias)):
        if v is not None:
            _check(v, name, torch.float32, (n,))
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"output dtype {out_dtype} not supported")
    if out_dtype != torch.float32:
        for name, v in (("so", so), ("zo", zo)):
            if v is None or v.numel() != 1:
                raise ValueError(f"{name} must hold one value to requantize")
            _check(v, name, torch.float32, v.shape)
    return m, k, n


def _launch(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype, qmin,
            qmax, plan) -> torch.Tensor:
    """One launch: the split-K kernel over ``plan`` (cluster, slice_k,
    smem), or the tiled kernel where ``plan`` is None."""
    m, k = a_q.shape
    n = b_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if m == 0 or n == 0:
        return out
    args = (a_q.data_ptr(), b_q.data_ptr(), sa.data_ptr(), za.data_ptr(),
            sb.data_ptr(), zb.data_ptr(), _ptr(bias), _ptr(so), _ptr(zo),
            out.data_ptr(), m, n, k, _ACT_CODES[act], _OUT_CODES[out_dtype],
            qmin, qmax)
    stream = torch.cuda.current_stream(a_q.device).cuda_stream
    if plan is None:
        rc = _launcher()(*args, stream)
    else:
        rc = _splitk_launcher()(*args, *plan[:2], stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed (code {rc}, "
                           f"{'split-K ' + str(plan) if plan else 'tiled'})")
    return out


def int8_matmul_cuda(a_q: torch.Tensor, b_q: torch.Tensor,
                     sa: torch.Tensor, za: torch.Tensor,
                     sb: torch.Tensor, zb: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     so: Optional[torch.Tensor] = None,
                     zo: Optional[torch.Tensor] = None, *,
                     act: Optional[str] = None,
                     out_dtype: torch.dtype = torch.float32,
                     qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """Launch a Hopper kernel on contiguous CUDA tensors: ``a_q`` int8
    [M, K], ``b_q`` int8 [K, N]; ``sa``/``za`` (and ``so``/``zo`` when
    ``out_dtype`` is an integer type) f32 of one element; ``sb``/``zb``
    and ``bias`` (or None) f32 [N].  Returns ``out_dtype`` [M, N]: f32,
    or the requantized lattice clipped to [qmin, qmax].  M <=
    ``_SPLITK_MAX_M`` takes the split-K kernel, larger M the tiled one;
    one launch either way."""
    m, k, n = _validated(a_q, b_q, sa, za, sb, zb, bias, so, zo, act,
                         out_dtype)
    plan = _plan_splitk(m, k, n) if m <= _SPLITK_MAX_M else None
    out = _launch(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype,
                  qmin, qmax, plan)
    if m and n:
        int8_matmul_cuda.launches += 1
        if plan is not None:
            int8_matmul_cuda.splitk_launches += 1
    return out


int8_matmul_cuda.launches = 0
int8_matmul_cuda.splitk_launches = 0


def int8_matmul_splitk(a_q, b_q, sa, za, sb, zb, bias=None, so=None, zo=None,
                       *, act=None, out_dtype=torch.float32, qmin=-128,
                       qmax=127, cluster: Optional[int] = None
                       ) -> torch.Tensor:
    """The split-K kernel at any M in [1, 32], with ``int8_matmul_cuda``'s
    arguments; ``cluster`` overrides the plan's cluster size (see
    ``_plan_splitk``).  Raises where the kernel does not take the shape.
    Counts its launches in ``int8_matmul_splitk.launches``."""
    m, k, n = _validated(a_q, b_q, sa, za, sb, zb, bias, so, zo, act,
                         out_dtype)
    plan = _plan_splitk(m, k, n, cluster)
    if plan is None:
        raise ValueError(f"the split-K kernel does not take M {m}, K {k}, "
                         f"N {n}")
    out = _launch(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype,
                  qmin, qmax, plan)
    int8_matmul_splitk.launches += 1
    return out


int8_matmul_splitk.launches = 0


def int8_matmul_tiled(a_q, b_q, sa, za, sb, zb, bias=None, so=None, zo=None,
                      *, act=None, out_dtype=torch.float32, qmin=-128,
                      qmax=127) -> torch.Tensor:
    """The tiled kernel (the first port's design: a CTA per 64 x 64 output
    tile walks all of K) at any shape, with ``int8_matmul_cuda``'s
    arguments.  Counts its launches in ``int8_matmul_tiled.launches``."""
    m, _, n = _validated(a_q, b_q, sa, za, sb, zb, bias, so, zo, act,
                         out_dtype)
    out = _launch(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype,
                  qmin, qmax, None)
    if m and n:
        int8_matmul_tiled.launches += 1
    return out


int8_matmul_tiled.launches = 0
