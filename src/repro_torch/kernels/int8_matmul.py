"""Launchers of the fused INT8 GEMM kernels (``csrc/int8_matmul.cu``,
``csrc/int8_matmul_sm90.cu``).

Counterpart of ``repro.kernels.int8_matmul.int8_matmul_pallas``: int8
``a_q`` [M, K] @ int8 ``b_q`` [K, N] with an int32 accumulator, the exact
asymmetric zero-point correction and a fused activation / requant
epilogue (see the CUDA sources).  Unlike the TPU kernel it takes any
shape: the kernels predicate or zero-fill their loads and mask their
stores, so nothing is padded on the host and ``true_k`` is simply K.

The weight is the reference's [K, N] tensor or a ``PackedInt8Weight``
(``pack_int8_weight``): the same tensor beside a K-major [N, K] copy and
its exact int32 colsum, made once by one launch of the pack kernel.

* ``int8_matmul_cuda`` dispatches on shape alone (``_design``), one GEMM
  launch a call:

  - M <= ``_SPLITK_MAX_M`` (decode steps and small drafts): the split-K
    kernel over the plan of ``_plan_splitk`` (a thread-block cluster per
    64-column tile, its CTAs over K slices, merged in distributed shared
    memory), on the [K, N] weight;
  - M > ``_SPLITK_MAX_M`` with K a multiple of 16 and A's and the packed
    weight's bases 16-byte aligned (what TMA asks of a row stride and a
    base): the ``wgmma`` kernel over the plan of ``_plan_wgmma`` (128 x
    BN output tiles, a TMA / ``mbarrier`` ring, a producer warp and two
    consumer warpgroups), on the packed weight.  A plain [K, N] weight is
    packed for the call first: a layout step, counted in
    ``int8_matmul_cuda.pack_launches``;
  - any other shape: the first port's tiled kernel (64 x 64 output
    tiles), on the [K, N] weight.

  A refused or failed launch raises; nothing retries on another kernel.
  Every call counts one launch in ``int8_matmul_cuda.launches``; the
  split-K and wgmma launches are counted apart too
  (``splitk_launches``, ``wgmma_launches``).
* ``int8_matmul_splitk``, ``int8_matmul_wgmma`` and ``int8_matmul_tiled``
  run one design each at any shape it takes (with another plan, if
  asked), each counting its own launches, to time and check the designs
  side by side; the front doors do not call them.

The front doors that dispatch on the tensor's device are in
``kernels.ops``; the plain versions are ``kernels.ref.int8_matmul_ref``
and ``kernels.ref.pack_int8_weight_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pack_int8_weight_ref

__all__ = ["PackedInt8Weight", "int8_matmul_cuda", "int8_matmul_splitk",
           "int8_matmul_tiled", "int8_matmul_wgmma", "pack_int8_weight",
           "pack_int8_weight_cuda"]

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


@functools.cache
def _wgmma_launcher():
    """The wgmma kernel's C entry point."""
    fn = _build.load("int8_matmul_sm90").int8_matmul_wgmma_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _pack_launcher():
    """The pack kernel's C entry point."""
    fn = _build.load("int8_matmul_sm90").int8_pack_weight_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# The packed weight
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedInt8Weight:
    """An int8 weight laid out for every INT8 kernel: ``kn`` the
    reference's [K, N] tensor (the split-K and tiled kernels read it),
    ``nk`` a contiguous K-major [N, K] copy (the wgmma kernel's: 8-bit
    ``wgmma`` reads B only K-major), ``colsum`` the exact int32 colsum
    [N].  Holding both layouts costs the weight's bytes twice."""

    kn: torch.Tensor
    nk: torch.Tensor
    colsum: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.kn.shape


Weight = Union[torch.Tensor, PackedInt8Weight]


def pack_int8_weight(w_q: torch.Tensor) -> PackedInt8Weight:
    """Pack an int8 [K, N] weight once: on a CUDA tensor one launch of the
    pack kernel (``pack_int8_weight_cuda``), on a CPU tensor the plain
    version (``kernels.ref.pack_int8_weight_ref``)."""
    if w_q.dtype != torch.int8 or w_q.ndim != 2:
        raise ValueError(f"w_q must be a 2-D int8 tensor, got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    if w_q.is_cuda:
        return pack_int8_weight_cuda(w_q)
    return PackedInt8Weight(w_q, *pack_int8_weight_ref(w_q))


def pack_int8_weight_cuda(w_q: torch.Tensor) -> PackedInt8Weight:
    """One launch of the pack kernel on a contiguous int8 CUDA [K, N]
    tensor: the [N, K] copy and the int32 colsum in one pass.  Counts its
    launches in ``pack_int8_weight_cuda.launches``."""
    if w_q.ndim != 2:
        raise ValueError("w_q must be 2-D")
    k, n = w_q.shape
    _check(w_q, "w_q", torch.int8, (k, n))
    nk = torch.empty((n, k), dtype=torch.int8, device=w_q.device)
    colsum = torch.empty((n,), dtype=torch.int32, device=w_q.device)
    if k and n:
        stream = torch.cuda.current_stream(w_q.device).cuda_stream
        rc = _pack_launcher()(w_q.data_ptr(), nk.data_ptr(), colsum.data_ptr(),
                              k, n, stream)
        if rc != 0:
            raise RuntimeError(f"int8 weight pack launch failed (code {rc})")
        pack_int8_weight_cuda.launches += 1
    else:
        colsum.zero_()
    return PackedInt8Weight(w_q, nk, colsum)


pack_int8_weight_cuda.launches = 0


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


# ---------------------------------------------------------------------------
# wgmma planning (M > _SPLITK_MAX_M)
# ---------------------------------------------------------------------------
#
# The wgmma kernel's CTAs own 128 x BN output tiles; ``grid`` CTAs walk the
# ceil(M / 128) x ceil(N / BN) tiles, CTA b taking tiles b, b + grid, ...,
# tile t at rows 128 (t % mt) and columns BN (t // mt) (M fastest, so the
# CTAs that share a B tile run at once).  Each ring slot holds the tile's
# A rows and its B rows (plus 16 rows of ones: their products are
# rowsum(A)) over 128 bytes of K.

_WG_BM = 128              # output rows a tile (64 per consumer warpgroup)
_WG_BK = 128              # K bytes of one ring stage
_WG_ONES = 16             # rows of ones after each slot's B tile
_WG_BNS = (128, 192)      # the tile widths the kernel is built for
_WG_STAGES = {128: 6, 192: 5}


def _wgmma_smem_bytes(bn: int) -> int:
    """Dynamic shared memory of one wgmma CTA (``WgCfg<BN>::kSmem`` in the
    CUDA source): 1024 bytes to align the ring, the ring's slots (A 128 x
    128, B (BN + 16) x 128), a full and an empty barrier per slot, and
    each consumer warpgroup's copy of a tile's four column parameters."""
    st = _WG_STAGES[bn]
    return (1024 + st * (_WG_BM * _WG_BK + (bn + _WG_ONES) * _WG_BK)
            + 16 * st + 2 * 16 * bn)


@functools.lru_cache(maxsize=None)
def _plan_wgmma(m: int, k: int, n: int, bn: Optional[int] = None,
                persistent: Optional[bool] = None) -> Optional[tuple]:
    """(bn, grid, smem_bytes) of a wgmma launch, or None where the kernel
    does not take the shape (M or N below 1, K below 16 or not a multiple
    of 16).  By default a persistent grid, at most one CTA per SM (one
    fits, by its shared memory), walking the tiles; the tile width gives
    the busiest CTA the fewest columns, then the fewest tiles (on an H100
    at M 512: 192 at N 11008, 2 tiles a CTA against 3 of 128, 3-4 %
    faster; 128 at N 4096, one wave either way, 26 % faster than 192).  ``bn``
    (128 or 192) and ``persistent`` (False: one CTA per tile) ask for
    another plan, for measuring the choice."""
    if m < 1 or n < 1 or k < 16 or k % 16:
        return None
    if bn is None:
        bn = min(_WG_BNS, key=lambda w: (_wgmma_waves(m, n, w) * w,
                                          _wgmma_waves(m, n, w)))
    if bn not in _WG_BNS:
        raise ValueError(f"bn must be one of {_WG_BNS}, got {bn}")
    tiles = -(-m // _WG_BM) * -(-n // bn)
    grid = tiles if persistent is False else min(tiles, _SMS)
    return bn, grid, _wgmma_smem_bytes(bn)


def _wgmma_waves(m: int, n: int, bn: int) -> int:
    """Tiles on the busiest CTA of a persistent grid of 128 x ``bn``
    tiles."""
    return -(-(-(-m // _WG_BM) * -(-n // bn)) // _SMS)


def _wgmma_tiles(m: int, n: int, plan: tuple) -> list:
    """The (row, column) origins of the output tiles each CTA of ``plan``
    computes, in its order: the kernel's walk, in Python."""
    bn, grid = plan[:2]
    mt = -(-m // _WG_BM)
    tiles = mt * -(-n // bn)
    return [[(_WG_BM * (t % mt), bn * (t // mt))
             for t in range(b, tiles, grid)] for b in range(grid)]


def _design(m: int, k: int, a_ptr: int, nk_ptr: Optional[int]) -> str:
    """The kernel the front door launches for an [M, K] A at ``a_ptr``:
    "splitk" at M <= 32, "wgmma" above where K is a positive multiple of
    16 and A and the packed weight (``nk_ptr``; None for a weight packed
    for the call, which is aligned) start on 16-byte boundaries, else
    "tiled"."""
    if m <= _SPLITK_MAX_M:
        return "splitk"
    aligned = a_ptr % 16 == 0 and (nk_ptr is None or nk_ptr % 16 == 0)
    if k >= 16 and k % 16 == 0 and aligned:
        return "wgmma"
    return "tiled"


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


def _kn(b_q: Weight) -> torch.Tensor:
    """The [K, N] tensor of a weight, packed or not."""
    return b_q.kn if isinstance(b_q, PackedInt8Weight) else b_q


def _validated(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype):
    """Check a kernel call's arguments (``b_q`` a [K, N] tensor or a
    ``PackedInt8Weight``); returns (m, k, n)."""
    kn = _kn(b_q)
    if a_q.ndim != 2 or kn.ndim != 2:
        raise ValueError("a_q and b_q must be 2-D")
    m, k = a_q.shape
    n = kn.shape[1]
    _check(a_q, "a_q", torch.int8, (m, k))
    _check(kn, "b_q", torch.int8, (k, n))
    if isinstance(b_q, PackedInt8Weight):
        _check(b_q.nk, "b_q.nk", torch.int8, (n, k))
        _check(b_q.colsum, "b_q.colsum", torch.int32, (n,))
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
            qmax, design, plan) -> torch.Tensor:
    """One launch of ``design`` ("splitk" over ``plan`` (cluster, slice_k,
    smem), "wgmma" over ``plan`` (bn, grid, smem) on a packed ``b_q``, or
    "tiled")."""
    m, k = a_q.shape
    n = b_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if m == 0 or n == 0:
        return out
    if design == "wgmma":
        head = (a_q.data_ptr(), b_q.nk.data_ptr(), b_q.colsum.data_ptr())
    else:
        head = (a_q.data_ptr(), _kn(b_q).data_ptr())
    args = (*head, sa.data_ptr(), za.data_ptr(),
            sb.data_ptr(), zb.data_ptr(), _ptr(bias), _ptr(so), _ptr(zo),
            out.data_ptr(), m, n, k, _ACT_CODES[act], _OUT_CODES[out_dtype],
            qmin, qmax)
    stream = torch.cuda.current_stream(a_q.device).cuda_stream
    if design == "tiled":
        rc = _launcher()(*args, stream)
    elif design == "splitk":
        rc = _splitk_launcher()(*args, *plan[:2], stream)
    else:
        rc = _wgmma_launcher()(*args, *plan[:2], stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed (code {rc}, {design}"
                           f"{' ' + str(plan) if plan else ''})")
    return out


def int8_matmul_cuda(a_q: torch.Tensor, b_q: Weight,
                     sa: torch.Tensor, za: torch.Tensor,
                     sb: torch.Tensor, zb: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     so: Optional[torch.Tensor] = None,
                     zo: Optional[torch.Tensor] = None, *,
                     act: Optional[str] = None,
                     out_dtype: torch.dtype = torch.float32,
                     qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """Launch a Hopper kernel on contiguous CUDA tensors: ``a_q`` int8
    [M, K], ``b_q`` int8 [K, N] or a ``PackedInt8Weight``; ``sa``/``za``
    (and ``so``/``zo`` when ``out_dtype`` is an integer type) f32 of one
    element; ``sb``/``zb`` and ``bias`` (or None) f32 [N].  Returns
    ``out_dtype`` [M, N]: f32, or the requantized lattice clipped to
    [qmin, qmax].  The kernel is chosen by ``_design`` (see the module's
    docstring); one GEMM launch either way."""
    m, k, n = _validated(a_q, b_q, sa, za, sb, zb, bias, so, zo, act,
                         out_dtype)
    packed = isinstance(b_q, PackedInt8Weight)
    design = _design(m, k, a_q.data_ptr(),
                     b_q.nk.data_ptr() if packed else None)
    plan = None
    if design == "splitk":
        plan = _plan_splitk(m, k, n)
    elif design == "wgmma":
        plan = _plan_wgmma(m, k, n)
    if plan is None:           # K = 0, or nothing to compute
        design = "tiled"
    elif design == "wgmma" and not packed:
        b_q = pack_int8_weight_cuda(b_q)
        int8_matmul_cuda.pack_launches += 1
    out = _launch(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype,
                  qmin, qmax, design, plan)
    if m and n:
        int8_matmul_cuda.launches += 1
        if design == "splitk":
            int8_matmul_cuda.splitk_launches += 1
        elif design == "wgmma":
            int8_matmul_cuda.wgmma_launches += 1
    return out


int8_matmul_cuda.launches = 0
int8_matmul_cuda.splitk_launches = 0
int8_matmul_cuda.wgmma_launches = 0
int8_matmul_cuda.pack_launches = 0


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
                  qmin, qmax, "splitk", plan)
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
                  qmin, qmax, "tiled", None)
    if m and n:
        int8_matmul_tiled.launches += 1
    return out


int8_matmul_tiled.launches = 0


def int8_matmul_wgmma(a_q, b_q, sa, za, sb, zb, bias=None, so=None, zo=None,
                      *, act=None, out_dtype=torch.float32, qmin=-128,
                      qmax=127, bn: Optional[int] = None,
                      persistent: Optional[bool] = None) -> torch.Tensor:
    """The wgmma kernel at any shape it takes (M, N >= 1, K a positive
    multiple of 16, 16-byte aligned bases), with ``int8_matmul_cuda``'s
    arguments but ``b_q`` a ``PackedInt8Weight``.  ``bn`` and
    ``persistent`` override the plan (see ``_plan_wgmma``).  Raises where
    the kernel does not take the arguments.  Counts its launches in
    ``int8_matmul_wgmma.launches``."""
    if not isinstance(b_q, PackedInt8Weight):
        raise ValueError("the wgmma kernel takes a PackedInt8Weight "
                         "(pack_int8_weight)")
    m, k, n = _validated(a_q, b_q, sa, za, sb, zb, bias, so, zo, act,
                         out_dtype)
    plan = _plan_wgmma(m, k, n, bn, persistent)
    if plan is None or a_q.data_ptr() % 16 or b_q.nk.data_ptr() % 16:
        raise ValueError(f"the wgmma kernel does not take M {m}, K {k}, "
                         f"N {n} (or an unaligned base)")
    out = _launch(a_q, b_q, sa, za, sb, zb, bias, so, zo, act, out_dtype,
                  qmin, qmax, "wgmma", plan)
    int8_matmul_wgmma.launches += 1
    return out


int8_matmul_wgmma.launches = 0
