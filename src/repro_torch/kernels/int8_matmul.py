"""Launcher of the fused INT8 GEMM kernel (``csrc/int8_matmul.cu``).

Counterpart of ``repro.kernels.int8_matmul.int8_matmul_pallas``: int8
``a_q`` [M, K] @ int8 ``b_q`` [K, N] with an int32 accumulator, the exact
asymmetric zero-point correction and a fused activation / requant
epilogue (see the CUDA source).  Unlike the TPU kernel it takes any
shape: the kernel predicates its loads and stores, so nothing is padded
on the host and ``true_k`` is simply K.  Launches are counted in
``int8_matmul_cuda.launches``.  The front doors that dispatch on the
tensor's device are in ``kernels.ops``; the plain version is
``kernels.ref.int8_matmul_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["int8_matmul_cuda"]

_ACT_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3}
_OUT_CODES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3}


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded on first use."""
    fn = _build.load("int8_matmul").int8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def int8_matmul_cuda(a_q: torch.Tensor, b_q: torch.Tensor,
                     sa: torch.Tensor, za: torch.Tensor,
                     sb: torch.Tensor, zb: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     so: Optional[torch.Tensor] = None,
                     zo: Optional[torch.Tensor] = None, *,
                     act: Optional[str] = None,
                     out_dtype: torch.dtype = torch.float32,
                     qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """Launch the Hopper kernel on contiguous CUDA tensors: ``a_q`` int8
    [M, K], ``b_q`` int8 [K, N]; ``sa``/``za`` (and ``so``/``zo`` when
    ``out_dtype`` is an integer type) f32 of one element; ``sb``/``zb``
    and ``bias`` (or None) f32 [N].  Returns ``out_dtype`` [M, N]: f32,
    or the requantized lattice clipped to [qmin, qmax]."""
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
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if m == 0 or n == 0:
        return out
    rc = _launcher()(
        a_q.data_ptr(), b_q.data_ptr(), sa.data_ptr(), za.data_ptr(),
        sb.data_ptr(), zb.data_ptr(), _ptr(bias), _ptr(so), _ptr(zo),
        out.data_ptr(), m, n, k, _ACT_CODES[act], _OUT_CODES[out_dtype],
        qmin, qmax, torch.cuda.current_stream(a_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed (code {rc})")
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0
