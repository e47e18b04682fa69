"""Plain PyTorch versions of the quantized-compute kernels.

Counterpart of ``repro.kernels.ref``: the paper's "On-device
Computation" (§2.1 steps 1-4) with an int32 accumulator and the full
asymmetric zero-point correction

    real = sa·sb·(A_q·B_q − za·colsum(B_q) − zb·rowsum(A_q) + za·zb·K)

followed by bias, activation and an optional Eq.(1) requantization.
The epilogue runs in f32 in the reference's order of operations.  These
are the oracle the CUDA kernel (``kernels.int8_matmul``) is held against
and the path a CPU tensor takes; on the card nothing else uses them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantParams, quantize

__all__ = ["int8_epilogue_ref", "int8_matmul_ref", "pack_int8_weight_ref",
           "quantized_dense_ref"]

# jax.nn.gelu defaults to the tanh approximation; torch's default is erf
_ACTS = {
    None: lambda x: x,
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


def _int_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``A_q @ B_q``.  PyTorch has no integer matmul on CUDA,
    so there the product runs in f64, which holds every int8·int8 sum of
    up to 2^38 terms exactly."""
    if a_q.is_cuda:
        return (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(
            torch.int32)
    return a_q.to(torch.int32) @ b_q.to(torch.int32)


def int8_matmul_ref(a_q: torch.Tensor, b_q: torch.Tensor, qa: QuantParams,
                    qb: QuantParams, *, bias: Optional[torch.Tensor] = None,
                    act: Optional[str] = None,
                    out_qp: Optional[QuantParams] = None) -> torch.Tensor:
    """Paper steps 1-4 on int8 ``a_q`` [M, K] and ``b_q`` [K, N]:
    integer matmul → Eq.(2) dequant → activation → Eq.(1) requant.
    ``qa`` is per-tensor; ``qb`` per-tensor or per-channel (axis 1).
    Returns f32 [M, N], or ``out_qp.storage_dtype`` when requantizing."""
    m, k = a_q.shape
    k2, n = b_q.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)}")
    acc = _int_matmul(a_q, b_q)                                # [M, N]
    rowsum_a = torch.sum(a_q, dim=1, keepdim=True, dtype=torch.int32)
    colsum_b = torch.sum(b_q, dim=0, keepdim=True, dtype=torch.int32)
    return int8_epilogue_ref(acc, rowsum_a, colsum_b, k, qa, qb, bias=bias,
                             act=act, out_qp=out_qp)


def int8_epilogue_ref(acc: torch.Tensor, rowsum_a: torch.Tensor,
                      colsum_b: torch.Tensor, k: int, qa: QuantParams,
                      qb: QuantParams, *,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None,
                      out_qp: Optional[QuantParams] = None) -> torch.Tensor:
    """Steps 2-4 of ``int8_matmul_ref`` on the exact int32 sums: ``acc``
    [M, N] = A_q·B_q, ``rowsum_a`` [M, 1], ``colsum_b`` [1, N], over a
    depth of ``k``."""
    dev = acc.device

    def f32(t, shape):
        return torch.as_tensor(t, dtype=torch.float32,
                               device=dev).reshape(shape)

    sa, za = f32(qa.scale, (1, 1)), f32(qa.zero_point, (1, 1))
    sb, zb = f32(qb.scale, (1, -1)), f32(qb.zero_point, (1, -1))
    real = sa * sb * (acc.to(torch.float32)
                      - za * colsum_b.to(torch.float32)
                      - zb * rowsum_a.to(torch.float32)
                      + za * zb * float(k))
    if bias is not None:
        real = real + f32(bias, (1, -1))
    real = _ACTS[act](real)
    if out_qp is None:
        return real
    q = torch.round(real / f32(out_qp.scale, ()) + f32(out_qp.zero_point, ()))
    return torch.clamp(q, out_qp.qmin, out_qp.qmax).to(out_qp.storage_dtype)


def quantized_dense_ref(x: torch.Tensor, w_q: torch.Tensor, qx: QuantParams,
                        qw: QuantParams, *,
                        bias: Optional[torch.Tensor] = None,
                        act: Optional[str] = None,
                        out_qp: Optional[QuantParams] = None
                        ) -> torch.Tensor:
    """fp input [..., K] → quantize (Eq.1) → int8 matmul → epilogue."""
    lead = x.shape[:-1]
    x_q = quantize(x.reshape(-1, x.shape[-1]), qx)
    out = int8_matmul_ref(x_q, w_q, qx, qw, bias=bias, act=act,
                          out_qp=out_qp)
    return out.reshape(*lead, out.shape[-1])


def pack_int8_weight_ref(w_q: torch.Tensor) -> tuple:
    """The pack kernel's plain version: int8 ``w_q`` [K, N] → (its
    contiguous K-major copy [N, K], its exact int32 colsum [N])."""
    return w_q.t().contiguous(), w_q.sum(0, dtype=torch.int32)
