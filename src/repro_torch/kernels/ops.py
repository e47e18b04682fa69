"""Front doors of the quantized-compute kernel.

Counterpart of ``repro.kernels.ops`` (``int8_matmul`` and
``quantized_dense``, with the reference's signatures less ``block`` and
``interpret``).  Each dispatches on the tensor's device alone: a CPU
tensor takes the plain version (``kernels.ref``), a CUDA tensor launches
the hand-written kernels (``kernels.int8_matmul``, which picks the
design by shape) or raises — nothing falls back.  The kernels take any
shape, so unlike the reference nothing is padded here; a per-tensor
``qb`` is broadcast to per-channel [N].  The weight is the reference's
int8 [K, N] tensor or a ``PackedInt8Weight`` (``pack_int8_weight``, made
once beside it); the plain version reads its [K, N] tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import QuantParams, quantize
from repro_torch.kernels.int8_matmul import (PackedInt8Weight, Weight,
                                             int8_matmul_cuda)
from repro_torch.kernels.ref import int8_matmul_ref

__all__ = ["int8_matmul", "kernel_args", "quantized_dense"]


def int8_matmul(a_q: torch.Tensor, b_q: Weight, qa: QuantParams,
                qb: QuantParams, *, bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                out_qp: Optional[QuantParams] = None) -> torch.Tensor:
    """Fused quantized matmul: int8 [M, K] @ int8 [K, N] (or its
    ``PackedInt8Weight``) → f32 [M, N], or ``out_qp.storage_dtype`` when
    ``out_qp`` requantizes the output."""
    if not a_q.is_cuda:
        kn = b_q.kn if isinstance(b_q, PackedInt8Weight) else b_q
        return int8_matmul_ref(a_q, kn, qa, qb, bias=bias, act=act,
                               out_qp=out_qp)
    args, kw = kernel_args(a_q, b_q, qa, qb, bias=bias, act=act,
                           out_qp=out_qp)
    return int8_matmul_cuda(*args, **kw)


def kernel_args(a_q: torch.Tensor, b_q: Weight, qa: QuantParams,
                qb: QuantParams, *, bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                out_qp: Optional[QuantParams] = None) -> tuple:
    """(args, kwargs) of the kernel launchers in ``kernels.int8_matmul``
    for ``int8_matmul``'s arguments on CUDA tensors: f32 scalars, the
    weight's scale and zero point per channel [N], the output type and
    lattice."""
    dev = a_q.device
    n = b_q.shape[-1]

    def f32(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev)

    def per_channel(t):
        return f32(t).reshape(-1).expand(n).contiguous()

    so = zo = None
    out_dtype = torch.float32
    qmin, qmax = -128, 127
    if out_qp is not None:
        so, zo = f32(out_qp.scale), f32(out_qp.zero_point)
        out_dtype, qmin, qmax = out_qp.storage_dtype, out_qp.qmin, out_qp.qmax
    if not isinstance(b_q, PackedInt8Weight):
        b_q = b_q.contiguous()
    return ((a_q.contiguous(), b_q, f32(qa.scale),
             f32(qa.zero_point), per_channel(qb.scale),
             per_channel(qb.zero_point),
             None if bias is None else f32(bias).contiguous(), so, zo),
            dict(act=act, out_dtype=out_dtype, qmin=qmin, qmax=qmax))


def quantized_dense(x: torch.Tensor, w_q: Weight, qx: QuantParams,
                    qw: QuantParams, *, bias: Optional[torch.Tensor] = None,
                    act: Optional[str] = None,
                    out_qp: Optional[QuantParams] = None) -> torch.Tensor:
    """fp activations [..., K] → Eq.(1) quantize → fused int8 matmul →
    epilogue: one full layer of the paper's on-device computation."""
    lead = x.shape[:-1]
    x_q = quantize(x.reshape(-1, x.shape[-1]), qx)
    out = int8_matmul(x_q, w_q, qx, qw, bias=bias, act=act, out_qp=out_qp)
    return out.reshape(*lead, out.shape[-1])
