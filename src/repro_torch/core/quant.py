"""Scalar INT8 quantization core — paper §2.1, Eq. (1)/(2), in PyTorch.

Counterpart of ``repro.core.quant``: the same asymmetric affine
(min/max-threshold) scheme

    scale      = (T_max - T_min) / Range_LP
    zero_point = round(qmin - T_min / scale)     (clipped)
    q          = clip(round(x / scale + zero_point), q_min, q_max)
    x̂          = scale * (q - zero_point)

on the same lattice bit for bit: ``torch.round`` rounds half to even
like ``jnp.round``, and every intermediate keeps the dtype the JAX code
gives it (a bf16 input keeps its thresholds in bf16 until the final
cast, exactly as JAX's weak-typed scalars do).

Only the forward path the serving slice runs is here; the
straight-through gradient and the calibrators come with training.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["QuantParams", "compute_qparams", "quantize", "dequantize",
           "fake_quant"]


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Affine quantization parameters for one tensor.

    ``scale``/``zero_point`` are f32 scalars (per-tensor) or 1-D tensors
    of length ``shape[axis]`` (per-channel)."""

    scale: torch.Tensor
    zero_point: torch.Tensor
    axis: Optional[int] = None
    bits: int = 8
    signed: bool = True

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2 ** self.bits - 1

    @property
    def range_lp(self) -> int:
        """The paper's Range_LP (255 for INT8)."""
        return 2 ** self.bits - 1

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.bits <= 8:
            return torch.int8 if self.signed else torch.uint8
        return torch.int16 if self.signed else torch.uint16

    def _bcast(self, arr: torch.Tensor, ndim: int) -> torch.Tensor:
        """Broadcast a per-channel vector against an ndim-rank tensor."""
        if self.axis is None or arr.ndim == 0:
            return arr
        shape = [1] * ndim
        shape[self.axis] = -1
        return arr.reshape(shape)


def _minmax_to_qparams(t_min: torch.Tensor, t_max: torch.Tensor, *,
                       bits: int, signed: bool,
                       axis: Optional[int]) -> QuantParams:
    """Thresholds → (scale, zero_point), the paper's "Step 1"."""
    t_min = torch.clamp(t_min, max=0.0)   # keep 0 representable
    t_max = torch.clamp(t_max, min=0.0)
    range_lp = float(2 ** bits - 1)
    span = torch.clamp(t_max - t_min, min=1e-12)
    scale = span / range_lp
    qmin = -(2 ** (bits - 1)) if signed else 0
    zero_point = torch.round(qmin - t_min / scale)
    zero_point = torch.clamp(zero_point, qmin, qmin + range_lp)
    return QuantParams(scale=scale.to(torch.float32),
                       zero_point=zero_point.to(torch.float32),
                       axis=axis, bits=bits, signed=signed)


def compute_qparams(x: torch.Tensor, *, axis: Optional[int] = None,
                    bits: int = 8, signed: bool = True,
                    symmetric: bool = False) -> QuantParams:
    """One-shot min/max calibration of a single tensor (paper Step 1).

    The reduced dims are ``range(x.ndim)`` minus ``axis`` exactly as in
    the JAX reference, so a negative ``axis`` reduces every dim there
    too (one range for the tensor) and the lattices stay identical."""
    if axis is None:
        t_min, t_max = torch.amin(x), torch.amax(x)
    else:
        red = tuple(d for d in range(x.ndim) if d != axis)
        if red:
            t_min, t_max = torch.amin(x, dim=red), torch.amax(x, dim=red)
        else:
            t_min, t_max = x, x
    if symmetric:
        amax = torch.maximum(torch.abs(t_min), torch.abs(t_max))
        t_min, t_max = -amax, amax
    return _minmax_to_qparams(t_min, t_max, bits=bits, signed=signed,
                              axis=axis)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Paper Eq.(1): real → low-precision lattice, with saturation."""
    scale = qp._bcast(qp.scale, x.ndim)
    zp = qp._bcast(qp.zero_point, x.ndim)
    q = torch.round(x / scale + zp)
    q = torch.clamp(q, qp.qmin, qp.qmax)
    return q.to(qp.storage_dtype)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Paper Eq.(2): lattice → real."""
    scale = qp._bcast(qp.scale, q.ndim)
    zp = qp._bcast(qp.zero_point, q.ndim)
    return (q.to(torch.float32) - zp) * scale


def fake_quant(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Quantize→dequantize on the Eq.(1) lattice (forward of the JAX
    reference's straight-through round trip)."""
    scale = qp._bcast(qp.scale, x.ndim)
    zp = qp._bcast(qp.zero_point, x.ndim)
    q = torch.clamp(torch.round(x / scale + zp), float(qp.qmin),
                    float(qp.qmax))
    return (q - zp) * scale
