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

Also here: the clipped straight-through gradient of ``fake_quant``
(quantization-aware training), the min/max, percentile and EMA
calibrators (the paper's off-line profiling step) and the
parameter-tree helpers of the edge's INT8 model download.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["QuantParams", "compute_qparams", "quantize", "dequantize",
           "fake_quant", "MinMaxCalibrator", "PercentileCalibrator",
           "EMACalibrator", "quantize_pytree", "dequantize_pytree",
           "pytree_quant_bytes"]


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


@functools.lru_cache(maxsize=None)
def _range_divisor(device: torch.device, bits: int) -> torch.Tensor:
    """Range_LP as a 0-dim f32 tensor on ``device``, made once per
    (device, bits).  Torch on CUDA computes a division by a Python
    number as a product with its reciprocal, one ulp off the quotient
    now and then; by a tensor on the same device it divides, as its CPU
    kernel and eager JAX do."""
    return torch.tensor(float(2 ** bits - 1), dtype=torch.float32,
                        device=device)


def _minmax_to_qparams(t_min: torch.Tensor, t_max: torch.Tensor, *,
                       bits: int, signed: bool,
                       axis: Optional[int]) -> QuantParams:
    """Thresholds → (scale, zero_point), the paper's "Step 1".  An f32
    span is divided by ``_range_divisor``, so the same span gives the
    same scale on the card and on the CPU (eager JAX's quotient; jitted
    XLA multiplies by the reciprocal instead).  A bf16 or f16 span keeps
    the Python divisor, which both devices' kernels turn into a product
    with its reciprocal."""
    t_min = torch.clamp(t_min, max=0.0)   # keep 0 representable
    t_max = torch.clamp(t_max, min=0.0)
    range_lp = float(2 ** bits - 1)
    span = torch.clamp(t_max - t_min, min=1e-12)
    scale = span / (_range_divisor(span.device, bits)
                    if span.dtype == torch.float32 else range_lp)
    qmin = -(2 ** (bits - 1)) if signed else 0
    zero_point = torch.round(qmin - t_min / scale)
    zero_point = torch.clamp(zero_point, qmin, qmin + range_lp)
    return QuantParams(scale=scale.to(torch.float32),
                       zero_point=zero_point.to(torch.float32),
                       axis=axis, bits=bits, signed=signed)


def _reduce_minmax(x: torch.Tensor, axis: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    if axis is None:
        return torch.amin(x), torch.amax(x)
    red = tuple(d for d in range(x.ndim) if d != axis)
    if not red:
        return x, x
    return torch.amin(x, dim=red), torch.amax(x, dim=red)


def compute_qparams(x: torch.Tensor, *, axis: Optional[int] = None,
                    bits: int = 8, signed: bool = True,
                    symmetric: bool = False) -> QuantParams:
    """One-shot min/max calibration of a single tensor (paper Step 1).

    The reduced dims are ``range(x.ndim)`` minus ``axis`` exactly as in
    the JAX reference, so a negative ``axis`` reduces every dim there
    too (one range for the tensor) and the lattices stay identical."""
    t_min, t_max = _reduce_minmax(x, axis)
    if symmetric:
        amax = torch.maximum(torch.abs(t_min), torch.abs(t_max))
        t_min, t_max = -amax, amax
    return _minmax_to_qparams(t_min, t_max, bits=bits, signed=signed,
                              axis=axis)


def _promoted(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """``x`` in the dtype JAX computes ``x / scale`` in.  Torch lets a
    0-dim f32 scale (one range for the tensor) keep a bf16 ``x`` in
    bf16; JAX promotes it to f32, and so the lattice is taken in f32."""
    return x.to(torch.promote_types(x.dtype, qp.scale.dtype))


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Paper Eq.(1): real → low-precision lattice, with saturation."""
    x = _promoted(x, qp)
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


def _roundtrip(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               qmin: float, qmax: float) -> torch.Tensor:
    q = torch.clamp(torch.round(x / scale + zp), qmin, qmax)
    return (q - zp) * scale


class _ClippedSTE(torch.autograd.Function):
    """The reference's ``_ste_roundtrip``: the Eq.(1)/(2) round trip
    forward; backward passes the gradient where the value before
    rounding was representable (``qmin - 0.5 <= x / scale + zp <= qmax
    + 0.5``) and gives 0 where it saturated.  Scale and zero point get
    no gradient, as the reference's backward returns ``None`` for them."""

    @staticmethod
    def forward(ctx, x, scale, zp, qmin, qmax):
        if ctx.needs_input_grad[0]:
            t = x / scale + zp
            ctx.save_for_backward((t >= qmin - 0.5) & (t <= qmax + 0.5))
        return _roundtrip(x, scale, zp, qmin, qmax)

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return (torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                                   device=g.device)),
                None, None, None, None)


def fake_quant(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Quantize→dequantize on the Eq.(1) lattice with the reference's
    clipped straight-through gradient (QAT).  Without autograd
    recording a gradient of ``x`` the round trip runs plainly: the same
    operations, bit for bit."""
    x = _promoted(x, qp)
    scale = qp._bcast(qp.scale, x.ndim)
    zp = qp._bcast(qp.zero_point, x.ndim)
    lo, hi = float(qp.qmin), float(qp.qmax)
    if torch.is_grad_enabled() and x.requires_grad:
        return _ClippedSTE.apply(x, scale.detach(), zp.detach(), lo, hi)
    return _roundtrip(x, scale, zp, lo, hi)


class MinMaxCalibrator:
    """Running global min/max over observed batches (paper Step 1, run
    off-line over calibration batches)."""

    def __init__(self, *, axis: Optional[int] = None, bits: int = 8,
                 signed: bool = True, symmetric: bool = False):
        self.axis, self.bits, self.signed = axis, bits, signed
        self.symmetric = symmetric
        self._min: Optional[torch.Tensor] = None
        self._max: Optional[torch.Tensor] = None

    def observe(self, x: torch.Tensor) -> None:
        lo, hi = _reduce_minmax(x, self.axis)
        if self._min is None:
            self._min, self._max = lo, hi
        else:
            self._min = torch.minimum(self._min, lo)
            self._max = torch.maximum(self._max, hi)

    def qparams(self) -> QuantParams:
        if self._min is None:
            raise RuntimeError("observe() at least one batch first")
        t_min, t_max = self._min, self._max
        if self.symmetric:
            amax = torch.maximum(torch.abs(t_min), torch.abs(t_max))
            t_min, t_max = -amax, amax
        return _minmax_to_qparams(t_min, t_max, bits=self.bits,
                                  signed=self.signed, axis=self.axis)


class PercentileCalibrator:
    """Clip thresholds at a percentile of the observed values — robust to
    activation outliers (per tensor only).  The reference's numpy
    arithmetic: each batch subsampled with a fixed stride to about 65,536
    values, at most ``1 << 22`` values kept (the oldest batches dropped),
    thresholds by ``np.percentile``."""

    def __init__(self, percentile: float = 99.9, *, bits: int = 8,
                 signed: bool = True):
        if not 50.0 < percentile <= 100.0:
            raise ValueError(f"percentile {percentile} not in (50, 100]")
        self.percentile, self.bits, self.signed = percentile, bits, signed
        self._samples: list = []
        self._budget = 1 << 22
        self._device: Optional[torch.device] = None

    def observe(self, x: torch.Tensor) -> None:
        self._device = x.device
        flat = x.detach().to(torch.float32).cpu().numpy().ravel()
        if flat.size > 65536:
            flat = flat[::flat.size // 65536]
        self._samples.append(flat)
        total = sum(s.size for s in self._samples)
        while total > self._budget and len(self._samples) > 1:
            total -= self._samples.pop(0).size

    def qparams(self) -> QuantParams:
        if not self._samples:
            raise RuntimeError("observe() at least one batch first")
        allv = np.concatenate(self._samples)
        lo = np.float32(np.percentile(allv, 100.0 - self.percentile))
        hi = np.float32(np.percentile(allv, self.percentile))
        t = functools.partial(torch.tensor, dtype=torch.float32,
                              device=self._device)
        return _minmax_to_qparams(t(lo), t(hi), bits=self.bits,
                                  signed=self.signed, axis=None)


class EMACalibrator:
    """Exponential-moving-average min/max (TensorRT-style smoothing):
    ``m * old + (1 - m) * new`` in f32, as the reference's weak-typed
    scalars compute it."""

    def __init__(self, momentum: float = 0.95, *, axis: Optional[int] = None,
                 bits: int = 8, signed: bool = True):
        self.momentum, self.axis = momentum, axis
        self.bits, self.signed = bits, signed
        self._min: Optional[torch.Tensor] = None
        self._max: Optional[torch.Tensor] = None

    def observe(self, x: torch.Tensor) -> None:
        lo, hi = _reduce_minmax(x, self.axis)
        if self._min is None:
            self._min, self._max = lo, hi
        else:
            m = self.momentum
            self._min = m * self._min + (1 - m) * lo
            self._max = m * self._max + (1 - m) * hi

    def qparams(self) -> QuantParams:
        if self._min is None:
            raise RuntimeError("observe() at least one batch first")
        return _minmax_to_qparams(self._min, self._max, bits=self.bits,
                                  signed=self.signed, axis=self.axis)


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts and lists of tensors) — the edge engine's
# model download is the quantized tree (the paper's "model storage
# reduction").
# ---------------------------------------------------------------------------


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def quantize_pytree(params: Any, *, bits: int = 8, signed: bool = True,
                    per_channel: bool = True,
                    symmetric_weights: bool = False) -> Tuple[Any, Any]:
    """Quantize every float leaf → (q_tree, qp_tree).  A rank ≥ 2 leaf
    is quantized per channel along its last (output-feature) axis, a
    bias per tensor; a non-float leaf passes through with ``None``."""
    kw = dict(bits=bits, signed=signed, per_channel=per_channel,
              symmetric_weights=symmetric_weights)
    if isinstance(params, dict):
        pairs = {k: quantize_pytree(v, **kw) for k, v in params.items()}
        return ({k: q for k, (q, _) in pairs.items()},
                {k: qp for k, (_, qp) in pairs.items()})
    if isinstance(params, (list, tuple)):
        pairs = [quantize_pytree(v, **kw) for v in params]
        return (type(params)(q for q, _ in pairs),
                type(params)(qp for _, qp in pairs))
    if not params.is_floating_point():
        return params, None
    axis = params.ndim - 1 if per_channel and params.ndim >= 2 else None
    qp = compute_qparams(params, axis=axis, bits=bits, signed=signed,
                         symmetric=symmetric_weights)
    return quantize(params, qp), qp


def dequantize_pytree(q_tree: Any, qp_tree: Any) -> Any:
    """Inverse of ``quantize_pytree``: lattice leaves → f32 (Eq. 2)."""
    if isinstance(q_tree, dict):
        return {k: dequantize_pytree(v, qp_tree[k])
                for k, v in q_tree.items()}
    if isinstance(q_tree, (list, tuple)):
        return type(q_tree)(dequantize_pytree(v, qp)
                            for v, qp in zip(q_tree, qp_tree))
    return q_tree if qp_tree is None else dequantize(q_tree, qp_tree)


def pytree_quant_bytes(params: Any, *, bits: int = 8) -> Tuple[int, int]:
    """(fp32 bytes, quantized bytes incl. 8 B of scale/zero point per
    leaf)."""
    fp = qb = 0
    for leaf in _tree_leaves(params):
        n = leaf.numel()
        fp += n * 4
        qb += (n * bits + 7) // 8 + 8
    return fp, qb
