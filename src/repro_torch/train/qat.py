"""Quantization-aware training: train with the paper's Eq.(1)/(2)
lattice in the loss (``fake_quant`` with the clipped straight-through
gradient, ``core.quant``), so the INT8 edge engine loses (almost)
nothing at deployment.  Counterpart of ``repro.train.qat``.

Usage: wrap any model loss that threads ``qctx``:

    qat_loss = make_qat_loss(lambda p, b, qctx: my_loss(p, b, qctx=qctx))
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.models.layers import QuantCtx

__all__ = ["make_qat_loss", "qat_ctx"]


def qat_ctx(*, w_bits: int = 8, a_bits: int = 8,
            per_channel: bool = True) -> QuantCtx:
    """Dynamic fake-quant context: thresholds from each batch (the
    paper's per-tensor activation quantization)."""
    return QuantCtx(mode="dynamic", w_bits=w_bits, a_bits=a_bits,
                    per_channel=per_channel)


def make_qat_loss(loss_with_qctx: Callable[..., Any], *, w_bits: int = 8,
                  a_bits: int = 8) -> Callable[..., Any]:
    ctx = qat_ctx(w_bits=w_bits, a_bits=a_bits)

    def loss(params, batch):
        return loss_with_qctx(params, batch, ctx)

    return loss
