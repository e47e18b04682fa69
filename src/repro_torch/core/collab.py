"""Cloud-edge collaborative inference runtime (paper Fig. 1, right side).

Counterpart of ``repro.core.collab``.  A model participates as a
``SegmentedModel``: an ordered list of single-tensor-in /
single-tensor-out segments whose boundaries are exactly the candidate
partition points of its ``LayerGraph``.

``CollaborativeEngine`` implements the deployment flow:

  edge:  INT8 engine — weights stored int8 per channel (the "model
         download", dequantized once), activations statically
         calibrated per tensor (off-line profiling), executed as
         fake-quant on the Eq.(1) lattice.
  wire:  the boundary blob is quantized per Eq.(1) → int8 + (scale, zp),
         charged on a simulated wireless ``Channel``.
  cloud: dequantizes per Eq.(2) and runs the fp32 suffix.

Both sides run eagerly where the engine's ``device`` says (the card
unless the caller passes ``device="cpu"``); each wall time ends in a
``torch.cuda.synchronize`` on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.bridge import tree_map
from repro_torch.core.costmodel import QP_BYTES, Channel
from repro_torch.core.graph import LayerGraph
from repro_torch.core.partition import candidate_partition_points
from repro_torch.core.quant import (QuantParams, compute_qparams, dequantize,
                                    dequantize_pytree, fake_quant,
                                    pytree_quant_bytes, quantize,
                                    quantize_pytree)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import QuantCtx, make_calib_ctx

Params = Any
ApplyFn = Callable[..., torch.Tensor]     # (params, x, *, qctx=None) -> y


@dataclasses.dataclass
class Segment:
    name: str                  # must equal a candidate point in the graph
    apply: ApplyFn
    params: Params


@dataclasses.dataclass
class SegmentedModel:
    name: str
    graph: LayerGraph
    segments: List[Segment]
    max_blobs: int = 1

    def candidate_names(self) -> List[str]:
        return [c.name for c in candidate_partition_points(
            self.graph, max_blobs=self.max_blobs)]

    def full_apply(self, x: torch.Tensor) -> torch.Tensor:
        for seg in self.segments:
            x = seg.apply(seg.params, x)
        return x

    def verify_alignment(self) -> None:
        cands = set(self.candidate_names())
        for seg in self.segments:
            if seg.name not in cands:
                raise ValueError(
                    f"segment {seg.name} is not a candidate partition "
                    f"point; candidates: {sorted(cands)}")


@dataclasses.dataclass
class TransmissionRecord:
    blob_bytes: int
    precision: str
    simulated_latency_s: float
    edge_wall_s: float
    cloud_wall_s: float


def _run(segments: Sequence[Segment], params: Sequence[Params],
         h: torch.Tensor, qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    for seg, p in zip(segments, params):
        h = seg.apply(p, h, qctx=qctx)
    return h


@dataclasses.dataclass
class _LatticeTrace(QuantCtx):
    """A static ``QuantCtx`` that keeps each activation's lattice in call
    order and, given ``force`` (another run's lattices in that order),
    goes on from those rather than from its own."""
    lattices: List[torch.Tensor] = dataclasses.field(default_factory=list)
    force: Optional[List[torch.Tensor]] = None

    def act(self, x: torch.Tensor, name: Optional[str] = None
            ) -> torch.Tensor:
        qp = self.scales.get(name)
        if qp is None:
            return x
        self.lattices.append(quantize(x, qp))
        if self.force is None:
            return fake_quant(x, qp)
        return dequantize(self.force[len(self.lattices) - 1], qp)


class CollaborativeEngine:
    """Mixed-precision split inference at a chosen partition point."""

    def __init__(self, model: SegmentedModel, cut: str, *,
                 channel: Optional[Channel] = None,
                 calib_batches: Optional[Sequence[torch.Tensor]] = None,
                 a_bits: int = 8, w_bits: int = 8,
                 device: DeviceLike = None):
        names = [s.name for s in model.segments]
        if cut == "input":
            k = -1
        elif cut in names:
            k = names.index(cut)
        else:
            raise ValueError(f"{cut} not in segments {names}")
        self.device = resolve_device(device)
        self.model = model
        self.cut = cut
        self.channel = channel or Channel(bandwidth_bytes_per_s=float("inf"))
        self.edge_segments = model.segments[: k + 1]
        self.cloud_segments = model.segments[k + 1:]
        self.a_bits, self.w_bits = a_bits, w_bits
        to_dev = lambda t: t.to(self.device)  # noqa: E731

        # --- off-line: quantize the edge model (the "model download") ----
        edge_params = [tree_map(to_dev, s.params) for s in self.edge_segments]
        edge_q, edge_qp = quantize_pytree(edge_params, bits=w_bits)
        fp_bytes, q_bytes = pytree_quant_bytes(edge_params, bits=w_bits)
        self.edge_download_bytes = q_bytes
        self.edge_fp32_bytes = fp_bytes
        total_fp, _ = pytree_quant_bytes([s.params for s in model.segments],
                                         bits=w_bits)
        self.storage_reduction = 1.0 - (q_bytes / total_fp if total_fp
                                        else 0.0)
        # what the deployed edge engine computes with: the int8-stored
        # weights, dequantized once, and ``edge_qctx`` (below)
        self.edge_params = dequantize_pytree(edge_q, edge_qp)
        self._cloud_params = [tree_map(to_dev, s.params)
                              for s in self.cloud_segments]

        # --- off-line: calibrate edge activation thresholds --------------
        self.act_scales: Dict[str, QuantParams] = {}
        if calib_batches is not None and self.edge_segments:
            ctx = make_calib_ctx(a_bits=a_bits, w_bits=w_bits)
            with torch.no_grad():
                for xb in calib_batches:
                    _run(self.edge_segments, edge_params,
                         xb.to(self.device), ctx)
            self.act_scales = ctx.finalize_calibration()
        self.edge_qctx = (
            QuantCtx(mode="static", scales=self.act_scales, a_bits=a_bits,
                     w_bits=w_bits) if self.act_scales else
            QuantCtx(mode="dynamic", a_bits=a_bits, w_bits=w_bits))

    # -- engines -----------------------------------------------------------
    @torch.no_grad()
    def edge_forward(self, x: torch.Tensor) -> torch.Tensor:
        """INT8 engine: runs the prefix with quantized weights + acts."""
        return _run(self.edge_segments, self.edge_params,
                    x.to(self.device), self.edge_qctx)

    @torch.no_grad()
    def cloud_forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self.cloud_segments, self._cloud_params,
                    x.to(self.device))

    def boundary(self, h: torch.Tensor) -> Tuple[torch.Tensor, QuantParams]:
        """Eq.(1) of the edge's output: the int8 blob and its (scale,
        zero point), one range for the whole tensor."""
        qp = compute_qparams(h, bits=self.a_bits)
        return quantize(h, qp), qp

    @torch.no_grad()
    def last_edge_input(self, x: torch.Tensor) -> torch.Tensor:
        """What the last edge segment reads: ``x`` through the INT8
        engine's other segments."""
        return _run(self.edge_segments[:-1], self.edge_params[:-1],
                    x.to(self.device), self.edge_qctx)

    @torch.no_grad()
    def last_edge_trace(self, h: torch.Tensor, *,
                        force: Optional[Sequence[torch.Tensor]] = None,
                        scales: Optional[Dict[str, QuantParams]] = None
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The last edge segment of a calibrated engine run on ``h`` (from
        ``last_edge_input`` of this or another engine) → (its float
        output, the lattice of each static activation in call order).
        Given ``force`` (another engine's lattices of this segment), each
        activation goes on from the forced lattice instead of its own, so
        every lattice is this engine's quantizer on the float that the
        other engine's lattices lead to: teacher-forced lattice by
        lattice, where feeding ``h`` alone forces only the segment's
        input.  ``scales`` (another engine's ``act_scales``) replaces this
        engine's calibrated ranges."""
        to_dev = lambda t: t.to(self.device)  # noqa: E731
        ctx = _LatticeTrace(
            mode="static", a_bits=self.a_bits, w_bits=self.w_bits,
            scales={k: dataclasses.replace(qp, scale=to_dev(qp.scale),
                                           zero_point=to_dev(qp.zero_point))
                    for k, qp in (scales or self.act_scales).items()},
            force=None if force is None else [to_dev(t) for t in force])
        z = _run(self.edge_segments[-1:], self.edge_params[-1:],
                 to_dev(h), ctx)
        return z, ctx.lattices

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- end-to-end ----------------------------------------------------------
    def infer(self, x: torch.Tensor
              ) -> Tuple[torch.Tensor, TransmissionRecord]:
        t0 = time.perf_counter()
        if self.edge_segments:
            h = self.edge_forward(x)
            self._sync()
            t1 = time.perf_counter()
            blob, qp = self.boundary(h)
            # payload + the Eq.(1) scale/zero-point frame (the canonical
            # constant the serving engines and the cost model charge)
            blob_bytes = blob.numel() * blob.element_size() + int(QP_BYTES)
            precision = "int8"
            h = dequantize(blob, qp)                      # Eq.(2)
        else:
            t1 = time.perf_counter()
            blob_bytes = x.numel() * 4
            precision = "fp32"
            h = x
        latency = self.channel.transfer_time(blob_bytes)
        y = self.cloud_forward(h)
        self._sync()
        t2 = time.perf_counter()
        return y, TransmissionRecord(
            blob_bytes=int(blob_bytes), precision=precision,
            simulated_latency_s=latency, edge_wall_s=t1 - t0,
            cloud_wall_s=t2 - t1)
