"""Auto-tuning partition — the paper's Algorithm 1 — and its serving-time
sibling: auto-tuning the speculative draft length.

For every candidate cut L_i (from §2.2's rules):
  Net_edge  = Net.Split(First, L_i)   quantized to INT8
  Net_cloud = Net.Split(L_i+1, Last)  kept at FP32
  PredictPerformance(Engine_edge, Engine_cloud)   — from off-line profiles
and finally the best partition for the current environment (bandwidth)
is returned.  ``p_best`` minimizes end-to-end latency by default; the
paper also reports the "fastest" vs "best" distinction (best = fastest
subject to edge-storage/accuracy constraints) which we expose through
``constraints``.

``tune_spec_k`` applies the same predict-then-pick loop to the decode
round length k of the speculative collaborative engine: for every
candidate k it evaluates ``costmodel.speculative_round_time`` (draft k
tokens locally, one uplink, one batched verify, one downlink) at the
environment's channel and the measured/assumed draft acceptance rate,
and returns the k minimizing predicted time per *accepted* token.  k=1
is always a candidate and recovers the non-speculative step exactly, so
the tuner degrades gracefully on fast channels or poor drafts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import (
    CLOUD_TITANXP_CLASS, Channel, DeviceModel, EDGE_TX2_CLASS, MSG_BYTES,
    PhaseBreakdown, Profile, QP_BYTES, TOK_BYTES, expected_accepted_tokens,
    layer_time, speculative_round_time, subgraph_time)
from repro_torch.core.graph import LayerGraph
from repro_torch.core.partition import (CandidatePoint,
                                        candidate_partition_points,
                                        merge_non_parametric)

__all__ = ["PartitionPerf", "AutoTuner", "auto_tune", "SpecKPerf",
           "tune_spec_k", "spec_k_for_lm", "lm_round_args", "CutKPerf",
           "tune_cut_and_k"]


@dataclasses.dataclass(frozen=True)
class PartitionPerf:
    """The ``(L_i, info)`` record of Algorithm 1, line 8."""
    point: str
    edge_time_s: float
    upload_time_s: float
    cloud_time_s: float
    transmit_bytes: float
    edge_model_bytes: float          # quantized prefix download (paper Table 3)
    storage_reduction: float         # vs full fp32 model on device
    edge_flops: float
    n_blobs: int

    @property
    def total_s(self) -> float:
        return self.edge_time_s + self.upload_time_s + self.cloud_time_s


class AutoTuner:
    def __init__(self, graph: LayerGraph, edge: DeviceModel,
                 cloud: DeviceModel, *,
                 edge_profile: Optional[Profile] = None,
                 cloud_profile: Optional[Profile] = None,
                 max_blobs: int = 1,
                 loop_steps: int = 1,
                 quant_bits: int = 8):
        self.graph = graph
        self.merged = merge_non_parametric(graph)
        self.edge = edge
        self.cloud = cloud
        self.edge_profile = edge_profile
        self.cloud_profile = cloud_profile
        self.max_blobs = max_blobs
        self.loop_steps = loop_steps      # diffusion: transmissions per call
        self.quant_bits = quant_bits
        self.candidates: List[CandidatePoint] = candidate_partition_points(
            graph, max_blobs=max_blobs)
        self._total_param_bytes_fp32 = self.merged.total_param_elems() * 4.0

    # -- Algorithm 1 lines 3-9 -------------------------------------------
    def predict_performance(self, cand: CandidatePoint,
                            channel: Channel) -> PartitionPerf:
        order = self.merged.topo()
        ci = order.index(cand.name)
        prefix = order[: ci + 1]
        suffix = order[ci + 1:]
        edge_t = subgraph_time(self.merged, prefix, self.edge,
                               precision="int8", profile=self.edge_profile)
        cloud_t = subgraph_time(self.merged, suffix, self.cloud,
                                precision="fp32", profile=self.cloud_profile)
        # the input node itself costs nothing to "compute"
        upload_t = channel.transfer_time(cand.transmit_bytes)
        if self.loop_steps > 1:
            edge_t *= self.loop_steps
            cloud_t *= self.loop_steps
            upload_t *= self.loop_steps
        edge_param_bytes = cand.edge_param_elems * (self.quant_bits / 8.0)
        return PartitionPerf(
            point=cand.name,
            edge_time_s=edge_t,
            upload_time_s=upload_t,
            cloud_time_s=cloud_t,
            transmit_bytes=cand.transmit_bytes,
            edge_model_bytes=edge_param_bytes,
            storage_reduction=1.0 - (edge_param_bytes
                                     / max(self._total_param_bytes_fp32, 1.0)),
            edge_flops=cand.edge_flops,
            n_blobs=cand.n_blobs)

    # -- Algorithm 1 lines 10-14 -------------------------------------------
    def tune(self, channel: Channel, *,
             constraints: Optional[Callable[[PartitionPerf], bool]] = None,
             ) -> tuple[PartitionPerf, List[PartitionPerf]]:
        """Returns (p_best, P).  ``constraints`` filters feasible points
        (e.g. edge storage budget); best = argmin total latency among
        feasible, the paper's ``Env(p_i) is better than Env(p_best)``."""
        perfs = [self.predict_performance(c, channel) for c in self.candidates]
        feasible = [p for p in perfs if constraints is None or constraints(p)]
        if not feasible:
            feasible = perfs
        best = min(feasible, key=lambda p: p.total_s)
        return best, perfs

    def cloud_only(self, channel: Channel) -> PartitionPerf:
        """Baseline: ship the raw input, run everything in the cloud."""
        inp = [c for c in self.candidates
               if self.merged.nodes[c.name].op == "input"]
        assert inp, "graph has no input node"
        return self.predict_performance(inp[0], channel)

    def speedup_vs_cloud_only(self, channel: Channel) -> float:
        best, _ = self.tune(channel)
        return self.cloud_only(channel).total_s / best.total_s


def auto_tune(graph: LayerGraph, edge: DeviceModel, cloud: DeviceModel,
              channel: Channel, **kw) -> tuple[PartitionPerf, List[PartitionPerf]]:
    """One-shot convenience wrapper (Algorithm 1 end-to-end)."""
    return AutoTuner(graph, edge, cloud, **kw).tune(channel)


# ---------------------------------------------------------------------------
# Speculative draft-length auto-tuning (Algorithm 1's loop applied to k)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecKPerf:
    """The ``(k, info)`` record of the spec-k tuning loop."""
    k: int
    breakdown: PhaseBreakdown                # one round, tokens = E[accepts]
    uplink_bytes_per_token: float            # wire bytes per accepted token

    @property
    def s_per_token(self) -> float:
        return self.breakdown.per_token_s


def tune_spec_k(*, edge_flops: float, cloud_flops: float, blob_bytes: float,
                edge: DeviceModel, cloud: DeviceModel, channel: Channel,
                draft_flops: float = 0.0, acceptance: float = 0.8,
                ks: Sequence[int] = (1, 2, 4, 8, 16, 32),
                return_bytes: float = 4.0, rows: int = 1,
                cloud_layers: int = 0, cloud_act_bytes: float = 0.0,
                draft_q_bytes: float = 0.0,
                ) -> Tuple[SpecKPerf, List[SpecKPerf]]:
    """Pick the draft length k minimizing predicted time per accepted
    token for this channel/acceptance-rate — per-step flop/byte inputs
    are exactly ``collab_decode_step_time``'s, and the k=1 candidate
    evaluates to exactly that non-speculative step.  ``draft_q_bytes``
    (sampled traffic's shipped draft distributions, see
    ``speculative_round_time``) makes large k pay its real uplink, so
    hot sampling traffic tunes to a smaller k than greedy."""
    perfs = []
    for k in ks:
        bd = speculative_round_time(
            k=k, edge_flops=edge_flops, cloud_flops=cloud_flops,
            blob_bytes=blob_bytes, edge=edge, cloud=cloud, channel=channel,
            draft_flops=draft_flops, acceptance=acceptance,
            return_bytes=return_bytes, rows=rows,
            cloud_layers=cloud_layers, cloud_act_bytes=cloud_act_bytes,
            draft_q_bytes=draft_q_bytes)
        uplink = k * blob_bytes \
            + (k - 1) * (TOK_BYTES * rows + draft_q_bytes) + MSG_BYTES
        perfs.append(SpecKPerf(
            k=k, breakdown=bd,
            uplink_bytes_per_token=uplink
            / expected_accepted_tokens(k, acceptance)))
    best = min(perfs, key=lambda p: p.s_per_token)
    return best, perfs


def lm_round_args(cfg, cut_layer: int, *, batch: int,
                  sampled_frac: float = 0.0) -> dict:
    """Per-step flop/byte arguments of ``tune_spec_k`` /
    ``speculative_round_time`` for an ``LMConfig`` split at
    ``cut_layer``: INT8 edge prefix of ``cut_layer + 1`` blocks, FP32
    cloud suffix + head, Eq.(1)-framed ``[B, 1, D]`` boundary delta.
    The edge's draft model is the INT8 suffix copy, so ``draft_flops``
    equals the cloud suffix's per-step flops (run at INT8 throughput).
    ``sampled_frac`` is the fraction of live slots decoding at
    temperature>0: each such row ships its f32 draft distribution per
    graded position (``draft_q_bytes`` — serve.spec's q-row uplink).

    This is the model half the online policy (``serve.policy``)
    re-evaluates against live telemetry — one dict per candidate cut,
    shared by the offline and online tuners."""
    blk = cfg.block_param_count()
    head = cfg.vocab * cfg.d_model + cfg.d_model
    suffix = 2 * (blk * (cfg.n_layers - cut_layer - 1) + head) * batch
    return dict(
        edge_flops=2 * blk * (cut_layer + 1) * batch,
        cloud_flops=suffix, draft_flops=suffix,
        blob_bytes=batch * (cfg.d_model + QP_BYTES),
        return_bytes=TOK_BYTES * batch, rows=batch,
        draft_q_bytes=sampled_frac * batch * cfg.vocab * 4.0,
        # TP all-reduce inputs: suffix depth and the [B, 1, D] f32
        # activation each of its blocks reduces (costmodel._tp_allreduce_s
        # charges them only when cloud.n_chips > 1 with a modeled link)
        cloud_layers=cfg.n_layers - cut_layer - 1,
        cloud_act_bytes=batch * cfg.d_model * 4.0)


def spec_k_for_lm(cfg, cut_layer: int, *, batch: int, channel: Channel,
                  acceptance: float = 0.8,
                  edge: DeviceModel = EDGE_TX2_CLASS,
                  cloud: DeviceModel = CLOUD_TITANXP_CLASS,
                  ks: Sequence[int] = (1, 2, 4, 8, 16),
                  sampled_frac: float = 0.0,
                  ) -> Tuple[SpecKPerf, List[SpecKPerf]]:
    """``tune_spec_k`` with the per-step flops/bytes of ``lm_round_args``
    — what ``CollaborativeServingEngine(spec_k="auto")`` calls."""
    return tune_spec_k(edge=edge, cloud=cloud, channel=channel,
                       acceptance=acceptance, ks=ks,
                       **lm_round_args(cfg, cut_layer, batch=batch,
                                       sampled_frac=sampled_frac))


# ---------------------------------------------------------------------------
# Joint (cut, k) tuning — Algorithm 1's loop over the full online grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CutKPerf:
    """One cell of the joint (cut_layer, spec_k) grid."""
    cut: int
    k: int
    breakdown: PhaseBreakdown

    @property
    def s_per_token(self) -> float:
        return self.breakdown.per_token_s


def tune_cut_and_k(cfg, *, batch: int, channel: Channel,
                   cuts: Sequence[int], acceptance: float = 0.8,
                   edge: DeviceModel = EDGE_TX2_CLASS,
                   cloud: DeviceModel = CLOUD_TITANXP_CLASS,
                   ks: Sequence[int] = (1, 2, 4, 8, 16),
                   sampled_frac: float = 0.0,
                   ) -> Tuple[CutKPerf, List[CutKPerf]]:
    """Algorithm 1's predict-then-pick loop over the joint grid of
    candidate partition points × speculative draft lengths, minimizing
    predicted time per *accepted* token — the decision the online
    control plane (``serve.policy``) re-evaluates as telemetry moves.

    The k=1 column degrades to the serial incremental step (there the
    smallest edge prefix tends to win: the slow INT8 edge runs only
    ``cut + 1`` blocks); the k>1 columns amortize the RTT and the
    per-message framing k-fold, and there the cut trades edge prefix
    steps against cloud verify flops.  All candidate cuts share one
    prequantized weight bank at serving time, so acting on a new best
    cut is a pointer swap (``serve.engine._CutBank``)."""
    perfs = []
    for cut in cuts:
        args = lm_round_args(cfg, cut, batch=batch,
                             sampled_frac=sampled_frac)
        for k in ks:
            bd = speculative_round_time(
                k=k, edge=edge, cloud=cloud, channel=channel,
                acceptance=acceptance, **args)
            perfs.append(CutKPerf(cut=cut, k=k, breakdown=bd))
    best = min(perfs, key=lambda p: p.s_per_token)
    return best, perfs
