"""Device / channel cost models for Algorithm 1's ``PredictPerformance``.

The paper profiles each operator off-line on the physical edge device
(Jetson TX2 + gemmlowp) and cloud server (TITAN Xp + cuDNN).  We model
both as roofline devices — ``time = max(compute, memory)`` per layer plus
a fixed launch overhead — and additionally support *measured* per-layer
profiles (``Profile``) that override the analytic model, which is exactly
the paper's off-line profiling mode.

The cloud can also be a multi-chip TPU pod; its per-layer time then
includes a collective term (bytes moved / link bandwidth) so the
auto-tuner sees the cost of distributed cloud inference (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from repro_torch.core.graph import LayerGraph, Node

__all__ = ["DeviceModel", "Channel", "Profile", "PhaseBreakdown",
           "EDGE_TX2_CLASS", "CLOUD_TITANXP_CLASS", "CLOUD_TPU_V5E_CHIP",
           "MSG_BYTES", "QP_BYTES", "TOK_BYTES",
           "layer_time", "subgraph_time", "tpu_v5e_pod",
           "collab_decode_step_time", "speculative_round_time",
           "expected_accepted_tokens", "predict_finish_time"]

# Canonical wire-framing constants, shared with the serving engines'
# accounting (``serve.transport``) so model predictions and measured
# byte counters can never drift apart:
#   MSG_BYTES — per-*message* protocol framing (TCP/IP-class headers +
#               slot ids/round counter); every channel traversal pays it
#               once, which is exactly what a draft/verify round
#               amortizes k-fold alongside the RTT.
#   QP_BYTES  — per-blob Eq.(1) framing: f32 scale + f32 zero-point.
#   TOK_BYTES — one token id (cloud→edge return / edge→cloud draft).
MSG_BYTES = 64.0
QP_BYTES = 8.0
TOK_BYTES = 4.0


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """A roofline device. Rates in ops/s and bytes/s."""
    name: str
    peak_flops_fp32: float
    peak_ops_int8: float
    dram_bw: float
    launch_overhead_s: float = 20e-6
    n_chips: int = 1
    link_bw: float = 0.0            # per-chip interconnect (pods)

    def scaled(self, n_chips: int) -> "DeviceModel":
        return dataclasses.replace(
            self, name=f"{self.name}x{n_chips}", n_chips=n_chips)


# Defaults approximating the paper's hardware (DESIGN.md §3):
# TX2-class edge — gemmlowp on 4xA57 delivers single-digit effective GOPS
# (the paper's AlexNet conv1-5 runs in ~0.3 s ≈ 1.4 GFLOP / 5 GOPS), and
# LPDDR4 effective bandwidth for streaming cold weights is a few GB/s.
EDGE_TX2_CLASS = DeviceModel(
    name="edge-tx2", peak_flops_fp32=2.0e9, peak_ops_int8=5.0e9,
    dram_bw=6e9, launch_overhead_s=200e-6)

# TITAN Xp-class cloud GPU: 12.1 TFLOP/s fp32, 547 GB/s.
CLOUD_TITANXP_CLASS = DeviceModel(
    name="cloud-titanxp", peak_flops_fp32=12.1e12, peak_ops_int8=12.1e12,
    dram_bw=547e9, launch_overhead_s=10e-6)

# One TPU v5e chip (the roofline constants of the assignment).
CLOUD_TPU_V5E_CHIP = DeviceModel(
    name="tpu-v5e", peak_flops_fp32=197e12, peak_ops_int8=394e12,
    dram_bw=819e9, launch_overhead_s=5e-6, link_bw=50e9)


def tpu_v5e_pod(n_chips: int = 256) -> DeviceModel:
    return CLOUD_TPU_V5E_CHIP.scaled(n_chips)


@dataclasses.dataclass(frozen=True)
class Channel:
    """Wireless link between edge and cloud (the paper's environment).

    ``loss_rate`` is the per-message loss probability a reliable
    transport observes (``serve.transport.LinkTelemetry``); with
    retransmit-until-delivered semantics the *expected* channel time per
    message is the clean time times ``expected_retx()`` = 1/(1-p), which
    is how the round-time models below price a lossy link — so the
    auto-tuner sees that a cut shipping more messages hurts more when
    messages are being lost."""
    bandwidth_bytes_per_s: float
    rtt_s: float = 0.0
    name: str = ""
    loss_rate: float = 0.0

    def expected_retx(self) -> float:
        """Expected transmissions per delivered message, clamped so a
        (transient) measured loss of ~1 can't predict infinity."""
        return 1.0 / (1.0 - min(max(self.loss_rate, 0.0), 0.95))

    def transfer_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return nbytes / self.bandwidth_bytes_per_s + self.rtt_s

    @classmethod
    def from_kbps(cls, kilobytes_per_s: float, rtt_ms: float = 0.0):
        return cls(bandwidth_bytes_per_s=kilobytes_per_s * 1e3,
                   rtt_s=rtt_ms * 1e-3,
                   name=f"{kilobytes_per_s:g}KB/s")


# measured per-layer seconds, node name -> time
Profile = Mapping[str, float]


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    """Per-phase latency split of a collaborative serving round:
    one-time prefill, decode compute (edge + cloud), and the wireless
    transfer of the boundary blob.  Mirrors the phase fields
    ``ServeStats`` measures, so predictions and measurements line up.
    ``tokens`` is the expected number of *accepted* tokens the round
    commits (1 for the non-speculative step), so ``per_token_s`` is the
    per-accepted-token cost the spec-k auto-tuner minimizes."""
    prefill_s: float = 0.0
    decode_s: float = 0.0
    channel_s: float = 0.0
    tokens: float = 1.0

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s + self.channel_s

    @property
    def per_token_s(self) -> float:
        return self.total_s / max(self.tokens, 1e-9)


def _tp_allreduce_s(cloud: DeviceModel, cloud_layers: int,
                    cloud_act_bytes: float) -> float:
    """Per-step tensor-parallel collective cost of the cloud suffix:
    Megatron TP pays two all-reduces per block (after attention out-proj
    and after FFN-out), each moving ``2·(n-1)/n`` of the activation
    bytes per chip on a ring.  Zero for a single chip or an unmodeled
    interconnect — the term only kicks in when a mesh actually scales
    ``n_chips`` up, which is what lets the tuner trade cloud
    parallelism against channel cost."""
    if cloud.n_chips <= 1 or cloud.link_bw <= 0 or cloud_layers <= 0:
        return 0.0
    ring = 2.0 * (cloud.n_chips - 1) / cloud.n_chips \
        * cloud_act_bytes / cloud.link_bw
    return 2.0 * cloud_layers * ring


def collab_decode_step_time(*, edge_flops: float, cloud_flops: float,
                            blob_bytes: float, edge: DeviceModel,
                            cloud: DeviceModel, channel: Channel,
                            return_bytes: float = 4.0,
                            msg_bytes: float = MSG_BYTES,
                            cloud_layers: int = 0,
                            cloud_act_bytes: float = 0.0) -> PhaseBreakdown:
    """Predicted per-token cost of *incremental* collaborative decode.

    With split KV caches, each generated token runs only the new-token
    slice through the edge prefix (INT8) and the cloud suffix (FP32) and
    ships a single [B, 1, D] quantized boundary delta — so the wire term
    is O(1) in sequence length, which is what makes transmission stop
    dominating (JointDNN's observation applied per token).  Each step is
    a full round trip: the uplink delta plus the cloud→edge return of
    the sampled tokens (``return_bytes``), each a *message* paying the
    ``msg_bytes`` protocol framing the engines charge (``ServeStats``)
    on top of its payload, and each paying the channel RTT.  A lossy
    channel multiplies the whole wire term by the expected retransmit
    count (``Channel.expected_retx``)."""
    edge_s = edge_flops / edge.peak_ops_int8 + edge.launch_overhead_s
    cloud_s = (cloud_flops / (cloud.peak_flops_fp32 * cloud.n_chips)
               + cloud.launch_overhead_s
               + _tp_allreduce_s(cloud, cloud_layers, cloud_act_bytes))
    channel_s = (channel.transfer_time(blob_bytes + msg_bytes)
                 + channel.transfer_time(return_bytes + msg_bytes)) \
        * channel.expected_retx()
    return PhaseBreakdown(decode_s=edge_s + cloud_s, channel_s=channel_s)


def expected_accepted_tokens(k: int, acceptance: float) -> float:
    """Expected tokens a draft/verify round of length k commits, with
    i.i.d. per-position draft accuracy ``acceptance``: the round always
    commits the verify's corrected token and extends one position per
    leading accepted draft, so E = sum_{i=0}^{k-1} acceptance^i."""
    if acceptance >= 1.0:
        return float(k)
    return (1.0 - acceptance ** k) / (1.0 - acceptance)


def speculative_round_time(*, k: int, edge_flops: float, cloud_flops: float,
                           blob_bytes: float, edge: DeviceModel,
                           cloud: DeviceModel, channel: Channel,
                           draft_flops: float = 0.0,
                           acceptance: float = 1.0,
                           return_bytes: float = 4.0,
                           rows: int = 1,
                           msg_bytes: float = MSG_BYTES,
                           cloud_layers: int = 0,
                           cloud_act_bytes: float = 0.0,
                           draft_q_bytes: float = 0.0) -> PhaseBreakdown:
    """Predicted cost of one speculative *draft/verify round* of length
    ``k`` (the flop/byte arguments are per-step quantities, exactly
    ``collab_decode_step_time``'s).

    The edge pays k serial prefix steps plus — when actually drafting
    (k > 1) — k local INT8 suffix steps (``draft_flops``); the cloud
    verifies all k positions in ONE batched multi-token step (k× the
    flops, one launch); the channel carries one uplink (k boundary
    deltas + the k-1 graded draft-token ids, 4 B each across ``rows``
    live requests) and one downlink (the sampled/corrected token plus,
    for k > 1, a byte-packed accept mask) — so the RTT *and the
    per-message ``msg_bytes`` framing* are paid once per round instead
    of once per token.  ``tokens`` in the returned breakdown is the
    expected accepted-token count at the given per-position draft
    ``acceptance``, making ``per_token_s`` the quantity
    ``autotune.tune_spec_k`` minimizes.

    ``draft_q_bytes`` prices sampled (temperature>0) traffic: the
    rejection-sampling verify needs the draft's filtered distribution at
    each of the k-1 graded positions, so the uplink grows by
    ``(k-1) * draft_q_bytes`` per round (per-graded-position bytes, with
    the batch rows already baked in — see ``autotune.lm_round_args``).
    The default 0.0 keeps every greedy prediction bit-identical.

    ``k=1`` recovers ``collab_decode_step_time`` exactly: no draft
    model, no mask, one delta, one token, no shipped distributions — the
    auto-tuner can always fall back to today's serial step."""
    edge_step = edge_flops / edge.peak_ops_int8 + edge.launch_overhead_s
    draft_step = draft_flops / edge.peak_ops_int8 + edge.launch_overhead_s
    edge_s = k * edge_step + (k * draft_step if k > 1 else 0.0)
    # verify acts are [B, k, D]: the TP all-reduces move k× the bytes
    cloud_s = (k * cloud_flops / (cloud.peak_flops_fp32 * cloud.n_chips)
               + cloud.launch_overhead_s
               + _tp_allreduce_s(cloud, cloud_layers, k * cloud_act_bytes))
    uplink = k * blob_bytes + (k - 1) * (TOK_BYTES * rows + draft_q_bytes) \
        + msg_bytes
    downlink = return_bytes + msg_bytes \
        + (float(-(-k // 8)) * rows if k > 1 else 0.0)
    channel_s = (channel.transfer_time(uplink)
                 + channel.transfer_time(downlink)) \
        * channel.expected_retx()
    return PhaseBreakdown(decode_s=edge_s + cloud_s, channel_s=channel_s,
                          tokens=expected_accepted_tokens(k, acceptance))


def predict_finish_time(round: PhaseBreakdown, *, now: float, max_new: int,
                        queue_tokens: float = 0.0, slots: int = 1,
                        prefill_s: float = 0.0) -> float:
    """Predicted absolute completion time of a request entering service.

    ``round`` is one decode round's predicted cost (its ``tokens`` field
    is the expected accepted tokens per round, so a lossy channel's
    expected retransmissions — baked into ``channel_s`` by
    ``speculative_round_time`` via ``Channel.expected_retx`` — and a low
    draft acceptance both stretch the prediction).  ``queue_tokens`` is
    the budget the engine still owes work admitted *ahead* of this
    request; under continuous batching those tokens drain across
    ``slots`` parallel slots at the same per-round cadence, which is the
    queue-depth term of deadline-aware admission (``serve.policy.
    DeadlineAdmission``): a doomed request is one whose predicted finish
    already overshoots its deadline *before* it is granted a slot."""
    toks = max(float(round.tokens), 1e-9)
    rounds_own = -(-float(max_new) // toks)            # ceil
    rounds_queued = max(0.0, float(queue_tokens)) / (max(int(slots), 1)
                                                     * toks)
    return now + prefill_s + (rounds_own + rounds_queued) * round.total_s


def layer_time(node: Node, dev: DeviceModel, *, precision: str,
               profile: Optional[Profile] = None) -> float:
    """Roofline time of one (possibly fused) layer on ``dev``."""
    if profile is not None and node.name in profile:
        return profile[node.name]
    if precision == "int8":
        compute = node.flops / (dev.peak_ops_int8 * dev.n_chips)
        pbytes = node.param_elems * 1.0
        abytes = node.out_elems * 1.0
    else:
        compute = node.flops / (dev.peak_flops_fp32 * dev.n_chips)
        pbytes = node.param_elems * 4.0
        abytes = node.out_elems * 4.0
    # per-chip memory traffic: weights stream once, activations in+out
    in_elems = sum(1 for _ in node.inputs) * node.out_elems  # approx
    mem_bytes = pbytes / dev.n_chips + abytes * 2
    memory = mem_bytes / dev.dram_bw
    t = max(compute, memory) + dev.launch_overhead_s
    # distributed cloud: moving activations between chips each layer
    if dev.n_chips > 1 and dev.link_bw > 0:
        t += abytes / (dev.link_bw * dev.n_chips)
    return t


def subgraph_time(g: LayerGraph, names, dev: DeviceModel, *, precision: str,
                  profile: Optional[Profile] = None) -> float:
    return sum(layer_time(g.nodes[n], dev, precision=precision,
                          profile=profile) for n in names)
