"""Online re-tuning policy: the control plane of collaborative serving.

Counterpart of ``repro.serve.policy``.  The paper's Algorithm 1 picks
a partition for *one* environment snapshot; this module closes the loop
while serving:

    measurement  ``transport.LinkTelemetry`` — EWMA bandwidth/RTT from
                 every charged message, EWMA draft acceptance from every
                 verify round;
    model        ``costmodel.speculative_round_time`` over the joint
                 (cut_layer, spec_k) grid via ``autotune.tune_cut_and_k``
                 — the offline tuner's predict-then-pick loop,
                 re-evaluated against live estimates;
    actuation    the engine applies a new ``spec_k`` between rounds and
                 a new ``cut_layer`` at the next request-admission
                 boundary (the scheduler drains occupied slots first,
                 because the split KV caches change layer ownership);
                 every candidate cut's weights sit in the prequantized
                 ``_CutBank``, so a re-partition is a pointer swap.

Hysteresis guards both switches: a re-partition costs a drain barrier,
so its predicted win must clear a higher bar than a draft-length change
before the policy acts.  ``DeadlineAdmission`` applies the same
telemetry-fed model to the admit/shed decision.  The control plane is
host Python, as in the reference: the only tensors are the bank's.  The
devices it prices are the reference's (a TX2-class edge, a TitanXP-class
cloud, TP-scaled on a mesh), so its decisions are the reference's.
``FleetFairness`` is the fleet's cross-tenant sharing (``serve.fleet``):
weighted virtual service orders admission, page quotas cap a tenant's
claim, and preemption picks the tenant most over its fair page share.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.bridge import tree_map
from repro_torch.core.autotune import tune_cut_and_k
from repro_torch.core.costmodel import (CLOUD_TITANXP_CLASS, Channel,
                                        DeviceModel, EDGE_TX2_CLASS,
                                        predict_finish_time)
from repro_torch.models import transformer as TF
from repro_torch.serve.transport import (_MSG_BYTES, _QP_BYTES, _TOK_BYTES,
                                         LinkTelemetry)

__all__ = ["Decision", "AdaptivePolicy", "DeadlineAdmission",
           "FleetFairness", "_CutBank", "_prequantize_blocks"]


def _quantize_layers(leaf: torch.Tensor, deploy_qctx) -> torch.Tensor:
    """Apply ``deploy_qctx.weight`` to every ``[L]`` slice of a stacked
    leaf, writing into one preallocated stacked output."""
    out = None
    for i in range(leaf.shape[0]):
        w = deploy_qctx.weight(leaf[i])
        if out is None:
            out = torch.empty((leaf.shape[0],) + tuple(w.shape),
                              dtype=w.dtype, device=w.device)
        out[i] = w
    return leaf if out is None else out


# the param-dict keys ``layers.dense`` and ``layers.moe`` route through
# ``QuantCtx.weight``, and the MoE router's ``w``: every floating leaf
# whose nearest key is one of these carries the INT8 lattice
_WEIGHT_KEYS = ("w", "wi", "wg", "wo")


def _prequantize_blocks(blocks: Dict[str, Any], deploy_qctx,
                        key: str = "") -> Dict[str, Any]:
    """Stacked block params → the same tree with every weight leaf on
    the deployment lattice (f32, as fake-quant returns it), one layer
    at a time: the dense ``"w"`` leaves, the MoE router's ``w`` (the
    runtime never quantizes it, so the edge routes on the lattice the
    bank gives it, as the reference's bank does) and the raw expert
    leaves ``wi``/``wg``/``wo`` (``[E, D, F]`` a layer, ranges per last
    axis over E·D)."""
    if isinstance(blocks, dict):
        return {k: _prequantize_blocks(v, deploy_qctx, k)
                for k, v in blocks.items()}
    if key in _WEIGHT_KEYS and blocks.is_floating_point():
        return _quantize_layers(blocks, deploy_qctx)
    return blocks


class _CutBank:
    """Prequantized weight bank for the cuts an engine may serve — the
    actuation half of a re-partition.

    The edge prefix of the deepest bank cut — with ``drafts``, the whole
    block stack — is quantized once (per block, so every cut shares the
    identical quantized blocks).  Each cut's (INT8-lattice edge prefix,
    fp cloud suffix, INT8-lattice draft suffix) slices are views of the
    stacked leaves, built on first use of the cut and cached, so a warm
    re-partition never requantizes anything."""

    def __init__(self, params: Dict[str, Any], cfg: TF.LMConfig,
                 cuts: Iterable[int], deploy_qctx=None, *,
                 drafts: bool = False) -> None:
        self._cuts = tuple(sorted({int(c) for c in cuts}))
        if not all(0 <= c < cfg.n_layers for c in self._cuts):
            raise ValueError(f"cuts {self._cuts} outside [0, {cfg.n_layers})")
        self._fp = params["blocks"]
        self._drafts = drafts
        depth = cfg.n_layers if drafts else max(self._cuts) + 1
        quantized = tree_map(lambda v: v[:depth], self._fp)
        self._q = quantized if deploy_qctx is None \
            else _prequantize_blocks(quantized, deploy_qctx)
        self._slices: Dict[int, Tuple[Any, Any, Any]] = {}

    @property
    def cuts(self) -> Tuple[int, ...]:
        return self._cuts

    def get(self, cut: int) -> Tuple[Dict[str, Any], Dict[str, Any],
                                      Optional[Dict[str, Any]]]:
        """(edge prefix @ INT8 lattice, cloud suffix @ fp, draft suffix
        copy @ INT8 lattice or None without ``drafts``) for ``cut``."""
        if cut not in self._cuts:
            raise KeyError(f"cut {cut} not in weight bank {self._cuts}")
        if cut not in self._slices:
            draft = (tree_map(lambda v: v[cut + 1:], self._q)
                     if self._drafts else None)
            self._slices[cut] = (tree_map(lambda v: v[:cut + 1], self._q),
                                 tree_map(lambda v: v[cut + 1:], self._fp),
                                 draft)
        return self._slices[cut]


@dataclasses.dataclass(frozen=True)
class Decision:
    """One output of the control loop: the (cut, k) the engine should
    run, plus the evidence it was decided on."""
    cut: int
    spec_k: int
    s_per_token: float           # predicted, at the decision's estimates
    current_s_per_token: float   # prediction for the config it replaces
    bandwidth_bytes_per_s: float
    rtt_s: float
    acceptance: float

    @property
    def predicted_speedup(self) -> float:
        return self.current_s_per_token / max(self.s_per_token, 1e-12)


class AdaptivePolicy:
    """Re-tunes ``(cut_layer, spec_k)`` for a collaborative engine from
    live link telemetry.

    ``cuts=None`` restricts the policy to the draft length only — the
    self-correcting ``spec_k="auto"`` mode: the engine's measured
    acceptance rate replaces the construction-time prior in
    ``tune_spec_k`` and k is revised between requests.  With candidate
    ``cuts`` the policy also re-partitions; every candidate's INT8
    prefix/suffix weights are prequantized into the engine's cut bank,
    so acting on a decision never requantizes anything.

    ``decide`` is cheap (a closed-form grid of |cuts| x |ks| roofline
    evaluations), so the engine calls it every scheduler turn; decisions
    only *change* when the predicted per-accepted-token win clears
    ``k_hysteresis`` (draft length — a free switch) or
    ``cut_hysteresis`` (re-partition — pays a drain barrier and fresh
    phase traces).
    """

    def __init__(self, cfg, *, batch: int,
                 cuts: Optional[Sequence[int]] = None,
                 ks: Sequence[int] = (1, 2, 4, 8, 16),
                 edge: DeviceModel = EDGE_TX2_CLASS,
                 cloud: DeviceModel = CLOUD_TITANXP_CLASS,
                 fallback_channel: Optional[Channel] = None,
                 acceptance_prior: float = 0.8,
                 k_hysteresis: float = 0.02,
                 cut_hysteresis: float = 0.15,
                 k_between_requests_only: bool = False,
                 min_dwell: int = 0):
        if cuts is not None and not all(0 <= c < cfg.n_layers - 1
                                        for c in cuts):
            raise ValueError(f"candidate cuts {tuple(cuts)} must each leave "
                             f"at least one cloud block")
        self.cfg = cfg
        self.batch = batch
        self.cuts = tuple(cuts) if cuts is not None else None
        self.ks = tuple(ks)
        self.edge = edge
        self.cloud = cloud
        self.fallback_channel = fallback_channel or Channel(
            bandwidth_bytes_per_s=float("inf"))
        self.acceptance_prior = acceptance_prior
        self.k_hysteresis = k_hysteresis
        self.cut_hysteresis = cut_hysteresis
        self.k_between_requests_only = k_between_requests_only
        # flap damping: after recommending a switch, hold the new config
        # for at least ``min_dwell`` decide() ticks before recommending
        # another — an oscillating or lossy channel (telemetry swinging
        # every round) must not thrash cut/spec_k between consecutive
        # scheduler turns.  0 disables (hysteresis alone).
        self.min_dwell = int(min_dwell)
        self._ticks_since_switch: Optional[int] = None
        self.history: List[Decision] = []

    def decide(self, telemetry: LinkTelemetry, *, cut: int,
               spec_k: int, sampled_frac: float = 0.0) -> Decision:
        """One control-loop evaluation: current telemetry → the (cut, k)
        the engine should be running, with hysteresis against the
        config it is running.  ``sampled_frac`` (live slots decoding at
        temperature>0) prices the q-row uplink sampled rounds ship, and
        the measured acceptance EWMA already reflects stochastic
        rejection — together they pull hot sampling traffic toward a
        smaller k than greedy traffic on the same link."""
        channel = telemetry.channel(self.fallback_channel)
        acc = telemetry.acceptance(self.acceptance_prior)
        cuts = self.cuts if self.cuts is not None else (cut,)
        best, grid = tune_cut_and_k(
            self.cfg, batch=self.batch, channel=channel, cuts=cuts,
            acceptance=acc, edge=self.edge, cloud=self.cloud, ks=self.ks,
            sampled_frac=sampled_frac)
        cur = [p for p in grid if p.cut == cut and p.k == spec_k]
        cur_s = cur[0].s_per_token if cur else float("inf")

        # hysteresis: keep the running config unless the win is real.  A
        # re-partition must beat the best *stay-at-this-cut* option by
        # the higher bar — a k-only win never justifies a drain barrier
        # when (almost) the same win is available at the current cut
        stay = min((p for p in grid if p.cut == cut),
                   key=lambda p: p.s_per_token)
        new_cut, new_k, new_s = best.cut, best.k, best.s_per_token
        if new_cut != cut and \
                new_s >= stay.s_per_token * (1.0 - self.cut_hysteresis):
            new_cut, new_k, new_s = cut, stay.k, stay.s_per_token
        if new_cut == cut and new_k != spec_k \
                and new_s >= cur_s * (1.0 - self.k_hysteresis):
            new_k, new_s = spec_k, cur_s

        # dwell-time floor: a fresh switch recommendation starts a hold
        # window of ``min_dwell`` ticks during which further changes are
        # suppressed — back-to-back flapping costs more than any
        # single-tick prediction can be trusted to win back
        if self._ticks_since_switch is not None:
            self._ticks_since_switch += 1
        if (new_cut, new_k) != (cut, spec_k):
            if self._ticks_since_switch is not None \
                    and self._ticks_since_switch <= self.min_dwell:
                new_cut, new_k, new_s = cut, spec_k, cur_s
            else:
                self._ticks_since_switch = 0

        d = Decision(cut=new_cut, spec_k=new_k, s_per_token=new_s,
                     current_s_per_token=cur_s,
                     bandwidth_bytes_per_s=channel.bandwidth_bytes_per_s,
                     rtt_s=channel.rtt_s, acceptance=acc)
        # log each *distinct* control action once: while the engine
        # defers a pending switch (drain barrier / between-requests), the
        # same recommendation recurs every scheduler turn and must not
        # spam the history
        if (d.cut != cut or d.spec_k != spec_k) and (
                not self.history
                or (self.history[-1].cut, self.history[-1].spec_k)
                != (d.cut, d.spec_k)):
            self.history.append(d)
        return d


class FleetFairness:
    """Cross-tenant weighted-fair sharing for the fleet engine — the
    overload discipline's priority/preemption rules extended to a shared
    slot table and page pool serving many edges at once.

    Each tenant carries a ``weight`` (its share of the cloud) and an
    optional hard page ``quota``.  Every committed token charges its
    tenant ``1 / weight`` of virtual service, and admission orders the
    eligible requests by (priority desc, virtual service asc, FIFO), so
    a hot tenant keeps admitting only while its weighted service stays
    behind the others'.  Preemption inverts the ordering with pool
    pressure first: the tenant most over its fair page share (the
    pool's ``owner_pages``), then the lowest priority, then the most
    remaining budget."""

    def __init__(self, weights: Dict[str, float],
                 quotas: Optional[Dict[str, Optional[int]]] = None):
        if not weights or not all(w > 0 for w in weights.values()):
            raise ValueError(f"tenant weights must be positive: {weights}")
        self.weights = dict(weights)
        self.quotas = {t: (quotas or {}).get(t) for t in weights}
        self._wsum = sum(self.weights.values())
        self.vservice: Dict[str, float] = {t: 0.0 for t in weights}

    def charge(self, tenant: str, tokens: int) -> None:
        """``tokens`` committed for ``tenant``: advance its virtual
        service by the weighted amount."""
        self.vservice[tenant] += tokens / self.weights[tenant]

    def admission_key(self, req) -> Tuple:
        """Sort key for the eligible-request queue (ascending)."""
        return (-req.priority, self.vservice.get(req.tenant, 0.0), req._seq)

    def fair_pages(self, tenant: str, usable_pages: int) -> float:
        """``tenant``'s weighted fair share of the pool."""
        return usable_pages * self.weights[tenant] / self._wsum

    def over_quota(self, tenant: str, held: int) -> bool:
        """Hard quota check (a ``None`` quota is uncapped)."""
        q = self.quotas.get(tenant)
        return q is not None and held > q

    def victim_key(self, req, tenant_pages: int, usable_pages: int,
                   remaining: int) -> Tuple:
        """Sort key for preemption victims (ascending = preempt first):
        most over the fair page share, then lowest priority, then most
        remaining budget; the caller breaks ties by slot."""
        over = tenant_pages - self.fair_pages(req.tenant, usable_pages)
        return (-over, req.priority, -remaining)


class DeadlineAdmission:
    """Deadline-aware admission control: the paper's predict-then-pick
    discipline (Algorithm 1) applied to the *admit/shed* decision.

    Where ``AdaptivePolicy`` asks "which (cut, k) is fastest right
    now?", this asks "can this request finish by its deadline at the
    engine's current (cut, k), behind the work already admitted?" — and
    if the answer is no *at admission time, with the request first in
    line for a slot*, the request can only finish even later, so the
    engine sheds it instead of letting it occupy pages and head-of-line
    block traffic that could still meet its deadline.

    The prediction reuses the same telemetry-fed roofline the tuner
    runs: ``tune_cut_and_k`` evaluated at the single live (cut, k) point
    gives the per-round phase breakdown — expected retransmissions on a
    lossy link are already priced into its channel term — and
    ``costmodel.predict_finish_time`` folds in the request's own budget,
    the queue's owed tokens, and the prefill round-trip.  ``margin``
    inflates the predicted service time (>1 = conservative: shed
    earlier, protect admitted work; <1 = optimistic)."""

    def __init__(self, cfg, *, batch: int,
                 fallback_channel: Optional[Channel] = None,
                 edge: DeviceModel = EDGE_TX2_CLASS,
                 cloud: DeviceModel = CLOUD_TITANXP_CLASS,
                 acceptance_prior: float = 0.8, margin: float = 1.1,
                 blob_itemsize: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.fallback_channel = fallback_channel or Channel(
            bandwidth_bytes_per_s=float("inf"))
        self.edge = edge
        self.cloud = cloud
        self.acceptance_prior = acceptance_prior
        self.margin = float(margin)
        self.blob_itemsize = int(blob_itemsize)

    def predict_finish(self, telemetry: LinkTelemetry, *, now: float,
                       cut: int, spec_k: int, plen: int, max_new: int,
                       slots: int, queue_tokens: float = 0.0) -> float:
        """Predicted absolute finish time of a request admitted now."""
        channel = telemetry.channel(self.fallback_channel)
        acc = telemetry.acceptance(self.acceptance_prior)
        best, _ = tune_cut_and_k(
            self.cfg, batch=self.batch, channel=channel, cuts=(cut,),
            ks=(spec_k,), acceptance=acc, edge=self.edge, cloud=self.cloud)
        # the admission prefill's wire cost: the [plen, D] boundary blob
        # up, the first token down, both paying expected retransmissions
        prefill_s = (channel.transfer_time(
            plen * self.cfg.d_model * self.blob_itemsize
            + _QP_BYTES + _MSG_BYTES)
            + channel.transfer_time(_TOK_BYTES + _MSG_BYTES)) \
            * channel.expected_retx()
        t = predict_finish_time(best.breakdown, now=now, max_new=max_new,
                                queue_tokens=queue_tokens, slots=slots,
                                prefill_s=prefill_s)
        return now + (t - now) * self.margin
