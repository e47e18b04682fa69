"""Collaborative (cloud-edge) LM serving — the paper's mode — in PyTorch.

Counterpart of ``repro.serve.engine.CollaborativeServingEngine``.  The
INT8 edge prefix (the first ``cut_layer + 1`` blocks on the fake-quant
lattice) and the fp cloud suffix each own a KV cache covering only
their block sub-range: by default paged INT8 over **one shared block
table**; ``edge_paged`` / ``cloud_paged`` false give that side a dense
cache (the edge's INT8 with fixed scales when ``edge_int8``, the cloud's
fp whatever ``cloud_int8`` says, as in the reference), ``edge_int8`` /
``cloud_int8`` false fp pages; any of the four layout combinations
runs, and the page pool exists only while a side is paged.  Each
prefill ships the prompt's per-row Eq.(1) boundary blob uplink; each
decode step ships a per-row-quantized ``[B, 1, D]`` boundary delta
uplink and the token downlink, charged to ``ServeStats`` byte for byte
as the JAX engine charges them.  ``spec_k = k > 1`` turns each decode
step into a speculative draft/verify round (``serve.spec``);
``spec_k=1`` is the serial step, bit for bit.  ``a_bits=None`` with fp
pages on both sides is the lossless configuration, whose greedy stream
does not depend on the cut — nor on a cut or k switch mid-stream, nor
on preemption.

The control loop (``serve.policy``): ``policy="auto"`` (or an object
with ``decide``) re-tunes the draft length between rounds and the cut
at request-admission boundaries from link telemetry — a cut switch
drains the live slots first and takes its weights from the
prequantized ``_CutBank``; a raise out of k = 1 with live slots
rebuilds their draft caches instead of draining.  ``spec_k="auto"``
alone picks the starting k with the cost model and keeps correcting it
from the measured acceptance between requests.  Draft machinery and
page headroom are provisioned once for the largest k any controller
may pick (``_spec_max``).

Overload (``serve.overload``): ``demand_paged`` admits on the prompt's
pages and grows claims as sequences cross page boundaries, preempting
the lowest-priority request when the pool runs dry (its resume replays
prompt plus committed tokens in one prefill); ``pressure`` squeezes the
pool on the channel's simulated clock (``faults.PressureSchedule``);
``admission="deadline"`` sheds requests predicted to miss their
deadline (``policy.DeadlineAdmission``).

``mesh`` (``launch.mesh.make_serve_mesh``) runs the cloud suffix, its
head and its page pool tensor-parallel over the mesh's ``model`` shards
(``serve.sharding``), and the auto policy prices the cloud as a
TP-scaled device (a dense cloud cache on more than one shard is not
ported, ROADMAP A16).  A request with ``SamplingParams(temperature > 0)``
is sampled (``serve.sampling``); all-greedy traffic never enters a
sampled phase.  ``forward`` / ``generate_recompute`` are the seed
recompute path (``serve.seedpath``): no cache, the whole sequence again
at every step.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.core.autotune import spec_k_for_lm
from repro_torch.core.costmodel import CLOUD_TITANXP_CLASS, Channel
from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import engine_device
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.cloud import ServingEngine
from repro_torch.serve.faults import PressureSchedule
from repro_torch.serve.kvcache import _PagedPool
from repro_torch.serve.overload import _OverloadMixin
from repro_torch.serve.phases import _SplitPhases
from repro_torch.serve.policy import (AdaptivePolicy, DeadlineAdmission,
                                      _CutBank)
from repro_torch.serve.scheduler import _SamplingMirrors, _SlotEngine
from repro_torch.serve.seedpath import _SeedPathMixin
from repro_torch.serve.sharding import place_collab_engine, tp_size
from repro_torch.serve.spec import _SpecDraftMixin
from repro_torch.serve.transport import (_MSG_BYTES, _QP_BYTES, _TOK_BYTES,
                                         LinkTelemetry, Transport)

Params = Any

__all__ = ["ServingEngine", "CollaborativeServingEngine"]


class CollaborativeServingEngine(_SpecDraftMixin, _SeedPathMixin,
                                 _OverloadMixin, _SplitPhases,
                                 _SamplingMirrors, _SlotEngine):
    """Paper mode with incremental decode over split KV caches (paged over
    a shared table by default, or dense) and the online tuning loop (see
    the module docstring), on
    ``device`` (default ``"cuda"``), its cloud half tensor-parallel over
    the shards of ``mesh`` when one is given (its first device is then
    the engine's device; ``data > 1`` raises, ROADMAP A16).

    ``candidate_cuts`` overrides the auto policy's cut grid {0, mid,
    last-1} ∪ {cut_layer}; without a policy it puts extra cuts in the
    bank for externally scripted re-partitions (``_set_cut``).
    ``timed`` waits for the device after each prefill and round and adds
    their wall times to ``stats.prefill_s`` / ``stats.decode_s``."""

    # a subclass that serves on the edge's INT8 suffix copy through cloud
    # outages (``serve.resilience``) keeps the copy and its draft cache
    # even at spec_k = 1, with one round of page headroom for it
    _standby = False

    def __init__(self, params: Params, cfg: TF.LMConfig, *, cut_layer: int,
                 channel: Optional[Channel] = None, max_len: int = 128,
                 a_bits: Optional[int] = 8, max_batch: int = 4,
                 edge_paged: bool = True, edge_int8: bool = True,
                 cloud_paged: bool = True, cloud_int8: bool = True,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 spec_k: Union[int, str] = 1, spec_acceptance: float = 0.8,
                 policy: Union[AdaptivePolicy, str, None] = None,
                 candidate_cuts: Optional[Tuple[int, ...]] = None,
                 demand_paged: bool = False,
                 pressure: Optional[PressureSchedule] = None,
                 admission: Union[DeadlineAdmission, str, None] = None,
                 mesh=None, timed: bool = False,
                 device: DeviceLike = None):
        if not 0 <= cut_layer < cfg.n_layers:
            raise ValueError(
                f"cut_layer {cut_layer} outside [0, {cfg.n_layers})")
        dev = engine_device(mesh, device)
        super().__init__(cfg, max_batch=max_batch, max_len=max_len,
                         device=dev, timed=timed)
        self.transport = Transport(channel)
        self.a_bits = a_bits
        self.edge_paged = edge_paged
        self.edge_int8 = edge_int8
        self.cloud_paged = cloud_paged
        self.cloud_int8 = cloud_int8
        self.page_size = page_size
        self.mesh = mesh
        # the channel the offline tuners assume before telemetry locks on
        # (a DriftingChannel or FaultyChannel contributes its current
        # phase — the site survey)
        initial_ch = self.transport.channel
        initial_ch = getattr(initial_ch, "phase", initial_ch)

        spec_auto = spec_k == "auto"
        if spec_auto:
            spec_k = spec_k_for_lm(cfg, cut_layer, batch=max_batch,
                                   channel=initial_ch,
                                   acceptance=spec_acceptance)[0].k
        if not (isinstance(spec_k, int) and spec_k >= 1):
            raise ValueError(f"spec_k must be an int >= 1 or 'auto', got "
                             f"{spec_k!r}")
        self.spec_k = spec_k

        # -- control plane ---------------------------------------------------
        if policy == "auto":
            if cut_layer > cfg.n_layers - 2:
                raise ValueError("the adaptive policy needs at least one "
                                 "cloud block at every candidate cut")
            cuts = candidate_cuts or tuple(sorted(
                {0, (cfg.n_layers - 1) // 2, cfg.n_layers - 2, cut_layer}))
            # a TP mesh scales the cloud term of the policy's cost grid,
            # so a bigger mesh discovers its own edge-ward optimal cut
            policy = AdaptivePolicy(cfg, batch=max_batch, cuts=cuts,
                                    ks=(1, 2, 4, 8),
                                    cloud=CLOUD_TITANXP_CLASS.scaled(
                                        tp_size(mesh)),
                                    fallback_channel=initial_ch,
                                    acceptance_prior=spec_acceptance)
        elif policy is None and spec_auto:
            # spec_k="auto" alone: k-only self-correction between requests
            policy = AdaptivePolicy(cfg, batch=max_batch, cuts=None,
                                    ks=(1, 2, 4, 8, 16),
                                    fallback_channel=initial_ch,
                                    acceptance_prior=spec_acceptance,
                                    k_between_requests_only=True)
        self.policy = policy or None
        if (self.policy is not None and self.policy.cuts is not None
                and cut_layer not in self.policy.cuts):
            raise ValueError(f"cut_layer {cut_layer} not in candidate cuts "
                             f"{self.policy.cuts}")
        # largest k any controller may pick — draft machinery and page
        # headroom are provisioned for it once, up front
        self._spec_max = self.spec_k if self.policy is None \
            else max(self.spec_k, *self.policy.ks)
        if self._standby:
            self._spec_max = max(self._spec_max, 2)

        params = tree_map(lambda t: t.to(dev), params)
        self.embed = params["embed"]
        # the edge drafts with the whole head; the cloud's may be split
        self.tail = {"final_norm": params["final_norm"],
                     "lm_head": params["lm_head"]}
        self.cloud_tail = self.tail
        # act_axis=0: per-slot activation ranges — a shared-batch range
        # would couple each request's Eq.(1) lattice to its neighbours'
        # (and to stale values in idle slots)
        self._edge_qctx = None if a_bits is None else \
            ML.QuantCtx(a_bits=a_bits, quantize_weights=False, act_axis=0)
        deploy_qctx = None if a_bits is None else ML.QuantCtx(a_bits=a_bits)
        # one shared page pool / block table for every paged split cache;
        # its geometry is cut-independent, so it survives re-partitions
        self._pool = None
        if edge_paged or cloud_paged:
            self._pool = _PagedPool.build(max_batch, max_len, page_size,
                                          num_pages, dev)
        # overload robustness (demand paging / pressure faults / deadline
        # admission): hook implementations live in serve.overload
        self._init_overload(cfg, demand_paged=demand_paged,
                            pressure=pressure, admission=admission,
                            max_batch=max_batch, initial_ch=initial_ch,
                            spec_acceptance=spec_acceptance, a_bits=a_bits)
        # every cut the engine may ever serve goes into the bank up front
        bank_cuts = {cut_layer} | set(candidate_cuts or ())
        if self.policy is not None and self.policy.cuts is not None:
            bank_cuts |= set(self.policy.cuts)
        self._bank = _CutBank(params, cfg, bank_cuts, deploy_qctx,
                              drafts=self._spec_max > 1)
        self._set_cut(cut_layer, count=False)
        self._init_sampling()
        # calls of the degradation and resync phases (serve.spec)
        self.phase_calls = {"edge_only": 0, "resync": 0}

    # -- wire plumbing -------------------------------------------------------
    @property
    def channel(self):
        return self.transport.channel

    @channel.setter
    def channel(self, ch) -> None:
        self.transport.channel = ch

    @property
    def telemetry(self) -> LinkTelemetry:
        return self.transport.telemetry

    # -- online re-tuning ----------------------------------------------------
    def _set_cut(self, cut: int, *, count: bool = True) -> None:
        """Partition at ``cut`` — only ever with no occupied slots
        (construction, or the scheduler's drained admission boundary).
        Weights come out of the bank (views); the split caches are
        allocated anew for the two layer sub-ranges (their contents
        belonged to retired requests); the page pool, block table and
        telemetry carry over; on a mesh the new cloud half is placed on
        its shards."""
        cfg = self.cfg
        self.cut = cut
        self.n_edge = cut + 1
        self.n_cloud = cfg.n_layers - self.n_edge
        self.edge_blocks, self.cloud_blocks, self.draft_blocks = \
            self._bank.get(cut)
        # the old cut's caches go before the new ones are allocated
        self._edge_cache = self._cloud_cache = None
        if self._spec_max > 1:
            self._draft_cache = None
        # the cloud's dense cache is fp whatever cloud_int8 says, as the
        # reference allocates it
        self._edge_cache = self._new_cache(self.n_edge, self.edge_paged,
                                           self.edge_int8)
        self._cloud_cache = self._new_cache(
            self.n_cloud, self.cloud_paged,
            self.cloud_int8 and self.cloud_paged)
        if self._spec_max > 1:
            # the edge's draft model: the bank's INT8 copy of the cloud
            # suffix, over a draft cache in the edge's layout that shares
            # the block table
            self._draft_cache = self._new_cache(self.n_cloud,
                                                self.edge_paged,
                                                self.edge_int8)
        place_collab_engine(self)
        if count:
            self.stats.cut_switches += 1

    def _new_cache(self, layers: int, paged: bool, quantized: bool):
        """A split cache of ``layers`` blocks for every slot: paged over
        the shared pool's pages, or dense over ``max_len`` positions."""
        return TF.init_cache(
            self.cfg, self.max_batch, self.max_len, layers=layers,
            paged=paged, quantized=quantized, page_size=self.page_size,
            num_pages=self._pool.allocator.num_pages if paged else None,
            device=self.device)

    def _table(self):
        """The shared block table on the device, or None with no pool."""
        return None if self._pool is None else self._pool.table_dev()

    def _policy_tick(self, n_active: int) -> bool:
        if self.policy is None:
            return False
        live = self._sched_active or {}
        frac = (sum(1.0 for s in live if self._samp_t[s] > 0) / len(live)
                if live else 0.0)
        # the keyword only when sampled traffic is aboard: duck-typed
        # policies that predate sampling keep working on greedy traffic
        kw = {"sampled_frac": frac} if frac > 0.0 else {}
        d = self.policy.decide(self.telemetry, cut=self.cut,
                               spec_k=self.spec_k, **kw)
        if d.spec_k != self.spec_k and not (
                self.policy.k_between_requests_only and n_active > 0):
            if d.spec_k > 1 and self.spec_k == 1 and n_active > 0:
                # k = 1 rounds run the serial step and leave the draft
                # cache stale for the live slots: rebuild it from their
                # committed prefix instead of draining
                self._rebuild_draft_caches()
            self.spec_k = d.spec_k
            self.stats.spec_k_switches += 1
        if d.cut != self.cut:
            if n_active:
                self.stats.policy_holds += 1
                return True          # re-partition barrier: drain first
            self._set_cut(d.cut)
        return False

    def _round_headroom(self) -> int:
        return self._spec_max - 1

    # -- scheduler hooks ----------------------------------------------------
    def _admit(self, toks, plens, max_news, slots, cur, pos, samplings=None):
        self._note_samplings(slots, samplings)
        bt_rows = None
        if self._pool is not None:
            bt_rows = self._pool.admit(slots, plens,
                                       self._admit_reserve(max_news),
                                       toks.shape[1])
        slots_d = torch.as_tensor(slots, device=self.device).long()
        plens_d = torch.as_tensor(plens, device=self.device)
        blob, qp = self._edge_prefill(self.edge_blocks, self.embed, toks,
                                      self._edge_cache, slots_d, bt_rows,
                                      plens_d)
        self.transport.account_blob(
            self.stats, blob, phase="prefill",
            row_elems=plens.astype(np.int64) * self.cfg.d_model)
        if (self._samp_t[slots] > 0).any():
            cur, pos = self._cloud_prefill_sample_impl(
                self.cloud_blocks, self.cloud_tail, blob, qp,
                self._cloud_cache, slots_d, bt_rows, cur, pos, plens_d,
                *(torch.as_tensor(v[slots], device=self.device)
                  for v in (self._samp_t, self._samp_p, self._samp_s)))
        else:
            cur, pos = self._cloud_prefill(self.cloud_blocks,
                                           self.cloud_tail, blob, qp,
                                           self._cloud_cache, slots_d,
                                           bt_rows, cur, pos, plens_d)
        if self.spec_k > 1:
            # requests served at k = 1 never draft (a later raise
            # rebuilds their draft caches), so the draft prefill runs
            # only while the engine drafts
            self._draft_prefill_impl(self.draft_blocks, blob, qp,
                                     self._draft_cache, slots_d, bt_rows,
                                     plens_d)
        self.transport.account_downlink(self.stats, toks.shape[0],
                                        phase="prefill")
        return cur, pos

    def _decode_all(self, cur, pos, n_active):
        return self._serial_step(cur, pos, n_active, self._cloud_decode)

    def _decode_all_sample(self, cur, pos, n_active):
        """Serial (k = 1) step with a sampled slot aboard: the same edge
        pass and wire bytes; the committed token is the ``CLOUD``-stream
        draw (greedy rows keep their argmax, bit for bit)."""
        samp = (*self._samp_vecs(), self._offsets())
        return self._serial_step(
            cur, pos, n_active,
            lambda *a: self._cloud_decode_sample_impl(*a, *samp))

    def _serial_step(self, cur, pos, n_active, cloud_step):
        bt = self._table()
        blob, qp = self._edge_decode(self.edge_blocks, self.embed, cur,
                                     self._edge_cache, pos, bt)
        self.transport.account_blob(self.stats, blob, phase="decode",
                                    rows=n_active)
        cur, pos = cloud_step(self.cloud_blocks, self.cloud_tail, blob, qp,
                              self._cloud_cache, pos, bt)
        self.transport.account_downlink(self.stats, n_active)
        return cur, pos

    def _round(self, cur, pos, slots):
        n_samp = int((self._samp_t[slots] > 0).sum())
        # k = 1 is the serial step, which never waits for the device
        if self.spec_k == 1:
            if not n_samp:
                return super()._round(cur, pos, slots)
            cur, pos = self._decode_all_sample(cur, pos, len(slots))
            return cur, pos, cur[:, None], None
        return self._spec_round(cur, pos, slots)

    def _draft_round(self, cur, pos, bt, slots):
        """The edge half of a speculative round: ``(drafted, nbytes,
        verify)`` — the ``(blobs, scales, zps, drafts)`` of the k drafted
        steps, the bytes of the one uplink message that carries them,
        and the cloud half, ``verify(pos) -> (toks, n_commit, cur,
        pos)``."""
        k, n_active = self.spec_k, len(slots)
        n_samp = int((self._samp_t[slots] > 0).sum())
        args = (self.edge_blocks, self.draft_blocks, self.embed, self.tail,
                cur, self._edge_cache, self._draft_cache, pos, bt)
        if n_samp:
            samp = (*self._samp_vecs(), self._offsets())
            draft_fn, verify_fn = self._spec_sample_fns(k)
            blobs, scales, zps, drafts, qs = draft_fn(*args, *samp)
            tail_args = (qs,)
        else:
            samp, tail_args = (), ()
            draft_fn, verify_fn = self._spec_fns(k)
            blobs, scales, zps, drafts = draft_fn(*args)
        # one uplink message: k per-row-framed [1, D] deltas + the k-1
        # graded drafts, the header (and the RTT) paid once per round; a
        # sampled row also ships the k-1 graded positions' f32 draft
        # distributions the rejection test needs
        nbytes = (n_active * (k * (self.cfg.d_model * blobs.element_size()
                                   + _QP_BYTES) + (k - 1) * _TOK_BYTES)
                  + _MSG_BYTES + n_samp * (k - 1) * self.cfg.vocab * 4)

        def verify(pos):
            return verify_fn(self.cloud_blocks, self.cloud_tail, blobs,
                             scales, zps, drafts, *tail_args,
                             self._cloud_cache, pos, bt, *samp)

        return (blobs, scales, zps, drafts), nbytes, verify

    def _spec_round(self, cur, pos, slots):
        bt = self._table()
        _, nbytes, verify = self._draft_round(cur, pos, bt, slots)
        self.transport.charge(self.stats, nbytes, phase="decode")
        toks, n_commit, cur, pos = verify(pos)
        # the edge needs the accept counts to schedule the next round, so
        # this sync is part of the protocol, not a host-loop artifact
        counts = n_commit.cpu().numpy()
        self.transport.account_downlink(self.stats, len(slots),
                                        k=self.spec_k)
        self._count_round(counts, slots)
        return cur, pos, toks, counts

    def _count_round(self, counts, slots) -> None:
        """A verified round's counters and its acceptance sample."""
        k, n_active = self.spec_k, len(slots)
        self.stats.spec_rounds += 1
        hits = int(np.minimum(counts[slots] - 1, k - 1).sum())
        self.stats.drafted_tokens += (k - 1) * n_active
        self.stats.draft_hits += hits
        self.telemetry.observe_round((k - 1) * n_active, hits)

    def _retire(self, slot):
        if self._pool is not None:
            self._pool.retire(slot)

    def _can_admit(self, group_shapes, plen, max_new, bucket):
        if self._pool is None:
            return True
        shapes = [(p, int(self._admit_reserve(np.int64(m))))
                  for p, m in group_shapes + [(plen, max_new)]]
        return self._pool.can_admit(shapes, bucket)

    def edge_cache_bytes(self, *, live_only: bool = False) -> int:
        """Edge KV footprint; ``live_only`` counts allocated pages only
        (a dense cache is all live)."""
        if self.edge_paged and live_only:
            return self._pool.live_cache_bytes(self._edge_cache)
        return sum(v.numel() * v.element_size()
                   for v in self._edge_cache.values())
