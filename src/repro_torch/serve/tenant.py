"""Per-tenant building blocks of the fleet engine (``serve.fleet``).

Counterpart of ``repro.serve.tenant``: the tenant spec and its runtime
state, the per-cut serving runtime (the split-cache phases and the
caches shared by every tenant at one cut), and the cross-tenant fair
admission half of the scheduler (``_FleetAdmitMixin``).

The reference jits each phase and merges a group's ``cur``/``pos`` back
into the fleet's arrays inside the jitted call; here each phase is a
plain call that updates its paged caches in place, and the merge is a
``torch.where`` on the group mask.  Rows outside a group ride along in
its call on zeroed block-table rows (``_PagedPool.table_for``): their
K/V writes land in the dump page, and no other per-slot tensor of theirs
changes (prefill scales are written for the group's slots only, decode
and verify write pages only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models import transformer as TF
from repro_torch.serve.phases import _SplitPhases
from repro_torch.serve.policy import AdaptivePolicy
from repro_torch.serve.scheduler import (Request, _bucket_len, _remove_is,
                                         _SamplingMirrors, _SlotEngine)
from repro_torch.serve.spec import _SpecDraftMixin
from repro_torch.serve.transport import ServeStats, Transport

__all__ = ["TenantSpec", "_Tenant", "_CutRuntime", "_FleetAdmitMixin"]


@dataclasses.dataclass
class TenantSpec:
    """One edge of the fleet: its link, its partition, its share.

    ``policy="auto"`` gives the tenant its own ``AdaptivePolicy`` over
    its own telemetry (candidate cuts {0, mid, last-1} ∪ {cut_layer});
    its switches apply at the tenant's own drained boundary.  ``weight``
    is the tenant's share under ``FleetFairness``; ``max_pages`` is an
    optional hard KV page quota (None = uncapped)."""
    name: str
    channel: Any = None
    cut_layer: int = 0
    spec_k: int = 1
    weight: float = 1.0
    max_pages: Optional[int] = None
    policy: Union[AdaptivePolicy, str, None] = None


class _Tenant:
    """Runtime state of one edge: its transport (channel and telemetry),
    its stats, its current (cut, spec_k) and a pending re-tune."""

    def __init__(self, spec: TenantSpec, policy: Optional[AdaptivePolicy]):
        self.name = spec.name
        self.spec = spec
        self.transport = Transport(spec.channel)
        self.stats = ServeStats()
        self.cut = spec.cut_layer
        self.spec_k = spec.spec_k
        self.policy = policy
        self.pending = None          # a Decision awaiting a drained boundary
        self.hold = False            # pause this tenant's admission

    @property
    def telemetry(self):
        return self.transport.telemetry

    def now(self) -> float:
        return float(getattr(self.transport.channel, "clock_s", 0.0))

    def wait(self, seconds: float) -> bool:
        """Advance this tenant's clock by ``seconds``, charged to its
        ``stall_wait_s``; False on a clockless channel."""
        s = float(seconds)
        if s <= 0:
            return True
        w = getattr(self.transport.channel, "wait", None)
        if w is None:
            return False
        w(s)
        self.stats.stall_wait_s += s
        return True


class _CutRuntime(_SpecDraftMixin, _SplitPhases):
    """Per-cut serving runtime: the split-cache phases and the edge,
    cloud and draft caches of one cut, shared by every tenant served at
    that cut.  Its weights are the fleet's ``_CutBank`` slices (views:
    building a runtime never requantizes), and its caches have the
    fleet pool's page count, so one slot's pages mean the same in every
    runtime.  It holds no reference to the fleet."""

    def __init__(self, fleet, cut: int):
        cfg = fleet.cfg
        self.cfg = cfg
        self.device = fleet.device
        self.max_len = fleet.max_len
        self.page_size = fleet.page_size
        self.a_bits = fleet.a_bits
        # the fleet shares one page pool: its caches are always paged
        self.edge_paged = self.cloud_paged = True
        self.edge_int8 = fleet.edge_int8
        self.cloud_int8 = fleet.cloud_int8
        self._edge_qctx = fleet._edge_qctx
        self._rope_tab = fleet._rope()
        self.n_edge = cut + 1
        self.n_cloud = cfg.n_layers - self.n_edge
        self.edge_blocks, self.cloud_blocks, self.draft_blocks = \
            fleet._bank.get(cut)
        n_pool = fleet._pool.allocator.num_pages

        def cache(layers, quantized):
            return TF.init_cache(cfg, fleet.max_batch, fleet.max_len,
                                 layers=layers, paged=True,
                                 quantized=quantized,
                                 page_size=fleet.page_size,
                                 num_pages=n_pool, device=self.device)

        self._edge_cache = cache(self.n_edge, self.edge_int8)
        self._cloud_cache = cache(self.n_cloud, self.cloud_int8)
        self._spec_max = fleet._spec_max
        self._draft_cache = (cache(self.n_cloud, self.edge_int8)
                             if self._spec_max > 1 else None)

    def _rope(self):
        return self._rope_tab

    # The round phases with the group merge: only the group's rows of
    # the fleet's cur/pos take the phase's new values.
    def _cloud_decode_merge_impl(self, blocks, tail, blob, qp, cache, pos,
                                 bt, cur, gmask):
        nxt, npos = self._cloud_decode(blocks, tail, blob, qp, cache, pos,
                                       bt)
        return torch.where(gmask, nxt, cur), torch.where(gmask, npos, pos)

    def _cloud_decode_sample_merge_impl(self, blocks, tail, blob, qp, cache,
                                        pos, bt, temps, top_ps, seeds,
                                        offsets, cur, gmask):
        nxt, npos = self._cloud_decode_sample_impl(
            blocks, tail, blob, qp, cache, pos, bt, temps, top_ps, seeds,
            offsets)
        return torch.where(gmask, nxt, cur), torch.where(gmask, npos, pos)

    def _verify_merge_impl(self, k, blocks, tail, blobs, scales, zps,
                           drafts, cache, pos, bt, cur, gmask):
        t, n_commit, ncur, npos = self._verify_impl(
            k, blocks, tail, blobs, scales, zps, drafts, cache, pos, bt)
        return (t, n_commit, torch.where(gmask, ncur, cur),
                torch.where(gmask, npos, pos))

    def _verify_sample_merge_impl(self, k, blocks, tail, blobs, scales, zps,
                                  drafts, qs, cache, pos, bt, temps, top_ps,
                                  seeds, offsets, cur, gmask):
        t, n_commit, ncur, npos = self._verify_sample_impl(
            k, blocks, tail, blobs, scales, zps, drafts, qs, cache, pos, bt,
            temps, top_ps, seeds, offsets)
        return (t, n_commit, torch.where(gmask, ncur, cur),
                torch.where(gmask, npos, pos))

    def _fleet_spec_fns(self, k: int):
        """(draft, merging verify) for draft length ``k``; each looks its
        phase up when called, so a wrapper installed on the runtime sees
        every call."""
        return (lambda *a: self._spec_draft_impl(k, *a),
                lambda *a: self._verify_merge_impl(k, *a))

    def _fleet_spec_sample_fns(self, k: int):
        """Sampled twin of ``_fleet_spec_fns``, for a (cut, k) group
        carrying at least one temperature > 0 slot; its greedy rows stay
        on the argmax branch, bit for bit."""
        return (lambda *a: self._spec_draft_sample_impl(k, *a),
                lambda *a: self._verify_sample_merge_impl(k, *a))


class _FleetAdmitMixin(_SamplingMirrors):
    """The admission half of ``FleetServingEngine``, with the solo
    engine's per-slot sampling mirrors."""

    def _reserve(self, max_news: np.ndarray) -> np.ndarray:
        head = self._spec_max - 1
        if self.demand_paged:
            return np.minimum(max_news + head, self._spec_max)
        return max_news + head

    def _quota_blocked(self, tenant: str, pending: int, needed: int) -> bool:
        q = self.fairness.quotas.get(tenant)
        return q is not None and \
            self._pool.owner_pages(tenant) + pending + needed > q

    def _admit_turn(self, queue, active, free, cur, pos, rounds):
        """One admission turn: fair-ordered eligible requests grouped by
        (cut, bucket) into batched prefill calls over the shared slot
        table.  Returns (admitted any, cur, pos, the first blocked
        request).  A quota-blocked request is skipped (its tenant waits
        without blocking the others); a pool-wide shortfall ends the
        turn."""
        admitted = False
        stalled: Optional[Request] = None
        while free:
            elig = [r for r in queue
                    if not self._tenants[r.tenant].hold
                    and r.arrival_s <= self._tenants[r.tenant].now() + 1e-12]
            elig.sort(key=self.fairness.admission_key)
            group: List[Request] = []
            rows: List[np.ndarray] = []
            slots: List[int] = []
            shapes: List[Tuple[int, int]] = []
            pending_pages: Dict[str, int] = {}
            gcut = gbucket = None
            pool_short = False
            for r in elig:
                if not free:
                    break
                t = self._tenants[r.tenant]
                bucket = _bucket_len(_SlotEngine._eff_plen(self, r),
                                     self.max_len)
                if gcut is not None and (t.cut, bucket) != (gcut, gbucket):
                    continue
                row = _SlotEngine._eff_prompt(r)
                eff_new = (r.max_new_tokens if r._parked is None
                           else r.max_new_tokens - len(r._parked) + 1)
                if len(row) + eff_new + self._spec_max - 1 > self.max_len:
                    raise ValueError(
                        f"request uid={r.uid} of tenant {r.tenant!r}: "
                        f"prompt + generation (+ draft headroom) exceeds "
                        f"cache max_len={self.max_len}")
                needed = self._pool.pages_needed(
                    len(row), int(self._reserve(np.int64(eff_new))),
                    bucket)
                if self._quota_blocked(r.tenant,
                                       pending_pages.get(r.tenant, 0),
                                       needed):
                    stalled = stalled or r
                    continue
                if sum(self._pool.pages_needed(
                        p, int(self._reserve(np.int64(m))), bucket)
                        for p, m in shapes) + needed \
                        > self._pool.free_pages():
                    stalled = stalled or r
                    pool_short = True
                    break
                if gcut is None:
                    gcut, gbucket = t.cut, bucket
                pending_pages[r.tenant] = \
                    pending_pages.get(r.tenant, 0) + needed
                shapes.append((len(row), eff_new))
                group.append(r)
                rows.append(row)
                slots.append(free.pop(0))
            if not group:
                break
            for r in group:
                _remove_is(queue, r)
            cur, pos = self._admit_group(group, rows, slots, shapes,
                                         gcut, gbucket, cur, pos, rounds,
                                         active)
            admitted = True
            if pool_short:
                break
        return admitted, cur, pos, stalled

    def _admit_group(self, group, rows, slots, shapes, cut, bucket, cur,
                     pos, rounds, active):
        """Batched prefill of one (cut, bucket) admission group, whose
        rows may span tenants; each tenant's wire is charged apart."""
        runtime = self._runtime(cut)
        self._note_samplings(slots, [r.sampling for r in group])
        toks = np.zeros((len(group), bucket), np.int32)
        for i, row in enumerate(rows):
            toks[i, :len(row)] = row
        plens = np.asarray([len(row) for row in rows], np.int32)
        reserves = self._reserve(
            np.asarray([m for _, m in shapes], np.int64))
        # pool admission per run of one tenant's rows (owner tagging)
        i = 0
        while i < len(group):
            j = i
            while j < len(group) and group[j].tenant == group[i].tenant:
                j += 1
            self._pool.admit(slots[i:j], plens[i:j], reserves[i:j], bucket,
                             owner=group[i].tenant)
            i = j
        slots_a = np.asarray(slots, np.int32)
        bt_rows = self._pool.rows(slots_a, bucket)
        dev = self.device
        slots_d = torch.as_tensor(slots_a, device=dev).long()
        plens_d = torch.as_tensor(plens, device=dev)
        toks_d = torch.tensor(toks, device=dev)
        blob, qp = runtime._edge_prefill(
            runtime.edge_blocks, self.embed, toks_d, runtime._edge_cache,
            slots_d, bt_rows, plens_d)
        if (self._samp_t[slots] > 0).any():
            cur, pos = runtime._cloud_prefill_sample_impl(
                runtime.cloud_blocks, self.tail, blob, qp,
                runtime._cloud_cache, slots_d, bt_rows, cur, pos, plens_d,
                *(torch.as_tensor(v[slots], device=dev)
                  for v in (self._samp_t, self._samp_p, self._samp_s)))
        else:
            cur, pos = runtime._cloud_prefill(
                runtime.cloud_blocks, self.tail, blob, qp,
                runtime._cloud_cache, slots_d, bt_rows, cur, pos, plens_d)
        drafting = any(self._tenants[r.tenant].spec_k > 1 for r in group)
        if self._spec_max > 1 and drafting:
            runtime._draft_prefill_impl(
                runtime.draft_blocks, blob, qp, runtime._draft_cache,
                slots_d, bt_rows, plens_d)
        # per-tenant wire accounting over the group's rows
        for name in dict.fromkeys(r.tenant for r in group):
            t = self._tenants[name]
            idx = [i for i, r in enumerate(group) if r.tenant == name]
            t.transport.account_blob(
                t.stats, blob, phase="prefill",
                row_elems=plens[idx].astype(np.int64) * self.cfg.d_model)
            t.transport.account_downlink(t.stats, len(idx),
                                         phase="prefill")
            t.stats.prefill_calls += 1
            t.stats.prefill_tokens += int(plens[idx].sum())
        # resumed requests: pin the stream to the parked tokens
        resumes = [(s, r) for r, s in zip(group, slots)
                   if r._parked is not None]
        if resumes:
            rs = torch.tensor([s for s, _ in resumes], dtype=torch.long,
                              device=dev)
            lasts = torch.tensor([int(r._parked[-1]) for _, r in resumes],
                                 dtype=cur.dtype, device=dev)
            cur = cur.index_put((rs,), lasts)
        fresh = [(r, s, 1) for r, s in zip(group, slots)
                 if r._parked is None]
        if fresh:
            rounds.append((cur[:, None], fresh))
        for r, s in zip(group, slots):
            t = self._tenants[r.tenant]
            active[s] = (r, 1 if r._parked is None else len(r._parked))
            if r.admit_s is None:
                r.admit_s = t.now()
            t.stats.queue_wait_s += max(0.0, t.now() - r._enq_s)
            r._parked = None
        return cur, pos
