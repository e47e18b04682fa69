"""Multi-edge fleet serving: one shared cloud engine, N tenant edges.

Counterpart of ``repro.serve.fleet``.  ``FleetServingEngine`` admits
request streams from many simulated edges (tenants), each with its own
channel, ``LinkTelemetry`` and ``ServeStats`` and its own ``(cut_layer,
spec_k)``, served out of **one** prequantized ``_CutBank`` (no per-tenant
weight copies) over **one** slot table and KV page pool.

Every scheduler turn groups the live slots by ``(cut, spec_k)`` and
advances each group with one phase sequence over the whole slot axis:
one edge decode (k = 1) or one k-step draft, one uplink charge per
tenant, one batched verify over the shared pool (``paged_flash_mq``).
Tenants at different cuts run through their own per-cut runtime
(``serve.tenant._CutRuntime``) but share the slot and page tables; rows
riding along in another group's call are masked to the dump page
(``_PagedPool.table_for``), so per-slot streams stay independent: a
tenant's stream is the stream it would get served alone.  The edge
quantizes each row's boundary on its own range (``act_axis=0``), so in
the INT8 mode too a tenant's stream does not depend on who shares its
batch.

Temperature > 0 requests ride the same group rounds through the sampled
phase twins; their keys depend only on (seed, output index, stream),
never on co-tenants or slot numbers, and sampled rows' k-1 filtered q
rows are charged to their tenant's uplink at f32 vocabulary width.

Fairness (``policy.FleetFairness``): admission orders eligible requests
by priority, then weighted virtual service, then arrival; per-tenant
page quotas bound a tenant's claim; with ``demand_paged`` a growth the
pool cannot cover preempts the tenant most over its fair page share
first, and the preempted request resumes by replay.  Per-tenant
re-tuning (``policy="auto"`` on a ``TenantSpec``) applies a cut or
draft-length switch at that tenant's own drained boundary; no other
tenant waits for it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.core.costmodel import Channel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.kvcache import PoolExhausted, _PagedPool
from repro_torch.serve.policy import AdaptivePolicy, FleetFairness, _CutBank
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from repro_torch.serve.tenant import (TenantSpec, _CutRuntime,
                                      _FleetAdmitMixin, _Tenant)
from repro_torch.serve.transport import (_MSG_BYTES, _QP_BYTES, _TOK_BYTES,
                                         ServeStats)

__all__ = ["TenantSpec", "FleetServingEngine"]


class FleetServingEngine(_FleetAdmitMixin):
    """One cloud, N edges: continuous batching over a shared slot table
    with cross-tenant batched rounds (see the module docstring), on
    ``device`` (default ``"cuda"``).

    ``tenants`` is a list of ``TenantSpec``; requests are submitted per
    tenant (``generate``/``generate_requests``) and served concurrently.
    Each tenant's wire traffic is charged to its own channel and
    ``ServeStats`` (``engine.tenant(name).stats``); ``engine.stats``
    sums the fleet.  ``round_calls`` counts the batched round phase
    sequences issued (one per (cut, k) group per turn)."""

    def __init__(self, params, cfg: TF.LMConfig,
                 tenants: Sequence[TenantSpec], *, max_batch: int = 8,
                 max_len: int = 128, a_bits: Optional[int] = 8,
                 edge_int8: bool = True, cloud_int8: bool = True,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 demand_paged: bool = False,
                 spec_acceptance: float = 0.8,
                 device: DeviceLike = None):
        if not tenants:
            raise ValueError("a fleet needs at least one tenant")
        if len({t.name for t in tenants}) != len(tenants):
            raise ValueError("tenant names must be unique")
        dev = resolve_device(device)
        self.device = dev
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.a_bits = a_bits
        self.edge_int8 = edge_int8
        self.cloud_int8 = cloud_int8
        self.page_size = page_size
        self.demand_paged = bool(demand_paged)
        self._rope_tab = None
        # act_axis=0: each slot's Eq.(1) activation lattice is its own,
        # which is what keeps a tenant's INT8 stream independent of who
        # shares its batch
        self._edge_qctx = None if a_bits is None else \
            ML.QuantCtx(a_bits=a_bits, quantize_weights=False, act_axis=0)
        deploy_qctx = None if a_bits is None else ML.QuantCtx(a_bits=a_bits)
        self._pool = _PagedPool.build(max_batch, max_len, page_size,
                                      num_pages, dev)

        # per-tenant control planes and the one shared weight bank
        self._tenants: Dict[str, _Tenant] = {}
        bank_cuts = set()
        spec_max = 1
        for spec in tenants:
            if not 0 <= spec.cut_layer < cfg.n_layers:
                raise ValueError(f"tenant {spec.name!r}: cut_layer "
                                 f"{spec.cut_layer} outside [0, "
                                 f"{cfg.n_layers})")
            policy = spec.policy
            if policy == "auto":
                if spec.cut_layer > cfg.n_layers - 2:
                    raise ValueError("adaptive tenants need a cloud block "
                                     "at every candidate cut")
                initial = spec.channel or Channel(
                    bandwidth_bytes_per_s=float("inf"))
                initial = getattr(initial, "phase", initial)
                cuts = tuple(sorted({0, (cfg.n_layers - 1) // 2,
                                     cfg.n_layers - 2, spec.cut_layer}))
                policy = AdaptivePolicy(cfg, batch=max_batch, cuts=cuts,
                                        ks=(1, 2, 4, 8),
                                        fallback_channel=initial,
                                        acceptance_prior=spec_acceptance)
            self._tenants[spec.name] = _Tenant(spec, policy or None)
            bank_cuts.add(spec.cut_layer)
            spec_max = max(spec_max, spec.spec_k)
            if policy is not None:
                bank_cuts |= set(policy.cuts or ())
                spec_max = max(spec_max, *policy.ks)
        self._spec_max = spec_max
        self.fairness = FleetFairness(
            {t.name: t.weight for t in tenants},
            {t.name: t.max_pages for t in tenants})

        params = tree_map(lambda t: t.to(dev), params)
        self.embed = params["embed"]
        self.tail = {"final_norm": params["final_norm"],
                     "lm_head": params["lm_head"]}
        self._bank = _CutBank(params, cfg, bank_cuts, deploy_qctx,
                              drafts=spec_max > 1)
        self._runtimes: Dict[int, _CutRuntime] = {}
        # batched round phase sequences issued: one per (cut, k) group
        # per turn — what co-batching divides by up to N
        self.round_calls = 0
        # device group masks, keyed by slot tuple (groups repeat)
        self._gmasks: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._init_sampling()
        # the scheduler's live view, as the solo engine's
        self._sched_active = None
        self._sched_committed = None

    # -- public surface ------------------------------------------------------
    def tenant(self, name: str) -> _Tenant:
        return self._tenants[name]

    @property
    def stats(self) -> ServeStats:
        """Fleet-wide rollup of the per-tenant stats."""
        return ServeStats.aggregate(
            [t.stats for t in self._tenants.values()])

    def generate(self, prompts: Dict[str, List[np.ndarray]], *,
                 max_new_tokens: int = 16,
                 sampling=None) -> Dict[str, List[List[int]]]:
        """Decode per-tenant prompt lists with cross-tenant continuous
        batching; returns the token streams per tenant in input order.
        ``sampling`` is None (greedy), one ``SamplingParams`` for every
        prompt, or a dict from tenant name to one ``SamplingParams`` or a
        per-prompt list."""
        def _samp(name: str, i: int) -> Optional[SamplingParams]:
            s = (sampling.get(name) if isinstance(sampling, dict)
                 else sampling)
            return s[i] if isinstance(s, (list, tuple)) else s
        reqs = {name: [Request(uid=i, prompt=np.asarray(p),
                               max_new_tokens=max_new_tokens,
                               sampling=_samp(name, i))
                       for i, p in enumerate(ps)]
                for name, ps in prompts.items()}
        return self.generate_requests(reqs)

    def generate_requests(self, reqs: Dict[str, List[Request]]
                          ) -> Dict[str, List[List[int]]]:
        """Run caller-built per-tenant ``Request`` lists (priorities,
        deadlines, arrival times on each tenant's own simulated clock)."""
        flat: List[Request] = []
        seq = 0
        for name, rl in reqs.items():
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r}")
            for r in rl:
                r.tenant = name
                r._seq = seq
                r._enq_s = float(r.arrival_s)
                seq += 1
                flat.append(r)
        if flat:
            self._run(flat)
        return {name: [r.out_tokens for r in rl]
                for name, rl in reqs.items()}

    # -- internals -----------------------------------------------------------
    def _rope(self):
        """RoPE tables over ``max_len`` positions, built once and shared
        by every runtime."""
        if self._rope_tab is None:
            self._rope_tab = ML.rope_table(
                self.max_len, self.cfg.hd, base=self.cfg.rope_base,
                dtype=self.cfg.dtype, device=self.device)
        return self._rope_tab

    def _runtime(self, cut: int) -> _CutRuntime:
        if cut not in self._runtimes:
            self._runtimes[cut] = _CutRuntime(self, cut)
        return self._runtimes[cut]

    def _tenant_tick(self, t: _Tenant, n_active: int) -> None:
        """One control-loop turn for one tenant: re-decide (cut, k) from
        its telemetry and apply it at its own drained boundary, holding
        only its admission while its slots drain."""
        if t.policy is not None:
            live = [s for s, (r, _c) in (self._sched_active or {}).items()
                    if r.tenant == t.name]
            frac = (sum(1 for s in live if self._samp_t[s] > 0)
                    / len(live) if live else 0.0)
            kw = {"sampled_frac": frac} if frac > 0.0 else {}
            d = t.policy.decide(t.telemetry, cut=t.cut, spec_k=t.spec_k,
                                **kw)
            t.pending = d if (d.cut, d.spec_k) != (t.cut, t.spec_k) else None
        if t.pending is None:
            t.hold = False
            return
        if n_active:
            t.hold = True
            t.stats.policy_holds += 1
            return
        if t.pending.cut != t.cut:
            t.cut = t.pending.cut
            t.stats.cut_switches += 1
        if t.pending.spec_k != t.spec_k:
            t.spec_k = t.pending.spec_k
            t.stats.spec_k_switches += 1
        t.pending = None
        t.hold = False

    def _run(self, reqs: List[Request]) -> None:
        queue: List[Request] = list(reqs)
        active: Dict[int, Tuple[Request, int]] = {}
        free = list(range(self.max_batch))
        cur = torch.zeros((self.max_batch,), dtype=torch.int32,
                          device=self.device)
        pos = torch.zeros_like(cur)
        rounds: List[Tuple[torch.Tensor, List[Tuple[Request, int, int]]]] = []

        def committed_tokens(r: Request) -> np.ndarray:
            chunks = [t[s, :n].cpu().numpy()
                      for t, takes in rounds
                      for rr, s, n in takes if rr is r and n > 0]
            return (np.concatenate(chunks).astype(np.int32) if chunks
                    else np.zeros((0,), np.int32))

        self._sched_active = active
        self._sched_committed = committed_tokens

        def preempt(slot: int) -> None:
            r, _c = active.pop(slot)
            t = self._tenants[r.tenant]
            r._parked = committed_tokens(r)
            r._enq_s = t.now()
            r.preemptions += 1
            t.stats.preemptions += 1
            self._pool.retire(slot)
            free.append(slot)
            queue.append(r)

        try:
            while queue or active:
                # control plane: per-tenant policy ticks, pool snapshot
                n_active_by = {name: 0 for name in self._tenants}
                for r, _c in active.values():
                    n_active_by[r.tenant] += 1
                for name, t in self._tenants.items():
                    self._tenant_tick(t, n_active_by[name])
                    t.stats.observe_pool(self._pool)

                admitted, cur, pos, stalled = self._admit_turn(
                    queue, active, free, cur, pos, rounds)

                if not admitted and not active and queue:
                    # nothing running or admitted: advance each tenant's
                    # clock to its own next arrival (clocks are
                    # independent, so no tenant pays another's idle gap),
                    # or raise when nothing can ever be admitted
                    progressed = False
                    for name, t in self._tenants.items():
                        pend = [r.arrival_s for r in queue
                                if r.tenant == name]
                        if pend and min(pend) > t.now():
                            progressed |= t.wait(min(pend) - t.now())
                    if not progressed:
                        if stalled is not None:
                            r = stalled
                            raise RuntimeError(
                                f"fleet KV page pool (or tenant "
                                f"{r.tenant!r} quota) can never admit "
                                f"request uid={r.uid} (prompt "
                                f"{len(r.prompt)} + {r.max_new_tokens} "
                                f"new) even with every slot idle")
                        # clockless channels: everything queued on them
                        # counts as already arrived
                        for r in queue:
                            ch = self._tenants[r.tenant].transport.channel
                            if getattr(ch, "wait", None) is None:
                                r.arrival_s = 0.0
                    continue

                # retire requests whose budget just filled
                for s in [s for s, (r, c) in active.items()
                          if c >= r.max_new_tokens]:
                    r, _ = active.pop(s)
                    t = self._tenants[r.tenant]
                    r.done = True
                    r.finish_s = t.now()
                    if (r.deadline_s is not None
                            and r.finish_s > r.deadline_s + 1e-9):
                        t.stats.deadline_misses += 1
                    self._pool.retire(s)
                    free.append(s)

                # demand paging: grow live claims; PoolExhausted preempts
                # the tenant most over its fair share first
                if active and self.demand_paged:
                    self._grow_claims(active, preempt)

                # rounds, one batched phase sequence per (cut, k) group
                if active:
                    groups: Dict[Tuple[int, int], List[int]] = {}
                    for s, (r, _c) in active.items():
                        t = self._tenants[r.tenant]
                        groups.setdefault((t.cut, t.spec_k), []).append(s)
                    for (gcut, gk) in sorted(groups):
                        cur, pos = self._group_round(
                            self._runtime(gcut), gk,
                            np.asarray(sorted(groups[(gcut, gk)]),
                                       np.int32),
                            cur, pos, active, rounds)
        finally:
            self._sched_active = None
            self._sched_committed = None
        if not rounds:
            return
        # one device -> host copy for the whole run
        all_toks = torch.cat([t for t, _ in rounds], dim=1).cpu().numpy()
        col = 0
        for toks_r, takes in rounds:
            for r, s, n in takes:
                r.out_tokens.extend(int(t) for t in all_toks[s, col:col + n])
            col += toks_r.shape[1]

    def _grow_claims(self, active, preempt) -> None:
        """Grow every live slot's claim to cover its coming round, in
        priority order; on ``PoolExhausted`` preempt by
        ``FleetFairness.victim_key`` (slot breaks ties) and retry."""
        usable = self._pool.allocator.num_pages - 1
        for s in sorted(active, key=lambda v: (-active[v][0].priority, v)):
            if s not in active:
                continue
            r, c = active[s]
            k_t = self._tenants[r.tenant].spec_k
            horizon = min(len(r.prompt) + c - 1 + k_t, self.max_len)
            while s in active:
                try:
                    self._pool.ensure(s, horizon)
                    break
                except PoolExhausted:
                    victims = sorted(active, key=lambda v: (
                        *self.fairness.victim_key(
                            active[v][0],
                            self._pool.owner_pages(active[v][0].tenant),
                            usable,
                            active[v][0].max_new_tokens - active[v][1]),
                        v))
                    preempt(victims[0])

    def _group_mask(self, slots_g: np.ndarray) -> torch.Tensor:
        key = tuple(int(s) for s in slots_g)
        if key not in self._gmasks:
            gm = np.zeros((self.max_batch,), np.bool_)
            gm[list(key)] = True
            self._gmasks[key] = torch.as_tensor(gm, device=self.device)
        return self._gmasks[key]

    # -- the cross-tenant batched round --------------------------------------
    def _group_round(self, runtime, k, slots_g, cur, pos, active, rounds):
        """Advance one (cut, k) group of live slots, possibly spanning
        several tenants, with one phase sequence: one edge decode and
        cloud step (k = 1), or one k-step draft and **one** multi-token
        verify over the shared pool.  Slots outside the group write to
        the dump page; only the group's rows merge back into cur/pos.
        A group with a temperature > 0 slot takes the sampled twins
        (its greedy rows stay bit for bit), and a sampled row's q rows
        are charged to its tenant."""
        self.round_calls += 1
        by_tenant: Dict[str, List[int]] = {}
        for s in slots_g:
            by_tenant.setdefault(active[int(s)][0].tenant, []).append(int(s))
        bt = self._pool.table_for(slots_g)
        gmask = self._group_mask(slots_g)
        sampled = bool((self._samp_t[slots_g] > 0).any())
        samp = (*self._samp_vecs(), self._offsets()) if sampled else ()
        if k == 1:
            blob, qp = runtime._edge_decode(
                runtime.edge_blocks, self.embed, cur, runtime._edge_cache,
                pos, bt)
            for name, srows in by_tenant.items():
                t = self._tenants[name]
                t.transport.account_blob(t.stats, blob, phase="decode",
                                         rows=len(srows))
            args = (runtime.cloud_blocks, self.tail, blob, qp,
                    runtime._cloud_cache, pos, bt)
            if sampled:
                cur, pos = runtime._cloud_decode_sample_merge_impl(
                    *args, *samp, cur, gmask)
            else:
                cur, pos = runtime._cloud_decode_merge_impl(*args, cur,
                                                            gmask)
            for name, srows in by_tenant.items():
                t = self._tenants[name]
                t.transport.account_downlink(t.stats, len(srows))
            counts = None
            toks_block = cur[:, None]
        else:
            args = (runtime.edge_blocks, runtime.draft_blocks, self.embed,
                    self.tail, cur, runtime._edge_cache,
                    runtime._draft_cache, pos, bt)
            if sampled:
                draft_fn, verify_fn = runtime._fleet_spec_sample_fns(k)
                blobs, scales, zps, drafts, qs = draft_fn(*args, *samp)
                tail_args = (qs,)
            else:
                draft_fn, verify_fn = runtime._fleet_spec_fns(k)
                blobs, scales, zps, drafts = draft_fn(*args)
                tail_args = ()
            for name, srows in by_tenant.items():
                t = self._tenants[name]
                n_samp = int((self._samp_t[srows] > 0).sum())
                t.transport.charge(
                    t.stats,
                    len(srows) * (k * (self.cfg.d_model
                                       * blobs.element_size() + _QP_BYTES)
                                  + (k - 1) * _TOK_BYTES)
                    + n_samp * (k - 1) * self.cfg.vocab * 4 + _MSG_BYTES,
                    phase="decode")
            toks_block, n_commit, cur, pos = verify_fn(
                runtime.cloud_blocks, self.tail, blobs, scales, zps, drafts,
                *tail_args, runtime._cloud_cache, pos, bt, *samp, cur,
                gmask)
            # the edge needs the accept counts to schedule the next round:
            # this sync is part of the protocol
            counts = n_commit.cpu().numpy()
            for name, srows in by_tenant.items():
                t = self._tenants[name]
                t.transport.account_downlink(t.stats, len(srows), k=k)
                t.stats.spec_rounds += 1
                hits = int(np.minimum(counts[srows] - 1, k - 1).sum())
                t.stats.drafted_tokens += (k - 1) * len(srows)
                t.stats.draft_hits += hits
                t.telemetry.observe_round((k - 1) * len(srows), hits)
        takes = []
        for s in slots_g:
            r, c = active[int(s)]
            n = 1 if counts is None else int(counts[s])
            n = min(n, r.max_new_tokens - c)
            active[int(s)] = (r, c + n)
            takes.append((r, int(s), n))
            self.fairness.charge(r.tenant, n)
            self._tenants[r.tenant].stats.decode_tokens += n
        for name in by_tenant:
            self._tenants[name].stats.decode_steps += 1
        rounds.append((toks_block, takes))
        return cur, pos
