"""Fault-tolerant collaborative serving: degradation and resync.

Counterpart of ``repro.serve.resilience``, whole.
``ResilientCollaborativeEngine`` is ``CollaborativeServingEngine`` with
the cloud allowed to disappear.  Three pieces compose:

* **Reliable transport** (``transport.ReliableTransport``): every
  boundary message gets a sequence number, a deadline from the link
  telemetry and a bounded retry budget with seeded backoff.  A send
  that exhausts its budget raises ``CloudUnreachable`` — the engine's
  signal, not its crash.
* **Graceful degradation**: on that signal the engine declares the
  cloud down and keeps streaming *edge-only* on the ``_CutBank``'s INT8
  copy of the cloud suffix (the speculative draft model), with no wire
  bytes; the committed tokens are counted in
  ``ServeStats.edge_only_tokens``.  In the lossless ``a_bits=None``
  mode the suffix copy *is* the cloud suffix, so the stream does not
  change.
* **Resync on reconnect**: while down, the engine keeps each live
  slot's dequantized f32 boundary rows (what the cloud suffix would
  have consumed; on the device, so an edge-only round reads nothing
  back to the host).  A single-attempt probe every ``probe_every``
  scheduler turns detects recovery; the rows then replay through the
  cloud suffix in one multi-token cached step per group of slots with
  the same replay length (``paged_flash_mq`` at S = R, each row from
  its own resume position), rebuilding the cloud's paged KV to the
  committed stream, and draft/verify rounds resume.  A slot admitted
  during the outage replays prefill-style from position 0, calibrating
  the cloud's INT8 scales.

Protocol fine print, chosen so state never forks:

* The draft cache is kept **hot** even at k = 1 — the edge runs its
  suffix copy beside every uplink — so failover needs no warm-up; the
  suffix copy and its page headroom exist from construction
  (``_standby``).
* A downlink lost *after* the cloud committed (a verify result, a
  prefill ack) keeps the result: sequence numbers make the retransmit
  idempotent, and the cloud-side state is already the truth.
* An uplink lost *mid-round* commits the round's local drafts: the
  boundary rows are computed, so the failed round costs only the wire
  it never got.
* The policy is suspended while down (a re-partition would invalidate
  the replay rows, which are boundary activations at the current cut),
  and probing takes its place between rounds.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.quant import dequantize
from repro_torch.serve.engine import CollaborativeServingEngine
from repro_torch.serve.kvcache import _cdiv
from repro_torch.serve.transport import (_MSG_BYTES, _QP_BYTES,
                                         CloudUnreachable, ReliableTransport)

__all__ = ["ResilientCollaborativeEngine"]


class ResilientCollaborativeEngine(CollaborativeServingEngine):
    """Collaborative serving that survives drops, stalls and outages.

    Takes every ``CollaborativeServingEngine`` argument plus:

    ``transport``     a ``ReliableTransport`` to use (default: one around
                      the given channel, with the default retry budget
                      and deadline parameters);
    ``probe_every``   while down, send one heartbeat probe every this
                      many scheduler turns (each failed probe costs one
                      deadline of simulated waiting, which is also what
                      moves a fault schedule's clock toward the end of an
                      outage window).

    ``round_log`` holds one ``{"t_s", "committed", "cloud_down"}`` entry
    per round: the availability trace over an outage.  It needs the
    paged layouts on both sides, as the reference does: the resync
    replays into the cloud's pages through the shared block table."""

    _standby = True

    def __init__(self, params, cfg, *, transport: Optional[
            ReliableTransport] = None, probe_every: int = 2, **kw):
        if not (kw.get("edge_paged", True) and kw.get("cloud_paged", True)):
            raise ValueError("resilient serving needs the paged KV layouts "
                             "(the resync replays into the cloud's pages)")
        super().__init__(params, cfg, **kw)
        if transport is None:
            transport = ReliableTransport(self.transport.channel,
                                          self.transport.telemetry)
        self.transport = transport
        self.probe_every = max(1, int(probe_every))
        self.cloud_down = False
        self._down_since: Optional[float] = None
        self._rounds_down = 0
        self._live_slots: Set[int] = set()
        # slot -> [resume position, list of [r, D] f32 boundary-row chunks]
        self._replay: Dict[int, List] = {}
        self.round_log: List[dict] = []

    # -- outage state machine ------------------------------------------------
    def _enter_outage(self, pos: torch.Tensor) -> None:
        if self.cloud_down:
            return
        self.cloud_down = True
        self._rounds_down = 0
        self._down_since = getattr(self.channel, "clock_s", None)
        # every live slot resumes the cloud KV from its position at the
        # loss: the one host read an outage costs
        p = pos.cpu().numpy()
        self._replay = {s: [int(p[s]), []] for s in self._live_slots}

    def _policy_tick(self, n_active: int) -> bool:
        # while down the control loop is probe-and-resync: a cut switch
        # would invalidate the replay rows (boundary at the current cut)
        if self.cloud_down:
            self._rounds_down += 1
            if self._rounds_down % self.probe_every == 0:
                self._try_reconnect()
            return False
        return super()._policy_tick(n_active)

    def _try_reconnect(self) -> None:
        ok, _ = self.transport.probe(self.stats)
        if not ok:
            return
        try:
            self._resync()
        except CloudUnreachable:
            return      # relapsed mid-resync: buffers intact, stay down
        clock = getattr(self.channel, "clock_s", None)
        if clock is not None and self._down_since is not None:
            self.stats.outage_s += clock - self._down_since
        self.cloud_down = False
        self._down_since = None
        self._rounds_down = 0
        self._replay = {}
        self.stats.resyncs += 1

    def _resync(self) -> None:
        """Replay every live slot's buffered boundary rows through the
        cloud suffix, rebuilding its paged KV to the committed stream.
        Slots sharing a replay length run as one multi-token cached step;
        outage-admitted slots (resume position 0) also calibrate the
        cloud's per-slot INT8 scales, prefill-style."""
        groups: Dict[Tuple[int, bool], List] = {}
        for s, (p0, chunks) in self._replay.items():
            if not chunks:
                continue
            rows = torch.cat(chunks, dim=0)             # [R, D] f32
            groups.setdefault((rows.shape[0], p0 == 0), []).append(
                (s, p0, rows))
        itemsize = 1 if self.a_bits is not None else 4
        dev, pool = self.device, self._pool
        for (r_len, fresh), members in sorted(groups.items()):
            slots = [s for s, _, _ in members]
            # the wire carries the rows re-framed on the Eq.(1) lattice
            # (they are dequantized lattice points, so requantizing is
            # exact), one message per group; a loss here aborts the
            # resync and the engine stays down with its buffers
            self.transport.charge(
                self.stats,
                len(members) * r_len * (self.cfg.d_model * itemsize
                                        + _QP_BYTES) + _MSG_BYTES,
                phase="decode", log=False)
            if fresh:
                w = max(1, _cdiv(r_len, self.page_size))
                self._resync_prefill_impl(
                    self.cloud_blocks,
                    torch.stack([r for _, _, r in members]),
                    self._cloud_cache,
                    torch.as_tensor(slots, device=dev).long(),
                    pool._copy(pool.bt[slots][:, :w]),
                    torch.full((len(members),), r_len, dtype=torch.int32,
                               device=dev))
            else:
                hb = torch.zeros((self.max_batch, r_len, self.cfg.d_model),
                                 dtype=torch.float32, device=dev)
                posb = np.zeros((self.max_batch,), np.int32)
                bt = np.zeros_like(pool.bt)
                need = 1
                for s, p0, rows in members:
                    hb[s], posb[s] = rows, p0
                    bt[s] = pool.bt[s]
                    need = max(need, _cdiv(p0 + r_len, self.page_size))
                w = 1
                while w < need:
                    w *= 2
                w = min(w, pool.pages_per_slot)
                self._resync_replay_impl(
                    self.cloud_blocks, hb, self._cloud_cache,
                    torch.as_tensor(posb, device=dev), pool._copy(bt[:, :w]))

    # -- scheduler hooks, fault-aware ---------------------------------------
    def _round_width(self):
        # edge-only rounds are serial whatever spec_k is
        return 1 if (self.cloud_down or self.spec_k == 1) else self.spec_k

    def _edge_step(self, cur, pos, bt, slots):
        """One local step of the hot standby: ``(blob, qp, f32 boundary
        row, token, new pos)``.  Sampled slots draw their token from the
        ``CLOUD`` stream on the suffix copy's filtered distribution
        (``serve.spec``), so a lossless edge-only stream is the cloud's
        serial sampled stream bit for bit."""
        args = (self.edge_blocks, self.draft_blocks, self.embed, self.tail,
                cur, self._edge_cache, self._draft_cache, pos, bt)
        if (self._samp_t[slots] > 0).any():
            return self._edge_only_step_sample_impl(
                *args, *self._samp_vecs(), self._offsets())
        return self._edge_only_step_impl(*args)

    def _admit(self, toks, plens, max_news, slots, cur, pos, samplings=None):
        self._note_samplings(slots, samplings)
        bt_rows = self._pool.admit(slots, plens,
                                   self._admit_reserve(max_news),
                                   toks.shape[1])
        slots_d = torch.as_tensor(slots, device=self.device).long()
        plens_d = torch.as_tensor(plens, device=self.device)
        blob, qp = self._edge_prefill(self.edge_blocks, self.embed, toks,
                                      self._edge_cache, slots_d, bt_rows,
                                      plens_d)
        samp = ()
        if (self._samp_t[slots] > 0).any():
            samp = tuple(torch.as_tensor(v[slots], device=self.device)
                         for v in (self._samp_t, self._samp_p, self._samp_s))
        if not self.cloud_down:
            try:
                self.transport.account_blob(
                    self.stats, blob, phase="prefill",
                    row_elems=plens.astype(np.int64) * self.cfg.d_model)
                prefill = (self._cloud_prefill_sample_impl if samp
                           else self._cloud_prefill)
                cur, pos = prefill(self.cloud_blocks, self.cloud_tail, blob,
                                   qp, self._cloud_cache, slots_d, bt_rows,
                                   cur, pos, plens_d, *samp)
                # the standby drafts whatever the current spec_k
                self._draft_prefill_impl(self.draft_blocks, blob, qp,
                                         self._draft_cache, slots_d,
                                         bt_rows, plens_d)
                self._live_slots.update(int(s) for s in slots)
                try:
                    self.transport.account_downlink(self.stats,
                                                    toks.shape[0],
                                                    phase="prefill")
                except CloudUnreachable:
                    # the cloud committed the prefill; only the ack is
                    # lost, and the seq-numbered retransmit is
                    # idempotent: keep it
                    self._enter_outage(pos)
                return cur, pos
            except CloudUnreachable:
                self._enter_outage(pos)
        # cloud down: the suffix copy serves the admission alone
        admit = (self._edge_only_prefill_sample_impl if samp
                 else self._edge_only_prefill_impl)
        cur, pos = admit(self.draft_blocks, self.tail, blob, qp,
                         self._draft_cache, slots_d, bt_rows, plens_d, cur,
                         pos, *samp)
        rows = dequantize(blob, qp)                    # [n, S, D] f32
        for i, s in enumerate(slots):
            self._replay[int(s)] = [0, [rows[i, :int(plens[i])]]]
        self._live_slots.update(int(s) for s in slots)
        self.stats.edge_only_tokens += len(slots)
        return cur, pos

    def _round(self, cur, pos, slots):
        if self.cloud_down:
            return self._edge_only_round(cur, pos, slots)
        if self.spec_k == 1:
            return self._serial_round(cur, pos, slots)
        return self._spec_round(cur, pos, slots)

    def _serial_round(self, cur, pos, slots):
        n_active = len(slots)
        bt = self._pool.table_dev()
        # the edge half also advances the suffix copy: the hot standby
        blob, qp, hq, nxt, pos_e = self._edge_step(cur, pos, bt, slots)
        try:
            self.transport.account_blob(self.stats, blob, phase="decode",
                                        rows=n_active)
        except CloudUnreachable:
            self._enter_outage(pos)
            return self._commit_local(nxt, pos_e, hq, slots)
        if (self._samp_t[slots] > 0).any():
            cur, pos = self._cloud_decode_sample_impl(
                self.cloud_blocks, self.cloud_tail, blob, qp,
                self._cloud_cache, pos, bt, *self._samp_vecs(),
                self._offsets())
        else:
            cur, pos = self._cloud_decode(self.cloud_blocks,
                                          self.cloud_tail, blob, qp,
                                          self._cloud_cache, pos, bt)
        try:
            self.transport.account_downlink(self.stats, n_active)
        except CloudUnreachable:
            self._enter_outage(pos)   # committed cloud-side: keep the token
        return cur, pos, cur[:, None], None

    def _spec_round(self, cur, pos, slots):
        k, n_active = self.spec_k, len(slots)
        bt = self._pool.table_dev()
        (blobs, scales, zps, drafts), nbytes, verify = self._draft_round(
            cur, pos, bt, slots)
        try:
            self.transport.charge(self.stats, nbytes, phase="decode")
        except CloudUnreachable:
            # the round's drafts are computed and locally consistent:
            # commit all k instead of wasting the round.  Sampled rows
            # commit their DRAFT-stream draws: in the lossless mode the
            # draft distribution is the cloud's, so the committed tokens
            # keep the cloud's distribution
            self._enter_outage(pos)
            h = (blobs.to(torch.float32) - zps[..., None]) \
                * scales[..., None]                          # [k, B, D]
            for s in slots:
                self._replay[int(s)][1].append(h[:, int(s), :])
            self.stats.edge_only_tokens += k * n_active
            counts = np.full((self.max_batch,), k, np.int64)
            return drafts[-1], torch.clamp(pos + k, max=self.max_len - 1), \
                drafts.transpose(0, 1), counts
        toks, n_commit, cur, pos = verify(pos)
        counts = n_commit.cpu().numpy()
        try:
            self.transport.account_downlink(self.stats, n_active, k=k)
        except CloudUnreachable:
            self._enter_outage(pos)   # verify committed: keep its result
        self._count_round(counts, slots)
        return cur, pos, toks, counts

    def _edge_only_round(self, cur, pos, slots):
        bt = self._pool.table_dev()
        _, _, hq, nxt, pos = self._edge_step(cur, pos, bt, slots)
        return self._commit_local(nxt, pos, hq, slots)

    def _commit_local(self, nxt, pos, hq, slots):
        for s in slots:
            self._replay[int(s)][1].append(hq[int(s)][None, :])
        self.stats.edge_only_tokens += len(slots)
        return nxt, pos, nxt[:, None], None

    def _retire(self, slot):
        super()._retire(slot)
        self._live_slots.discard(int(slot))
        # a request finished on edge-only tokens owes the cloud nothing
        self._replay.pop(int(slot), None)

    def _after_round(self, n_active: int, committed: int) -> None:
        self.round_log.append({
            "t_s": float(getattr(self.channel, "clock_s", 0.0)),
            "committed": committed,
            "cloud_down": self.cloud_down,
        })
