"""Slot-based continuous-batching scheduler shared by both engines.

Counterpart of ``repro.serve.scheduler``.  Requests queue up, prompts
are right-padded to power-of-two *buckets* and same-bucket prompts are
prefilled together into free cache slots, every **round** advances all
occupied slots at their own positions by one committed token (the
serial step) or, in a speculative engine, by a per-slot number of them
that the engine reports back (``_round``), and a finished request frees
its slot — and its KV pages — for the next queued prompt mid-flight.
The current token and position of every slot stay on the device; the
host reads the tokens once, after the last round (a speculative round
also syncs its small accept-count vector, which the edge needs to
schedule the next round).

Requests may carry ``SamplingParams`` (``serve.sampling``), a priority,
a deadline and an arrival time on the engine's simulated clock
(``generate_requests``).  Admission takes the arrived requests in
priority order; a deadline-aware engine sheds a request predicted to
finish late (``_admission_policy``).  A demand-paged engine grows each
live slot's page claim before a round writes (``_ensure_slot``); when
the pool is exhausted the scheduler **preempts** a victim — lowest
priority first, then the most remaining budget — parks its committed
tokens and re-queues it, and its re-admission replays prompt plus
committed tokens in one prefill, pinning the last committed token.

The scheduler also hosts the engine-side half of the online re-tuning
loop: ``_policy_tick`` runs at the top of every scheduler turn, where a
policy may switch the draft length between rounds and request a
**re-partition barrier** — admission pauses until the occupied slots
drain, the cut switch applies at that admission boundary, and the queue
resumes on the new partition.

The JAX reference jits each phase and donates the cache buffers; here
each phase is a plain call and the cache tensors are updated in place,
which is what donation achieves there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.kvcache import PoolExhausted
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.stats import ServeStats

__all__ = ["Request", "_bucket_len", "_SamplingMirrors", "_SlotEngine"]


def _bucket_len(plen: int, max_len: int) -> int:
    """Power-of-two prefill bucket (floor 8, capped at ``max_len``)."""
    b = 8
    while b < plen:
        b *= 2
    return min(b, max_len)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # None or temperature=0 → the greedy path, bit for bit
    sampling: Optional[SamplingParams] = None
    # -- overload-robust serving (all optional; defaults = plain batch) --
    priority: int = 0             # higher admits first / preempts last
    deadline_s: Optional[float] = None   # absolute, on the simulated clock
    arrival_s: float = 0.0        # when the request becomes admissible
    # -- multi-tenant fleet serving (serve.fleet) -------------------------
    tenant: Optional[str] = None  # owning edge; None = single-tenant
    shed: bool = False            # refused by deadline-aware admission
    preemptions: int = 0          # times this request was suspended
    admit_s: Optional[float] = None      # first admission time
    finish_s: Optional[float] = None     # retirement time
    # scheduler internals
    _seq: int = dataclasses.field(default=0, repr=False)
    _enq_s: float = dataclasses.field(default=0.0, repr=False)
    _parked: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)  # committed tokens across a preemption


def _remove_is(lst: List, item) -> None:
    """Remove by identity (dataclass ``==`` compares field values, and
    two requests may carry identical fields)."""
    for i, x in enumerate(lst):
        if x is item:
            del lst[i]
            return


class _SamplingMirrors:
    """Per-slot sampling state of an engine (``serve.sampling``): host
    mirrors of each slot's (temperature, top_p, seed), refreshed at
    admission, and their device copies, cached until the slot mix
    changes.  The engine provides ``max_batch``, ``device`` and the
    scheduler's live view ``_sched_active``."""

    def _init_sampling(self) -> None:
        self._samp_t = np.zeros((self.max_batch,), np.float32)
        self._samp_p = np.ones((self.max_batch,), np.float32)
        self._samp_s = np.zeros((self.max_batch,), np.int64)
        self._samp_dev: Optional[Tuple[torch.Tensor, ...]] = None

    def _note_samplings(self, slots, samplings) -> None:
        """Refresh the mirrors of ``slots`` at admission (a greedy or
        ``None`` request zeroes its slot, so slot reuse never leaks a
        previous request's temperature)."""
        for i, s in enumerate(slots):
            sp = None if samplings is None else samplings[i]
            sp = sp if (sp is not None and sp.sampled) else None
            self._samp_t[s] = sp.temperature if sp else 0.0
            self._samp_p[s] = sp.top_p if sp else 1.0
            self._samp_s[s] = sp.seed if sp else 0
        self._samp_dev = None

    def _samp_vecs(self) -> Tuple[torch.Tensor, ...]:
        if self._samp_dev is None:
            self._samp_dev = tuple(torch.as_tensor(v, device=self.device)
                                   for v in (self._samp_t, self._samp_p,
                                             self._samp_s))
        return self._samp_dev

    def _offsets(self) -> torch.Tensor:
        """[max_batch] absolute output index each live slot's next round
        starts at: its committed count, exact on the host (the scheduler
        counts commits as rounds report them), so every sampled draw's
        key is pinned to (seed, index, stream), whoever shares the
        batch."""
        off = np.zeros((self.max_batch,), np.int64)
        for s, (_r, c) in self._sched_active.items():
            off[s] = c
        return torch.as_tensor(off, device=self.device)


class _SlotEngine:
    """Continuous-batching scheduler base class.

    Subclasses implement ``_admit`` (prefill a prompt group into specific
    slots, with each request's ``SamplingParams`` or ``None``) and
    ``_decode_all`` (advance every slot one token), and may hook
    ``_round`` (a speculative round instead of one serial step),
    ``_retire`` (a slot's request finished — return its KV pages),
    ``_can_admit`` (admission backpressure from the page pool),
    ``_policy_tick`` (online re-tuning) and the overload hooks
    (``_tick_resources``, ``_now``, ``_wait``, ``_on_stall``,
    ``_ensure_slot``, ``_preempt``, ``_admission_policy``; their
    implementations are ``serve.overload._OverloadMixin``).  With
    ``timed``, each prefill and round waits for the device and adds its
    wall time to ``stats.prefill_s`` / ``stats.decode_s``."""

    def __init__(self, cfg: TF.LMConfig, *, max_batch: int, max_len: int,
                 device: torch.device, timed: bool = False):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = device
        self.timed = timed
        self.stats = ServeStats()
        self._rope_tab = None
        # live view for hooks that rebuild per-slot state mid-run (the
        # draft-cache rebuild on a warm k raise): slot -> (request,
        # n_committed), and a function returning a live request's
        # committed tokens
        self._sched_active = None
        self._sched_committed = None

    # -- subclass interface -------------------------------------------------
    def _admit(self, toks: torch.Tensor, plens: np.ndarray,
               max_news: np.ndarray, slots: np.ndarray, cur: torch.Tensor,
               pos: torch.Tensor, samplings=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _decode_all(self, cur: torch.Tensor, pos: torch.Tensor,
                    n_active: int) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _round(self, cur: torch.Tensor, pos: torch.Tensor,
               slots: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor,
                                           Optional[np.ndarray]]:
        """Advance the occupied ``slots`` by one round.

        Returns ``(cur, pos, tokens, counts)``: ``tokens`` is the
        ``[max_batch, k]`` device block of tokens the round produced and
        ``counts`` the per-slot number of *committed* leading tokens —
        ``None`` means "one per slot" (the serial step, which therefore
        never waits for the device)."""
        cur, pos = self._decode_all(cur, pos, len(slots))
        return cur, pos, cur[:, None], None

    def _round_headroom(self) -> int:
        """Cache positions a round may write *past* a request's budget
        (speculative drafting overshoots by up to k-1); admission
        reserves them so overshoot writes never alias another request's
        pages."""
        return 0

    def _round_width(self) -> int:
        """Cache positions one round writes per slot (the draft length);
        demand paging grows each slot's claim to cover them before the
        round runs."""
        return 1

    def _after_round(self, n_active: int, committed: int) -> None:
        """Hook: one round just finished, having committed ``committed``
        tokens across ``n_active`` slots."""

    def _retire(self, slot: int) -> None:
        """Hook: the request in ``slot`` finished (free paged KV, etc.)."""

    def _can_admit(self, group_shapes: List[Tuple[int, int]], plen: int,
                   max_new: int, bucket: int) -> bool:
        """Hook: may this request join the prefill group right now?
        ``group_shapes`` are the (plen, max_new) pairs already accepted
        into the group this turn; a paged engine refuses when its pool
        cannot cover the whole group, backpressuring admission until
        retirements return pages."""
        return True

    def _policy_tick(self, n_active: int) -> bool:
        """Hook: one turn of the online re-tuning loop, at the top of
        every scheduler turn (so between rounds, and with ``n_active ==
        0`` between requests).  Returns True to **pause admission** this
        turn — the re-partition barrier: a pending cut switch waits for
        the occupied slots to drain.  Must return False when ``n_active
        == 0`` (apply the switch instead), or the loop would livelock;
        the loop checks it."""
        return False

    def _tick_resources(self) -> None:
        """Hook: top of every scheduler turn, before admission — a
        pressure-injecting engine applies its ``faults.PressureSchedule``
        to the page allocator here, at the current simulated time."""

    def _now(self) -> float:
        """Hook: current simulated time.  Clockless engines serve one
        batch at t = 0; clocked engines mirror their channel's
        ``clock_s``."""
        return 0.0

    def _wait(self, seconds: float) -> bool:
        """Hook: advance the simulated clock by ``seconds`` (a stall or
        an inter-arrival gap), charging ``stats.stall_wait_s``.  Returns
        False when the engine has no clock to advance — the scheduler
        then treats every queued request as already arrived."""
        return seconds <= 0

    def _on_stall(self) -> bool:
        """Hook: the engine is drained but admission still cannot fit the
        next request.  True after waiting out a *transient* cause (a
        ``PressureSchedule`` window) — the scheduler retries; False means
        the stall is permanent and the scheduler raises."""
        return False

    def _ensure_slot(self, slot: int, horizon: int) -> None:
        """Hook: grow ``slot``'s page claim to cover ``horizon`` cache
        positions before the coming round writes them; raises
        ``kvcache.PoolExhausted`` when the pool cannot (the scheduler
        preempts a victim and retries).  Default: worst-case reservation
        at admission — nothing to grow."""

    def _preempt(self, slot: int) -> None:
        """Hook: ``slot`` is being suspended mid-flight — release its KV
        pages but keep the request resumable (the scheduler has parked
        its committed tokens and re-queued it)."""
        self._retire(slot)

    def _admission_policy(self, req: Request, *, now: float,
                          queue_tokens: float) -> bool:
        """Hook: may ``req`` be admitted at all?  False sheds it.
        ``queue_tokens`` is the generation budget still owed to work
        that runs ahead of it."""
        return True

    # -- shared helpers -----------------------------------------------------
    def _rope(self):
        """RoPE tables over ``max_len`` positions, built once."""
        if self._rope_tab is None:
            self._rope_tab = ML.rope_table(
                self.max_len, self.cfg.hd, base=self.cfg.rope_base,
                dtype=self.cfg.dtype, device=self.device)
        return self._rope_tab

    def _timed(self, phase: str, fn):
        """``fn()``; with ``timed``, waited for and its wall time added
        to ``stats.<phase>``."""
        if not self.timed:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        setattr(self.stats, phase,
                getattr(self.stats, phase) + time.perf_counter() - t0)
        return out

    @staticmethod
    def _eff_prompt(r: Request) -> np.ndarray:
        """The token row a (re-)admission prefills: the prompt — for a
        preempted request extended by all but the last committed token.
        The batched prefill rebuilds the suspended slot's KV in one call
        and its argmax re-derives the last committed token, so resume
        recomputes no committed position one by one."""
        if r._parked is None or len(r._parked) == 0:
            return np.asarray(r.prompt, np.int32)
        return np.concatenate([np.asarray(r.prompt, np.int32),
                               r._parked[:-1]])

    def _eff_plen(self, r: Request) -> int:
        return len(r.prompt) + (0 if r._parked is None
                                else max(0, len(r._parked) - 1))

    # -- scheduler ----------------------------------------------------------
    def generate(self, prompts: List[np.ndarray], *, max_new_tokens: int = 16,
                 sampling=None) -> List[List[int]]:
        """Decode a list of prompts with continuous batching.
        ``sampling`` is one ``SamplingParams`` for all prompts, or a
        per-prompt list; ``None`` (default) is greedy."""
        samps = (list(sampling) if isinstance(sampling, (list, tuple))
                 else [sampling] * len(prompts))
        if len(samps) != len(prompts):
            raise ValueError(f"{len(samps)} sampling entries for "
                             f"{len(prompts)} prompts")
        reqs = [Request(uid=i, prompt=np.asarray(p),
                        max_new_tokens=max_new_tokens, sampling=s)
                for i, (p, s) in enumerate(zip(prompts, samps))]
        return self.generate_requests(reqs)

    def generate_requests(self, reqs: List[Request]) -> List[List[int]]:
        """Run caller-built ``Request``s — priorities, deadlines, arrival
        times — through the scheduler; returns their token streams in
        input order.  A shed request comes back empty with ``r.shed``
        set; completion metadata lands on ``admit_s`` / ``finish_s`` /
        ``preemptions``."""
        if reqs:
            self._run(reqs)
        return [r.out_tokens for r in reqs]

    def _run(self, reqs: List[Request]) -> None:
        for i, r in enumerate(reqs):
            r._seq = i
            r._enq_s = float(r.arrival_s)
        queue: List[Request] = list(reqs)
        active: Dict[int, Tuple[Request, int]] = {}  # slot -> (req, n_done)
        free = list(range(self.max_batch))
        cur = torch.zeros((self.max_batch,), dtype=torch.int32,
                          device=self.device)
        pos = torch.zeros_like(cur)
        # every admission and every round logs (token block [B, k], takes);
        # token blocks stay on device until one concat + copy at the end
        rounds: List[Tuple[torch.Tensor, List[Tuple[Request, int, int]]]] = []

        def committed_tokens(r: Request) -> np.ndarray:
            """``r``'s committed tokens, read off the logged round blocks
            — the one host sync a preemption or a draft rebuild costs."""
            chunks = [t[s, :n].cpu().numpy()
                      for t, takes in rounds
                      for rr, s, n in takes if rr is r and n > 0]
            return (np.concatenate(chunks).astype(np.int32) if chunks
                    else np.zeros((0,), np.int32))

        self._sched_active = active
        self._sched_committed = committed_tokens

        def preempt(slot: int) -> None:
            r, _c = active.pop(slot)
            r._parked = committed_tokens(r)
            r._enq_s = self._now()
            r.preemptions += 1
            self.stats.preemptions += 1
            self._preempt(slot)
            free.append(slot)
            queue.append(r)

        try:
            while queue or active:
                self._tick_resources()
                hold = self._policy_tick(len(active))
                if hold and not active:
                    raise RuntimeError("_policy_tick must not pause "
                                       "admission on a drained engine")
                now = self._now()
                elig = sorted((r for r in queue
                               if r.arrival_s <= now + 1e-12),
                              key=lambda r: (-r.priority, r._seq))
                if not elig and queue and not active and not hold:
                    # nothing has arrived yet: advance the clock to the
                    # next arrival, or — on a clockless engine — treat
                    # everything queued as already here
                    nxt = min(r.arrival_s for r in queue)
                    if self._wait(nxt - now):
                        continue
                    elig = sorted(queue, key=lambda r: (-r.priority, r._seq))
                cur, pos, stall_req = self._admit_eligible(
                    elig, queue, active, free, cur, pos, rounds, now, hold)
                if stall_req is not None and not active:
                    # a drained engine that still cannot admit: either a
                    # transient squeeze (wait it out on the simulated
                    # clock and retry) or an impossible request
                    if not self._on_stall():
                        r = stall_req
                        raise RuntimeError(
                            f"KV page pool too small for request "
                            f"uid={r.uid} (prompt {len(r.prompt)} + "
                            f"{r.max_new_tokens} new tokens) even with "
                            f"every slot idle")
                    continue
                # retire requests whose budget just filled, before the
                # next round, so their slots and pages free one round
                # earlier
                for s in [s for s, (r, c) in active.items()
                          if c >= r.max_new_tokens]:
                    r, _ = active.pop(s)
                    r.done = True
                    r.finish_s = self._now()
                    if (r.deadline_s is not None
                            and r.finish_s > r.deadline_s + 1e-9):
                        self.stats.deadline_misses += 1
                    self._retire(s)
                    free.append(s)
                # demand paging: grow every live slot's claim to cover
                # the positions the coming round writes; on PoolExhausted
                # preempt victims — lowest priority first, then most
                # remaining budget — until the growth fits (possibly the
                # grower itself, which also resolves it)
                if active:
                    k = self._round_width()
                    for s in sorted(active,
                                    key=lambda t: (-active[t][0].priority,
                                                   t)):
                        if s not in active:
                            continue  # already someone else's victim
                        r, c = active[s]
                        horizon = min(len(r.prompt) + c - 1 + k,
                                      self.max_len)
                        while s in active:
                            try:
                                self._ensure_slot(s, horizon)
                                break
                            except PoolExhausted:
                                preempt(min(active, key=lambda t: (
                                    active[t][0].priority,
                                    -(active[t][0].max_new_tokens
                                      - active[t][1]), t)))
                if active:
                    act = np.asarray(sorted(active), np.int32)
                    cur, pos, toks_r, counts = self._timed(
                        "decode_s", lambda: self._round(cur, pos, act))
                    takes = []
                    for s in act.tolist():
                        r, c = active[s]
                        n = 1 if counts is None else int(counts[s])
                        n = min(n, r.max_new_tokens - c)  # trim overshoot
                        active[s] = (r, c + n)
                        takes.append((r, s, n))
                    rounds.append((toks_r, takes))
                    self.stats.decode_steps += 1
                    committed = sum(n for _, _, n in takes)
                    self.stats.decode_tokens += committed
                    self._after_round(len(takes), committed)
        finally:
            self._sched_active = None
            self._sched_committed = None
        if not rounds:
            return  # everything shed before a single token committed
        # single device → host copy for the whole run
        all_toks = torch.cat([t for t, _ in rounds], dim=1).cpu().numpy()
        col = 0
        for toks_r, takes in rounds:
            for r, s, n in takes:
                r.out_tokens.extend(int(t) for t in all_toks[s, col:col + n])
            col += toks_r.shape[1]

    def _admit_eligible(self, elig, queue, active, free, cur, pos, rounds,
                        now, hold):
        """Admit eligible requests into free slots, grouping by prefill
        bucket so one batched prefill covers each group; shed the ones
        deadline admission refuses.  A paged engine may refuse a request
        (pool backpressure) and a pending re-partition holds admission
        entirely.  Returns ``(cur, pos, the request that stalled or
        None)``."""
        while free and elig and not hold:
            bucket = _bucket_len(self._eff_plen(elig[0]), self.max_len)
            group: List[Request] = []
            rows: List[np.ndarray] = []
            slots: List[int] = []
            shapes: List[Tuple[int, int]] = []
            stall_req = None
            while free and elig and _bucket_len(
                    self._eff_plen(elig[0]), self.max_len) == bucket:
                r = elig[0]
                row = self._eff_prompt(r)
                eff_new = (r.max_new_tokens if r._parked is None
                           else r.max_new_tokens - len(r._parked) + 1)
                if len(row) + eff_new + self._round_headroom() \
                        > self.max_len:
                    raise ValueError(
                        f"request uid={r.uid}: prompt + generation "
                        f"(+ draft headroom) exceeds cache "
                        f"max_len={self.max_len}")
                if r._parked is None and r.deadline_s is not None:
                    # budget owed to work that will run ahead of this
                    # request: equal-or-higher priority only — lower
                    # priority slots are preemptable
                    owed = (sum(rr.max_new_tokens - cc
                                for rr, cc in active.values()
                                if rr.priority >= r.priority)
                            + sum(m for _, m in shapes))
                    if not self._admission_policy(
                            r, now=now, queue_tokens=float(owed)):
                        # predicted to finish past its deadline even if
                        # admitted this instant: shed it
                        r.shed = True
                        r.done = True
                        self.stats.shed += 1
                        elig.pop(0)
                        _remove_is(queue, r)
                        continue
                if not self._can_admit(shapes, len(row), eff_new, bucket):
                    stall_req = r
                    break
                shapes.append((len(row), eff_new))
                group.append(r)
                rows.append(row)
                elig.pop(0)
                _remove_is(queue, r)
                slots.append(free.pop(0))
            if group:
                cur, pos = self._prefill_group(group, rows, slots, shapes,
                                               bucket, active, cur, pos,
                                               rounds, now)
            if stall_req is not None or not group:
                return cur, pos, stall_req
        return cur, pos, None

    def _prefill_group(self, group, rows, slots, shapes, bucket, active,
                       cur, pos, rounds, now):
        """One batched prefill of an admitted group; a resumed request
        replays its committed tokens and keeps the last one pinned."""
        toks = np.zeros((len(group), bucket), np.int32)
        for i, row in enumerate(rows):
            toks[i, :len(row)] = row
        plens = np.asarray([len(row) for row in rows], np.int32)
        max_news = np.asarray([m for _, m in shapes], np.int32)
        slots_a = np.asarray(slots, np.int32)
        toks_d = torch.tensor(toks, device=self.device)
        cur, pos = self._timed(
            "prefill_s",
            lambda: self._admit(toks_d, plens, max_news, slots_a, cur, pos,
                                samplings=[r.sampling for r in group]))
        self.stats.prefill_calls += 1
        self.stats.prefill_tokens += int(plens.sum())
        resumes = [(s, r) for r, s in zip(group, slots)
                   if r._parked is not None]
        if resumes:
            # the replay prefill re-derives the last committed token;
            # pin the stream to the parked value so resume never
            # diverges (INT8 recalibration over the longer prefix may
            # flip the argmax — lossless mode is bitwise identical
            # either way, which the preemption tests pin)
            rs = torch.tensor([s for s, _ in resumes], dtype=torch.long,
                              device=self.device)
            lasts = torch.tensor([int(r._parked[-1]) for _, r in resumes],
                                 dtype=cur.dtype, device=self.device)
            cur = cur.index_put((rs,), lasts)
        # a fresh request's first committed token is the prefill argmax;
        # a resumed request's tokens are already logged in its earlier
        # rounds
        fresh = [(r, s, 1) for r, s in zip(group, slots)
                 if r._parked is None]
        if fresh:
            rounds.append((cur[:, None], fresh))
        for r, s in zip(group, slots):
            active[s] = (r, 1 if r._parked is None else len(r._parked))
            if r.admit_s is None:
                r.admit_s = now
            self.stats.queue_wait_s += max(0.0, now - r._enq_s)
            r._parked = None
        return cur, pos
