"""Slot-based continuous-batching scheduler shared by both engines.

Counterpart of ``repro.serve.scheduler`` for the slice this port runs:
requests queue up in order, prompts are right-padded to power-of-two
*buckets* and same-bucket prompts are prefilled together into free
cache slots, every **round** advances all occupied slots at their own
positions, and a finished request frees its slot — and its KV pages —
for the next queued prompt mid-flight.  A round commits one token per
slot (the serial step) or, in a speculative engine, a per-slot number
of them that the engine reports back (``_round``).  The current token
and position of every slot stay on the device; the host reads the
tokens once, after the last round.

The JAX reference jits each phase and donates the cache buffers; here
each phase is a plain call and the cache tensors are updated in place,
which is what donation achieves there.  CUDA graphs of the phases come
in a later PR.  A request may carry ``SamplingParams`` (``serve.
sampling``); the engine reads them at admission.  Priorities, deadlines,
arrival times, preemption and the online policy hooks come with the
overload and adaptive slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.stats import ServeStats

__all__ = ["Request", "_bucket_len", "_SlotEngine"]


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


class _SlotEngine:
    """Continuous-batching scheduler base class.

    Subclasses implement ``_admit`` (prefill a prompt group into specific
    slots, with each request's ``SamplingParams`` or ``None``) and
    ``_decode_all`` (advance every slot one token), and may hook
    ``_round`` (a speculative round instead of one serial step),
    ``_retire`` (a slot's request finished — return its KV pages) and
    ``_can_admit`` (admission backpressure from the page pool)."""

    def __init__(self, cfg: TF.LMConfig, *, max_batch: int, max_len: int,
                 device: torch.device):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = device
        self.stats = ServeStats()
        self._rope_tab = None
        # live view for hooks that rebuild per-slot state mid-run (the
        # draft-cache rebuild): slot -> (request, n_committed), and a
        # function returning a live request's committed tokens
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
        demand paging (ROADMAP A12) grows each slot's claim by it before
        the round runs."""
        return 1

    def _after_round(self, n_active: int, committed: int) -> None:
        """Hook: one round just finished, having committed ``committed``
        tokens across ``n_active`` slots."""

    def _retire(self, slot: int) -> None:
        """Hook: the request in ``slot`` finished (free paged KV, etc.)."""

    def _can_admit(self, group_shapes: List[Tuple[int, int]], plen: int,
                   max_new: int, bucket: int) -> bool:
        """Hook: may this request join the prefill group right now?"""
        return True

    # -- shared helpers -----------------------------------------------------
    def _rope(self):
        """RoPE tables over ``max_len`` positions, built once."""
        if self._rope_tab is None:
            self._rope_tab = ML.rope_table(
                self.max_len, self.cfg.hd, base=self.cfg.rope_base,
                dtype=self.cfg.dtype, device=self.device)
        return self._rope_tab

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
        if reqs:
            self._run(reqs)
        return [r.out_tokens for r in reqs]

    def _run(self, reqs: List[Request]) -> None:
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
            (one host copy per block that holds some)."""
            chunks = [t[s, :n].cpu().numpy()
                      for t, takes in rounds
                      for rr, s, n in takes if rr is r and n > 0]
            return (np.concatenate(chunks).astype(np.int32) if chunks
                    else np.zeros((0,), np.int32))

        self._sched_active = active
        self._sched_committed = committed_tokens

        while queue or active:
            stalled = False
            stall_req: Optional[Request] = None
            # admit queued prompts into free slots, grouping by prefill
            # bucket so one batched prefill call covers the whole group
            while free and queue and not stalled:
                bucket = _bucket_len(len(queue[0].prompt), self.max_len)
                group: List[Request] = []
                shapes: List[Tuple[int, int]] = []
                slots: List[int] = []
                while free and queue and _bucket_len(
                        len(queue[0].prompt), self.max_len) == bucket:
                    r = queue[0]
                    if (len(r.prompt) + r.max_new_tokens
                            + self._round_headroom()) > self.max_len:
                        raise ValueError(
                            f"request uid={r.uid}: prompt + generation "
                            f"(+ draft headroom) exceeds cache "
                            f"max_len={self.max_len}")
                    if not self._can_admit(shapes, len(r.prompt),
                                           r.max_new_tokens, bucket):
                        stalled, stall_req = True, r
                        break
                    shapes.append((len(r.prompt), r.max_new_tokens))
                    group.append(queue.pop(0))
                    slots.append(free.pop(0))
                if not group:
                    break
                toks = np.zeros((len(group), bucket), np.int32)
                for i, r in enumerate(group):
                    toks[i, :len(r.prompt)] = r.prompt
                plens = np.asarray([p for p, _ in shapes], np.int32)
                max_news = np.asarray([m for _, m in shapes], np.int32)
                slots_a = np.asarray(slots, np.int32)
                toks_d = torch.tensor(toks, device=self.device)
                cur, pos = self._admit(toks_d, plens, max_news, slots_a,
                                       cur, pos, samplings=[
                                           r.sampling for r in group])
                self.stats.prefill_calls += 1
                self.stats.prefill_tokens += int(plens.sum())
                # a request's first token comes from the prefill
                rounds.append((cur[:, None], [(r, s, 1)
                                              for r, s in zip(group, slots)]))
                for r, s in zip(group, slots):
                    active[s] = (r, 1)
            if stalled and not active:
                r = stall_req
                raise RuntimeError(
                    f"KV page pool too small for request uid={r.uid} "
                    f"(prompt {len(r.prompt)} + {r.max_new_tokens} new "
                    f"tokens) even with every slot idle")
            # retire requests whose budget just filled, before the next
            # round, so their slots and pages free one round earlier
            for s in [s for s, (r, c) in active.items()
                      if c >= r.max_new_tokens]:
                r, _ = active.pop(s)
                r.done = True
                self._retire(s)
                free.append(s)
            if active:
                act = np.asarray(sorted(active), np.int32)
                cur, pos, toks_r, counts = self._round(cur, pos, act)
                takes = []
                for s in act.tolist():
                    r, c = active[s]
                    n = 1 if counts is None else int(counts[s])
                    n = min(n, r.max_new_tokens - c)  # trim budget overshoot
                    active[s] = (r, c + n)
                    takes.append((r, s, n))
                rounds.append((toks_r, takes))
                self.stats.decode_steps += 1
                committed = sum(n for _, _, n in takes)
                self.stats.decode_tokens += committed
                self._after_round(len(takes), committed)
        self._sched_active = None
        self._sched_committed = None
        # single device → host copy for the whole run
        all_toks = torch.cat([t for t, _ in rounds], dim=1).cpu().numpy()
        col = 0
        for toks_r, takes in rounds:
            for r, s, n in takes:
                r.out_tokens.extend(int(t) for t in all_toks[s, col:col + n])
            col += toks_r.shape[1]
