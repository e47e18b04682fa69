"""Overload-robustness layer: the scheduler hooks that make an engine
safe to oversubscribe.

Counterpart of ``repro.serve.overload``, whole.

``_OverloadMixin`` implements the ``_SlotEngine`` hooks behind demand
paging, preemptive page reclamation, and deadline-aware admission for
any engine that owns a ``_PagedPool`` (``self._pool``) and a channel
with a simulated clock:

* **demand paging** — ``_admit_reserve`` shrinks the admission-time
  page claim from worst-case ``prompt + max_new`` to the padded prompt
  plus one round of speculative headroom, and ``_ensure_slot`` grows a
  live slot's claim just before each round writes new positions.  A
  growth that raises ``kvcache.PoolExhausted`` makes the scheduler
  preempt a victim (scheduler policy: lowest priority, then
  most-remaining-budget) instead of crashing;
* **simulated time** — ``_now``/``_wait`` mirror the channel's
  ``clock_s``, charging explicit waits to ``ServeStats.stall_wait_s``
  so the clock decomposes exactly into transfers + charged waits;
* **resource faults** — ``_tick_resources`` applies a
  ``faults.PressureSchedule`` (scripted page-pool squeezes) at the top
  of every scheduler turn, and ``_on_stall`` waits a drained-but-stuck
  engine out to the schedule's next window edge;
* **deadline admission** — ``_admission_policy`` asks
  ``policy.DeadlineAdmission`` to predict the request's finish time
  from live telemetry and sheds it when the prediction already misses
  its deadline.

The mixin is pure hook overrides + one ``_init_overload`` call from
the engine constructor; the preemption/resume machinery itself lives
in ``serve.scheduler`` (parking committed tokens, replay-based
re-admission) and the page accounting in ``serve.kvcache``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.models import transformer as TF
from repro_torch.serve.faults import PressureSchedule
from repro_torch.serve.policy import DeadlineAdmission

__all__ = ["_OverloadMixin"]


class _OverloadMixin:
    """Scheduler-hook implementations for overload-robust serving (see
    the module docstring); mixed into ``CollaborativeServingEngine``
    ahead of ``_SlotEngine`` so these override the scheduler's no-op
    defaults."""

    def _init_overload(self, cfg: TF.LMConfig, *, demand_paged: bool,
                       pressure: Optional[PressureSchedule],
                       admission: Union[DeadlineAdmission, str, None],
                       max_batch: int, initial_ch,
                       spec_acceptance: float,
                       a_bits: Optional[int]) -> None:
        # demand paging: admission reserves only the padded prompt plus
        # one round of speculative headroom; claims grow page-by-page as
        # the sequence crosses boundaries (_ensure_slot) and a mid-round
        # PoolExhausted preempts a victim instead of crashing
        self.demand_paged = bool(demand_paged)
        self.pressure = pressure
        if admission == "deadline":
            admission = DeadlineAdmission(
                cfg, batch=max_batch, fallback_channel=initial_ch,
                acceptance_prior=spec_acceptance,
                blob_itemsize=(1 if a_bits is not None else 4))
        self.admission: Optional[DeadlineAdmission] = admission or None

    # -- demand paging -------------------------------------------------------
    def _admit_reserve(self, max_news: np.ndarray) -> np.ndarray:
        """Positions past the prompt that admission reserves pages for.
        Worst-case engines reserve the full budget plus speculative
        overshoot (a round's rejected tail can never spill into another
        request's pages); a demand-paged engine reserves only one round
        of speculative headroom — exactly what the first round after
        admission may write — and grows the claim via ``_ensure_slot``,
        which is what makes oversubscribing the pool safe."""
        head = self._round_headroom()
        if self.demand_paged:
            return np.minimum(max_news + head, self._spec_max)
        return max_news + head

    def _round_width(self):
        return self.spec_k

    def _ensure_slot(self, slot, horizon):
        if self._pool is not None and self.demand_paged:
            self._pool.ensure(slot, horizon)

    # -- simulated time + resource faults ------------------------------------
    def _tick_resources(self):
        if self.pressure is not None and self._pool is not None:
            self.pressure.apply(self._pool.allocator, self._now())
        if self._pool is not None:
            # pool-pressure snapshot: benchmarks and the fairness policy
            # read free pages / utilization off stats, not pool privates
            self.stats.observe_pool(self._pool)

    def _now(self):
        return float(getattr(self.transport.channel, "clock_s", 0.0))

    def _wait(self, seconds):
        s = float(seconds)
        if s <= 0:
            return True
        w = getattr(self.transport.channel, "wait", None)
        if w is None:
            return False         # clockless channel: nothing to advance
        w(s)
        self.stats.stall_wait_s += s
        return True

    def _on_stall(self):
        # a drained engine that can't admit is only worth retrying if a
        # pressure window is due to release pages; wait to its next edge
        if self.pressure is None:
            return False
        now = self._now()
        nxt = self.pressure.next_change(now)
        if nxt is None:
            return False
        return self._wait(nxt - now + 1e-9)

    # -- deadline-aware admission --------------------------------------------
    def _admission_policy(self, req, *, now, queue_tokens):
        if self.admission is None or req.deadline_s is None:
            return True
        t = self.admission.predict_finish(
            self.transport.telemetry, now=now, cut=self.cut, spec_k=self.spec_k,
            plen=len(req.prompt), max_new=req.max_new_tokens,
            slots=self.max_batch, queue_tokens=queue_tokens)
        return t <= req.deadline_s
