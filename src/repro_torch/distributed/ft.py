"""Fault-tolerance runtime: heartbeats, straggler detection, elastic
re-meshing, and a supervised train loop with checkpoint/restart.

Counterpart of ``repro.distributed.ft`` (the same detection thresholds,
re-mesh planning and restart protocol; host-count-agnostic logic).  The
restart path is ``restore_checkpoint``: leaves are stored whole, one a
file, so a checkpoint restores onto any device (``device=``) — where the
reference restores onto another mesh's shardings.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                latest_step,
                                                restore_checkpoint)

__all__ = ["HeartbeatMonitor", "plan_elastic_mesh", "TrainSupervisor",
           "WorkerFailure"]


class WorkerFailure(RuntimeError):
    """Raised by the training step when a (simulated) worker dies."""


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-rank heartbeats; flags dead ranks and stragglers.

    * dead: no heartbeat within ``timeout_s``
    * straggler: step-time > ``straggler_factor`` × median of the fleet
      (the standard mitigation at scale: flag, drain, re-mesh around it)
    """
    n_ranks: int
    timeout_s: float = 10.0
    straggler_factor: float = 2.0

    def __post_init__(self):
        now = time.monotonic()
        self._last: List[float] = [now] * self.n_ranks
        self._step_times: Dict[int, List[float]] = {
            r: [] for r in range(self.n_ranks)}

    def beat(self, rank: int, *, step_time_s: Optional[float] = None,
             now: Optional[float] = None) -> None:
        self._last[rank] = time.monotonic() if now is None else now
        if step_time_s is not None:
            ts = self._step_times[rank]
            ts.append(step_time_s)
            if len(ts) > 32:
                ts.pop(0)

    def dead_ranks(self, *, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [r for r, t in enumerate(self._last)
                if now - t > self.timeout_s]

    def stragglers(self) -> List[int]:
        means = {r: np.mean(ts) for r, ts in self._step_times.items() if ts}
        if len(means) < 2:
            return []
        med = float(np.median(list(means.values())))
        return [r for r, m in means.items()
                if m > self.straggler_factor * med]

    def healthy_ranks(self) -> List[int]:
        bad = set(self.dead_ranks()) | set(self.stragglers())
        return [r for r in range(self.n_ranks) if r not in bad]


def plan_elastic_mesh(n_healthy_chips: int, *, model_parallel: int = 16,
                      min_data: int = 1) -> Tuple[int, int]:
    """Largest (data, model) mesh that fits the surviving chips.

    Keeps the model axis intact (TP degree is baked into layouts) and
    shrinks the data axis — the standard elastic-DP policy.  Returns
    (data, model)."""
    model = model_parallel
    while model > 1 and n_healthy_chips < model:
        model //= 2
    data = max(n_healthy_chips // model, min_data)
    return data, model


@dataclasses.dataclass
class TrainSupervisor:
    """Run a step function under checkpoint/restart supervision.

    ``step_fn(state, step) -> (state, metrics)`` may raise
    ``WorkerFailure`` (node loss).  The supervisor restores the latest
    checkpoint and resumes — deterministically, because the data pipeline
    is keyed by step.  ``on_restart`` lets the caller rebuild meshes /
    re-jit against a shrunk device set before resuming.
    """
    checkpoint_dir: str
    ckpt_every: int = 10
    max_restarts: int = 8

    def run(self, state: Any, step_fn: Callable[[Any, int], Tuple[Any, Dict]],
            n_steps: int, *, start_step: int = 0,
            on_restart: Optional[Callable[[Any, int], Any]] = None,
            ) -> Tuple[Any, List[Dict]]:
        mgr = CheckpointManager(self.checkpoint_dir, every=self.ckpt_every,
                                async_save=False)
        history: List[Dict] = []
        step = start_step
        restarts = 0
        # step-0 checkpoint so the first failure can restart
        mgr.maybe_save(step, state)
        while step < n_steps:
            try:
                state, metrics = step_fn(state, step)
                step += 1
                history.append({"step": step, **metrics})
                mgr.maybe_save(step, state)
            except WorkerFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                restored = latest_step(self.checkpoint_dir)
                state, step, _ = restore_checkpoint(
                    self.checkpoint_dir, state, step=restored)
                if on_restart is not None:
                    state = on_restart(state, step)
        mgr.wait()
        return state, history
