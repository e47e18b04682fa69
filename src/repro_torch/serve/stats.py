"""``ServeStats`` — the per-phase serving counters every engine
populates (split out of ``serve.transport``, which re-exports it; the
accounting *semantics* — what counts as uplink/downlink/decode bytes —
are documented there, next to the code that does the charging)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass
class ServeStats:
    """Per-phase serving counters (see ``serve.transport`` for the
    accounting semantics).

    ``drafted_tokens`` / ``draft_hits`` grade the speculative drafts the
    verify step compared (k-1 per round per live slot), giving
    ``acceptance_rate`` — under rejection-sampling verify a "hit" is an
    *accepted* draft, so the same counters price stochastic acceptance.
    ``bytes_per_decode_token`` is uplink bytes per accepted token;
    ``wire_bytes_per_accepted_token`` adds the decode downlink.
    ``spec_k_switches``/``cut_switches`` count online retune events
    applied by a ``serve.policy`` controller.

    ``prefill_s``/``decode_s`` are wall-clock phase totals, populated
    when the engine runs with ``timed=True`` (timing blocks on device
    results, so it is off by default to keep the decode loop fully
    async).

    The fault counters are populated by ``ReliableTransport`` and the
    resilient engine (``serve.resilience``): ``retries`` counts
    retransmission attempts after a deadline miss or checksum failure,
    ``timeouts`` counts the deadline misses themselves, ``corrupt_msgs``
    counts messages whose checksum failed on arrival, ``outage_s`` is
    simulated time spent with the cloud declared down, and
    ``edge_only_tokens``/``resyncs`` count tokens committed with zero
    wire bytes during degradation and the cloud KV rebuilds on
    reconnect.  Retransmissions' bytes and waiting are charged to
    ``transmitted_bytes``/``channel_latency_s`` like any other traffic —
    a lossy link is priced, not hidden."""
    prefill_calls: int = 0
    decode_steps: int = 0
    transmitted_bytes: int = 0
    channel_latency_s: float = 0.0
    # per-phase splits
    prefill_bytes: int = 0
    decode_bytes: int = 0
    decode_bytes_log: List[int] = dataclasses.field(default_factory=list)
    downlink_bytes: int = 0
    decode_downlink_bytes: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    # speculative draft/verify rounds
    spec_rounds: int = 0
    drafted_tokens: int = 0
    draft_hits: int = 0
    # online re-tuning events (serve.policy)
    spec_k_switches: int = 0
    cut_switches: int = 0
    # warm k-raise path: ``draft_rebuilds`` counts draft-cache rebuilds
    # from committed prefix state (raising out of k=1 with live slots no
    # longer drains); ``policy_holds`` counts scheduler turns admission
    # actually paused on a policy barrier (now only cut re-partitions)
    draft_rebuilds: int = 0
    policy_holds: int = 0
    # reliability layer (serve.faults / ReliableTransport / resilience)
    retries: int = 0
    timeouts: int = 0
    corrupt_msgs: int = 0
    outage_s: float = 0.0
    edge_only_tokens: int = 0
    resyncs: int = 0
    # overload robustness (serve.scheduler / serve.policy / faults):
    # ``preemptions`` counts live slots suspended to reclaim their pages,
    # ``shed`` counts requests refused at admission because their
    # predicted finish already missed their deadline, ``deadline_misses``
    # counts served requests that finished late anyway, ``queue_wait_s``
    # is total simulated time requests spent between (re-)enqueue and
    # admission, and ``stall_wait_s`` is simulated time the scheduler
    # itself idled — waiting out page-pool pressure or a gap until the
    # next request arrival.  The simulated clock decomposes exactly:
    # every advance is either a charged transfer (``channel_latency_s``)
    # or a charged scheduler wait (``stall_wait_s``) — property-tested
    # in ``tests/test_overload_serve.py``.
    preemptions: int = 0
    shed: int = 0
    deadline_misses: int = 0
    queue_wait_s: float = 0.0
    stall_wait_s: float = 0.0
    # pool-pressure snapshot (multi-tenant fleet serving): engines that
    # own a ``kvcache._PagedPool`` refresh these each scheduler turn via
    # ``observe_pool`` so benchmarks and the fairness policy read pool
    # pressure off a stats snapshot instead of poking pool privates
    pool_free_pages: int = -1          # -1 = engine has no paged pool
    pool_utilization: float = 0.0
    pool_utilization_peak: float = 0.0

    def observe_pool(self, pool) -> None:
        """Snapshot a ``_PagedPool``'s pressure (free pages, utilization,
        peak utilization) onto this stats object."""
        self.pool_free_pages = pool.free_pages()
        self.pool_utilization = pool.utilization()
        self.pool_utilization_peak = max(self.pool_utilization_peak,
                                         self.pool_utilization)

    @classmethod
    def aggregate(cls, parts: Sequence["ServeStats"]) -> "ServeStats":
        """Fleet-wide rollup of per-tenant stats: counters sum, the pool
        snapshot (shared pool — identical on every tenant) carries the
        worst case.  ``decode_bytes_log`` concatenates in input order."""
        total = cls()
        for p in parts:
            for f in dataclasses.fields(cls):
                if f.name == "decode_bytes_log":
                    total.decode_bytes_log.extend(p.decode_bytes_log)
                elif f.name == "pool_free_pages":
                    total.pool_free_pages = (
                        p.pool_free_pages if total.pool_free_pages < 0
                        else min(total.pool_free_pages,
                                 max(p.pool_free_pages, 0)))
                elif f.name.startswith("pool_utilization"):
                    setattr(total, f.name,
                            max(getattr(total, f.name), getattr(p, f.name)))
                else:
                    setattr(total, f.name,
                            getattr(total, f.name) + getattr(p, f.name))
        return total

    def bytes_per_decode_token(self) -> float:
        """Decode *uplink* bytes per accepted token (PR 1/PR 2 metric)."""
        return self.decode_bytes / max(self.decode_tokens, 1)

    def wire_bytes_per_accepted_token(self) -> float:
        """Both directions per accepted token: uplink deltas + drafts
        and the downlink accept-mask + corrected token."""
        return (self.decode_bytes + self.decode_downlink_bytes) \
            / max(self.decode_tokens, 1)

    def acceptance_rate(self) -> float:
        """Fraction of graded speculative drafts the verify accepted."""
        return self.draft_hits / max(self.drafted_tokens, 1)

    def report(self) -> Dict[str, float]:
        return {
            "prefill_calls": self.prefill_calls,
            "decode_steps": self.decode_steps,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "accepted_tokens": self.decode_tokens,
            "transmitted_bytes": self.transmitted_bytes,
            "prefill_bytes": self.prefill_bytes,
            "decode_bytes": self.decode_bytes,
            "downlink_bytes": self.downlink_bytes,
            "bytes_per_decode_token": self.bytes_per_decode_token(),
            "wire_bytes_per_accepted_token":
                self.wire_bytes_per_accepted_token(),
            "spec_rounds": self.spec_rounds,
            "drafted_tokens": self.drafted_tokens,
            "acceptance_rate": self.acceptance_rate(),
            "spec_k_switches": self.spec_k_switches,
            "cut_switches": self.cut_switches,
            "draft_rebuilds": self.draft_rebuilds,
            "policy_holds": self.policy_holds,
            "channel_latency_s": self.channel_latency_s,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "corrupt_msgs": self.corrupt_msgs,
            "outage_s": self.outage_s,
            "edge_only_tokens": self.edge_only_tokens,
            "resyncs": self.resyncs,
            "preemptions": self.preemptions,
            "shed": self.shed,
            "deadline_misses": self.deadline_misses,
            "queue_wait_s": self.queue_wait_s,
            "stall_wait_s": self.stall_wait_s,
            "pool_free_pages": self.pool_free_pages,
            "pool_utilization": self.pool_utilization,
            "pool_utilization_peak": self.pool_utilization_peak,
        }
