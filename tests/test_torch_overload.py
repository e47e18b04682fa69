"""Port parity: overload-robust serving of ``repro_torch.serve`` against
``repro.serve`` (mirrors ``tests/test_overload_serve.py`` and the
``FaultyChannel`` tests of ``tests/test_chaos_serve.py``), on the JAX
suite's ``overload-tiny`` LM with weights from the JAX ``init_lm``
bridged by value.

* Host side, exact and side by side in this process: the typed
  ``PoolExhausted`` and the hardened allocator (a Hypothesis property
  drives both packages' allocators through the same interleavings),
  the pool's geometry floor and demand growth, ``PressureSchedule``
  squeezes, and ``FaultyChannel`` events and clocks for a seed.
* Engines, against the JAX engines in one subprocess: demand-paged
  streams equal the worst-case-reservation ones with every page
  returned; lossless streams under seeded pressure schedules (with
  preemption and replay) equal the unpreempted ones and the JAX
  engine's, at k = 1 and k = 4; priority traffic at 2x pool
  oversubscription, deadline shedding and staggered arrivals give the
  JAX engine's streams, admission and finish times, preemption counts
  and every ``ServeStats`` counter, with the simulated clock equal to
  transfers plus charged waits; the INT8 default under preemption
  equals the JAX engine token for token.

The JAX engines run with XLA:CPU's asynchronous dispatch off (ROADMAP
C); one engine per configuration is reset between runs, as the JAX
suite reuses its module-scoped engines."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import costmodel as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve import kvcache as JK  # noqa: E402
from repro.serve import transport as JTR  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.costmodel import (Channel, PhaseBreakdown,  # noqa: E402
                                        predict_finish_time)
from repro_torch.models.transformer import LMConfig  # noqa: E402
from repro_torch.serve import (CollaborativeServingEngine,  # noqa: E402
                               FaultOutcome, FaultyChannel, PageAllocator,
                               PoolExhausted, PressureSchedule, Request)
from repro_torch.serve import faults as TF  # noqa: E402
from repro_torch.serve import transport as TTR  # noqa: E402
from repro_torch.serve.kvcache import _PagedPool  # noqa: E402

CFG_KW = dict(name="overload-tiny", n_layers=3, d_model=32, n_heads=4,
              n_kv=2, d_ff=64, vocab=64)
TCFG = LMConfig(**CFG_KW)
PAGE = 8
LOSSLESS = dict(a_bits=None, edge_int8=False, cloud_int8=False,
                page_size=PAGE, max_batch=2, max_len=64)
INT8 = dict(page_size=PAGE, max_batch=2, max_len=64)
# 2x oversubscription: 4 slots x 9+40-token worst case want ~20 usable
# pages; the pool has 10 (plus the reserved dump page)
OVERSUB = dict(LOSSLESS, max_batch=4, num_pages=11)
BASE = dict(kbps=500, rtt_ms=10)
PLENS = (6, 7, 9)
MAX_NEW = 10
STATS = ("prefill_calls", "prefill_tokens", "decode_steps", "decode_tokens",
         "spec_rounds", "draft_hits", "drafted_tokens", "transmitted_bytes",
         "prefill_bytes", "decode_bytes", "downlink_bytes",
         "decode_downlink_bytes", "decode_bytes_log", "channel_latency_s",
         "preemptions", "shed", "deadline_misses", "queue_wait_s",
         "stall_wait_s", "pool_free_pages", "pool_utilization",
         "pool_utilization_peak")
REQ = ("out_tokens", "shed", "done", "preemptions", "admit_s", "finish_s")
# name: (engine, demand_paged, admission, pressure windows, workload)
RUNS = {
    "worst_case": ("lossless", False, None, None, "plain"),
    "demand": ("lossless", True, None, None, "plain"),
    "pressure_a": ("lossless", True, None, [(0.02, 0.25, 0)], "plain"),
    "pressure_b": ("lossless", True, None, [(0.0, 0.1, 1), (0.15, 0.4, 0)],
                   "plain"),
    "pressure_c": ("lossless", True, None, [(0.05, 0.5, 2)], "plain"),
    "clock": ("lossless", True, None, [(0.02, 0.25, 0)], "staggered"),
    "shedding": ("lossless", True, "deadline", None, "deadlines"),
    "spec_worst_case": ("spec", False, None, None, "plain"),
    "spec_pressure": ("spec", True, None, [(0.02, 0.3, 1)], "plain"),
    "naive": ("oversub", False, None, None, "overload"),
    "robust": ("oversub", True, "deadline", None, "overload"),
    "int8_worst_case": ("int8", False, None, None, "plain"),
    "int8_pressure": ("int8", True, None, [(0.02, 0.3, 0)], "plain"),
}

# the workloads, the same source in both processes (``Request`` and
# ``CFG`` come from the namespace it runs in)
WORKLOADS = '''
def prompts(lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32) for n in lens]

def workload(name):
    if name == "plain":
        return [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(prompts(PLENS))]
    if name == "staggered":
        return [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW,
                        arrival_s=0.05 * i)
                for i, p in enumerate(prompts(PLENS))]
    if name == "deadlines":
        ps = prompts((6, 7, 6))
        return [Request(uid=0, prompt=ps[0], max_new_tokens=8,
                        deadline_s=1e9),
                Request(uid=1, prompt=ps[1], max_new_tokens=8,
                        deadline_s=1e-6),
                Request(uid=2, prompt=ps[2], max_new_tokens=8)]
    rng = np.random.RandomState(7)
    mk = lambda: rng.randint(0, CFG.vocab, 9).astype(np.int32)
    rs = [Request(uid=i, prompt=mk(), max_new_tokens=40, priority=0)
          for i in range(6)]
    rs += [Request(uid=10 + i, prompt=mk(), max_new_tokens=20, priority=1,
                   arrival_s=0.3, deadline_s=0.3 + 0.9) for i in range(2)]
    return rs
'''

_REFERENCE = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
import numpy as np
from repro.core.costmodel import Channel
from repro.models.transformer import LMConfig, init_lm
from repro.serve import (CollaborativeServingEngine, FaultyChannel,
                         PressureSchedule, Request, ServeStats, Transport)
from repro.serve.policy import DeadlineAdmission
CFG = LMConfig(max_seq=64, remat=False, **CFG_KW)
p = init_lm(jax.random.PRNGKey(0), CFG)
exec(WORKLOADS)
base = Channel.from_kbps(BASE["kbps"], rtt_ms=BASE["rtt_ms"])
engines = {
    "lossless": CollaborativeServingEngine(p, CFG, cut_layer=1, **LOSSLESS),
    "spec": CollaborativeServingEngine(p, CFG, cut_layer=1, spec_k=4,
                                       **LOSSLESS),
    "oversub": CollaborativeServingEngine(p, CFG, cut_layer=1, **OVERSUB),
    "int8": CollaborativeServingEngine(p, CFG, cut_layer=1, **INT8)}
ref = {}
for name, (which, demand, admission, windows, wl) in RUNS.items():
    eng = engines[which]
    fch = FaultyChannel(base, seed=0)
    eng.transport = Transport(fch)      # fresh telemetry too
    eng.stats = ServeStats()
    eng.demand_paged = demand
    eng.admission = None if admission is None else DeadlineAdmission(
        CFG, batch=eng.max_batch, fallback_channel=base,
        blob_itemsize=1 if eng.a_bits is not None else 4)
    eng.pressure = None if windows is None else PressureSchedule(windows)
    reqs = workload(wl)
    eng.generate_requests(reqs)
    held = 0 if windows is None else eng.pressure.held_pages
    if windows is not None:
        eng.pressure.apply(eng._pool.allocator, float("inf"))
    a = eng._pool.allocator
    ref[name] = dict(
        stats={f: getattr(eng.stats, f) for f in STATS},
        reqs=[{f: getattr(r, f) for f in REQ} for r in reqs],
        clock_s=fch.clock_s, held=held,
        free=a.num_free, live=len(a.live))
json.dump(ref, sys.stdout)
"""


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0),
                   JT.LMConfig(max_seq=64, remat=False, **CFG_KW))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' streams, request metadata and stats, from one
    subprocess."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    consts = dict(CFG_KW=CFG_KW, LOSSLESS=LOSSLESS, INT8=INT8,
                  OVERSUB=OVERSUB, BASE=BASE, PLENS=PLENS, MAX_NEW=MAX_NEW,
                  STATS=STATS, REQ=REQ, RUNS=RUNS, WORKLOADS=WORKLOADS)
    code = "".join(f"{k} = {v!r}\n" for k, v in consts.items()) + _REFERENCE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


_ns = {"np": np, "Request": Request, "CFG": TCFG, "PLENS": PLENS,
       "MAX_NEW": MAX_NEW}
exec(WORKLOADS, _ns)
workload, _prompts = _ns["workload"], _ns["prompts"]


def _base():
    return Channel.from_kbps(BASE["kbps"], rtt_ms=BASE["rtt_ms"])


def _engine(params, which, demand, admission, windows):
    kw = dict(spec=dict(LOSSLESS, spec_k=4), lossless=LOSSLESS,
              oversub=OVERSUB, int8=INT8)[which]
    return CollaborativeServingEngine(
        params, TCFG, cut_layer=1, channel=FaultyChannel(_base(), seed=0),
        demand_paged=demand, admission=admission,
        pressure=None if windows is None else PressureSchedule(windows),
        device="cpu", **kw)


def _run(params, name):
    which, demand, admission, windows, wl = RUNS[name]
    eng = _engine(params, which, demand, admission, windows)
    reqs = workload(wl)
    eng.generate_requests(reqs)
    held = 0 if windows is None else eng.pressure.held_pages
    if windows is not None:
        eng.pressure.apply(eng._pool.allocator, float("inf"))
    a = eng._pool.allocator
    got = dict(stats={f: getattr(eng.stats, f) for f in STATS},
               reqs=[{f: getattr(r, f) for f in REQ} for r in reqs],
               clock_s=eng.channel.clock_s, held=held, free=a.num_free,
               live=len(a.live))
    return eng, reqs, got


# ---------------------------------------------------------------------------
# Hardened allocator, pool geometry, demand growth
# ---------------------------------------------------------------------------


def test_pool_exhausted_is_typed_and_state_preserving():
    alloc = PageAllocator(4)
    pages = alloc.alloc(2)
    with pytest.raises(PoolExhausted):
        alloc.alloc(2)
    assert isinstance(PoolExhausted("x"), RuntimeError)
    assert alloc.num_free == 1 and set(alloc.live) == set(pages)
    with pytest.raises(ValueError, match="not live"):
        alloc.free([0])
    alloc.free(pages)
    with pytest.raises(ValueError, match="not live"):
        alloc.free([pages[0]])
    assert alloc.num_free == 3


def test_pool_build_floor_rejects_impossible_geometry():
    with pytest.raises(ValueError, match="can never admit"):
        _PagedPool.build(2, 64, PAGE, 8, "cpu")
    pool = _PagedPool.build(2, 64, PAGE, 9, "cpu")
    assert pool.allocator.num_free == 8


def test_demand_growth_and_ensure_contract():
    pool = _PagedPool.build(2, 64, PAGE, 9, "cpu")
    ref = JK._PagedPool.build(2, 64, PAGE, num_pages=9)
    for p in (pool, ref):
        p.admit([0], np.asarray([6]), np.asarray([1]), 8)
    assert pool.pages_held(0) == 1 and pool.table_dev().shape == (2, 1)
    assert pool.ensure(0, 17) is True and ref.ensure(0, 17) is True
    assert pool.pages_held(0) == 3
    # the grown claim reaches the device table on its next read
    assert pool.table_dev().shape == (2, 4)
    np.testing.assert_array_equal(pool.table_dev().numpy(),
                                  np.asarray(ref.table_dev()))
    assert pool.ensure(0, 17) is False
    held = pool.pages_held(0)
    with pytest.raises(PoolExhausted):
        pool.ensure(0, 64 * 2)
    assert pool.pages_held(0) == held
    assert (pool.free_pages(), pool.utilization()) == (5, 3 / 8)
    pool.retire(0)
    assert pool.allocator.num_free == 8 and pool.utilization() == 0.0
    with pytest.raises(KeyError):
        pool.ensure(1, 8)


def test_pressure_schedule_squeezes_and_restores():
    alloc = PageAllocator(9)
    pr = PressureSchedule([(1.0, 2.0, 3), (1.5, 1.8, 1)])
    assert pr.target_free(0.5) is None and pr.target_free(1.7) == 1
    assert pr.next_change(1.6) == 1.8 and pr.next_change(3.0) is None
    pr.apply(alloc, 1.2)
    assert pr.held_pages == 5 and alloc.num_free == 3
    pr.apply(alloc, 1.7)
    assert pr.held_pages == 7 and alloc.num_free == 1
    pr.apply(alloc, 1.9)
    assert pr.held_pages == 5 and alloc.num_free == 3
    pr.apply(alloc, 3.0)
    assert pr.held_pages == 0 and alloc.num_free == 8
    live = alloc.alloc(6)
    pr.apply(alloc, 1.7)
    assert alloc.num_free == 1 and set(live) <= set(alloc.live)
    with pytest.raises(ValueError):
        PressureSchedule([(1.0, 1.0, 2)])


def test_pressure_schedule_matches_reference():
    """Both packages' schedules over the same allocator traffic: the
    same pages held and freed at every step."""
    windows = [(0.1, 0.6, 2), (0.3, 0.4, 0), (0.8, 1.2, 5)]
    logs = []
    for mod, alloc in ((TF, PageAllocator(13)), (JF, JK.PageAllocator(13))):
        pr, log, held = mod.PressureSchedule(windows), [], []
        rng = np.random.RandomState(0)
        for t in np.linspace(0.0, 1.5, 31):
            if held and rng.rand() < 0.4:
                alloc.free([held.pop()])
            elif alloc.num_free and rng.rand() < 0.5:
                held.extend(alloc.alloc(1))
            pr.apply(alloc, float(t))
            log.append((sorted(alloc.live), alloc.num_free, pr.held_pages))
        logs.append(log)
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# FaultyChannel: the fault model (twins of tests/test_chaos_serve.py)
# ---------------------------------------------------------------------------


def test_faulty_channel_scripted_events():
    ch = FaultyChannel(_base(), script=["drop", "corrupt", "stall", "ok"],
                       stall_s=0.5)
    assert ch.attempt(1000) == FaultOutcome(False, False, 0.0, "drop")
    assert ch.clock_s == 0.0
    corrupt = ch.attempt(1000)
    assert corrupt.delivered and corrupt.corrupt
    base_t = _base().transfer_time(1000)
    assert corrupt.seconds == pytest.approx(base_t)
    stall = ch.attempt(1000)
    assert stall.seconds == pytest.approx(base_t + 0.5)
    ok = ch.attempt(1000)
    assert ok == FaultOutcome(True, False, ok.seconds, "ok")
    assert ch.clock_s == pytest.approx(3 * base_t + 0.5)
    assert ch.faults == {"drop": 1, "corrupt": 1, "stall": 1, "outage": 0}


def test_faulty_channel_seeded_is_deterministic():
    kw = dict(seed=7, drop_p=0.3, corrupt_p=0.2, stall_p=0.2)
    a, b = FaultyChannel(_base(), **kw), FaultyChannel(_base(), **kw)
    kinds_a = [a.attempt(100).kind for _ in range(50)]
    assert kinds_a == [b.attempt(100).kind for _ in range(50)]
    assert {"drop", "corrupt", "stall"} <= set(kinds_a)


def test_faulty_channel_outage_window():
    ch = FaultyChannel(_base(), seed=0, outages=[(0.1, 0.4)])
    assert ch.attempt(50_000).delivered and 0.1 < ch.clock_s < 0.4
    assert ch.in_outage() and ch.outage_end() == 0.4
    out = ch.attempt(100)
    assert out.kind == "outage" and not out.delivered and out.seconds == 0.0
    ch.wait(0.4 - ch.clock_s)
    assert not ch.in_outage() and ch.outage_end() is None
    assert ch.attempt(100).delivered and ch.faults["outage"] == 1


def test_faulty_channel_naive_transfer_blocks_through_outage():
    ch = FaultyChannel(_base(), seed=0, outages=[(0.0, 2.0)], rto_s=0.25)
    assert ch.transfer_time(1000) >= 2.0
    assert ch.clock_s >= 2.0 and not ch.in_outage()
    assert FaultyChannel(_base(), seed=0).transfer_time(1000) == \
        pytest.approx(_base().transfer_time(1000))


def test_faulty_channel_syncs_drifting_base_clock():
    fast = Channel.from_kbps(1000, rtt_ms=1)
    slow = Channel.from_kbps(10, rtt_ms=100)
    ch = FaultyChannel(TTR.DriftingChannel([(0.0, fast), (0.5, slow)]),
                       seed=0)
    assert ch.attempt(1000).seconds == pytest.approx(fast.transfer_time(1000))
    ch.wait(1.0)
    assert ch.attempt(1000).seconds == pytest.approx(slow.transfer_time(1000))
    assert "faulty[" in ch.name


def test_faulty_channel_matches_reference():
    """A seed draws the same faults, times and clocks in both packages,
    through attempts, blocking transfers, waits and an outage."""
    logs = []
    for mod, cm, tr in ((TF, Channel, TTR), (JF, JC.Channel, JTR)):
        base = tr.DriftingChannel([(0.0, cm.from_kbps(500, rtt_ms=10)),
                                   (0.3, cm.from_kbps(50, rtt_ms=80))])
        ch = mod.FaultyChannel(base, seed=11, drop_p=0.2, corrupt_p=0.1,
                               stall_p=0.1, outages=[(0.5, 0.7)],
                               rto_s=0.05)
        log = []
        for i in range(60):
            if i % 4 == 3:
                log.append(("t", ch.transfer_time(800.0 + 37 * i)))
            else:
                o = ch.attempt(2000.0 + 11 * i)
                log.append((o.kind, o.delivered, o.corrupt, o.seconds))
            if i % 10 == 0:
                ch.wait(0.02)
            log.append(ch.clock_s)
        logs.append((log, ch.attempts, ch.faults, ch.name))
    assert logs[0] == logs[1]
    assert logs[0][2]["outage"] > 0


# ---------------------------------------------------------------------------
# Engines against the JAX engines
# ---------------------------------------------------------------------------


def test_demand_paged_stream_matches_worst_case(params, reference):
    _, _, want = _run(params, "worst_case")
    eng, _, got = _run(params, "demand")
    assert got == reference["demand"]
    assert want == reference["worst_case"]
    assert [r["out_tokens"] for r in got["reqs"]] == \
        [r["out_tokens"] for r in want["reqs"]]
    assert all(len(r["out_tokens"]) == MAX_NEW for r in got["reqs"])
    a = eng._pool.allocator
    assert a.num_free == a.num_pages - 1 and not a.live


def test_admission_reserves_prompt_not_budget(params):
    eng = _engine(params, "lossless", True, None, None)
    cur = torch.zeros((2,), dtype=torch.int32)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = _prompts([6])[0]
    eng._admit(torch.tensor(toks), np.asarray([6], np.int32),
               np.asarray([30], np.int32),
               np.asarray([0], np.int32), cur, cur.clone())
    assert eng._pool.pages_held(0) == 1
    eng._retire(0)
    worst = _engine(params, "lossless", False, None, None)
    assert worst._admit_reserve(np.asarray([30]))[0] == 30


@pytest.mark.parametrize("name", ["pressure_a", "pressure_b", "pressure_c",
                                  "spec_pressure"])
def test_preemption_streams_match_unpreempted_and_reference(params,
                                                            reference,
                                                            name):
    """Seeded pressure schedules squeeze the pool mid-run: requests are
    preempted, parked and replayed, and the lossless streams are the
    unpreempted ones bit for bit — the JAX engine's, with the same
    preemptions, waits and wire bytes."""
    eng, _, got = _run(params, name)
    oracle = reference["spec_worst_case" if name.startswith("spec")
                       else "worst_case"]
    assert got == reference[name]
    assert [r["out_tokens"] for r in got["reqs"]] == \
        [r["out_tokens"] for r in oracle["reqs"]]
    if name in ("pressure_a", "spec_pressure"):
        assert got["stats"]["preemptions"] >= 1
    assert got["free"] == eng._pool.allocator.num_pages - 1
    assert got["live"] == 0


def test_priority_survives_oversubscription(params, reference):
    """At 2x pool oversubscription the robust engine preempts
    best-effort work and meets every priority deadline; the naive
    worst-case engine head-of-line blocks them past their deadlines.
    Admission and finish times, preemptions and streams: the JAX
    engines'."""
    _, nreqs, naive = _run(params, "naive")
    robust_eng, rreqs, robust = _run(params, "robust")
    assert naive == reference["naive"] and robust == reference["robust"]
    rpri = [r for r in rreqs if r.priority > 0]
    npri = [r for r in nreqs if r.priority > 0]
    assert all(len(r.out_tokens) == r.max_new_tokens for r in rpri)
    assert all(r.finish_s <= r.deadline_s for r in rpri)
    assert robust_eng.stats.preemptions >= 1
    assert robust_eng.stats.deadline_misses == 0
    assert naive["stats"]["preemptions"] == 0
    assert all(r.finish_s > r.deadline_s for r in npri)
    assert [r.out_tokens for r in rreqs] == [r.out_tokens for r in nreqs]


def test_deadline_shedding(params, reference):
    eng, reqs, got = _run(params, "shedding")
    assert got == reference["shedding"]
    assert reqs[1].shed and reqs[1].done and reqs[1].out_tokens == []
    assert reqs[1].admit_s is None and reqs[1].finish_s is None
    assert len(reqs[0].out_tokens) == len(reqs[2].out_tokens) == 8
    assert eng.stats.shed == 1 and eng.stats.deadline_misses == 0


def test_predict_finish_time_shape():
    rd = PhaseBreakdown(prefill_s=0.0, decode_s=0.1, channel_s=0.05,
                        tokens=2.0)
    t0 = predict_finish_time(rd, now=1.0, max_new=8)
    assert t0 == pytest.approx(1.0 + 4 * rd.total_s)
    assert predict_finish_time(rd, now=1.0, max_new=8, queue_tokens=16.0,
                               slots=2) == pytest.approx(t0 + 4 * rd.total_s)


def test_stats_clock_decomposition_and_counters(params, reference):
    """Staggered arrivals under pressure: the simulated clock is exactly
    transfers plus charged waits, per-request preemptions sum to the
    engine's count, and everything equals the JAX engine's."""
    eng, reqs, got = _run(params, "clock")
    assert got == reference["clock"]
    st = eng.stats
    assert st.preemptions >= 1
    assert st.preemptions == sum(r.preemptions for r in reqs)
    assert got["clock_s"] == pytest.approx(
        st.channel_latency_s + st.stall_wait_s, rel=1e-12)
    assert st.stall_wait_s > 0 and st.queue_wait_s > 0
    for r in reqs:
        assert r.finish_s >= r.admit_s >= r.arrival_s


def test_int8_preemption_matches_reference(params, reference):
    """The INT8 default (INT8 edge lattice and pages) under a pressure
    schedule: the replay prefill recalibrates over the longer prefix,
    so the stream may leave the unpreempted one, but it is the JAX
    engine's token for token, with the same counters."""
    _, _, got = _run(params, "int8_pressure")
    assert got == reference["int8_pressure"]
    assert got["stats"]["preemptions"] >= 1
    _, _, worst = _run(params, "int8_worst_case")
    assert worst == reference["int8_worst_case"]
    assert [r["out_tokens"][0] for r in got["reqs"]] == \
        [r["out_tokens"][0] for r in worst["reqs"]]


try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    st = None

if st is not None:
    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.tuples(st.booleans(), st.integers(0, 5)),
                    max_size=60))
    def test_allocator_interleaving_property(ops):
        """Any alloc/free interleaving keeps the free list and the live
        set exact complements, a failed alloc mutates nothing, and both
        packages' allocators hand out the same pages."""
        alloc, ref = PageAllocator(17), JK.PageAllocator(17)
        held = []
        for is_alloc, n in ops:
            if is_alloc:
                if n > alloc.num_free:
                    before = (alloc.num_free, set(alloc.live))
                    with pytest.raises(PoolExhausted):
                        alloc.alloc(n)
                    assert (alloc.num_free, set(alloc.live)) == before
                else:
                    got = alloc.alloc(n)
                    assert got == ref.alloc(n)
                    held.extend(got)
            elif held:
                back = [held.pop() for _ in range(min(n, len(held)))]
                alloc.free(back)
                ref.free(back)
            assert set(held) == set(alloc.live) == set(ref.live)
            assert alloc.num_free == 16 - len(held) == ref.num_free
        if held:
            alloc.free([held[0]])
            with pytest.raises(ValueError):
                alloc.free([held[0]])

    @settings(max_examples=4, deadline=None)
    @given(windows=st.lists(
        st.tuples(st.floats(0.0, 0.4), st.floats(0.05, 0.5),
                  st.integers(0, 2)),
        min_size=1, max_size=2))
    def test_preemption_schedule_bit_identity_property(params, reference,
                                                       windows):
        """Under any pressure schedule the lossless streams are the
        unpreempted ones."""
        eng = _engine(params, "lossless", True, None,
                      [(t0, t0 + d, n) for t0, d, n in windows])
        got = eng.generate(_prompts(PLENS), max_new_tokens=MAX_NEW)
        assert got == [r["out_tokens"]
                       for r in reference["worst_case"]["reqs"]]
else:
    @pytest.mark.skip(reason="property tests need hypothesis")
    def test_allocator_interleaving_property():
        pass

    @pytest.mark.skip(reason="property tests need hypothesis")
    def test_preemption_schedule_bit_identity_property():
        pass
