"""Port parity: the reliability layer of ``repro_torch.serve`` against
``repro.serve`` (twins of ``tests/test_chaos_serve.py``), on the JAX
suite's ``chaos-tiny`` LM with weights from the JAX ``init_lm`` bridged
by value.

* Host side, both packages side by side in this process, exact: the
  message ``checksum``; ``ReliableTransport``'s retries through drops,
  immediate resend on corruption, escalation to ``CloudUnreachable``,
  telemetry-derived deadlines, the plain-channel path and the probe —
  every ``ServeStats`` field, the simulated clock, the sequence number
  and the loss EWMA — and a long seeded run over a drifting faulty
  channel; the telemetry guards and the lossy-link pricing;
  ``_PagedPool.table_for``; the hot standby's provisioning at k = 1.
* Engines, against the JAX engines in one subprocess
  (``torch_resilience_common``): the outage-admitted calibrating resync,
  the post-recovery wave, preemption under an outage, and the
  Hypothesis property on one reused engine, every example it drew
  replayed on the JAX engine: streams, every counter, phase calls,
  ``round_log`` and clock equal, and each lossless stream the
  fault-free one."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_resilience_common as RC  # noqa: E402
from repro.core import costmodel as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve import kvcache as JK  # noqa: E402
from repro.serve import resilience as JR  # noqa: E402
from repro.serve import stats as JS  # noqa: E402
from repro.serve import transport as JTR  # noqa: E402
from repro_torch.core import costmodel as TC  # noqa: E402
from repro_torch.models.transformer import LMConfig  # noqa: E402
from repro_torch.serve import faults as TF  # noqa: E402
from repro_torch.serve import stats as TS  # noqa: E402
from repro_torch.serve import transport as TTR  # noqa: E402
from repro_torch.serve.engine import CollaborativeServingEngine  # noqa: E402
from repro_torch.serve.kvcache import _PagedPool  # noqa: E402
from repro_torch.serve.resilience import (  # noqa: E402
    ResilientCollaborativeEngine)

TCFG = LMConfig(**RC.CFG_KW)
JCFG = JT.LMConfig(max_seq=64, remat=False, **RC.CFG_KW)
# (transport, faults, costmodel, stats) of each package
PORT = (TTR, TF, TC, TS)
REF = (JTR, JF, JC, JS)
RUNS = ("outage_admission", "post_recovery", "preempt_outage")


def _base(cm):
    return cm.Channel.from_kbps(500, rtt_ms=10)


def _state(tr, ch, stats):
    return dict(stats=dataclasses.asdict(stats),
                clock_s=getattr(ch, "clock_s", None),
                seq=getattr(tr, "seq", None),
                loss_rate=tr.telemetry.loss_rate,
                samples=tr.telemetry.n_samples)


def _side_by_side(scenario):
    """``scenario(transport, faults, costmodel, stats modules)`` for the
    port and the reference; both must return equal results."""
    got, want = scenario(*PORT), scenario(*REF)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# Checksum and the reliable transport
# ---------------------------------------------------------------------------


def test_checksum_detects_corruption():
    blob = np.arange(256, dtype=np.int8)
    c = TTR.checksum(blob)
    assert c == TTR.checksum(np.arange(256, dtype=np.int8)) \
        == JTR.checksum(blob)
    flipped = blob.copy()
    flipped[17] ^= 1
    assert TTR.checksum(flipped) != c
    assert TTR.checksum(flipped) == JTR.checksum(flipped)
    assert TTR.checksum(blob.tobytes()) == c
    assert TTR.checksum(torch.tensor(blob)) == c


def test_reliable_transport_retries_through_drops():
    def scenario(tr_m, f_m, cm, st_m):
        ch = f_m.FaultyChannel(_base(cm), script=["drop", "drop", "ok"])
        tr = tr_m.ReliableTransport(ch, max_retries=3,
                                    fallback_deadline_s=0.2)
        stats = st_m.ServeStats()
        tr.charge(stats, 1000, phase="decode", log=False)
        return _state(tr, ch, stats)
    s = _side_by_side(scenario)
    st = s["stats"]
    assert st["retries"] == 2 and st["timeouts"] == 2
    assert st["corrupt_msgs"] == 0 and st["transmitted_bytes"] == 1000
    assert st["decode_bytes_log"] == []
    assert st["channel_latency_s"] > 2 * 0.2
    assert s["loss_rate"] > 0.0 and s["seq"] == 1


def test_reliable_transport_corrupt_resends_immediately():
    def scenario(tr_m, f_m, cm, st_m):
        ch = f_m.FaultyChannel(_base(cm), script=["corrupt", "ok"])
        tr = tr_m.ReliableTransport(ch, fallback_deadline_s=0.5)
        stats = st_m.ServeStats()
        tr.charge(stats, 1000, phase="decode", log=False)
        return _state(tr, ch, stats)
    st = _side_by_side(scenario)["stats"]
    assert st["corrupt_msgs"] == 1 and st["timeouts"] == 0
    assert st["retries"] == 1
    assert st["channel_latency_s"] < \
        2 * _base(TC).transfer_time(1000) + 0.1


def test_reliable_transport_raises_cloud_unreachable():
    def scenario(tr_m, f_m, cm, st_m):
        ch = f_m.FaultyChannel(_base(cm), seed=0, outages=[(0.0, 100.0)])
        tr = tr_m.ReliableTransport(ch, max_retries=2,
                                    fallback_deadline_s=0.1)
        stats = st_m.ServeStats()
        with pytest.raises(tr_m.CloudUnreachable) as e:
            tr.charge(stats, 1000, phase="decode", log=False)
        return dict(_state(tr, ch, stats), msg=str(e.value))
    s = _side_by_side(scenario)
    assert s["stats"]["timeouts"] == 3 and s["stats"]["retries"] == 2
    assert s["stats"]["channel_latency_s"] > 3 * 0.1
    assert s["clock_s"] > 0.3
    assert issubclass(TTR.CloudUnreachable, RuntimeError)


def test_reliable_transport_deadline_tracks_telemetry():
    def scenario(tr_m, f_m, cm, st_m):
        tr = tr_m.ReliableTransport(f_m.FaultyChannel(_base(cm), seed=0),
                                    deadline_margin=3.0,
                                    fallback_deadline_s=0.5)
        before = tr.deadline_for(10_000)
        for n in (100, 5000, 300, 20000, 64, 1000):
            tr.telemetry.observe_transfer(n, _base(cm).transfer_time(n))
        return (before, tr.deadline_for(10_000), tr.deadline_for(0),
                tr.telemetry.bandwidth_bytes_per_s, tr.telemetry.rtt_s)
    before, d, d0, bw, rtt = _side_by_side(scenario)
    assert before == 0.5
    assert d == pytest.approx(3.0 * (10_000 / bw + rtt), rel=0.01)
    assert d0 >= 0.01


def test_reliable_transport_degenerates_on_plain_channel():
    """No ``attempt`` method: the base transport, bit for bit."""
    def scenario(tr_m, f_m, cm, st_m):
        tr = tr_m.ReliableTransport(_base(cm))
        stats = st_m.ServeStats()
        tr.charge(stats, 1000, phase="decode", log=False)
        return dict(_state(tr, None, stats), probe=tr.probe(stats))
    s = _side_by_side(scenario)
    assert s["stats"]["retries"] == s["stats"]["timeouts"] == 0
    assert s["stats"]["channel_latency_s"] == pytest.approx(
        _base(TC).transfer_time(1000))
    assert s["probe"] == (True, 0.0) and s["seq"] == 0


def test_reliable_transport_probe():
    def scenario(tr_m, f_m, cm, st_m):
        ch = f_m.FaultyChannel(_base(cm), seed=0, outages=[(0.0, 0.3)])
        tr = tr_m.ReliableTransport(ch, fallback_deadline_s=0.2)
        stats = st_m.ServeStats()
        probes = [(tr.probe(stats), ch.clock_s) for _ in range(3)]
        return dict(_state(tr, ch, stats), probes=probes)
    s = _side_by_side(scenario)
    (p1, c1), (p2, c2), (p3, _) = s["probes"]
    assert p1 == (False, pytest.approx(0.2)) and c1 == pytest.approx(0.2)
    assert not p2[0] and c2 == pytest.approx(0.4)
    assert p3[0] and p3[1] == pytest.approx(
        _base(TC).transfer_time(TTR._MSG_BYTES))
    assert s["stats"]["timeouts"] == 2


def test_reliable_transport_matches_reference_over_a_seeded_run():
    """Charges, downlinks and probes over a drifting channel with drops,
    corruption, stalls and two outages: every escalation, counter,
    deadline, clock reading and backoff draw equal."""
    def scenario(tr_m, f_m, cm, st_m):
        base = tr_m.DriftingChannel([(0.0, cm.Channel.from_kbps(
            500, rtt_ms=10)), (0.4, cm.Channel.from_kbps(50, rtt_ms=80))])
        ch = f_m.FaultyChannel(base, seed=13, drop_p=0.2, corrupt_p=0.1,
                               stall_p=0.1, stall_s=0.05,
                               outages=[(0.3, 0.6), (1.0, 1.1)])
        tr = tr_m.ReliableTransport(ch, max_retries=2, seed=5)
        stats, rng, log = st_m.ServeStats(), np.random.RandomState(1), []
        for i in range(150):
            n = int(rng.randint(64, 20_000))
            try:
                if i % 5 == 0:
                    tr.account_downlink(stats, int(rng.randint(1, 5)),
                                        k=int(rng.randint(1, 9)))
                elif i % 5 == 1:
                    log.append(tr.probe(stats))
                else:
                    tr.charge(stats, n, phase=("prefill" if i % 5 == 2
                                               else "decode"),
                              log=bool(i % 2))
                log.append(("ok", ch.clock_s, tr.deadline_for(n)))
            except tr_m.CloudUnreachable as e:
                log.append(("down", str(e), ch.clock_s))
        return dict(_state(tr, ch, stats), log=log, faults=dict(ch.faults),
                    attempts=ch.attempts)
    s = _side_by_side(scenario)
    st = s["stats"]
    assert st["retries"] > 0 and st["timeouts"] > 0
    assert st["corrupt_msgs"] > 0
    assert any(e[0] == "down" for e in s["log"])
    assert s["faults"]["outage"] > 0


# ---------------------------------------------------------------------------
# Telemetry guards and the lossy-link pricing
# ---------------------------------------------------------------------------


def test_telemetry_rejects_zero_duration_samples():
    def scenario(tr_m, f_m, cm, st_m):
        tel, ch = tr_m.LinkTelemetry(), cm.Channel.from_kbps(250, rtt_ms=40)
        for n in (100, 5000, 300, 20000):
            tel.observe_transfer(n, ch.transfer_time(n))
        bw = tel.bandwidth_bytes_per_s
        for _ in range(50):
            tel.observe_transfer(4096, 0.0)
            tel.observe_transfer(0, 0.01)
        return bw, tel.bandwidth_bytes_per_s, tel.n_samples
    bw, after, n = _side_by_side(scenario)
    assert bw == pytest.approx(250e3, rel=0.05) and after == bw and n == 4


def test_telemetry_clamps_bandwidth_ceiling():
    def scenario(tr_m, f_m, cm, st_m):
        tel = tr_m.LinkTelemetry()
        for n in (100, 5000, 300, 20000, 64, 1000):
            tel.observe_transfer(n, n * 1e-16 + 0.01)
        return tel.bandwidth_bytes_per_s, tel.rtt_s
    bw, _ = _side_by_side(scenario)
    assert bw == TTR.LinkTelemetry.BW_CEILING_BYTES_PER_S


def test_loss_rate_ewma_and_expected_retx_pricing():
    def scenario(tr_m, f_m, cm, st_m):
        tel = tr_m.LinkTelemetry()
        for _ in range(40):
            tel.observe_delivery(True)
            tel.observe_delivery(False)
        est = tel.channel(_base(cm))
        kw = dict(edge_flops=1e7, cloud_flops=5e7, blob_bytes=1000.0,
                  return_bytes=16.0, edge=cm.EDGE_TX2_CLASS,
                  cloud=cm.CLOUD_TITANXP_CLASS)
        clean = cm.collab_decode_step_time(channel=cm.Channel(
            bandwidth_bytes_per_s=1e6, rtt_s=0.01), **kw)
        lossy = cm.collab_decode_step_time(channel=cm.Channel(
            bandwidth_bytes_per_s=1e6, rtt_s=0.01, loss_rate=0.5), **kw)
        return (tel.loss_rate, est.bandwidth_bytes_per_s, est.loss_rate,
                cm.Channel(bandwidth_bytes_per_s=1e6,
                           loss_rate=0.5).expected_retx(),
                cm.Channel(bandwidth_bytes_per_s=1e6,
                           loss_rate=0.999).expected_retx(),
                clean.channel_s, lossy.channel_s)
    loss, bw, est_loss, r5, r999, clean, lossy = _side_by_side(scenario)
    assert loss == pytest.approx(0.5, abs=0.15) and est_loss == loss
    assert bw == _base(TC).bandwidth_bytes_per_s
    assert r5 == pytest.approx(2.0) and r999 == pytest.approx(20.0)
    assert lossy == pytest.approx(2.0 * clean)


# ---------------------------------------------------------------------------
# The masked block table and the standby's provisioning
# ---------------------------------------------------------------------------


def test_table_for_matches_reference():
    """Rows outside the group zeroed (they write the dump page), cached
    per group, and rebuilt after every admit, growth and retire."""
    pool = _PagedPool.build(4, 64, RC.PAGE, None, "cpu")
    ref = JK._PagedPool.build(4, 64, RC.PAGE)

    def same(groups):
        for g in groups:
            got = pool.table_for(g)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(ref.table_for(g)))
            assert got.dtype == torch.int32
            assert pool.table_for(list(reversed(g))) is got
            full = pool.table_dev().numpy()
            keep = np.isin(np.arange(4), g)
            np.testing.assert_array_equal(got.numpy()[keep], full[keep])
            assert not got.numpy()[~keep].any()

    groups = ([0], [2], [0, 2], [1], [0, 1, 2, 3])
    for p in (pool, ref):
        p.admit([0, 2], np.asarray([9, 17]), np.asarray([8, 8]), 32)
    same(groups)
    before = pool.table_for([0])
    for step in (lambda p: p.ensure(0, 40),
                 lambda p: p.admit([1], np.asarray([5]), np.asarray([3]), 8),
                 lambda p: p.retire(2)):
        for p in (pool, ref):
            step(p)
        assert pool.table_for([0]) is not before
        before = pool.table_for([0])
        same(groups)


@pytest.fixture(scope="module")
def jparams():
    return JT.init_lm(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params():
    return RC.bridged_params()


@pytest.mark.parametrize("demand", [False, True])
def test_standby_is_provisioned_at_k1_like_reference(params, jparams,
                                                     demand):
    """The hot standby at spec_k = 1: the suffix copy and its draft
    cache exist from construction, with one round of page headroom —
    the reference's ``_spec_max`` of 2 — so admission reserves the
    reference's pages; a plain engine at k = 1 keeps neither."""
    eng = ResilientCollaborativeEngine(params, TCFG, cut_layer=1, spec_k=1,
                                       demand_paged=demand, device="cpu",
                                       **RC.LOSSLESS)
    ref = JR.ResilientCollaborativeEngine(jparams, JCFG, cut_layer=1,
                                          spec_k=1, demand_paged=demand,
                                          **RC.LOSSLESS)
    assert eng._spec_max == ref._spec_max == 2
    assert eng._round_headroom() == ref._round_headroom() == 1
    assert eng._round_width() == ref._round_width() == 1
    news = np.asarray([1, 5, 30])
    reserve = eng._admit_reserve(news)
    np.testing.assert_array_equal(reserve, ref._admit_reserve(news))
    assert eng.draft_blocks is not None
    assert tuple(eng._draft_cache["k_pages"].shape) == \
        tuple(ref._draft_cache["k_pages"].shape)
    assert isinstance(eng.transport, TTR.ReliableTransport)
    # an admission reserves the reference's pages
    toks = np.zeros((1, 16), np.int32)
    toks[0, :9] = np.arange(9)
    cur = torch.zeros((2,), dtype=torch.int32)
    eng._admit(torch.tensor(toks), np.asarray([9], np.int32),
               np.asarray([30], np.int32), np.asarray([0], np.int32), cur,
               cur.clone())
    assert eng._pool.pages_held(0) == ref._pool.pages_needed(
        9, int(ref._admit_reserve(np.asarray([30]))[0]), 16)
    plain = CollaborativeServingEngine(params, TCFG, cut_layer=1, spec_k=1,
                                       device="cpu", **RC.LOSSLESS)
    assert plain._spec_max == 1 and plain._round_headroom() == 0
    assert plain.draft_blocks is None
    assert getattr(plain, "_draft_cache", None) is None


def test_resilient_engine_without_device_raises_when_no_card(params,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResilientCollaborativeEngine(params, TCFG, cut_layer=1,
                                     **RC.LOSSLESS)


# ---------------------------------------------------------------------------
# Engines against the JAX engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port(params):
    ns = RC.port_runner(params)
    ns["CACHE"] = {}
    return ns


@pytest.fixture(scope="module")
def prop_run(port):
    """The JAX suite's Hypothesis property on the port, on one reused
    engine: each example's lossless stream against the port's
    fault-free one.  Keeps the examples drawn, in order, for the JAX
    replay, with the port's results; a failure is kept for the test."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    cache, seen, results = port["CACHE"], [], []
    port["start_examples"](cache)

    @hyp.settings(max_examples=10, deadline=None)
    @hyp.given(drop_p=st.floats(min_value=0.0, max_value=0.3),
               out_start=st.floats(min_value=0.0, max_value=0.5),
               out_len=st.floats(min_value=0.3, max_value=2.0),
               plens=st.lists(st.integers(min_value=5, max_value=18),
                              min_size=1, max_size=4),
               seed=st.integers(min_value=0, max_value=2 ** 16))
    def prop(drop_p, out_start, out_len, plens, seed):
        ex = [drop_p, out_start, out_len, list(plens), seed]
        got = RC.jsonable(port["run_example"](cache, ex))
        seen.append(ex)
        results.append(got)
        want = port["example_oracle"](cache, ex)["waves"][0]["outs"]
        assert got["outs"] == want
        assert all(len(g) == 8 for g in got["outs"])

    try:
        prop()
        error = None
    except Exception as e:             # re-raised by the property test
        error = e
    return dict(examples=seen, results=results, error=error)


@pytest.fixture(scope="module")
def reference(prop_run):
    return RC.reference({"runs": list(RUNS),
                         "oracles": [n for n in RUNS if n in RC.ORACLES],
                         "examples": prop_run["examples"]})


def _run(port, name):
    return RC.jsonable(port["run"](port["CACHE"], name))


def _outs(res, wave=0):
    return res["waves"][wave]["outs"]


def test_oracle_streams_match_reference(port, reference):
    for name in RUNS:
        got = RC.jsonable(port["oracle"](port["CACHE"], name))
        assert got == reference["oracle:" + name]


def test_outage_admission_uses_calibrating_resync(port, reference):
    """Requests admitted during the outage never met the cloud; the
    resync rebuilds their cloud KV from position 0 (the calibrating
    prefill flavor), spec rounds resume, and the stream is the
    fault-free one — all as the JAX engine does it."""
    got = _run(port, "outage_admission")
    assert got == reference["outage_admission"]
    assert _outs(got) == _outs(reference["oracle:outage_admission"])
    w = got["waves"][0]
    st = w["stats"]
    assert st["edge_only_tokens"] > 0 and st["resyncs"] >= 1
    assert w["calls"]["resync"] >= 1 and not w["cloud_down"]
    assert st["spec_rounds"] > 0 and got["pages_back"]


def test_post_recovery_wave_runs_normal_protocol(port, reference):
    got = _run(port, "post_recovery")
    assert got == reference["post_recovery"]
    first, second = got["waves"]
    assert not first["cloud_down"]
    assert _outs(got, 1) == _outs(reference["oracle:post_recovery"], 1)
    assert second["stats"]["spec_rounds"] > first["stats"]["spec_rounds"]
    assert second["stats"]["edge_only_tokens"] == \
        first["stats"]["edge_only_tokens"]


def test_preemption_under_outage_resilient(port, reference):
    """Pressure and a cloud outage together (twin of
    ``tests/test_overload_serve.py::test_preemption_under_outage_resilient``):
    preemption, degradation and resume compose without forking the
    stream."""
    got = _run(port, "preempt_outage")
    assert got == reference["preempt_outage"]
    assert got["waves"][0]["stats"]["preemptions"] >= 1
    assert _outs(got) == _outs(reference["oracle:preempt_outage"])
    assert got["pages_back"]


def test_lossless_stream_identical_under_any_fault_schedule(prop_run,
                                                            reference):
    """Any seeded drop rate, any single outage window, reconnect or not:
    the lossless greedy stream is the fault-free stream, and every
    example equals the JAX engine's replay of it."""
    if prop_run["error"] is not None:
        raise prop_run["error"]
    assert len(prop_run["examples"]) >= 5
    assert prop_run["results"] == reference["examples"]
    for got, want in zip(reference["examples"],
                         reference["example_oracles"]):
        assert got["outs"] == want["waves"][0]["outs"]
