"""Port parity: ``repro_torch.serve.resilience`` against
``repro.serve.resilience`` — the resilient engine end to end (twins of
``tests/test_chaos_serve.py``'s engine tests), on the JAX suite's
``chaos-tiny`` LM with weights from the JAX ``init_lm`` bridged by
value, against the JAX engines in one subprocess
(``torch_resilience_common``).

Every run's streams, every ``ServeStats`` field after each wave, the
edge-only and resync phase calls, the ``round_log``, the simulated clock,
the transport's sequence number and loss rate, the slots left holding
replay rows and the pages returned equal the JAX engine's:

* edge-only streaming through a mid-stream outage (k = 1: the hot
  standby, the replay at each slot's resume position), speculative
  rounds absorbing heavy drops, an outage that outlasts the traffic;
* sampled traffic through an outage and through an outage-admitted
  resync (the edge-only sampled twins on the ``CLOUD`` stream);
* the INT8 default under corruption and an outage (k = 2) and under
  two outages and drops (k = 1), token for token;
* the naive engine stalling through the window.

Each lossless stream is also the fault-free one; on a tensor-parallel
mesh the resync runs on the cloud's shards and changes nothing; an
edge-only round reads nothing back to the host, and greedy traffic never
enters a sampled phase."""
import pytest

torch = pytest.importorskip("torch")

import torch_resilience_common as RC  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402

RUNS = ("outage_serial", "heavy_drops", "int8_corrupt", "naive",
        "sampled_outage", "sampled_admission", "never_back", "int8_serial")


@pytest.fixture(scope="module")
def port():
    ns = RC.port_runner(RC.bridged_params())
    ns["CACHE"] = {}
    return ns


@pytest.fixture(scope="module")
def reference():
    return RC.reference({"runs": list(RUNS),
                         "oracles": [n for n in RUNS if n in RC.ORACLES]})


def _run(port, name, cache=None):
    return RC.jsonable(port["run"](
        port["CACHE"] if cache is None else cache, name))


def _outs(res, wave=0):
    return res["waves"][wave]["outs"]


def test_oracle_streams_match_reference(port, reference):
    for name in RUNS:
        if name in RC.ORACLES:
            got = RC.jsonable(port["oracle"](port["CACHE"], name))
            assert got == reference["oracle:" + name]


def test_edge_only_stream_through_outage_is_bit_identical(port, reference):
    """Mid-stream outage at k = 1: the engine degrades to the suffix
    copy, keeps committing, resyncs on reconnect, and the lossless
    stream is the fault-free one."""
    got = _run(port, "outage_serial")
    assert got == reference["outage_serial"]
    assert _outs(got) == _outs(reference["oracle:outage_serial"])
    w = got["waves"][0]
    st = w["stats"]
    assert st["edge_only_tokens"] > 0 and st["resyncs"] == 1
    assert st["outage_s"] > 0.0 and not w["cloud_down"]
    assert w["calls"]["edge_only"] >= 1 and w["calls"]["resync"] >= 1
    down = [r for r in got["round_log"] if r["cloud_down"]]
    assert down and all(r["committed"] > 0 for r in down)
    assert got["pages_back"] and got["replay_slots"] == []


def test_spec_rounds_survive_heavy_drops(port, reference):
    got = _run(port, "heavy_drops")
    assert got == reference["heavy_drops"]
    assert _outs(got) == _outs(reference["oracle:heavy_drops"])
    st = got["waves"][0]["stats"]
    assert st["retries"] > 0 and st["timeouts"] > 0
    assert st["resyncs"] == 0 and got["loss_rate"] > 0.0


def test_outage_outlasting_traffic_drops_retired_replays(port, reference):
    """Every request finishes on edge-only tokens while the cloud stays
    down; each retired slot drops its replay rows (it owes the cloud
    nothing), and the stream is still the fault-free one."""
    got = _run(port, "never_back")
    assert got == reference["never_back"]
    assert _outs(got) == _outs(reference["oracle:never_back"])
    w = got["waves"][0]
    assert w["cloud_down"] and w["stats"]["resyncs"] == 0
    assert got["replay_slots"] == [] and got["pages_back"]


@pytest.mark.parametrize("name", ["sampled_outage", "sampled_admission"])
def test_sampled_stream_through_outage_is_fault_free(port, reference, name):
    """Sampled requests through an outage: the edge-only steps (and, for
    requests admitted while down, the edge-only prefill) draw from the
    ``CLOUD`` stream with the cloud's keys, so the lossless stream is the
    fault-free sampled one and the JAX engine's."""
    got = _run(port, name)
    assert got == reference[name]
    assert _outs(got) == _outs(reference["oracle:" + name])
    st = got["waves"][0]["stats"]
    assert st["edge_only_tokens"] > 0 and st["resyncs"] >= 1


def test_int8_mode_survives_corruption_and_outage(port, reference):
    """The INT8 default at k = 2 under corruption and an outage: the run
    completes, counts its faults, comes back up, and equals the JAX
    engine token for token."""
    got = _run(port, "int8_corrupt")
    assert got == reference["int8_corrupt"]
    w = got["waves"][0]
    assert all(len(o) == 16 for o in w["outs"])
    st = w["stats"]
    assert st["corrupt_msgs"] > 0 and st["edge_only_tokens"] > 0
    assert st["resyncs"] >= 1 and not w["cloud_down"]


def test_int8_serial_standby_matches_reference(port, reference):
    """The INT8 default at k = 1 (the standby's INT8 suffix copy, the
    replay into calibrated INT8 cloud pages) through two outages and
    drops: the JAX engine's streams and counters."""
    got = _run(port, "int8_serial")
    assert got == reference["int8_serial"]
    st = got["waves"][0]["stats"]
    assert st["resyncs"] == 2 and st["edge_only_tokens"] > 0
    assert got["pages_back"]


def test_naive_engine_stalls_through_outage(port, reference):
    """The baseline: the plain engine's blocking channel pays the whole
    outage as latency."""
    got = _run(port, "naive")
    assert got == reference["naive"]
    assert got["waves"][0]["stats"]["channel_latency_s"] >= 1.4
    assert got["faults"]["outage"] > 0


@pytest.mark.parametrize("name", ["outage_serial", "outage_admission",
                                  "heavy_drops"])
def test_resync_runs_on_the_shards_of_a_mesh(port, name):
    """With the cloud tensor-parallel over two shards the replay and the
    calibrating resync prefill run on the shards' caches: streams,
    counters, phase calls and clock equal the one-shard engine's."""
    want = _run(port, name)
    ns = RC.port_runner(port["PARAMS"])
    ns["DEV_KW"] = dict(ns["DEV_KW"], mesh=make_serve_mesh(model=2,
                                                           device="cpu"))
    got = _run(ns, name, cache={})
    assert got == want


def test_degraded_rounds_read_nothing_back(port, monkeypatch):
    """A fault-free run syncs the host as often as the plain engine's;
    an outage adds one read (the resume positions), and the edge-only
    rounds and the replay's rows stay on the device."""
    reads = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: (reads.append(1),
                                            real(t, *a, **k))[1])
    counts = {}
    for name, spec in (
            ("plain", dict(engine="oracle", plain=True,
                           faults=dict(seed=0), waves=[((9, 7, 11), 2, 12)])),
            ("clean", dict(engine="r1", faults=dict(seed=0),
                           waves=[((9, 7, 11), 2, 12)])),
            ("outage", RC.RUNS["outage_serial"])):
        reads.clear()
        res = port["run_spec"](port["CACHE"], spec)
        counts[name] = (len(reads), res["waves"][0]["stats"]["resyncs"])
    assert counts["clean"] == (counts["plain"][0], 0)
    assert counts["outage"] == (counts["plain"][0] + 1, 1)


def test_greedy_traffic_enters_no_sampled_phase(port):
    eng = port["engine"](port["CACHE"], "r1")
    for name in ("_edge_only_step_sample_impl",
                 "_edge_only_prefill_sample_impl",
                 "_cloud_prefill_sample_impl", "_cloud_decode_sample_impl"):
        setattr(eng, name, _refuse)
    try:
        got = _run(port, "outage_serial")
    finally:
        for name in ("_edge_only_step_sample_impl",
                     "_edge_only_prefill_sample_impl",
                     "_cloud_prefill_sample_impl",
                     "_cloud_decode_sample_impl"):
            delattr(eng, name)
    assert got["waves"][0]["stats"]["edge_only_tokens"] > 0


def _refuse(*a, **k):
    raise AssertionError("greedy traffic entered a sampled phase")
