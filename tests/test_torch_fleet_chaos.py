"""Port parity: the fleet's weighted-fair sharing and per-tenant fault
isolation (``tests/test_fleet_serve.py``, its last five tests) against
the JAX fleet, on the JAX suite's ``fleet-tiny`` LM with weights from
the JAX ``init_lm`` bridged by value (``tests/torch_fleet_common.py``).

Each run equals the JAX fleet's exactly: every tenant's streams and
``ServeStats`` fields, ``round_calls``, each request's preemptions and
times, every channel's clock, faults and attempts, the quota peaks and
the pool's state at the end.  On top, each test asserts what its JAX
twin asserts of the port."""
import pytest

torch = pytest.importorskip("torch")

import torch_fleet_common as FC  # noqa: E402

RUNS = ("quota", "preemption", "gauges", "chaos_outage", "chaos_all")


@pytest.fixture(scope="module")
def params():
    return FC.bridged_params()


@pytest.fixture(scope="module")
def port(params):
    return FC.port_runner(params)


@pytest.fixture(scope="module")
def reference():
    return FC.reference({"runs": list(RUNS)})


def _run(port, reference, name):
    fleet, got = port["run_spec"](FC.RUNS[name])
    got = FC.jsonable(got)
    assert got == reference[name]
    return fleet, got


def _full(got, n):
    return all(len(o) == n for v in got["outs"].values() for o in v)


def test_fleet_page_quota_bounds_footprint(port, reference):
    """A quota'd tenant's page footprint never exceeds ``max_pages``;
    the quota serializes its requests while the uncapped tenant keeps
    both of its requests resident, and every stream completes."""
    _, got = _run(port, reference, "quota")
    assert got["peaks"]["hog"] <= 2 < got["peaks"]["meek"]
    assert _full(got, 8) and got["pages_back"]
    assert got["owner_pages"] == {"hog": 0, "meek": 0}


def test_fleet_cross_tenant_preemption(port, reference):
    """Under pool pressure the over-share tenant is preempted and
    resumed; the light tenant is never the victim and both finish."""
    _, got = _run(port, reference, "preemption")
    st = got["stats"]
    assert st["hog"]["preemptions"] >= 1
    assert st["meek"]["preemptions"] == 0
    assert sum(r["preemptions"] for r in got["reqs"]["hog"]) == \
        st["hog"]["preemptions"]
    assert _full(got, 18) and got["pages_back"]


def test_stats_expose_pool_gauges(port, reference):
    """``ServeStats`` carries the shared pool's free-page and
    utilization gauges, per tenant and on the fleet aggregate."""
    fleet, got = _run(port, reference, "gauges")
    st = got["stats"]["a"]
    assert st["pool_utilization_peak"] > 0.0
    assert 0 <= st["pool_free_pages"] < got["free_pages"] \
        <= fleet._pool.allocator.num_pages - 1
    assert 0.0 < st["pool_utilization"] <= st["pool_utilization_peak"] <= 1.0
    assert got["fleet_stats"]["pool_utilization_peak"] == \
        st["pool_utilization_peak"]


def test_fleet_chaos_outage_isolation(port, params, reference):
    """A storm tenant (drops, corruption, a long outage) beside a calm
    one: both complete, the storm pays its fault time on its own clock,
    and the calm tenant's stream equals a storm-free solo run."""
    _, got = _run(port, reference, "chaos_outage")
    assert _full(got, 8)
    assert sum(got["faults"]["storm"].values()) > 0
    assert sum(got["faults"]["calm"].values()) == 0
    assert got["clocks"]["storm"] > 0.8 > got["clocks"]["calm"]
    spec = FC.RUNS["chaos_outage"]
    calm = next(t for t in spec["tenants"] if t["name"] == "calm")
    want = FC.solo(params, calm, "int8", port["prompts"]([6, 6], 1), 8,
                   channel=port["channel"](FC.FAST))
    assert got["outs"]["calm"] == want


def test_fleet_chaos_every_tenant_faulted(port, reference):
    """Four tenants under distinct seeded fault schedules keep
    committing; each tenant's wire bytes and waits stay on its own
    ``ServeStats``."""
    _, got = _run(port, reference, "chaos_all")
    agg = got["fleet_stats"]
    for n, st in got["stats"].items():
        assert all(len(o) == 8 for o in got["outs"][n])
        # 2 requests x 7 decode-committed tokens (the 8th of each
        # stream is the prefill's)
        assert st["decode_tokens"] == 14
        assert 0 < st["transmitted_bytes"] < agg["transmitted_bytes"]
    assert agg["decode_tokens"] == 4 * 14
    assert agg["transmitted_bytes"] == sum(
        st["transmitted_bytes"] for st in got["stats"].values())
