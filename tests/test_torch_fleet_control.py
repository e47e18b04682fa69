"""Port parity: sampled co-batching and per-tenant re-tuning in the
fleet against the JAX fleet, on the JAX suite's ``fleet-tiny`` LM with
weights from the JAX ``init_lm`` bridged by value
(``tests/torch_fleet_common.py``).

* ``tests/test_sampled_spec.py::test_fleet_cobatching_keeps_sampled_stream_bit_identical``:
  a sampled tenant's fleet stream equals the same requests on the solo
  engine; the whole run equals the JAX fleet's.
* A ``policy="auto"`` tenant over a ``DriftingChannel`` beside a fixed
  tenant: its decisions, holds and switches equal JAX's, and the fixed
  tenant never holds (no fleet-wide drain barrier).
* Greedy fleet traffic never enters a sampled phase."""
import pytest

torch = pytest.importorskip("torch")

import torch_fleet_common as FC  # noqa: E402
from repro_torch.serve import SamplingParams  # noqa: E402
from repro_torch.serve import tenant as TTN  # noqa: E402

SAMPLED_PHASES = ("_cloud_prefill_sample_impl", "_cloud_decode_sample_impl",
                  "_spec_draft_sample_impl", "_verify_sample_impl")


@pytest.fixture(scope="module")
def params():
    return FC.bridged_params()


@pytest.fixture(scope="module")
def port(params):
    return FC.port_runner(params)


@pytest.fixture(scope="module")
def reference():
    return FC.reference({"runs": ["sampled_cobatch", "auto_drift"]})


def test_fleet_cobatching_keeps_sampled_stream_bit_identical(port, params,
                                                             reference):
    """Co-batched greedy neighbours, the shared pool and group-masked
    rounds never perturb a sampled tenant's per-request key streams."""
    spec = FC.RUNS["sampled_cobatch"]
    _, got = port["run_spec"](spec)
    got = FC.jsonable(got)
    assert got == reference["sampled_cobatch"]
    a = next(t for t in spec["tenants"] if t["name"] == "a")
    want = FC.solo(params, a, "lossless", port["prompts"]([6, 9], 8), 8,
                   max_batch=4, sampling=SamplingParams(**FC.SP))
    assert got["outs"]["a"] == want
    # the greedy neighbour's stream is its greedy solo stream
    b = next(t for t in spec["tenants"] if t["name"] == "b")
    assert got["outs"]["b"] == FC.solo(params, b, "lossless",
                                       port["prompts"]([7], 9), 8,
                                       max_batch=4)


def test_auto_tenant_over_drifting_channel_matches_reference(port,
                                                             reference):
    """A tenant's own ``AdaptivePolicy`` decides from its own telemetry
    and applies switches at its own drained boundary: its decisions
    (with their predicted costs), holds, switches, clock and streams
    equal the JAX fleet's, and the fixed tenant never holds."""
    fleet, got = port["run_spec"](FC.RUNS["auto_drift"])
    got = FC.jsonable(got)
    assert got == reference["auto_drift"]
    auto, fixed = got["stats"]["auto"], got["stats"]["fixed"]
    assert len(got["history"]["auto"]) >= 1
    assert auto["policy_holds"] >= 1
    assert auto["spec_k_switches"] + auto["cut_switches"] >= 1
    assert got["state"]["auto"] != [1, 1] and got["state"]["fixed"] == [1, 1]
    assert fixed["policy_holds"] == 0
    assert fixed["spec_k_switches"] == fixed["cut_switches"] == 0
    pol = fleet.tenant("auto").policy
    assert pol.cuts == (0, 1) and pol.ks == (1, 2, 4, 8)
    assert fleet.tenant("fixed").policy is None
    assert fleet._spec_max == 8 and got["pages_back"]


def test_greedy_fleet_enters_no_sampled_phase(port, monkeypatch):
    """An all-greedy fleet, drafting and serial groups alike, never
    calls a sampled phase."""
    def refuse(*a, **k):
        raise AssertionError("greedy traffic entered a sampled phase")
    for name in SAMPLED_PHASES:
        monkeypatch.setattr(TTN._CutRuntime, name, refuse)
    _, got = port["run_spec"](FC.RUNS["int8_isolation"])
    assert all(len(o) == 12 for v in got["outs"].values() for o in v)
