"""Port parity: the fleet's stream isolation and shared weight bank
(``tests/test_fleet_serve.py``, its first three tests) against the JAX
fleet, on the JAX suite's ``fleet-tiny`` LM with weights from the JAX
``init_lm`` bridged by value (``tests/torch_fleet_common.py``).

* The lossless property: two tenants at Hypothesis-drawn (cut, k) over
  one bank and pool stream bit for bit as each tenant served alone on
  the port's solo engine, and every example equals the JAX fleet's
  replay of it: streams, every ``ServeStats`` field, ``round_calls``.
* The per-row-ranges invariant in the INT8 default: a tenant's fleet
  stream equals the port's solo engine at another ``max_batch``, and
  the whole run equals the JAX fleet's.
* Co-cut tenants share one runtime, every runtime's blocks are the
  bank's slices, and every cache has the pool's page count."""
import pytest

torch = pytest.importorskip("torch")

import torch_fleet_common as FC  # noqa: E402


@pytest.fixture(scope="module")
def params():
    return FC.bridged_params()


@pytest.fixture(scope="module")
def port(params):
    return FC.port_runner(params)


def _solo(port, params, spec, name, prompts, max_new):
    t = next(t for t in spec["tenants"] if t["name"] == name)
    return FC.solo(params, t, spec["conf"], prompts, max_new,
                   channel=port["channel"](t["ch"]))


@pytest.fixture(scope="module")
def prop_run(port, params):
    """The JAX suite's Hypothesis property on the port: each example's
    fleet streams against the port's solo engines.  Keeps the examples
    drawn, in order, for the JAX replay, with the port's results; a
    failure is kept for the test."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    seen, results = [], []

    @hyp.settings(max_examples=5, deadline=None)
    @hyp.given(cut_a=st.sampled_from([0, 1, 2]),
               cut_b=st.sampled_from([0, 1, 2]),
               k_a=st.sampled_from([1, 2, 4]),
               k_b=st.sampled_from([1, 2, 4]),
               seed=st.integers(min_value=0, max_value=2 ** 16))
    def prop(cut_a, cut_b, k_a, k_b, seed):
        ex = [cut_a, cut_b, k_a, k_b, seed]
        got = FC.jsonable(port["run_example"](ex))
        seen.append(ex)
        results.append(got)
        spec = port["example_spec"](ex)
        prompts = port["example_prompts"](spec)
        for name in ("a", "b"):
            assert got["outs"][name] == _solo(port, params, spec, name,
                                              prompts[name], 10)

    try:
        prop()
        error = None
    except Exception as e:             # re-raised by the property test
        error = e
    return dict(examples=seen, results=results, error=error)


@pytest.fixture(scope="module")
def reference(prop_run):
    return FC.reference({"runs": ["int8_isolation", "shared_bank"],
                         "examples": prop_run["examples"]})


def test_fleet_lossless_bit_identity_property(prop_run, reference):
    """Two tenants at random (cut, k) over one bank and pool: each
    tenant's fleet stream is its solo stream bit for bit (lossless), and
    every example equals the JAX fleet's, counters and rounds too."""
    if prop_run["error"] is not None:
        raise prop_run["error"]
    assert len(prop_run["examples"]) >= 5
    assert prop_run["results"] == reference["examples"]


def test_fleet_int8_bit_identity(port, params, reference):
    """The INT8 default keeps the isolation: per-row Eq.(1) ranges
    (``act_axis=0``) and per-slot KV scales make a tenant's stream its
    solo stream at another ``max_batch``; the run equals JAX's."""
    fleet, got = port["run_spec"](FC.RUNS["int8_isolation"])
    got = FC.jsonable(got)
    assert got == reference["int8_isolation"]
    spec = FC.RUNS["int8_isolation"]
    for name, (lens, seed) in spec["work"].items():
        want = _solo(port, params, spec, name, port["prompts"](lens, seed),
                     spec["max_new"])
        assert got["outs"][name] == want
    assert got["pages_back"]
    # two groups a turn ((0, 1) and (1, 4)) while both tenants are live
    st = got["stats"]
    assert got["round_calls"] == st["a"]["decode_steps"] + \
        st["b"]["decode_steps"]
    assert st["b"]["spec_rounds"] == st["b"]["decode_steps"] > 0
    assert st["a"]["spec_rounds"] == 0


def test_fleet_shares_one_cut_bank(port, reference):
    """Co-cut tenants share one ``_CutRuntime``; each runtime's blocks
    are the bank's cached slices (pointer identity, no weight copies),
    and every cache indexes the one pool's pages."""
    fleet, got = port["run_spec"](FC.RUNS["shared_bank"])
    assert FC.jsonable(got) == reference["shared_bank"]
    assert set(fleet._runtimes) == {1, 2}
    assert fleet._runtime(1) is fleet._runtime(1)
    for cut in (1, 2):
        rt = fleet._runtime(cut)
        edge, cloud, draft = fleet._bank.get(cut)
        assert rt.edge_blocks is edge and rt.cloud_blocks is cloud
        assert rt.draft_blocks is draft
        for c in (rt._edge_cache, rt._cloud_cache, rt._draft_cache):
            assert c["k_pages"].shape[1] == fleet._pool.allocator.num_pages
        assert rt._rope() is fleet._rope()
    # the views share the bank's storage: no per-runtime weight copy
    w1 = fleet._runtime(1).edge_blocks["attn"]["wq"]["w"]
    w2 = fleet._runtime(2).edge_blocks["attn"]["wq"]["w"]
    assert w1.untyped_storage().data_ptr() == \
        w2.untyped_storage().data_ptr()
    assert all(len(o) == 4 for v in got["outs"].values() for o in v)
