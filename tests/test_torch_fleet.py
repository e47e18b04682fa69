"""Port parity, host side: the fleet's control plane in ``repro_torch``
against ``repro`` (the host half of ``tests/test_fleet_serve.py``),
side by side in this process and exact.

* ``FleetFairness``: virtual service, admission keys, fair shares,
  quotas and victim keys over Hypothesis sequences of charges.
* ``_PagedPool`` owner accounting: both packages' pools driven through
  the same ``admit(owner=)`` / ``ensure`` / ``retire`` interleavings,
  with ``owner_pages``, ``slot_owner``, the free lists and the block
  tables equal after every step.
* ``TenantSpec`` and ``_Tenant``: defaults, clocks and waits on a
  clockless, a faulty and a drifting channel.
* The fleet's entry point: configuration errors, the device rule and
  the package exports."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hyp = pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import costmodel as JC  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve import kvcache as JK  # noqa: E402
from repro.serve import policy as JP  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro.serve import tenant as JTN  # noqa: E402
from repro.serve import transport as JTR  # noqa: E402
from repro_torch.core import costmodel as TC  # noqa: E402
from repro_torch.models.transformer import LMConfig, init_lm  # noqa: E402
from repro_torch.serve import faults as TF  # noqa: E402
from repro_torch.serve import kvcache as TK  # noqa: E402
from repro_torch.serve import policy as TP  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
from repro_torch.serve import tenant as TTN  # noqa: E402
from repro_torch.serve import transport as TTR  # noqa: E402

CFG = LMConfig(name="fleet-tiny", n_layers=3, d_model=32, n_heads=4, n_kv=2,
               d_ff=64, vocab=64)


def _req(mod, uid, tenant, priority=0, seq=None):
    r = mod.Request(uid=uid, prompt=np.zeros(4, np.int32), max_new_tokens=4,
                    priority=priority)
    r.tenant = tenant
    r._seq = uid if seq is None else seq
    return r


# ---------------------------------------------------------------------------
# FleetFairness
# ---------------------------------------------------------------------------


def test_fairness_keys():
    """tests/test_fleet_serve.py::test_fleet_fairness_keys on the port."""
    ff = TP.FleetFairness({"a": 3.0, "b": 1.0}, quotas={"a": None, "b": 4})
    ff.charge("a", 9)
    ff.charge("b", 3)
    assert ff.vservice["a"] == pytest.approx(3.0)
    assert ff.vservice["b"] == pytest.approx(3.0)
    ra, rb = _req(TS, 0, "a"), _req(TS, 1, "b")
    ff.charge("b", 1)
    assert ff.admission_key(ra) < ff.admission_key(rb)
    assert not ff.over_quota("a", 100) and ff.over_quota("b", 5)
    assert ff.fair_pages("a", 16) == pytest.approx(12.0)
    with pytest.raises(ValueError):
        TP.FleetFairness({"a": 0.0})


@settings(max_examples=40, deadline=None)
@given(weights=st.lists(st.floats(min_value=0.25, max_value=8.0),
                        min_size=1, max_size=4),
       quotas=st.lists(st.one_of(st.none(), st.integers(0, 12)),
                       min_size=4, max_size=4),
       charges=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 9)),
                        max_size=30),
       probe=st.tuples(st.integers(0, 20), st.integers(1, 40),
                       st.integers(-2, 2), st.integers(0, 30)))
def test_fairness_matches_reference(weights, quotas, charges, probe):
    names = [f"t{i}" for i in range(len(weights))]
    w = dict(zip(names, weights))
    q = dict(zip(names, quotas))
    ours, ref = TP.FleetFairness(w, q), JP.FleetFairness(w, q)
    held, usable, prio, remaining = probe
    for i, n in charges:
        name = names[i % len(names)]
        ours.charge(name, n)
        ref.charge(name, n)
        assert ours.vservice == ref.vservice
        for j, t in enumerate(names):
            mine, theirs = (_req(TS, j, t, prio, seq=5 - j),
                            _req(JS, j, t, prio, seq=5 - j))
            assert ours.admission_key(mine) == ref.admission_key(theirs)
            assert ours.victim_key(mine, held, usable, remaining) == \
                ref.victim_key(theirs, held, usable, remaining)
            assert ours.fair_pages(t, usable) == ref.fair_pages(t, usable)
            assert ours.over_quota(t, held) == ref.over_quota(t, held)
    assert ours.quotas == ref.quotas and ours.weights == ref.weights


# ---------------------------------------------------------------------------
# Per-owner page accounting
# ---------------------------------------------------------------------------


def _pools(max_batch=4, max_len=32, page=4, num_pages=14):
    return (TK._PagedPool.build(max_batch, max_len, page, num_pages,
                                torch.device("cpu")),
            JK._PagedPool.build(max_batch, max_len, page, num_pages))


def _same(ours, ref, owners):
    assert ours.allocator._free == ref.allocator._free
    assert ours.allocator.live == ref.allocator.live
    assert np.array_equal(ours.bt, ref.bt)
    assert ours._slot_pages == ref._slot_pages
    for o in owners:
        assert ours.owner_pages(o) == ref.owner_pages(o)
    for s in range(ours.bt.shape[0]):
        assert ours.slot_owner(s) == ref.slot_owner(s)
    # every page a tagged slot holds is counted once, on its owner
    held = {o: 0 for o in owners}
    for s, pages in ours._slot_pages.items():
        if ours.slot_owner(s) is not None:
            held[ours.slot_owner(s)] += len(pages)
    assert held == {o: ours.owner_pages(o) for o in owners}


_OP = st.one_of(
    st.tuples(st.just("admit"), st.integers(0, 3), st.integers(1, 12),
              st.integers(0, 12), st.sampled_from(["x", "y", None])),
    st.tuples(st.just("ensure"), st.integers(0, 3), st.integers(1, 32)),
    st.tuples(st.just("retire"), st.integers(0, 3)))


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(_OP, max_size=25))
def test_owner_accounting_matches_reference(ops):
    """The same interleaving of owner-tagged admissions, demand growths
    (some exhausting the pool) and retirements on both pools."""
    ours, ref = _pools()
    owners = ("x", "y")
    for op in ops:
        kind, slot = op[0], op[1]
        if kind == "admit":
            if ours.pages_held(slot):
                continue
            plen, max_new, owner = op[2], op[3], op[4]
            bucket = TS._bucket_len(plen, 32)
            if not ours.can_admit([(plen, max_new)], bucket):
                assert not ref.can_admit([(plen, max_new)], bucket)
                continue
            rows = ours.admit([slot], [plen], [max_new], bucket, owner=owner)
            want = ref.admit([slot], [plen], [max_new], bucket, owner=owner)
            assert np.array_equal(rows.numpy(), np.asarray(want))
        elif kind == "ensure":
            if not ours.pages_held(slot):
                continue
            outcome = []
            for pool in (ours, ref):
                try:
                    outcome.append(pool.ensure(slot, op[2]))
                except RuntimeError as e:
                    outcome.append(type(e).__name__)
            assert outcome[0] == outcome[1]
        else:
            ours.retire(slot)
            ref.retire(slot)
        _same(ours, ref, owners)
        live = [s for s in range(4) if ours.pages_held(s)]
        if live:
            assert np.array_equal(ours.table_for(live[:1]).numpy(),
                                  np.asarray(ref.table_for(live[:1])))


def test_owner_accounting_survives_exhaustion():
    ours, _ = _pools(max_len=16, num_pages=6)
    ours.admit([0], [4], [0], 8, owner="x")            # 2 pages
    ours.admit([1], [4], [0], 8, owner="y")            # 2 pages
    assert (ours.owner_pages("x"), ours.owner_pages("y")) == (2, 2)
    with pytest.raises(TK.PoolExhausted):
        ours.ensure(0, 16)                              # needs 2 more, 1 free
    assert ours.owner_pages("x") == 2 and ours.pages_held(0) == 2
    assert ours.ensure(0, 12)
    assert ours.owner_pages("x") == 3
    ours.retire(0)
    assert ours.owner_pages("x") == 0 and ours.slot_owner(0) is None
    assert ours.owner_pages("y") == 2 and ours.slot_owner(1) == "y"
    ours.admit([2], [4], [0], 8)                        # untagged
    assert ours.slot_owner(2) is None
    assert ours.owner_pages("x") + ours.owner_pages("y") == 2


# ---------------------------------------------------------------------------
# Tenants: spec defaults, clocks, waits
# ---------------------------------------------------------------------------


def test_tenant_spec_defaults_match_reference():
    ours, ref = TTN.TenantSpec("e"), JTN.TenantSpec("e")
    assert vars(ours) == vars(ref)
    assert TS.Request(uid=0, prompt=np.zeros(1, np.int32)).tenant is None


def _channels(mod_c, mod_f, mod_t):
    base = mod_c.Channel.from_kbps(500, rtt_ms=40)
    return [None, base,
            mod_f.FaultyChannel(base, seed=3, drop_p=0.3,
                                outages=[(0.1, 0.4)], rto_s=0.05),
            mod_t.DriftingChannel([(0.0, base),
                                   (0.2, mod_c.Channel.from_kbps(50))])]


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_tenant_clock_and_waits_match_reference(which):
    ch_t = _channels(TC, TF, TTR)[which]
    ch_j = _channels(JC, JF, JTR)[which]
    ours = TTN._Tenant(TTN.TenantSpec("e", ch_t, cut_layer=1, spec_k=2),
                       None)
    ref = JTN._Tenant(JTN.TenantSpec("e", ch_j, cut_layer=1, spec_k=2),
                      None)
    assert (ours.cut, ours.spec_k, ours.hold, ours.pending) == \
        (ref.cut, ref.spec_k, ref.hold, ref.pending)
    for step, nbytes in enumerate((4096, 12, 30000, 700, 5, 250000)):
        assert ours.now() == ref.now()
        assert ours.wait(0.013 * step) == ref.wait(0.013 * step)
        assert ours.wait(-1.0) == ref.wait(-1.0)
        ours.transport.charge(ours.stats, nbytes, phase="decode")
        ref.transport.charge(ref.stats, nbytes, phase="decode")
        assert ours.stats.stall_wait_s == ref.stats.stall_wait_s
        assert ours.stats.channel_latency_s == ref.stats.channel_latency_s
        assert ours.telemetry.bandwidth_bytes_per_s == \
            ref.telemetry.bandwidth_bytes_per_s
    assert ours.now() == ref.now()
    clockless = which in (0, 1)
    assert ours.wait(1.0) is (not clockless)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_params():
    return init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")


def test_fleet_rejects_bad_configurations(tiny_params):
    from repro_torch.serve import FleetServingEngine, TenantSpec
    kw = dict(max_batch=2, max_len=32, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="at least one tenant"):
        FleetServingEngine(tiny_params, CFG, [], **kw)
    with pytest.raises(ValueError, match="unique"):
        FleetServingEngine(tiny_params, CFG, [TenantSpec("a"),
                                              TenantSpec("a")], **kw)
    with pytest.raises(ValueError, match="cut_layer"):
        FleetServingEngine(tiny_params, CFG,
                           [TenantSpec("a", cut_layer=3)], **kw)
    with pytest.raises(ValueError, match="cloud block"):
        FleetServingEngine(tiny_params, CFG,
                           [TenantSpec("a", cut_layer=2, policy="auto")],
                           **kw)
    fleet = FleetServingEngine(tiny_params, CFG, [TenantSpec("a")], **kw)
    with pytest.raises(KeyError, match="unknown tenant"):
        fleet.generate({"b": [np.zeros(3, np.int32)]})
    with pytest.raises(ValueError, match="max_len"):
        fleet.generate({"a": [np.zeros(30, np.int32)]}, max_new_tokens=8)


def test_fleet_without_device_raises_when_no_card(tiny_params, monkeypatch):
    from repro_torch.serve import FleetServingEngine, TenantSpec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetServingEngine(tiny_params, CFG, [TenantSpec("a")])


def test_package_exports_the_fleet():
    import repro.serve as J
    import repro_torch.serve as T
    for name in ("FleetServingEngine", "TenantSpec", "FleetFairness"):
        assert name in T.__all__ and name in J.__all__
        assert getattr(T, name).__name__ == getattr(J, name).__name__
    assert T.FleetFairness is TP.FleetFairness
    assert T.TenantSpec is TTN.TenantSpec
