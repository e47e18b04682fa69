"""Port parity: the mixture-of-experts layer of ``repro_torch.models.layers``
(``_route``, the static-capacity dispatch, ``_grouped_ffn``, ``moe``,
``moe_init``) against ``repro.models.layers`` on the same numpy-seeded
inputs and weights (twins of ``tests/test_transformer.py``'s MoE cases).

Tolerances: gates and the balance loss 1e-6 (softmax in f32, one ulp of
``exp`` apart); f32 outputs 1e-5 (outputs ~1); bf16 outputs 0.0625 with
outputs up to ~4 (bf16 products and sums in other orders: a few bf16
steps).  Exact: expert indices (at gate gaps well above f32 noise),
capacity, and which (token, k) pairs fall past their expert's capacity.
Ties of the gates go to the lower expert index, as ``lax.top_k`` breaks
them."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

D, F, E, K = 32, 48, 8, 2


@pytest.fixture(scope="module")
def params():
    p = JL.moe_init(jax.random.PRNGKey(3), D, F, E)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _dropped_reference(idx_k: np.ndarray, n_e: int, cap: int) -> np.ndarray:
    """The reference's drops, from its own indices by its own rule: the
    pairs sorted by expert with a stable sort, each expert keeping its
    first ``cap``."""
    flat = idx_k.reshape(-1)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(n_e))
    rank = np.empty_like(order)
    rank[order] = np.arange(flat.size)
    return (rank - starts[flat] >= cap).reshape(idx_k.shape)


def test_route_matches_reference(params):
    jp, tp = params
    xt = _x((64, D), seed=1)
    jg, ji, ja = JL._route(jp["router"], jnp.asarray(xt), E, K)
    tg, ti, ta = TL._route(tp["router"], torch.tensor(xt), E, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=1e-6)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    assert ta.dtype == torch.float32 and ta.ndim == 0


def test_route_ties_go_to_the_lower_index(params):
    """Experts 1, 4 and 6 get one column of router weights: their gates
    tie for every token; the reference (``lax.top_k``) and the port
    both take the lower indices first."""
    jp, tp = params
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 4] = w[:, 6] = w[:, 1] = 3.0 * np.abs(w[:, 1]).max()
    xt = np.abs(_x((16, D), seed=2))
    jg, ji, _ = JL._route({"w": jnp.asarray(w)}, jnp.asarray(xt), E, K)
    tg, ti, _ = TL._route({"w": torch.tensor(w)}, torch.tensor(xt), E, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == [1, 4]).all()
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 0.0625)])
def test_moe_matches_reference(params, dtype, atol):
    jp, _ = params
    jp = jax.tree_util.tree_map(lambda v: v.astype(dtype), jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = _x((4, 16, D), seed=3)
    jy, ja = JL.moe(jp, jnp.asarray(x, dtype), top_k=K)
    ty, ta = TL.moe(tp, torch.tensor(x).to(getattr(torch, dtype)), top_k=K)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == x.shape
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               atol=atol, rtol=atol)
    assert float(ta) == pytest.approx(float(ja), abs=1e-5)


@pytest.mark.parametrize("cf", [0.5, 1.0])
def test_capacity_overflow_drops_the_references_pairs(params, cf):
    """At capacity factor ``cf`` over 128 rows some experts overflow:
    the same capacity, the same pairs dropped, the same outputs (a
    dropped pair adds nothing; a token with all pairs dropped gets 0)."""
    jp, tp = params
    x = _x((2, 64, D), seed=4)
    xt = x.reshape(-1, D)
    _, ji, _ = JL._route(jp["router"], jnp.asarray(xt), E, K)
    _, ti, _ = TL._route(tp["router"], torch.tensor(xt), E, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    t = xt.shape[0]
    cap = TL.moe_capacity(t, K, E, cf)
    assert cap == max(int(cf * t * K / E), min(t * K, 32))
    plan = TL.moe_dispatch(ti, E, cap)
    want = _dropped_reference(np.asarray(ji), E, cap)
    np.testing.assert_array_equal(plan["pair_slot"].numpy() < 0, want)
    assert want.any()
    jy, _ = JL.moe(jp, jnp.asarray(x), top_k=K, capacity_factor=cf)
    ty, _ = TL.moe(tp, torch.tensor(x), top_k=K, capacity_factor=cf)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    gone = want.all(-1).reshape(2, 64)
    assert (_np(ty)[gone] == 0).all()


def test_dispatch_slots_hold_each_kept_pair_once():
    idx = torch.tensor([[2, 0], [2, 1], [0, 2], [2, 3]])
    plan = TL.moe_dispatch(idx, 4, 2)
    # expert 2's pairs in token order: tokens 0, 1 kept, token 2, 3 dropped
    assert plan["pair_slot"].tolist() == [[4, 0], [5, 2], [1, -1], [-1, 6]]
    # the slots that hold a pair gather that pair's token
    tok = plan["tok_for_slot"]
    for u, row in enumerate(plan["pair_slot"].tolist()):
        assert all(tok[s] == u for s in row if s >= 0)
    assert plan["slot"].tolist() == [[0, 1], [2, 3], [3, 4], [7, 7]]


def test_moe_routes_to_multiple_experts(params):
    """Twin of the reference test: balanced routing (aux near 1) and, at
    capacity 4.0 (nothing drops), reversing the tokens reverses the
    outputs."""
    jp, tp = params
    x = _x((2, 16, D), seed=7)
    y, aux = TL.moe(tp, torch.tensor(x), top_k=K)
    assert tuple(y.shape) == x.shape and float(aux) > 0.5
    y2, _ = TL.moe(tp, torch.tensor(x[:, ::-1].copy()), top_k=K,
                   capacity_factor=4.0)
    y1, _ = TL.moe(tp, torch.tensor(x), top_k=K, capacity_factor=4.0)
    np.testing.assert_allclose(_np(y1)[:, ::-1], _np(y2), rtol=1e-4,
                               atol=1e-5)
    jy1, _ = JL.moe(jp, jnp.asarray(x), top_k=K, capacity_factor=4.0)
    np.testing.assert_allclose(_np(y1), np.asarray(jy1), atol=1e-5)
    _, idx, _ = TL._route(tp["router"], torch.tensor(x.reshape(-1, D)), E, K)
    assert len(set(idx.flatten().tolist())) > K


def test_edge_quantctx_puts_the_experts_on_the_lattice(params):
    """With a ``QuantCtx``, ``wi``/``wg``/``wo`` go through its weight
    lattice (per last axis over E·D) and the router does not."""
    jp, tp = params
    x = _x((2, 8, D), seed=8)
    jy, _ = JL.moe(jp, jnp.asarray(x), top_k=K,
                   qctx=JL.QuantCtx(mode="dynamic"))
    ty, _ = TL.moe(tp, torch.tensor(x), top_k=K, qctx=TL.QuantCtx())
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5)
    fp, _ = TL.moe(tp, torch.tensor(x), top_k=K)
    assert not torch.allclose(ty, fp, atol=1e-6)


def test_two_runs_are_bit_identical(params):
    _, tp = params
    tp16 = {k: (v if k == "router" else v.to(torch.bfloat16))
            for k, v in tp.items()}
    for p, dt in ((tp, torch.float32), (tp16, torch.bfloat16)):
        x = torch.tensor(_x((4, 32, D), seed=9)).to(dt)
        a, _ = TL.moe(p, x, top_k=K, capacity_factor=0.75)
        b, _ = TL.moe(p, x, top_k=K, capacity_factor=0.75)
        assert torch.equal(a, b)


def test_moe_init_shapes_and_distributions():
    g = torch.Generator().manual_seed(0)
    p = TL.moe_init(g, 64, 96, 16, dtype=torch.bfloat16, device="cpu",
                    layers=3)
    assert tuple(p["router"]["w"].shape) == (3, 64, 16)
    assert tuple(p["wi"].shape) == tuple(p["wg"].shape) == (3, 16, 64, 96)
    assert tuple(p["wo"].shape) == (3, 16, 96, 64)
    for leaf, fan_in in ((p["router"]["w"], 64), (p["wi"], 64),
                         (p["wg"], 64), (p["wo"], 96)):
        assert leaf.dtype == torch.bfloat16
        assert float(leaf.float().std()) == pytest.approx(
            1 / math.sqrt(fan_in), rel=0.05)
    # each layer its own draw
    assert not torch.equal(p["wi"][0], p["wi"][1])
