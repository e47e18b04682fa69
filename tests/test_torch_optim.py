"""Port parity: ``repro_torch.train.optim`` against ``repro.train.optim``
on the same gradients and state (the reference called eagerly).

Tolerances: with the global norm under ``grad_clip`` (the clip is then
the identity) the moments are exact — f32 ``m``/``v``, and the 8-bit
state's ``m_q``, ``v_q`` and scales — since they do not involve the
bias corrections; parameters within 2e-6 relative (XLA's and torch's f32
``pow`` may differ by an ulp in ``1 - b ** step``); under an active clip
everything within 1e-5 (the norm's summation order).  Layer-at-a-time
updates equal whole-leaf ones bit for bit.  Schedule values within 1e-6
(the f32 ``cos``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optim as JO  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy,  # noqa: E402
                                params_from_numpy, tree_leaves)
from repro_torch.train import optim as TO  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SHAPES = {"stack": (3, 8, 256), "mat": (4, 256), "odd": (5, 100),
          "vec": (7,), "scalar": ()}


def _tree(rng, scale=1.0, dtype=np.float32):
    return {k: np.asarray(rng.randn(*s) * scale, dtype)
            for k, s in SHAPES.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return params_from_numpy(tree, device="cpu")


def _run(kind, steps, grad_scale, cfg, pdtype=jnp.float32, lr=None):
    """``steps`` updates of both packages from one state → (reference
    params, state; port params, state)."""
    rng = np.random.RandomState(0)
    jp = {k: jnp.asarray(v, pdtype) for k, v in _tree(rng).items()}
    init, upd = ((JO.adamw_init, JO.adamw_update) if kind == "f32"
                 else (JO.adamw8bit_init, JO.adamw8bit_update))
    js = init(jp)
    tp = _to_torch(_np(jp))
    ts = opt_state_from_numpy(_np(js), device="cpu")
    tupd = TO.adamw_update if kind == "f32" else TO.adamw8bit_update
    tlr = None if lr is None else torch.tensor(np.asarray(lr))
    for _ in range(steps):
        g = _tree(rng, grad_scale)
        jg = {k: jnp.asarray(v, pdtype) for k, v in g.items()}
        jp, js, jn = upd(jg, js, jp, cfg, lr=lr)
        tp, ts, tn = tupd(_to_torch(_np(jg)), ts, tp, cfg, lr=tlr)
    return jp, js, jn, tp, ts, tn


@pytest.mark.parametrize("pdtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_adamw_matches_reference_under_the_clip(pdtype):
    jp, js, jn, tp, ts, tn = _run("f32", 4, 0.05, JO.AdamWConfig(
        lr=1e-2, grad_clip=1e3), pdtype)
    assert int(ts.step) == int(js.step) == 4
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_array_equal(ts.m[k].numpy(), np.asarray(js.m[k]))
        np.testing.assert_array_equal(ts.v[k].numpy(), np.asarray(js.v[k]))
        want = np.asarray(jp[k].astype(jnp.float32))
        tol = 2e-6 if pdtype == jnp.float32 else 8e-3
        np.testing.assert_allclose(tp[k].float().numpy(), want, rtol=tol,
                                   atol=tol * 1e-2)
    assert tp["mat"].dtype == (torch.float32 if pdtype == jnp.float32
                               else torch.bfloat16)


def test_adamw_matches_reference_when_clipping():
    jp, js, jn, tp, ts, tn = _run("f32", 3, 3.0,
                                  JO.AdamWConfig(lr=1e-2, grad_clip=1.0))
    assert float(jn) > 1.0
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


def test_adamw_with_a_scheduled_lr():
    lr = JO.cosine_schedule(1e-2, 2, 10)(jnp.int32(3))
    jp, js, _, tp, ts, _ = _run("f32", 1, 0.05, JO.AdamWConfig(
        grad_clip=1e3), lr=lr)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=2e-6, atol=1e-8)


@pytest.mark.parametrize("pdtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_8bit_lattices_exact_under_the_clip(pdtype):
    jp, js, jn, tp, ts, tn = _run("8bit", 4, 0.05, JO.AdamWConfig(
        lr=1e-2, grad_clip=1e3), pdtype)
    for f in ("m_q", "m_scale", "v_q", "v_scale"):
        for k in SHAPES:
            got, want = getattr(ts, f)[k], np.asarray(getattr(js, f)[k])
            assert tuple(got.shape) == want.shape, (f, k)
            assert str(got.dtype).split(".")[1] == str(want.dtype), (f, k)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f + k)
    for k in SHAPES:
        tol = 2e-6 if pdtype == jnp.float32 else 8e-3
        np.testing.assert_allclose(
            tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32)),
            rtol=tol, atol=tol * 1e-2)


def test_8bit_matches_reference_when_clipping():
    jp, js, _, tp, ts, _ = _run("8bit", 3, 3.0,
                                JO.AdamWConfig(lr=1e-2, grad_clip=1.0))
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
        # a lattice point may move by one where the clip's ulp tips it
        diff = np.abs(ts.m_q[k].numpy().astype(int)
                      - np.asarray(js.m_q[k]).astype(int))
        assert diff.max() <= 1


def test_8bit_state_shapes_match_reference():
    rng = np.random.RandomState(2)
    jp = {k: jnp.asarray(v) for k, v in _tree(rng).items()}
    js = JO.adamw8bit_init(jp)
    ts = TO.adamw8bit_init(_to_torch(_np(jp)))
    for f in ("m_q", "m_scale", "v_q", "v_scale"):
        for k in SHAPES:
            want = np.asarray(getattr(js, f)[k])
            np.testing.assert_array_equal(getattr(ts, f)[k].numpy(), want)
    # m and v are separate tensors (the updates write in place)
    assert ts.m_q["mat"].data_ptr() != ts.v_q["mat"].data_ptr()


@pytest.mark.parametrize("kind", ["f32", "8bit"])
def test_layerwise_update_equals_whole_leaf(kind, monkeypatch):
    init, upd = ((TO.adamw_init, TO.adamw_update) if kind == "f32"
                 else (TO.adamw8bit_init, TO.adamw8bit_update))
    cfg = TO.AdamWConfig(lr=1e-2, grad_clip=1e3)   # the clip: identity
    rng = np.random.RandomState(3)
    base = _to_torch(_tree(rng))
    runs = []
    # row blocks of the rank-2 leaves too at this size; then whole leaves
    for patch in ({"_ROW_BLOCK_ELEMS": 256},
                  {"_slices": lambda p: iter([...])}):
        with monkeypatch.context() as mp:
            for name, value in patch.items():
                mp.setattr(TO, name, value)
            p = {k: v.clone() for k, v in base.items()}
            s = init(p)
            for step in range(3):
                g = _to_torch(_tree(np.random.RandomState(10 + step), 2.0))
                p, s, _ = upd(g, s, p, cfg)
            runs.append((p, s))
    (p1, s1), (p2, s2) = runs
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)


def test_cosine_schedule_matches():
    jlr = JO.cosine_schedule(3e-4, 7, 50)
    tlr = TO.cosine_schedule(3e-4, 7, 50)
    for s in range(0, 60):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.int32(s))), rtol=1e-6, atol=1e-12)


def test_global_norm_and_clip_match():
    rng = np.random.RandomState(4)
    g = _tree(rng, 2.0)
    jc, jn = JO.clip_by_global_norm({k: jnp.asarray(v) for k, v in
                                     g.items()}, 1.0)
    tc, tn = TO.clip_by_global_norm(_to_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-9)


# --------------------- twins of test_substrate / test_optim8bit -------------

def test_adamw_converges_on_quadratic():
    p = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    opt = TO.adamw_init(p)
    cfg = TO.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        g = {"w": 2 * p["w"], "b": 2 * p["b"]}
        p, opt, _ = TO.adamw_update(g, opt, p, cfg)
    assert float(torch.sum(p["w"] ** 2) + p["b"] ** 2) < 1e-3
    assert int(opt.step) == 200


def test_grad_clip_bounds_norm():
    clipped, norm = TO.clip_by_global_norm({"a": torch.full((4,), 100.0)},
                                           1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.sqrt(torch.sum(clipped["a"] ** 2))) == \
        pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape():
    lr = TO.cosine_schedule(1.0, warmup=10, total=100)
    at = lambda s: float(lr(torch.tensor(s, dtype=torch.int32)))
    assert at(0) == 0.0
    assert at(10) == pytest.approx(1.0, abs=1e-6)
    assert at(100) == pytest.approx(0.0, abs=1e-6)
    assert at(55) == pytest.approx(0.5, abs=0.01)


def test_blockwise_roundtrip_error_bounded():
    rng = np.random.RandomState(0)
    x = torch.tensor(np.concatenate([rng.randn(4, 128) * 1e-4,
                                     rng.randn(4, 128) * 10.0],
                                    axis=1).astype(np.float32))
    q, s = TO._blockwise_quantize(x, signed=True)
    back = TO._blockwise_dequantize(q, s)
    rel = (torch.abs(back - x) / (torch.abs(x) + 1e-12)).numpy()
    assert np.median(rel) < 0.01
    assert q.dtype == torch.int8
    assert tuple(s.shape) == (4, 2)


def test_blockwise_handles_odd_shapes():
    x = torch.tensor(np.random.RandomState(1).randn(7).astype(np.float32))
    q, s = TO._blockwise_quantize(x, signed=True)
    back = TO._blockwise_dequantize(q, s)
    assert float(torch.max(torch.abs(back - x))) < float(s) * 1.01


@pytest.mark.parametrize("shape", [(4, 128), (7,), (2, 3, 256)])
def test_blockwise_quantize_matches_reference(shape):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32) * 3
    jq, js = JO._blockwise_quantize(jnp.asarray(x), signed=True)
    tq, ts = TO._blockwise_quantize(torch.tensor(x), signed=True)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TO._blockwise_dequantize(tq, ts).numpy(),
        np.asarray(JO._blockwise_dequantize(jq, js)))


def test_8bit_adamw_converges_like_fp32():
    cfg = TO.AdamWConfig(lr=0.05, weight_decay=0.0)
    p32, p8 = {"w": torch.zeros(256)}, {"w": torch.zeros(256)}
    o32, o8 = TO.adamw_init(p32), TO.adamw8bit_init(p8)
    loss = lambda p: float(torch.sum((p["w"] - 3.0) ** 2))
    for _ in range(300):
        p32, o32, _ = TO.adamw_update({"w": 2 * (p32["w"] - 3.0)}, o32, p32,
                                      cfg)
        p8, o8, _ = TO.adamw8bit_update({"w": 2 * (p8["w"] - 3.0)}, o8, p8,
                                        cfg)
    assert loss(p8) < 1e-2
    assert abs(loss(p8) - loss(p32)) < 1e-2


def test_8bit_state_is_4x_smaller():
    p = {"w": torch.zeros((512, 512), dtype=torch.bfloat16)}
    nbytes = lambda t: sum(l.numel() * l.element_size()
                           for l in tree_leaves(t))
    assert nbytes(TO.adamw8bit_init(p)) < nbytes(TO.adamw_init(p)) / 3.5
