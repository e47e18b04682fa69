"""Port parity: the clipped straight-through estimator, QAT, the
percentile and EMA calibrators and INT8 gradient compression, against
``repro.core.quant``, ``repro.train.qat`` and
``repro.train.grad_compress``.

Tolerances: the STE's forward equal bit for bit to the plain round trip;
its gradient equal exactly to ``jax.grad`` of the reference's (a mask
times the cotangent); calibrator zero points and scales exact (the same
f32 arithmetic on the same thresholds); compression lattices exact,
transmitted values and error state within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import grad_compress as JG  # noqa: E402
from repro.train.qat import make_qat_loss as jmake_qat_loss  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.train import grad_compress as TG  # noqa: E402
from repro_torch.train.grads import (value_and_grad_into,  # noqa: E402
                                     zeros_like_tree)
from repro_torch.train.qat import make_qat_loss  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _qps(scale, zp, axis, bits=8, signed=True):
    """The same quantization parameters in both packages."""
    j = JQ.QuantParams(scale=jnp.asarray(scale), zero_point=jnp.asarray(zp),
                       axis=axis, bits=bits, signed=signed)
    t = TQ.QuantParams(scale=torch.tensor(scale), zero_point=torch.tensor(zp),
                       axis=axis, bits=bits, signed=signed)
    return j, t


def _edge_inputs(scale, zp, qmin, qmax, rng, n=64):
    """x whose ``x / scale + zp`` lands exactly on and beside the ±0.5
    edges of the lattice (power-of-two scales keep it exact)."""
    t = np.concatenate([
        [qmin - 0.5, qmax + 0.5, qmin - 0.5 - 2 ** -7, qmax + 0.5 + 2 ** -7,
         qmin - 0.5 + 2 ** -7, qmax + 0.5 - 2 ** -7, qmin - 3.0, qmax + 3.0,
         0.5, -0.5],
        rng.uniform(qmin - 4, qmax + 4, n)]).astype(np.float32)
    return ((t - zp) * scale).astype(np.float32)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["tensor", "channel"])
def test_ste_gradient_equals_jax_grad(per_channel, signed):
    rng = np.random.RandomState(0)
    qmin, qmax = (-128, 127) if signed else (0, 255)
    if per_channel:
        scale = np.array([2.0 ** -4, 2.0 ** -2, 0.5], np.float32)
        zp = np.array([3.0, -7.0, 0.0], np.float32)
        cols = [_edge_inputs(s, z, qmin, qmax, rng) for s, z in
                zip(scale, zp)]
        x = np.stack(cols, axis=1)                         # [74, 3]
        axis = 1
    else:
        scale, zp = np.float32(2.0 ** -3), np.float32(5.0)
        x = _edge_inputs(scale, zp, qmin, qmax, rng).reshape(2, -1)
        axis = None
    jqp, tqp = _qps(scale, zp, axis, signed=signed)
    ct = rng.randn(*x.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda v: JQ.fake_quant(v, jqp), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    out = TQ.fake_quant(xt, tqp)
    out.backward(torch.tensor(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))
    # the edges themselves pass the gradient, their outer neighbours not
    mask = np.asarray(jgrad) != 0
    assert mask.any() and not mask.all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [None, 1])
def test_ste_forward_is_the_plain_round_trip(axis, dtype):
    x = torch.tensor(np.random.RandomState(1).randn(6, 40).astype(
        np.float32) * 3).to(dtype)
    qp = TQ.compute_qparams(x, axis=axis)
    plain = TQ.fake_quant(x, qp)
    xg = x.clone().requires_grad_()
    ste = TQ.fake_quant(xg, qp)
    assert ste.grad_fn is not None and plain.grad_fn is None
    assert ste.dtype == plain.dtype
    np.testing.assert_array_equal(ste.detach().float().numpy(),
                                  plain.float().numpy())


def test_no_gradient_reaches_the_scale():
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    scale = torch.full((5,), 0.05, requires_grad=True)
    zp = torch.zeros(5, requires_grad=True)
    out = TQ.fake_quant(x, TQ.QuantParams(scale=scale, zero_point=zp,
                                          axis=1))
    out.sum().backward()
    assert scale.grad is None and zp.grad is None
    assert x.grad is not None


@pytest.mark.parametrize("kind", ["weight", "act"])
def test_dynamic_qctx_gradient_equals_jax_grad(kind):
    """Thresholds computed from the tensor itself: the reference's custom
    VJP gives the scale no gradient, so neither may the port's."""
    rng = np.random.RandomState(3)
    x = rng.randn(12, 9).astype(np.float32) * 2
    x[0, 0], x[1, 1] = 5.0, -6.5                    # the extremes
    ct = rng.randn(12, 9).astype(np.float32)
    jctx, tctx = JL.QuantCtx(mode="dynamic"), TL.QuantCtx(mode="dynamic")
    if kind == "weight":
        jf = lambda v: jctx.weight("w", v)
        tf = lambda v: tctx.weight(v)
    else:
        jf = lambda v: jctx.act("x", v)
        tf = lambda v: tctx.act(v)
    (jgrad,) = jax.vjp(jf, jnp.asarray(x))[1](jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    tf(xt).backward(torch.tensor(ct))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))


# ------------------------------ calibrators ---------------------------------

@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("sizes", [(5000, 3000, 7000), (200_000, 90_000),
                                   (70_000,) * 62],
                         ids=["small", "strided", "over_budget"])
def test_percentile_calibrator_matches(sizes, signed):
    rng = np.random.RandomState(4)
    jc = JQ.PercentileCalibrator(99.5, signed=signed)
    tc = TQ.PercentileCalibrator(99.5, signed=signed)
    for i, n in enumerate(sizes):
        x = (rng.standard_t(3, n) * (1 + i % 3)).astype(np.float32)
        jc.observe(jnp.asarray(x))
        tc.observe(torch.tensor(x))
    assert [s.size for s in tc._samples] == [s.size for s in jc._samples]
    jqp, tqp = jc.qparams(), tc.qparams()
    np.testing.assert_array_equal(tqp.scale.numpy(), np.asarray(jqp.scale))
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))


@pytest.mark.parametrize("axis", [None, 1, 0])
def test_ema_calibrator_matches(axis):
    rng = np.random.RandomState(5)
    jc = JQ.EMACalibrator(0.9, axis=axis)
    tc = TQ.EMACalibrator(0.9, axis=axis)
    for i in range(6):
        x = (rng.randn(16, 8) * (1 + i)).astype(np.float32)
        jc.observe(jnp.asarray(x))
        tc.observe(torch.tensor(x))
    jqp, tqp = jc.qparams(), tc.qparams()
    np.testing.assert_array_equal(tqp.scale.numpy(), np.asarray(jqp.scale))
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))


def test_calibrators_need_an_observation():
    with pytest.raises(RuntimeError):
        TQ.PercentileCalibrator().qparams()
    with pytest.raises(RuntimeError):
        TQ.EMACalibrator().qparams()
    with pytest.raises(ValueError):
        TQ.PercentileCalibrator(40.0)


# --------------------------- gradient compression ---------------------------

def test_compress_with_feedback_matches_over_steps():
    rng = np.random.RandomState(6)
    shapes = {"a": (33, 7), "b": (5,), "c": ()}
    jerr = JG.init_error_feedback({k: jnp.zeros(s) for k, s in
                                   shapes.items()})
    terr = TG.init_error_feedback({k: torch.zeros(s) for k, s in
                                   shapes.items()})
    for _ in range(5):
        g = {k: np.asarray(rng.randn(*s) * 0.1, np.float32)
             for k, s in shapes.items()}
        jq, _ = JG.compress({k: jnp.asarray(v) + jerr[k]
                             for k, v in g.items()})
        tq, _ = TG.compress({k: torch.tensor(v) + terr[k]
                             for k, v in g.items()})
        for k in shapes:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        jsent, jerr = JG.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tsent, terr = TG.compress_with_feedback(
            {k: torch.tensor(v) for k, v in g.items()}, terr)
        for k in shapes:
            np.testing.assert_allclose(tsent[k].numpy(),
                                       np.asarray(jsent[k]), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]),
                                       rtol=0, atol=1e-6)


def test_error_feedback_preserves_long_run_average():
    """Sum of transmitted grads ≈ sum of true grads (EF property)."""
    rng = np.random.RandomState(0)
    grads = [{"w": torch.tensor(rng.randn(64).astype(np.float32))}
             for _ in range(50)]
    err = TG.init_error_feedback(grads[0])
    sent_sum, true_sum = torch.zeros(64), torch.zeros(64)
    for g in grads:
        sent, err = TG.compress_with_feedback(g, err)
        sent_sum = sent_sum + sent["w"]
        true_sum = true_sum + g["w"]
    assert float(torch.max(torch.abs(sent_sum - true_sum))) < 0.05


def test_compression_rate_is_4x():
    params = {"w": torch.zeros(1024), "b": torch.zeros(8)}
    fp, comp = TG.compressed_allreduce_bytes(params)
    assert fp == 1032 * 4
    assert comp < fp / 3
    assert (fp, comp) == JG.compressed_allreduce_bytes(
        {"w": jnp.zeros(1024), "b": jnp.zeros(8)})


def test_sgd_with_compression_still_converges():
    p = torch.tensor([4.0, -3.0])
    err = TG.init_error_feedback({"w": p})
    for _ in range(80):
        g = {"w": 2 * p}
        sent, err = TG.compress_with_feedback(g, err)
        p = p - 0.1 * sent["w"]
    assert float(torch.sum(p ** 2)) < 1e-3


# ---------------------------------- QAT -------------------------------------

def _mlp_loss(L):
    def model_loss(p, batch, qctx=None):
        h = L.dense(p["l1"], batch["x"], qctx=qctx, name="l1", act="relu")
        out = L.dense(p["l2"], h, qctx=qctx, name="l2")
        return ((out - batch["y"]) ** 2).mean()
    return model_loss


def _mlp():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"l1": JL.dense_init(k1, 8, 16), "l2": JL.dense_init(k2, 16, 1)}
    rng = np.random.RandomState(1)
    x = rng.randn(64, 8).astype(np.float32)
    return params, {"x": x, "y": x[:, :1] * 2 - x[:, 1:2]}


def test_qat_loss_and_gradients_match_reference():
    jparams, batch = _mlp()
    jqat = jmake_qat_loss(_mlp_loss(JL))
    jl, jg = jax.value_and_grad(jqat)(jparams, jax.tree_util.tree_map(
        jnp.asarray, batch))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    acc = zeros_like_tree(tparams)
    tl = value_and_grad_into(make_qat_loss(_mlp_loss(TL)), tparams,
                             {k: torch.tensor(v) for k, v in batch.items()},
                             acc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("l1", "l2"):
        for leaf in ("w", "b"):
            want = np.asarray(jg[k][leaf])
            np.testing.assert_allclose(acc[k][leaf].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


def test_qat_training_tracks_fp32():
    """QAT on a tiny MLP: the quantized loss tracks the fp32 loss."""
    jparams, batch = _mlp()
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                          device="cpu")
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    model_loss = _mlp_loss(TL)
    qat = make_qat_loss(model_loss)
    for _ in range(150):
        g = zeros_like_tree(p)
        value_and_grad_into(qat, p, batch, g)
        p = {k: {n: p[k][n] - 0.05 * g[k][n] for n in p[k]} for k in p}
    fp32_after = float(model_loss(p, batch))
    qat_after = float(qat(p, batch))
    assert qat_after < 0.1
    assert abs(fp32_after - qat_after) < 0.05
