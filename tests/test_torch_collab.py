"""Port parity: the collaborative CNN runtime (``repro_torch.core.collab``),
the calibrating ``QuantCtx``, ``MinMaxCalibrator`` and the quickstart
twin against the JAX package, on the CPU, on the JAX suite's
``tiny_cnn`` (imported from ``tests/test_collab.py``; its port twin is
built by ``repro_torch.launch.quickstart.tiny_cnn`` and given the same
JAX-initialised weights through ``params_from_numpy``).

Compared exactly: the calibrators' qparams and the ``QuantCtx`` lattices
on identical inputs, the tiny graph and its candidates, Algorithm 1's
picks printed by the quickstart, and the edge's model download on
JAX-initialised AlexNet weights: ``quantize_pytree``'s lattices and
qparams, ``pytree_quant_bytes``.  The fp32 forward to 2e-4 × max |ref|.
The twins of ``tests/test_collab.py`` run inside the port with the JAX
suite's own thresholds.  The engines at each cut are held to JAX's in
``tests/test_torch_cnn_engines.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_collab import _input, tiny_cnn  # noqa: E402

from repro.core import autotune as JA  # noqa: E402
from repro.core import costmodel as JCM  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.models import layers as JLY  # noqa: E402
from repro.models import legacy as JL  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                qparams_from_numpy)
from repro_torch.core import collab as TC  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.costmodel import Channel  # noqa: E402
from repro_torch.launch import quickstart as QS  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import legacy as TL  # noqa: E402

CUTS = QS.TINY_CUTS


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """(JAX tiny_cnn, the port's twin on the same weights)."""
    jm = tiny_cnn()
    tm = QS.tiny_cnn(torch.Generator().manual_seed(0), device="cpu")
    for ts, js in zip(tm.segments, jm.segments):
        assert ts.name == js.name
        ts.params = params_from_numpy(_np(js.params), "cpu")
    return jm, tm


def _x(batch=2, seed=0):
    return torch.tensor(np.asarray(_input(batch=batch, seed=seed)))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# -- calibration ------------------------------------------------------------


@pytest.mark.parametrize("axis,symmetric", [(None, False), (1, False),
                                            (None, True), (3, False)])
def test_minmax_calibrator_matches(axis, symmetric):
    rng = np.random.RandomState(4)
    batches = [(rng.randn(2, 5, 5, 6) * (i + 1)).astype(np.float32)
               for i in range(3)]
    jc = JQ.MinMaxCalibrator(axis=axis, symmetric=symmetric)
    tc = TQ.MinMaxCalibrator(axis=axis, symmetric=symmetric)
    for b in batches:
        jc.observe(jnp.asarray(b))
        tc.observe(torch.tensor(b))
    jqp, tqp = jc.qparams(), tc.qparams()
    np.testing.assert_array_equal(tqp.scale.numpy(), np.asarray(jqp.scale))
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))
    assert tqp.axis == jqp.axis
    with pytest.raises(RuntimeError, match="observe"):
        TQ.MinMaxCalibrator().qparams()


def test_quant_ctx_modes_match():
    """calib records per name and passes through; static replays the
    thresholds (an unseen name passes through); dynamic ignores names."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 8).astype(np.float32)
    jcal, tcal = JLY.make_calib_ctx(), TLY.make_calib_ctx()
    for i in range(2):
        xi = x * (i + 1)
        assert np.array_equal(np.asarray(jcal.act("a", jnp.asarray(xi))),
                              tcal.act(torch.tensor(xi), "a").numpy())
    jcal.act("b", jnp.asarray(-x))
    tcal.act(torch.tensor(-x), "b")
    jsc, tsc = jcal.finalize_calibration(), tcal.finalize_calibration()
    assert sorted(tsc) == sorted(jsc) == ["a", "b"]
    jst = JLY.QuantCtx(mode="static", scales=jsc)
    tst = TLY.QuantCtx(mode="static",
                       scales={k: qparams_from_numpy(v, "cpu")
                               for k, v in jsc.items()})
    for name in ("a", "b", "unseen"):
        np.testing.assert_array_equal(
            tst.act(torch.tensor(x), name).numpy(),
            np.asarray(jst.act(name, jnp.asarray(x))))
    assert tst.act(torch.tensor(x), "unseen").numpy().tolist() == x.tolist()
    for k in jsc:
        np.testing.assert_array_equal(tsc[k].scale.numpy(),
                                      np.asarray(jsc[k].scale))
    w = rng.randn(8, 4).astype(np.float32)
    for kw in (dict(), dict(w_bits=4), dict(per_channel=False)):
        np.testing.assert_array_equal(
            TLY.QuantCtx(**kw).weight(torch.tensor(w), "w").numpy(),
            np.asarray(JLY.QuantCtx(**kw).weight("w", jnp.asarray(w))))
        np.testing.assert_array_equal(
            TLY.QuantCtx(**kw).act(torch.tensor(x), "any").numpy(),
            np.asarray(JLY.QuantCtx(**kw).act("other", jnp.asarray(x))))
    with pytest.raises(ValueError, match="mode"):
        TLY.QuantCtx(mode="fixed")
    with pytest.raises(ValueError, match="calib"):
        TLY.QuantCtx().finalize_calibration()


# -- the tiny CNN: port against JAX -------------------------------------------


def test_tiny_graph_matches(tiny):
    jm, tm = tiny
    assert tm.candidate_names() == jm.candidate_names()
    for name in jm.graph.topo():
        j, t = jm.graph[name], tm.graph[name]
        assert (t.op, t.inputs, t.out_shape, t.flops, t.param_elems) == (
            j.op, j.inputs, j.out_shape, j.flops, j.param_elems)


def test_tiny_full_apply_matches(tiny):
    jm, tm = tiny
    x = _input()
    want = np.asarray(jm.full_apply(x))
    got = tm.full_apply(torch.tensor(np.asarray(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


# -- twins of tests/test_collab.py, inside the port -------------------------


def test_segments_align_with_candidates(tiny):
    tiny[1].verify_alignment()
    m = tiny[1]
    bad = TC.SegmentedModel(m.name, m.graph, [TC.Segment("nope", None, {})])
    with pytest.raises(ValueError, match="candidate"):
        bad.verify_alignment()
    with pytest.raises(ValueError, match="not in segments"):
        TC.CollaborativeEngine(m, "nope", device="cpu")


@pytest.mark.parametrize("cut", CUTS)
def test_collab_matches_fp32_within_quant_noise(tiny, cut):
    m = tiny[1]
    x = _x()
    truth = m.full_apply(x)
    eng = TC.CollaborativeEngine(m, cut, calib_batches=[_x(seed=7)],
                                 device="cpu")
    got, rec = eng.infer(x)
    rel = _rel(got, truth)
    if cut == "input":
        assert rel < 1e-5
        assert rec.precision == "fp32"
    else:
        assert rel < 0.12, (cut, rel)
        assert rec.precision == "int8"


def test_boundary_blob_is_int8_sized(tiny):
    eng = TC.CollaborativeEngine(tiny[1], "conv2", device="cpu")
    _, rec = eng.infer(_x(batch=1))
    assert rec.blob_bytes == 8 * 8 * 16 + 8


def test_edge_download_is_quarter_of_fp32(tiny):
    eng = TC.CollaborativeEngine(tiny[1], "conv2", device="cpu")
    assert eng.edge_download_bytes < eng.edge_fp32_bytes / 3.5
    assert 0.0 < eng.storage_reduction < 1.0


def test_channel_latency_scales_with_bytes(tiny):
    x = _x(batch=1)
    slow = TC.CollaborativeEngine(tiny[1], "conv1", device="cpu",
                                  channel=Channel.from_kbps(100))
    fast = TC.CollaborativeEngine(tiny[1], "conv1", device="cpu",
                                  channel=Channel.from_kbps(10000))
    _, r_slow = slow.infer(x)
    _, r_fast = fast.infer(x)
    assert r_slow.simulated_latency_s == pytest.approx(
        100 * r_fast.simulated_latency_s)
    assert r_slow.simulated_latency_s == pytest.approx(
        r_slow.blob_bytes / 100e3)


def test_static_calibration_close_to_dynamic(tiny):
    x = _x()
    calibrated = TC.CollaborativeEngine(
        tiny[1], "conv2", device="cpu",
        calib_batches=[_x(seed=i) for i in range(4)])
    dynamic = TC.CollaborativeEngine(tiny[1], "conv2", device="cpu")
    assert calibrated.act_scales and not dynamic.act_scales
    y_c, _ = calibrated.infer(x)
    y_d, _ = dynamic.infer(x)
    assert _rel(y_c, y_d) < 0.1


def test_edge_only_cut_runs_everything_on_edge(tiny):
    x = _x()
    eng = TC.CollaborativeEngine(tiny[1], "head", device="cpu")
    y, rec = eng.infer(x)
    assert rec.cloud_wall_s >= 0 and not eng.cloud_segments
    assert _rel(y, tiny[1].full_apply(x)) < 0.15


@pytest.mark.parametrize("cut", ["conv1", "conv2", "head"])
def test_forced_boundary_of_own_input_is_the_boundary(tiny, cut):
    """Fed its own engine's input to the last edge segment, the
    teacher-forced boundary is the end-to-end one, exactly; fed another
    input, it is that input's."""
    eng = TC.CollaborativeEngine(tiny[1], cut, calib_batches=[_x(seed=7)],
                                 device="cpu")
    x = _x(seed=4)
    blob, qp = eng.boundary(eng.edge_forward(x))
    h = eng.last_edge_input(x)
    forced, fqp = eng.boundary(eng.last_edge_trace(h)[0])
    assert torch.equal(forced, blob)
    assert torch.equal(fqp.scale, qp.scale)
    assert torch.equal(fqp.zero_point, qp.zero_point)
    other = eng.last_edge_input(_x(seed=5))
    assert not torch.equal(
        eng.boundary(eng.last_edge_trace(other)[0])[0], blob)


@pytest.mark.parametrize("cut", ["conv1", "conv2", "head"])
def test_last_edge_trace_goes_on_from_the_forced_lattices(tiny, cut):
    """Each segment of the tiny CNN holds one static lattice, its input's.
    Forced with its own lattices (and scales) the trace is the plain run,
    exactly; forced with another input's, the recorded lattice is still
    its own input's and the output is the other input's."""
    eng = TC.CollaborativeEngine(tiny[1], cut, calib_batches=[_x(seed=7)],
                                 device="cpu")
    x = _x(seed=4)
    h, h_other = eng.last_edge_input(x), eng.last_edge_input(_x(seed=5))
    z, lats = eng.last_edge_trace(h)
    assert len(lats) == 1 and lats[0].dtype == torch.int8
    assert torch.equal(z, eng.edge_forward(x))
    z_own, lats_own = eng.last_edge_trace(h, force=lats,
                                          scales=dict(eng.act_scales))
    assert torch.equal(z_own, z) and torch.equal(lats_own[0], lats[0])
    z_other, lats_other = eng.last_edge_trace(h_other)
    assert not torch.equal(lats_other[0], lats[0])
    z_forced, lats_forced = eng.last_edge_trace(h, force=lats_other)
    assert torch.equal(lats_forced[0], lats[0])
    assert torch.equal(z_forced, z_other)


def test_engine_without_device_raises_when_no_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.CollaborativeEngine(tiny[1], "conv1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_alexnet(torch.Generator().manual_seed(0))


def test_quickstart_picks_are_the_jax_packages(capsys):
    """The quickstart twin runs on the CPU and prints, per bandwidth, the
    cut JAX's Algorithm 1 picks on AlexNet's graph."""
    QS.main(["--device", "cpu"])
    out = capsys.readouterr().out
    tuner = JA.AutoTuner(JL.alexnet_graph(), JCM.EDGE_TX2_CLASS,
                         JCM.CLOUD_TITANXP_CLASS)
    for kbps in QS.BANDWIDTHS_KBPS:
        best = tuner.tune(JCM.Channel.from_kbps(kbps))[0].point
        assert f"{kbps:>10} KB/s {best:>10} " in out
    for cut in QS.TINY_CUTS:
        assert f"cut={cut:6s}" in out
    assert "Done." in out


@pytest.fixture(scope="module")
def alexnet():
    """JAX-initialised AlexNet weights (numpy) and their bridge."""
    p = _np(jax.jit(JL.init_alexnet)(jax.random.PRNGKey(0)))
    return p, params_from_numpy(p, "cpu")


# -- the edge's model download ------------------------------------------------


def _flat(tree, path=""):
    """{path: leaf} of a nested dict/list tree (any leaf type)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def test_quantize_pytree_matches_on_bridged_weights(alexnet):
    """Eager, as the JAX engine runs it (under ``jax.jit`` XLA divides by
    255 as a product with its reciprocal, one ulp off in a scale)."""
    jp, tp = alexnet
    jq, jqp = JQ.quantize_pytree(jax.tree_util.tree_map(jnp.asarray, jp))
    tq, tqp = TQ.quantize_pytree(tp)
    jq, jqp, tq, tqp = _flat(jq), _flat(jqp), _flat(tq), _flat(tqp)
    assert sorted(tq) == sorted(jq) == sorted(tqp) == sorted(jqp)
    for k in jq:
        assert tq[k].dtype == torch.int8
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        qa, qb = tqp[k], jqp[k]
        assert (qa.axis, qa.bits, qa.signed) == (qb.axis, qb.bits,
                                                 qb.signed)
        np.testing.assert_array_equal(qa.scale.numpy(),
                                      np.asarray(qb.scale))
        np.testing.assert_array_equal(qa.zero_point.numpy(),
                                      np.asarray(qb.zero_point))
    for bits in (8, 4):
        assert (TQ.pytree_quant_bytes(tp, bits=bits)
                == JQ.pytree_quant_bytes(jp, bits=bits))


def test_dequantize_pytree_matches():
    rng = np.random.RandomState(2)
    tree = {"conv": {"w": rng.randn(3, 3, 4, 5).astype(np.float32),
                     "b": rng.randn(5).astype(np.float32)},
            "fc": [{"w": rng.randn(6, 7).astype(np.float32)}]}
    jq, jqp = JQ.quantize_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
    tq, tqp = TQ.quantize_pytree(params_from_numpy(tree, "cpu"))
    got = _flat(TQ.dequantize_pytree(tq, tqp))
    want = _flat(JQ.dequantize_pytree(jq, jqp))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_quantize_pytree_passes_non_float_leaves():
    tree = {"w": np.ones((3, 2), np.float32), "ids": np.arange(4),
            "blocks": [{"b": np.full(2, 0.5, np.float32)}]}
    jq, jqp = JQ.quantize_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
    tq, tqp = TQ.quantize_pytree(params_from_numpy(tree, "cpu"))
    assert tqp["ids"] is None and jqp["ids"] is None
    np.testing.assert_array_equal(tq["ids"].numpy(), np.arange(4))
    assert tqp["w"].axis == jqp["w"].axis == 1
    assert tqp["blocks"][0]["b"].axis is None
    np.testing.assert_array_equal(tq["blocks"][0]["b"].numpy(),
                                  np.asarray(jq["blocks"][0]["b"]))
    assert TQ.dequantize_pytree(tq, tqp)["ids"] is tq["ids"]
