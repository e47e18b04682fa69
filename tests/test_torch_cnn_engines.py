"""Port parity: the collaborative engine (``repro_torch.core.collab``) at
every cut of the JAX suite's ``tiny_cnn`` and at AlexNet's ``conv2``,
against the JAX package's engine, on the CPU (VGG16 and GoogLeNet, at
224², are in ``tests/test_torch_cnn_engines_224.py``, which shares this
file's comparison).

Both packages get the same numpy images and weights, bridged with
``params_from_numpy``: ``tiny_cnn``'s own (imported from
``tests/test_collab.py``; the port twin from
``repro_torch.launch.quickstart.tiny_cnn``), AlexNet's and VGG16's from
``init_*`` under ``jax.jit``, and GoogLeNet's numpy draws in JAX's
parameter tree (its JAX init compiles for many seconds).  The nets
run at batch 1, each engine calibrated on the same two batches of 2.

Compared exactly: download bytes, storage reduction, blob bytes,
simulated latency, zero points, and the Eq.(1) lattice of the *same*
float boundary tensor (JAX's edge output bridged into the port's
quantizer, teacher-forced).  With a tolerance: calibrated ``act_scales``
to rtol 1e-5 (their min/max come from float convs); the port's own
boundary lattice within one step of JAX's on a stated share of elements
(XLA and oneDNN sum a conv in other orders, so a value near a rounding
boundary can land on the next step, and every static lattice of the edge
passes the difference on); outputs to a stated relative L2 (the
cloud-only cut: 2e-4, the bound of ``tests/test_vision_models.py``).
Each bound is beside its measured value.  The edges compared have at
most three quantized convs: the difference grows along the chain
(AlexNet at ``conv5``, five convs: 6.7 % of the boundary one step off,
the edge outputs up to 1.2 steps apart on a CPU).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_collab import _input, tiny_cnn  # noqa: E402

from repro.core import collab as JC  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.models import legacy as JL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import collab as TC  # noqa: E402
from repro_torch.launch import quickstart as QS  # noqa: E402
from repro_torch.models import legacy as TL  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _engines_match(je, te, x, *, share, rel_l2):
    """One JAX/port engine pair at one cut on image batch ``x`` (numpy):
    everything countable equal, scales to rtol 1e-5, the teacher-forced
    boundary lattice equal, the port's own boundary lattice within one
    step of JAX's on at most ``share`` of its elements (``None``: not
    compared), the output within relative L2 ``rel_l2``."""
    assert te.edge_download_bytes == je.edge_download_bytes
    assert te.edge_fp32_bytes == je.edge_fp32_bytes
    assert te.storage_reduction == je.storage_reduction
    assert sorted(te.act_scales) == sorted(je.act_scales)
    for k, qp in je.act_scales.items():
        np.testing.assert_allclose(te.act_scales[k].scale.numpy(),
                                   np.asarray(qp.scale), rtol=1e-5)
        np.testing.assert_array_equal(te.act_scales[k].zero_point.numpy(),
                                      np.asarray(qp.zero_point))
    jy, jrec = je.infer(jnp.asarray(x))
    ty, trec = te.infer(torch.tensor(x))
    assert (trec.blob_bytes, trec.precision) == (jrec.blob_bytes,
                                                 jrec.precision)
    assert trec.simulated_latency_s == jrec.simulated_latency_s
    jy, ty = np.asarray(jy), ty.numpy()
    assert ty.shape == jy.shape and np.all(np.isfinite(ty))
    assert np.linalg.norm(ty - jy) / np.linalg.norm(jy) < rel_l2
    if not je.edge_segments:
        return
    jh = je.edge_forward(jnp.asarray(x))
    jqp = JQ.compute_qparams(jh)
    jblob = np.asarray(JQ.quantize(jh, jqp))
    tblob, tqp = te.boundary(torch.tensor(np.asarray(jh)))
    np.testing.assert_array_equal(tblob.numpy(), jblob)
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))
    if share is not None:
        own, _ = te.boundary(te.edge_forward(torch.tensor(x)))
        steps = np.abs(own.numpy().astype(np.int32)
                       - jblob.astype(np.int32))
        assert steps.max() <= 1 and (steps > 0).mean() <= share


# -- the tiny CNN at every cut ------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """(JAX tiny_cnn, the port's twin on the same weights)."""
    jm = tiny_cnn()
    tm = QS.tiny_cnn(torch.Generator().manual_seed(0), device="cpu")
    for ts, js in zip(tm.segments, jm.segments):
        ts.params = params_from_numpy(_np(js.params), "cpu")
    return jm, tm


@pytest.mark.parametrize("cut,calibrated", [
    *((cut, True) for cut in QS.TINY_CUTS), ("conv1", False),
    ("conv2", False)], ids=lambda v: {True: "static",
                                      False: "dynamic"}.get(v, v))
def test_tiny_engine_matches_jax(tiny, cut, calibrated):
    """Share ≤ 1 % (measured: 0 at every cut), relative L2 1e-3
    (measured: ≤ 1.8e-7)."""
    jm, tm = tiny
    calib = [np.asarray(_input(seed=s)) for s in (7, 8)]
    je = JC.CollaborativeEngine(
        jm, cut, calib_batches=[jnp.asarray(c) for c in calib]
        if calibrated else None)
    te = TC.CollaborativeEngine(
        tm, cut, device="cpu", calib_batches=[torch.tensor(c) for c in calib]
        if calibrated else None)
    _engines_match(je, te, np.asarray(_input(seed=3)), share=0.01,
                   rel_l2=1e-3)


# -- the paper's nets: port against JAX -------------------------------------


def _img(batch, res, seed):
    return np.random.RandomState(seed).rand(batch, res, res,
                                            3).astype(np.float32)


def _engine_pair(jm, tm, cut, res):
    calib = [_img(2, res, 10 + i) for i in range(2)]
    je = JC.CollaborativeEngine(jm, cut,
                                calib_batches=[jnp.asarray(c)
                                               for c in calib])
    te = TC.CollaborativeEngine(tm, cut, device="cpu",
                                calib_batches=[torch.tensor(c)
                                               for c in calib])
    return je, te


@pytest.fixture(scope="module")
def alexnet():
    p = _np(jax.jit(JL.init_alexnet)(jax.random.PRNGKey(0)))
    return (JL.alexnet_segments(jax.tree_util.tree_map(jnp.asarray, p)),
            TL.alexnet_segments(params_from_numpy(p, "cpu")))


def test_alexnet_engine_matches_jax(alexnet):
    """At ``conv2`` (two quantized convs on the edge): share ≤ 1 %
    (measured 0.12 %, one step), relative L2 5e-3 (measured 3.9e-4)."""
    je, te = _engine_pair(*alexnet, "conv2", 227)
    _engines_match(je, te, _img(1, 227, 0), share=0.01, rel_l2=5e-3)
