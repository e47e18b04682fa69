"""Port parity: the paper's CNNs (``repro_torch.models.legacy``), the CNN
layers of ``repro_torch.models.layers`` and the parameter-tree
quantizers against the JAX package, on the CPU.

Both packages get the same numpy inputs.  AlexNet's weights are
JAX-initialised (``init_alexnet`` under ``jax.jit``) and bridged with
``params_from_numpy``; GoogLeNet's are numpy draws in the tree JAX's
``init_googlenet`` gives (``jax.eval_shape``), fan-in scaled with
nonzero biases, because its JAX init compiles for many seconds, jitted
or eager.  VGG16 (138 M parameters) is held here at graph level; its
forward runs in ``tests/test_torch_cnn_engines.py`` at batch 1 and two cuts.

Compared exactly: every ``LayerGraph`` node (name, op, inputs, shape,
FLOPs, parameter elements), the candidate lists, Algorithm 1's pick and
every row at the Table 3 and quickstart bandwidths (ResNet-18's Table 3
row too; its model is in ``tests/test_torch_vision.py``)
(``tests/test_torch_collab.py`` holds the parameter-tree quantizers).
With a tolerance: ``conv2d``, ``dense``, ``lrn`` and ``maxpool2d`` to
1e-5 × max |ref| (XLA and oneDNN sum in other orders; the fake-quant
lattices of identical inputs are exact); whole forwards to 2e-4 ×
max |ref| (the bound of ``tests/test_vision_models.py``).  Never exact:
a lattice downstream of a float conv, or a top-1 class.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import autotune as JA  # noqa: E402
from repro.core import costmodel as JCM  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.configs import get_arch as jget  # noqa: E402
from repro.models import layers as JLY  # noqa: E402
from repro.models import legacy as JL  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core import costmodel as TCM  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.launch.quickstart import BANDWIDTHS_KBPS  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import legacy as TL  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NETS = ("alexnet", "vgg16", "googlenet")
TABLE3_NETS = NETS + ("resnet-18",)
LAYER_TOL = 1e-5
FORWARD_TOL = 2e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _img(batch, res, seed=0):
    return np.random.RandomState(seed).rand(batch, res, res,
                                            3).astype(np.float32)


def _np_weights(tree_shapes, seed):
    """Fan-in scaled numpy draws in a JAX parameter tree's shapes."""
    rng = np.random.RandomState(seed)

    def one(s):
        if len(s.shape) == 1:
            return (rng.randn(*s.shape) * 0.01).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map(one, tree_shapes)


@pytest.fixture(scope="module")
def alexnet():
    p = jax.tree_util.tree_map(
        np.asarray, jax.jit(JL.init_alexnet)(jax.random.PRNGKey(0)))
    return p, params_from_numpy(p, "cpu")


@pytest.fixture(scope="module")
def googlenet():
    p = _np_weights(jax.eval_shape(JL.init_googlenet,
                                   jax.random.PRNGKey(0)), 1)
    return p, params_from_numpy(p, "cpu")


# -- layers --------------------------------------------------------------


def _conv_case(k, stride, padding, groups, act, bias, hw, quant):
    rng = np.random.RandomState(k * 100 + stride * 10 + groups)
    c_in, c_out = 4 * groups, 6
    x = rng.randn(2, hw, hw, c_in).astype(np.float32)
    p = {"w": (rng.randn(k, k, c_in // groups, c_out) * 0.2)
         .astype(np.float32)}
    if bias:
        p["b"] = (rng.randn(c_out) * 0.1).astype(np.float32)
    kw = dict(stride=stride, padding=padding, groups=groups, act=act)
    want = JLY.conv2d(jax.tree_util.tree_map(jnp.asarray, p),
                      jnp.asarray(x), qctx=JLY.QuantCtx() if quant else None,
                      **kw)
    got = TLY.conv2d(params_from_numpy(p, "cpu"), torch.tensor(x),
                     qctx=TLY.QuantCtx() if quant else None, **kw)
    return got, want


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize(
    "k,stride,padding,groups,act,bias,hw",
    [(11, 4, "VALID", 1, "relu", True, 35),   # AlexNet conv1's form
     (7, 2, "SAME", 1, "relu", True, 30),     # pads (2, 3): GoogLeNet conv1
     (3, 1, "SAME", 1, None, True, 13),
     (5, 1, "SAME", 1, "gelu", False, 9),
     (3, 2, "SAME", 2, "tanh", True, 10),     # groups, pads (0, 1)
     (1, 1, "SAME", 1, "relu", True, 8),
     (3, 1, "VALID", 1, None, True, 9)])
def test_conv2d_matches(k, stride, padding, groups, act, bias, hw, quant):
    got, want = _conv_case(k, stride, padding, groups, act, bias, hw, quant)
    _close(got.numpy(), want, LAYER_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act,bias,lead", [("relu", True, (3,)),
                                           (None, True, (2, 5)),
                                           ("gelu", False, (4,)),
                                           ("tanh", True, (1, 3))])
def test_dense_matches(act, bias, lead, quant):
    rng = np.random.RandomState(len(lead))
    x = rng.randn(*lead, 24).astype(np.float32)
    p = {"w": (rng.randn(24, 10) * 0.2).astype(np.float32)}
    if bias:
        p["b"] = (rng.randn(10) * 0.1).astype(np.float32)
    want = JLY.dense(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                     qctx=JLY.QuantCtx() if quant else None, act=act)
    got = TLY.dense(params_from_numpy(p, "cpu"), torch.tensor(x),
                    qctx=TLY.QuantCtx() if quant else None, act=act)
    _close(got.numpy(), want, LAYER_TOL)


@pytest.mark.parametrize("window,stride,padding,hw",
                         [(3, 2, "VALID", 13), (3, 2, "SAME", 14),
                          (3, 1, "SAME", 7), (2, 2, "VALID", 8),
                          (3, 2, "SAME", 15), (5, 1, "SAME", 6)])
def test_maxpool2d_matches(window, stride, padding, hw):
    """Negative inputs: a window over pad cells must take −inf there."""
    x = np.random.RandomState(hw).randn(2, hw, hw, 5).astype(np.float32)
    x[:, -1] = -5.0
    want = JLY.maxpool2d(jnp.asarray(x), window=window, stride=stride,
                         padding=padding)
    got = TLY.maxpool2d(torch.tensor(x), window=window, stride=stride,
                        padding=padding)
    _close(got.numpy(), want, 0.0)


@pytest.mark.parametrize("c", [16, 3])
def test_lrn_matches(c):
    x = (np.random.RandomState(c).randn(2, 5, 5, c) * 4).astype(np.float32)
    _close(TL.lrn(torch.tensor(x)).numpy(), JL.lrn(jnp.asarray(x)),
           LAYER_TOL)


def test_same_padding_puts_the_odd_cell_at_the_end():
    assert TLY._same_pads(224, 7, 2) == (2, 3)
    assert TLY._same_pads(112, 3, 2) == (0, 1)
    assert TLY._same_pads(13, 3, 1) == (1, 1)
    with pytest.raises(ValueError, match="SAME"):
        TLY.conv2d({"w": torch.zeros(3, 3, 1, 1)}, torch.zeros(1, 4, 4, 1),
                   padding="FULL")


@pytest.mark.parametrize("saved", [True, False])
def test_cnn_products_leave_the_tf32_flags_as_they_were(saved, monkeypatch):
    """The conv and dense calls switch TF32 off around an f32 product on
    the card only and restore the caller's flags, on an exception too;
    on the CPU they leave them alone.  The scope is driven directly
    (no card here)."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    monkeypatch.setattr(mm, "allow_tf32", saved)
    monkeypatch.setattr(cudnn, "allow_tf32", saved)
    with TLY.full_f32(True):
        assert mm.allow_tf32 is False and cudnn.allow_tf32 is False
    assert mm.allow_tf32 is saved and cudnn.allow_tf32 is saved
    with pytest.raises(RuntimeError):
        with TLY.full_f32(True):
            raise RuntimeError("inside the product")
    assert mm.allow_tf32 is saved and cudnn.allow_tf32 is saved
    with TLY.full_f32(False):
        assert mm.allow_tf32 is saved and cudnn.allow_tf32 is saved
    got, _ = _conv_case(3, 1, "SAME", 1, "relu", True, 6, True)
    for dense in (TLY.dense, TLY.cnn_dense):
        dense({"w": torch.ones(4, 2), "b": torch.ones(2)}, torch.ones(3, 4),
              act="relu")
    assert mm.allow_tf32 is saved and cudnn.allow_tf32 is saved


# -- graphs, candidates, Algorithm 1 ---------------------------------------


def _rows(g):
    return [(n.name, n.op, list(n.inputs), tuple(n.out_shape), n.flops,
             n.param_elems, n.parametric) for n in (g[k] for k in g.topo())]


def _cand_rows(cands):
    return [(c.name, c.edge_flops, c.edge_param_elems, c.transmit_bytes,
             [(b.source, b.elems, b.precision) for b in c.blobs])
            for c in cands]


@pytest.mark.parametrize("net", NETS)
def test_graph_and_candidates_match(net):
    jg, tg = getattr(JL, f"{net}_graph")(), getattr(TL, f"{net}_graph")()
    assert _rows(tg) == _rows(jg)
    assert (_cand_rows(TP.candidate_partition_points(tg))
            == _cand_rows(JP.candidate_partition_points(jg)))
    assert tg.total_flops() == jg.total_flops()
    assert tg.total_param_elems() == jg.total_param_elems()


def _table3_graphs(net):
    """(JAX graph, port graph) of a Table 3 net at batch 1: the paper's
    CNNs from ``legacy``, ResNet-18 from its config."""
    if net == "resnet-18":
        return (JR.make_graph(jget(net).full, batch=1),
                TR.make_graph(tget(net).full, batch=1))
    return getattr(JL, f"{net}_graph")(), getattr(TL, f"{net}_graph")()


@pytest.mark.parametrize("net", TABLE3_NETS)
def test_algorithm1_matches(net):
    """Every row Algorithm 1 builds, and its pick, at the net's Table 3
    bandwidth and at the quickstart's, equal JAX's."""
    jg, tg = _table3_graphs(net)
    jt = JA.AutoTuner(jg, JCM.EDGE_TX2_CLASS, JCM.CLOUD_TITANXP_CLASS)
    tt = TA.AutoTuner(tg, TCM.EDGE_TX2_CLASS, TCM.CLOUD_TITANXP_CLASS)
    table3 = _chip_smoke().TABLE3_PICKS[net][0]
    for kbps in sorted({table3, *BANDWIDTHS_KBPS}):
        jbest, jperfs = jt.tune(JCM.Channel.from_kbps(kbps))
        tbest, tperfs = tt.tune(TCM.Channel.from_kbps(kbps))
        assert ([dataclasses.asdict(p) for p in tperfs]
                == [dataclasses.asdict(p) for p in jperfs]), kbps
        assert tbest.point == jbest.point, kbps
        assert (tt.speedup_vs_cloud_only(TCM.Channel.from_kbps(kbps))
                == jt.speedup_vs_cloud_only(JCM.Channel.from_kbps(kbps)))


@pytest.mark.parametrize("net", TABLE3_NETS)
def test_table3_picks_are_the_jax_packages(net):
    """``chip_smoke.py``'s constants are what the JAX package picks at
    the Table 3 bandwidths (not the paper's own cuts, which its cost
    model does not reproduce: ResNet-18's is ``res4a``), and the port
    picks the same."""
    kbps, pick = _chip_smoke().TABLE3_PICKS[net]
    jg, tg = _table3_graphs(net)
    jt = JA.AutoTuner(jg, JCM.EDGE_TX2_CLASS, JCM.CLOUD_TITANXP_CLASS)
    tt = TA.AutoTuner(tg, TCM.EDGE_TX2_CLASS, TCM.CLOUD_TITANXP_CLASS)
    assert jt.tune(JCM.Channel.from_kbps(kbps))[0].point == pick
    assert tt.tune(TCM.Channel.from_kbps(kbps))[0].point == pick


# -- twins of tests/test_vision_models.py's legacy cases ----------------------


def test_alexnet_graph_and_forward(alexnet):
    g = TL.alexnet_graph()
    assert 55e6 < g.total_param_elems() < 65e6
    assert 2.0e9 < g.total_flops() < 2.6e9
    x = torch.tensor(_img(1, 227))
    y = TL.alexnet_forward(alexnet[1], x)
    assert y.shape == (1, 1000) and bool(torch.all(torch.isfinite(y)))
    m = TL.alexnet_segments(alexnet[1])
    m.verify_alignment()
    np.testing.assert_allclose(m.full_apply(x).numpy(), y.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_vgg16_graph_counts():
    g = TL.vgg16_graph()
    assert 130e6 < g.total_param_elems() < 145e6
    assert 28e9 < g.total_flops() < 34e9
    assert "conv1_2" in {c.name for c in TP.candidate_partition_points(g)}


def test_googlenet_graph_and_candidates():
    g = TL.googlenet_graph()
    assert 5e6 < g.total_param_elems() < 8e6
    assert 2.5e9 < g.total_flops() < 4e9
    cands = {c.name for c in TP.candidate_partition_points(g)}
    assert "conv2" in cands
    assert "inc3a/b2b" not in cands and "inc3a/b4" in cands
    assert sum(1 for c in cands if c.endswith("/b4")) == 9


def test_googlenet_forward_small(googlenet):
    x = torch.tensor(_img(1, 224))
    y = TL.googlenet_forward(googlenet[1], x)
    assert y.shape == (1, 1000) and bool(torch.all(torch.isfinite(y)))
    m = TL.googlenet_segments(googlenet[1])
    m.verify_alignment()
    _close(m.full_apply(x).numpy(), y.numpy(), FORWARD_TOL)


# -- whole networks against JAX ---------------------------------------------


def test_alexnet_forward_matches(alexnet):
    x = _img(2, 227, seed=3)
    want = JL.alexnet_forward(jax.tree_util.tree_map(jnp.asarray,
                                                     alexnet[0]),
                              jnp.asarray(x))
    _close(TL.alexnet_forward(alexnet[1], torch.tensor(x)).numpy(), want,
           FORWARD_TOL)


def test_googlenet_forward_matches(googlenet):
    x = _img(1, 224, seed=3)
    want = jax.jit(JL.googlenet_forward)(
        jax.tree_util.tree_map(jnp.asarray, googlenet[0]), jnp.asarray(x))
    _close(TL.googlenet_forward(googlenet[1], torch.tensor(x)).numpy(), want,
           FORWARD_TOL)
