"""Port parity: ResNet and ViT (``repro_torch.models.resnet``/``vit``),
their configs, and the vision layers of ``repro_torch.models.layers``
against the JAX package, on the CPU.

Both packages get the same numpy inputs, moved into the port with
``params_from_numpy``.  The five FULL configs are held here at graph
level (resnet-152, deit-b and vit-h14 are never initialised in JAX: its
inits take 2–20 s a net here, and vit-h14 has 632 M parameters; the
port's inits run on the meta device); the forwards, the model download
and the engines are in ``tests/test_torch_vision_engines.py``.

Compared exactly: the configs, every ``LayerGraph`` node and the
candidate lists of all five FULL configs, Algorithm 1's rows and pick at
70 KB/s and the quickstart's bandwidths, the parameter trees of both
packages' inits shape for shape (and ``ViTConfig.param_count``), the
calibration names of ``attention``, and the Eq.(1) lattice of the same
bf16 tensor.  With a tolerance (× max |ref|): the layers in f32 to 1e-5
(XLA and torch sum in other orders) and in bf16 to 2e-2 (a bf16 ulp is
2^-8 of a value, and the two round bf16 partial results at other
points).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.core import autotune as JA  # noqa: E402
from repro.core import costmodel as JCM  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.models import layers as JLY  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.models import vit as JV  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core import costmodel as TCM  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.launch.quickstart import BANDWIDTHS_KBPS  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402

ARCHS = ("resnet-18", "resnet-152", "vit-s16", "deit-b", "vit-h14")
LAYER_TOL = 1e-5
BF16_LAYER_TOL = 2e-2
FORWARD_TOL = 2e-4


def _mods(arch):
    """(JAX module, port module) of an arch's family."""
    return (JR, TR) if arch.startswith("resnet") else (JV, TV)


def _shapes(arch, cfg):
    """The tree JAX's init gives for ``cfg``, as shapes (traced, not
    run)."""
    init = JR.init_resnet if arch.startswith("resnet") else JV.init_vit
    return jax.eval_shape(lambda key: init(key, cfg), jax.random.PRNGKey(0))


def _tinit(arch):
    return TR.init_resnet if arch.startswith("resnet") else TV.init_vit


def _f32(a):
    """A JAX array or a torch tensor as a f32 numpy array."""
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    """``got`` (torch) against ``want`` (JAX): same shape and dtype,
    finite, within ``tol`` × max |want|."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


DTYPES = [(jnp.float32, LAYER_TOL), (jnp.bfloat16, BF16_LAYER_TOL)]
DTYPE_IDS = ["f32", "bf16"]


def _pair(x, jdt):
    """One numpy array as (JAX array, torch tensor) in dtype ``jdt``."""
    j = jnp.asarray(x, jdt)
    return j, params_from_numpy(np.asarray(j), "cpu")


# -- configs ------------------------------------------------------------


def test_registry_has_the_vision_archs_with_the_references_numbers():
    """Five more archs, each FULL and SMOKE equal to the reference's field
    for field (dtype by name), registered as ``vision``."""
    assert set(ARCHS) <= set(list_archs())
    assert len(list_archs()) == 14
    for arch in ARCHS:
        ts, js = tget(arch), jget(arch)
        assert ts.family == js.family == "vision"
        for t, j in ((ts.full, js.full), (ts.smoke, js.smoke)):
            td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
            assert str(td.pop("dtype")).split(".")[-1] == \
                jnp.dtype(jd.pop("dtype")).name
            assert td == jd
    assert tget("resnet-18").full.dtype == torch.float32
    assert all(tget(a).full.dtype == torch.bfloat16 for a in ARCHS[1:])


# -- layers ---------------------------------------------------------------


@pytest.mark.parametrize("jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("c,bias", [(8, True), (64, True), (3, False),
                                    (96, True)])
def test_groupnorm_matches(c, bias, jdt, tol):
    """min(32, c) contiguous groups: 8 groups of 1, 32 of 2, 3 of 1, 32
    of 3."""
    rng = np.random.RandomState(c)
    x = rng.randn(2, 5, 6, c) * 3 + 1
    p = {"scale": 1 + 0.1 * rng.randn(c)}
    if bias:
        p["b"] = 0.1 * rng.randn(c)
    jx, tx = _pair(x, jdt)
    jp = {k: _pair(v, jdt)[0] for k, v in p.items()}
    tp = {k: _pair(v, jdt)[1] for k, v in p.items()}
    _close(TLY.groupnorm(tp, tx), JLY.groupnorm(jp, jx), tol)


@pytest.mark.parametrize("jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("bias", [True, False])
def test_layernorm_matches(bias, jdt, tol):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 48) * 2 - 0.5
    p = {"scale": 1 + 0.1 * rng.randn(48)}
    if bias:
        p["b"] = 0.1 * rng.randn(48)
    jx, tx = _pair(x, jdt)
    _close(TLY.layernorm({k: _pair(v, jdt)[1] for k, v in p.items()}, tx),
           JLY.layernorm({k: _pair(v, jdt)[0] for k, v in p.items()}, jx),
           tol)


def test_norm_init_bias_is_the_vision_default_only():
    """The LM's norms stay bias-free; ``bias=True`` adds a zero ``b``,
    as the reference's default."""
    lm = TLY.norm_init(6, dtype=torch.float32, device="cpu")
    vis = TLY.norm_init(6, bias=True, dtype=torch.float32, device="cpu",
                        layers=3)
    ref = JLY.norm_init(6)
    assert set(lm) == {"scale"} and set(vis) == set(ref) == {"scale", "b"}
    assert vis["b"].shape == (3, 6) and not vis["b"].any()


@pytest.mark.parametrize("jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_mlp_matches(quant, jdt, tol):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 16)
    p = {"wi": {"w": rng.randn(16, 40) / 4, "b": 0.1 * rng.randn(40)},
         "wo": {"w": rng.randn(40, 16) / 6, "b": 0.1 * rng.randn(16)}}
    jx, tx = _pair(x, jdt)
    jp = jax.tree_util.tree_map(lambda v: _pair(v, jdt)[0], p)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    _close(TLY.mlp(tp, tx, qctx=TLY.QuantCtx() if quant else None),
           JLY.mlp(jp, jx, qctx=JLY.QuantCtx() if quant else None), tol)


@pytest.mark.parametrize("jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("patch,res,quant", [(8, 32, False), (7, 28, True),
                                             (16, 48, False)])
def test_patch_embed_matches(patch, res, quant, jdt, tol):
    rng = np.random.RandomState(patch)
    x = rng.rand(2, res, res, 3)
    p = {"w": rng.randn(patch, patch, 3, 24) / (patch * 1.7),
         "b": 0.1 * rng.randn(24)}
    jx, tx = _pair(x, jdt)
    jp = {k: _pair(v, jdt)[0] for k, v in p.items()}
    tp = {k: _pair(v, jdt)[1] for k, v in p.items()}
    want = JLY.patch_embed(jp, jx, patch=patch,
                           qctx=JLY.QuantCtx() if quant else None)
    got = TLY.patch_embed(tp, tx, patch=patch,
                          qctx=TLY.QuantCtx() if quant else None)
    assert got.shape == (2, (res // patch) ** 2, 24)
    _close(got, want, tol)


@pytest.mark.parametrize("jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("window,stride,padding,hw",
                         [(3, 2, "SAME", 14),    # pads (0, 1)
                          (3, 2, "SAME", 15),    # pads (1, 1)
                          (4, 2, "SAME", 7),     # pads (1, 2)
                          (5, 1, "SAME", 6),     # pads (2, 2)
                          (3, 1, "SAME", 7),
                          (2, 2, "VALID", 8),
                          (3, 2, "VALID", 13)])
def test_avgpool2d_matches(window, stride, padding, hw, jdt, tol):
    """Divides by the cells that are not padding (an edge window of a
    positive input keeps its mean, not a diluted one)."""
    x = np.random.RandomState(hw).rand(2, hw, hw, 5) + 0.5
    jx, tx = _pair(x, jdt)
    want = JLY.avgpool2d(jx, window=window, stride=stride, padding=padding)
    got = TLY.avgpool2d(tx, window=window, stride=stride, padding=padding)
    _close(got, want, tol)


def _qkv(seed, b, sq, sk, h, d, jdt):
    rng = np.random.RandomState(seed)
    return [_pair(rng.randn(b, s, h, d), jdt) for s in (sq, sk, sk)]


@pytest.mark.parametrize("jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("causal,q_offset,sq,sk", [
    (False, 0, 9, 9), (True, 0, 9, 9), (True, 3, 4, 7),
    (True, "rows", 3, 8)])
def test_sdpa_matches(causal, q_offset, sq, sk, jdt, tol):
    """Non-causal, causal, causal from a scalar offset, and per-row
    offsets ([B]; row 1's first query sees only key 0)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(sq * 10 + sk, 2, sq, sk, 3, 8, jdt)
    if q_offset == "rows":
        joff, toff = jnp.asarray([5, 0]), torch.tensor([5, 0])
    else:
        joff, toff = q_offset, q_offset
    want = JLY._sdpa(jq, jk, jv, causal=causal, q_offset=joff)
    got = TLY._sdpa(tq, tk, tv, causal=causal, q_offset=toff)
    _close(got, want, tol)


def _attn_params(d, n_heads, n_kv, jdt, seed=4):
    rng = np.random.RandomState(seed)
    hd = d // n_heads
    p = {"wq": {"w": rng.randn(d, n_heads * hd) / np.sqrt(d)},
         "wk": {"w": rng.randn(d, n_kv * hd) / np.sqrt(d)},
         "wv": {"w": rng.randn(d, n_kv * hd) / np.sqrt(d)},
         "wo": {"w": rng.randn(n_heads * hd, d) / np.sqrt(d)}}
    jp = jax.tree_util.tree_map(lambda v: _pair(v, jdt)[0], p)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


@pytest.mark.parametrize("jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n_heads,n_kv,causal,quant", [
    (4, 4, False, False), (4, 4, False, True), (4, 2, True, False),
    (6, 2, False, True)])
def test_attention_without_cache_matches(n_heads, n_kv, causal, quant, jdt,
                                         tol):
    """ViT's form: no cache, GQA repeat, named projections; no new
    cache."""
    jp, tp = _attn_params(24, n_heads, n_kv, jdt)
    jx, tx = _pair(np.random.RandomState(5).randn(2, 7, 24), jdt)
    want, jc = JLY.attention(jp, jx, n_heads=n_heads, n_kv=n_kv,
                             causal=causal,
                             qctx=JLY.QuantCtx() if quant else None)
    got, tc = TLY.attention(tp, tx, n_heads=n_heads, n_kv=n_kv,
                            causal=causal,
                            qctx=TLY.QuantCtx() if quant else None)
    assert jc is None and tc is None
    _close(got, want, tol)


def test_attention_calibrates_under_the_references_names():
    """``{name}/q|k|v|o/in``: the key sets of one calibration pass, and
    the static lattice replayed from the bridged thresholds."""
    jp, tp = _attn_params(24, 4, 4, jnp.float32)
    x = np.random.RandomState(6).randn(2, 7, 24).astype(np.float32)
    jctx, tctx = JLY.make_calib_ctx(), TLY.make_calib_ctx()
    JLY.attention(jp, jnp.asarray(x), n_heads=4, n_kv=4, causal=False,
                  qctx=jctx, name="blk")
    TLY.attention(tp, torch.tensor(x), n_heads=4, n_kv=4, causal=False,
                  qctx=tctx, name="blk")
    jsc, tsc = jctx.finalize_calibration(), tctx.finalize_calibration()
    assert sorted(tsc) == sorted(jsc) == sorted(
        f"blk/{p}/in" for p in "qkvo")
    for k, qp in jsc.items():
        np.testing.assert_allclose(tsc[k].scale.numpy(),
                                   np.asarray(qp.scale), rtol=1e-6)


def test_bf16_lattice_is_taken_in_f32_as_in_jax():
    """One range for a bf16 tensor: JAX divides by the f32 scale in f32,
    and the port too (torch alone would keep a 0-dim f32 scale's
    quotient in bf16 and land on other points).  The lattice and the
    fake-quant values are exact and f32."""
    x = jnp.asarray(np.random.RandomState(7).randn(4, 33) * 3, jnp.bfloat16)
    tx = params_from_numpy(np.asarray(x), "cpu")
    jqp, tqp = JQ.compute_qparams(x), TQ.compute_qparams(tx)
    np.testing.assert_array_equal(tqp.scale.numpy(), np.asarray(jqp.scale))
    np.testing.assert_array_equal(TQ.quantize(tx, tqp).numpy(),
                                  np.asarray(JQ.quantize(x, jqp)))
    want, got = JQ.fake_quant(x, jqp), TQ.fake_quant(tx, tqp)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- graphs, candidates, Algorithm 1 ---------------------------------------


def _rows(g):
    return [(n.name, n.op, list(n.inputs), tuple(n.out_shape), n.flops,
             n.param_elems, n.parametric) for n in (g[k] for k in g.topo())]


def _cand_rows(cands):
    return [(c.name, c.edge_flops, c.edge_param_elems, c.transmit_bytes,
             [(b.source, b.elems, b.precision) for b in c.blobs])
            for c in cands]


def _graphs(arch, batch=1):
    jm, tm = _mods(arch)
    return (jm.make_graph(jget(arch).full, batch=batch),
            tm.make_graph(tget(arch).full, batch=batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_and_candidates_match(arch):
    jg, tg = _graphs(arch)
    assert _rows(tg) == _rows(jg)
    assert (_cand_rows(TP.candidate_partition_points(tg))
            == _cand_rows(JP.candidate_partition_points(jg)))
    assert _rows(_graphs(arch, batch=4)[1]) == _rows(_graphs(arch, 4)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_algorithm1_matches(arch):
    """Every row and the pick at 70 KB/s (Table 3's ResNet-18 bandwidth)
    and at the quickstart's bandwidths."""
    jg, tg = _graphs(arch)
    jt = JA.AutoTuner(jg, JCM.EDGE_TX2_CLASS, JCM.CLOUD_TITANXP_CLASS)
    tt = TA.AutoTuner(tg, TCM.EDGE_TX2_CLASS, TCM.CLOUD_TITANXP_CLASS)
    for kbps in sorted({70, *BANDWIDTHS_KBPS}):
        jbest, jperfs = jt.tune(JCM.Channel.from_kbps(kbps))
        tbest, tperfs = tt.tune(TCM.Channel.from_kbps(kbps))
        assert ([dataclasses.asdict(p) for p in tperfs]
                == [dataclasses.asdict(p) for p in jperfs]), kbps
        assert tbest.point == jbest.point, kbps


@pytest.mark.parametrize("arch,n_cands,n_segs,pick", [
    ("resnet-18", 11, 10, "head"), ("resnet-152", 53, 52, "input"),
    ("vit-s16", 27, 14, "patch"), ("deit-b", 27, 14, "input"),
    ("vit-h14", 67, 34, "input")])
def test_cuts_and_picks_at_70_kbps(arch, n_cands, n_segs, pick):
    """The candidate and segment counts (an engine cuts at ``input`` or a
    segment: ViT's ``blk{i}/attn`` candidates end no segment) and
    Algorithm 1's pick, on graphs built from meta-device weights."""
    cfg = tget(arch).full
    params = _tinit(arch)(torch.Generator().manual_seed(0), cfg,
                          device="meta")
    model = _mods(arch)[1].make_segments(params, cfg)
    model.verify_alignment()
    assert len(model.candidate_names()) == n_cands
    assert len(model.segments) == n_segs
    attn = [c for c in model.candidate_names() if c.endswith("/attn")]
    assert len(attn) == (cfg.n_layers if arch.startswith(("vit", "deit"))
                         else 0)
    best, _ = TA.AutoTuner(model.graph, TCM.EDGE_TX2_CLASS,
                           TCM.CLOUD_TITANXP_CLASS).tune(
        TCM.Channel.from_kbps(70))
    assert best.point == pick


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_parameter_counts_match(arch, size):
    """The port's init (on the meta device: no memory) has JAX's tree
    shape for shape; ViT's ``param_count`` is that count in both
    packages; ResNet's graph counts every parameter."""
    jcfg, tcfg = getattr(jget(arch), size), getattr(tget(arch), size)
    jshapes = _shapes(arch, jcfg)
    tparams = _tinit(arch)(torch.Generator().manual_seed(0), tcfg,
                           device="meta")
    jflat = {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype.name)
             for k, v in jax.tree_util.tree_leaves_with_path(jshapes)}
    tflat = {jax.tree_util.keystr(k): (tuple(v.shape),
                                       str(v.dtype).split(".")[-1])
             for k, v in jax.tree_util.tree_leaves_with_path(tparams)}
    assert tflat == jflat
    n = sum(int(np.prod(s)) for s, _ in tflat.values())
    if arch.startswith("resnet"):
        assert TR.make_graph(tcfg, batch=1).total_param_elems() == n
    else:
        assert tcfg.param_count() == jcfg.param_count() == n
