"""Port parity: the fused INT8 GEMM's front doors and plain version
(``repro_torch.kernels.ops`` / ``.ref``) against ``repro.kernels.ops``
(the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it) and ``repro.kernels.ref``, on the same numpy inputs.

Tolerances: f32 outputs to rtol 1e-5, atol 1e-4 (the JAX suite's own:
XLA and PyTorch round the f32 epilogue in different places); int8
outputs within one lattice step in under 1 % of elements; the identity
epilogue (unit scales, zero zero points) exactly, since every int32 sum
there fits f32's mantissa.  On the CPU the front door takes the plain
version and launches nothing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis; skip, don't "
    "kill collection of the whole tier-1 suite")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.quant import QuantParams as JQP  # noqa: E402
from repro.core.quant import compute_qparams  # noqa: E402
from repro.core.quant import quantize as jquantize  # noqa: E402
from repro.kernels import int8_matmul as JK  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.bridge import qparams_from_numpy  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import int8_matmul as TK  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

F32_TOL = dict(rtol=1e-5, atol=1e-4)
SHAPES = [(8, 16, 8), (16, 32, 24), (128, 128, 128), (64, 256, 96),
          (1, 64, 40), (33, 65, 17)]


def _inputs(m, k, n, seed=0, per_channel=False):
    """The JAX suite's inputs (``tests/test_kernels.py::_mk_inputs``),
    quantized by the JAX package, for both sides."""
    rng = np.random.RandomState(seed)
    a = jnp.asarray(rng.uniform(-4, 3, (m, k)).astype(np.float32))
    w = jnp.asarray(rng.uniform(-0.8, 1.1, (k, n)).astype(np.float32))
    qa = compute_qparams(a)
    qw = compute_qparams(w, axis=1 if per_channel else None)
    return jquantize(a, qa), jquantize(w, qw), qa, qw


def _t(x):
    return torch.tensor(np.asarray(x))


def _qp(qp):
    return qparams_from_numpy(qp, "cpu")


def _three_ways(a_q, b_q, qa, qw, **kw):
    """(Pallas in interpret mode, JAX oracle, port front door) as numpy;
    the port's front door must launch nothing on CPU tensors."""
    t_kw = dict(kw)
    if kw.get("bias") is not None:
        t_kw["bias"] = _t(kw["bias"])
    if kw.get("out_qp") is not None:
        t_kw["out_qp"] = _qp(kw["out_qp"])
    before = TK.int8_matmul_cuda.launches
    got = TO.int8_matmul(_t(a_q), _t(b_q), _qp(qa), _qp(qw), **t_kw)
    assert TK.int8_matmul_cuda.launches == before
    pallas = JO.int8_matmul(a_q, b_q, qa, qw, interpret=True, **kw)
    oracle = JR.int8_matmul_ref(a_q, b_q, qa, qw, **kw)
    return np.asarray(pallas), np.asarray(oracle), got.numpy()


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("per_channel", [False, True])
def test_matches_reference_f32_out(m, k, n, per_channel):
    a_q, b_q, qa, qw = _inputs(m, k, n, seed=m + n, per_channel=per_channel)
    pallas, oracle, got = _three_ways(a_q, b_q, qa, qw)
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got, oracle, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
def test_fused_activation_and_bias(act):
    a_q, b_q, qa, qw = _inputs(32, 64, 48, seed=7, per_channel=True)
    bias = jnp.asarray(np.random.RandomState(8).randn(48).astype(np.float32))
    pallas, oracle, got = _three_ways(a_q, b_q, qa, qw, bias=bias, act=act)
    np.testing.assert_allclose(got, oracle, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; torch's default (erf) differs by
    more than the tolerance on these inputs."""
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(TR._ACTS["gelu"](x).numpy(), want, **F32_TOL)
    assert np.abs(torch.nn.functional.gelu(x).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("act", ["relu", "silu", "gelu"])
def test_requant_int8_out(act):
    a_q, b_q, qa, qw = _inputs(64, 128, 32, seed=3)
    ref_f32 = JR.int8_matmul_ref(a_q, b_q, qa, qw, act=act)
    out_qp = compute_qparams(ref_f32)
    pallas, oracle, got = _three_ways(a_q, b_q, qa, qw, act=act,
                                      out_qp=out_qp)
    assert got.dtype == np.int8
    for want in (oracle, pallas):
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01


def test_multi_k_step_accumulation():
    """K = 512 spans several of the CUDA kernel's 128-deep tiles and the
    Pallas kernel's forced 128-deep K grid."""
    a_q, b_q, qa, qw = _inputs(16, 512, 16, seed=5)
    got = TO.int8_matmul(_t(a_q), _t(b_q), _qp(qa), _qp(qw)).numpy()
    pallas = JO.int8_matmul(a_q, b_q, qa, qw, block=(16, 16, 128),
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(JR.int8_matmul_ref(a_q, b_q, qa, qw)), **F32_TOL)


def test_identity_epilogue_is_the_exact_int32_product():
    rng = np.random.RandomState(9)
    a = rng.randint(-128, 128, (33, 300)).astype(np.int8)
    b = rng.randint(-128, 128, (300, 17)).astype(np.int8)
    one = TQ.QuantParams(scale=torch.tensor(1.0),
                         zero_point=torch.tensor(0.0))
    got = TO.int8_matmul(torch.tensor(a), torch.tensor(b), one, one)
    np.testing.assert_array_equal(
        got.numpy(), (a.astype(np.int64) @ b.astype(np.int64))
        .astype(np.float32))


def test_matmul_against_float_truth():
    m, k, n = 64, 256, 64
    rng = np.random.RandomState(11)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    ta, tw = torch.tensor(a), torch.tensor(w)
    qa, qw = TQ.compute_qparams(ta), TQ.compute_qparams(tw, axis=1)
    got = TO.int8_matmul(TQ.quantize(ta, qa), TQ.quantize(tw, qw), qa, qw)
    truth = ta @ tw
    assert float(torch.linalg.norm(got - truth)
                 / torch.linalg.norm(truth)) < 0.01


def test_quantized_dense_3d_batch():
    rng = np.random.RandomState(12)
    x = rng.randn(4, 9, 32).astype(np.float32)
    w = rng.randn(32, 24).astype(np.float32)
    qx = compute_qparams(jnp.asarray(x))
    qw = compute_qparams(jnp.asarray(w), axis=1)
    w_q = jquantize(jnp.asarray(w), qw)
    want = JR.quantized_dense_ref(jnp.asarray(x), w_q, qx, qw, act="relu")
    pallas = JO.quantized_dense(jnp.asarray(x), w_q, qx, qw, act="relu",
                                interpret=True)
    got = TO.quantized_dense(_t(x), _t(w_q), _qp(qx), _qp(qw), act="relu")
    ref = TR.quantized_dense_ref(_t(x), _t(w_q), _qp(qx), _qp(qw),
                                 act="relu")
    assert tuple(got.shape) == (4, 9, 24)
    for other in (want, pallas, ref.numpy()):
        np.testing.assert_allclose(got.numpy(), np.asarray(other),
                                   **F32_TOL)


def test_sub_int8_requant_follows_the_oracle_not_the_pallas_clip():
    """At 4-bit output the two JAX functions disagree: the Pallas
    epilogue clips to int8's range and always writes int8, the oracle
    clips to [qmin, qmax] of ``out_qp`` and casts to its storage type.
    The port follows the oracle (ROADMAP C)."""
    a_q, b_q, qa, qw = _inputs(24, 64, 20, seed=13, per_channel=True)
    for signed in (True, False):
        out_qp = JQP(scale=jnp.float32(0.05), zero_point=jnp.float32(
            0.0 if signed else 8.0), bits=4, signed=signed)
        pallas, oracle, got = _three_ways(a_q, b_q, qa, qw, out_qp=out_qp)
        assert pallas.dtype == np.int8
        assert oracle.dtype == (np.int8 if signed else np.uint8)
        assert not np.array_equal(pallas.astype(np.int32),
                                  oracle.astype(np.int32))
        assert got.dtype == oracle.dtype
        assert oracle.min() >= out_qp.qmin and oracle.max() <= out_qp.qmax
        diff = np.abs(got.astype(np.int32) - oracle.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_pallas_kernel_clip_is_int8_range():
    """The divergence above comes from the kernel itself, not from the
    front door's padding: the raw Pallas call at 4-bit requant params
    still produces values outside [-8, 7]."""
    a_q, b_q, qa, qw = _inputs(16, 32, 16, seed=14)
    n = b_q.shape[1]
    out = JK.int8_matmul_pallas(
        a_q, b_q, qa.scale, qa.zero_point,
        jnp.broadcast_to(qw.scale, (n,)),
        jnp.broadcast_to(qw.zero_point, (n,)), jnp.zeros((n,)),
        jnp.float32(0.05), jnp.float32(0.0), true_k=32, block=(16, 16, 32),
        requant=True, interpret=True)
    assert int(jnp.max(out)) > 7 or int(jnp.min(out)) < -8


def test_kernel_launcher_needs_cuda_tensors():
    a_q, b_q, qa, qw = _inputs(4, 16, 8, seed=15)
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        TK.int8_matmul_cuda(_t(a_q), _t(b_q), one, one, torch.ones(8),
                            torch.ones(8))
    assert TK.int8_matmul_cuda.launches == 0


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 80), st.integers(1, 40),
       st.booleans())
def test_prop_any_shape_matches_reference(m, k, n, per_channel):
    a_q, b_q, qa, qw = _inputs(m, k, n, seed=m * 89 + k * 7 + n,
                               per_channel=per_channel)
    got = TO.int8_matmul(_t(a_q), _t(b_q), _qp(qa), _qp(qw)).numpy()
    want = np.asarray(JR.int8_matmul_ref(a_q, b_q, qa, qw))
    np.testing.assert_allclose(got, want, **F32_TOL)


# ---------------------------------------------------------------------------
# The split-K kernel's plan (small M), and a plain model of its merge
# ---------------------------------------------------------------------------

PLAN_KS = [1, 17, 127, 128, 129, 300, 1000, 4096, 11008, 29568, 50000,
           1 << 20]
PLAN_NS = [1, 17, 64, 96, 4100, 11008]


def _slices(k, cluster, slice_k):
    return [(r * slice_k, min((r + 1) * slice_k, k)) for r in range(cluster)]


@pytest.mark.parametrize("m", range(1, TK._SPLITK_MAX_M + 1))
def test_splitk_plan_covers_k_once(m):
    """Every planned launch: 1-8 CTAs a cluster, slices of whole 128-deep
    stages, each non-empty, together exactly K, in at most 227 KB of
    shared memory, at any K (A rides in the ring, so shared memory does
    not grow with K)."""
    for k in PLAN_KS:
        for n in PLAN_NS:
            cluster, slice_k, smem = TK._plan_splitk(m, k, n)
            assert 1 <= cluster <= 8 and slice_k % TK._SK_BK == 0
            sl = _slices(k, cluster, slice_k)
            assert sl[0][0] == 0 and sl[-1][1] == k
            assert all(lo < hi for lo, hi in sl), (m, k, n, plan)
            assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
            assert smem == TK._splitk_smem_bytes(m, slice_k)
            assert smem <= TK._SK_MAX_SMEM


def test_splitk_plan_at_the_edge_shapes():
    """deepseek-7b's decode GEMMs: about one CTA per SM, K split at least
    in two, so 2 CTAs a 64-column tile both where N = 4096 leaves 64
    tiles and where gate/up has 172, 8 where 2 tiles need 66 and K
    allows it; the front door takes the split-K kernel up to its 32
    rows, and no plan above them or at K = 0 (the tiled kernel's
    shapes)."""
    assert TK._plan_splitk(4, 4096, 4096)[:2] == (2, 2048)
    assert TK._plan_splitk(4, 11008, 4096)[:2] == (2, 5504)
    assert TK._plan_splitk(4, 4096, 11008)[:2] == (2, 2048)
    assert TK._plan_splitk(16, 4096, 11008)[:2] == (2, 2048)
    assert TK._plan_splitk(4, 4096, 96)[:2] == (8, 512)
    assert TK._plan_splitk(4, 300, 96)[:2] == (3, 128)
    assert TK._plan_splitk(4, 4096, 4096, cluster=2)[:2] == (2, 2048)
    assert TK._plan_splitk(4, 300, 96, cluster=8)[:2] == (3, 128)
    assert TK._plan_splitk(33, 4096, 4096) is None
    assert TK._plan_splitk(4, 0, 4096) is None
    assert TK._SPLITK_MAX_M == 32


def _splitk_model(a_q, b_q, qa, qb, **kw):
    """The split-K kernel's arithmetic in plain torch: int32 partials of
    the accumulator, rowsum(A) and colsum(B) per planned K slice, summed,
    then the plain version's epilogue."""
    m, k = a_q.shape
    cluster, slice_k = TK._plan_splitk(m, k, b_q.shape[1])[:2]
    acc = rows = cols = 0
    for lo, hi in _slices(k, cluster, slice_k):
        a, b = a_q[:, lo:hi].to(torch.int32), b_q[lo:hi].to(torch.int32)
        acc = acc + a @ b
        rows = rows + a.sum(dim=1, keepdim=True, dtype=torch.int32)
        cols = cols + b.sum(dim=0, keepdim=True, dtype=torch.int32)
    return TR.int8_epilogue_ref(acc, rows, cols, k, qa, qb, **kw)


@pytest.mark.parametrize("m,k,n", [(1, 300, 96), (3, 1000, 17), (4, 4096, 40),
                                   (16, 1, 96), (16, 129, 65), (32, 2000, 8)])
@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("requant", [None, (8, True), (8, False), (16, True)])
def test_splitk_model_equals_plain_exactly(m, k, n, act, requant):
    """Summing int32 partials over the planned slices changes no bit of
    the output, at any activation and requant type: what lets the card
    kernel equal the tiled kernel bitwise."""
    rng = np.random.RandomState(m * 7 + k + n)
    a_q = torch.tensor(rng.randint(-128, 128, (m, k)).astype(np.int8))
    b_q = torch.tensor(rng.randint(-128, 128, (k, n)).astype(np.int8))
    qa = TQ.QuantParams(scale=torch.tensor(0.02), zero_point=torch.tensor(3.0))
    qb = TQ.QuantParams(
        scale=torch.tensor(rng.uniform(1e-4, 1.1e-3, n).astype(np.float32)),
        zero_point=torch.tensor(rng.randint(-6, 7, n).astype(np.float32)),
        axis=1)
    kw = dict(act=act, bias=torch.tensor(rng.randn(n).astype(np.float32)))
    if requant is not None:
        f32 = TR.int8_matmul_ref(a_q, b_q, qa, qb, **kw)
        kw["out_qp"] = TQ.compute_qparams(f32, bits=requant[0],
                                          signed=requant[1])
    want = TR.int8_matmul_ref(a_q, b_q, qa, qb, **kw)
    got = _splitk_model(a_q, b_q, qa, qb, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_splitk_launchers_need_cuda_tensors():
    a_q, b_q, qa, qw = _inputs(4, 16, 8, seed=16)
    one = torch.ones(())
    for fn in (TK.int8_matmul_splitk, TK.int8_matmul_tiled):
        with pytest.raises(ValueError, match="CUDA"):
            fn(_t(a_q), _t(b_q), one, one, torch.ones(8), torch.ones(8))
    assert TK.int8_matmul_splitk.launches == TK.int8_matmul_tiled.launches \
        == TK.int8_matmul_cuda.splitk_launches == 0


# ---------------------------------------------------------------------------
# The wgmma kernel (M > 32): its plan, the dispatch rule, the packed weight
# ---------------------------------------------------------------------------

WG_MS = [33, 48, 64, 65, 100, 127, 128, 129, 256, 257, 512, 1000, 1024]
WG_NS = [1, 8, 40, 96, 127, 4096, 4100, 11008]


@pytest.mark.parametrize("m", WG_MS)
def test_wgmma_plan_covers_every_tile_once(m):
    """Every plan (128- and 192-column tiles, persistent or one CTA per
    tile): the CTAs' walks cover each 128 x BN output tile exactly once,
    no CTA is idle, and the CTA fits in 227 KB of shared memory."""
    for n in WG_NS:
        for bn in (None, 128, 192):
            for persistent in (None, True, False):
                plan = TK._plan_wgmma(m, 4096, n, bn, persistent)
                width, grid, smem = plan
                walks = TK._wgmma_tiles(m, n, plan)
                tiles = [t for w in walks for t in w]
                want = {(r, c) for r in range(0, m, 128)
                        for c in range(0, n, width)}
                assert len(tiles) == len(set(tiles)) and set(tiles) == want
                assert all(walks) and len(walks) == grid
                assert grid == (len(want) if persistent is False
                                else min(len(want), TK._SMS))
                assert smem == TK._wgmma_smem_bytes(width) <= TK._SK_MAX_SMEM


def test_wgmma_plan_at_the_edge_shapes():
    """deepseek-7b's prefill GEMMs at M 512: 4 x 32 = 128 tiles at N 4096,
    one wave on 132 SMs; at N 11008 4 x 58 = 232 tiles of 192 columns,
    walked by 132 CTAs (2 tiles, 384 columns on the busiest, where 128
    columns would give it 3 tiles of the same 384); no plan where K is not
    a positive multiple of 16."""
    assert TK._plan_wgmma(512, 4096, 4096)[:2] == (128, 128)
    assert TK._plan_wgmma(512, 11008, 4096)[:2] == (128, 128)
    assert TK._plan_wgmma(512, 1024, 4096)[:2] == (128, 128)
    assert TK._plan_wgmma(512, 4096, 11008)[:2] == (192, 132)
    assert TK._plan_wgmma(512, 4096, 11008, bn=128)[:2] == (128, 132)
    assert TK._plan_wgmma(512, 4096, 11008, persistent=False)[:2] == (192, 232)
    assert TK._plan_wgmma(33, 4096, 40)[:2] == (128, 1)
    assert TK._plan_wgmma(1024, 4096, 11008)[:2] == (192, 132)
    assert TK._plan_wgmma(512, 4096, 11008, bn=128, persistent=False)[:2] \
        == (128, 344)
    assert len(TK._wgmma_tiles(512, 11008, TK._plan_wgmma(512, 4096,
                                                          11008))[0]) == 2
    for k in (0, 8, 17, 300, 4100 + 1):
        assert TK._plan_wgmma(512, k, 4096) is None
    with pytest.raises(ValueError, match="bn"):
        TK._plan_wgmma(512, 4096, 4096, bn=256)


@pytest.mark.parametrize("m,k,a_ptr,nk_ptr,want", [
    (1, 4096, 0, None, "splitk"),
    (32, 4096, 16, 32, "splitk"),
    (32, 300, 3, None, "splitk"),
    (33, 4096, 0, None, "wgmma"),
    (33, 16, 256, 512, "wgmma"),
    (512, 11008, 64, 128, "wgmma"),
    (1024, 144, 0, 0, "wgmma"),
    (33, 300, 0, None, "tiled"),
    (512, 4104 + 1, 0, None, "tiled"),
    (512, 8, 0, 0, "tiled"),
    (512, 0, 0, None, "tiled"),
    (512, 4096, 1, None, "tiled"),
    (512, 4096, 0, 8, "tiled"),
])
def test_dispatch_rule(m, k, a_ptr, nk_ptr, want):
    """The front door's kernel from the shape and the alignment alone:
    split-K at M <= 32, wgmma above where K is a positive multiple of 16
    and A's and the packed weight's bases are 16-byte aligned (a weight
    packed for the call always is), the tiled kernel otherwise."""
    assert TK._design(m, k, a_ptr, nk_ptr) == want


@pytest.mark.parametrize("k,n", [(1, 1), (16, 8), (17, 33), (300, 40),
                                 (4096, 96)])
def test_pack_int8_weight_ref(k, n):
    """The plain pack: the contiguous transpose and the exact int32
    colsum (int8 extremes included, past int8's and int16's range)."""
    rng = np.random.RandomState(k + n)
    w = rng.randint(-128, 128, (k, n)).astype(np.int8)
    w[:, 0] = -128
    nk, colsum = TR.pack_int8_weight_ref(torch.tensor(w))
    assert nk.is_contiguous() and nk.dtype == torch.int8
    np.testing.assert_array_equal(nk.numpy(), w.T)
    assert colsum.dtype == torch.int32
    np.testing.assert_array_equal(colsum.numpy(),
                                  w.astype(np.int64).sum(0))


def test_pack_int8_weight_on_cpu_takes_the_plain_version():
    w = torch.tensor(np.random.RandomState(3).randint(
        -128, 128, (300, 40)).astype(np.int8))
    p = TK.pack_int8_weight(w)
    assert isinstance(p, TK.PackedInt8Weight)
    assert p.kn is w and p.shape == w.shape
    assert torch.equal(p.nk, w.t()) and torch.equal(p.colsum,
                                                    w.sum(0, dtype=torch.int32))
    assert TK.pack_int8_weight_cuda.launches == 0
    with pytest.raises(ValueError, match="int8"):
        TK.pack_int8_weight(w.float())


@pytest.mark.parametrize("m", [33, 64, 130])
@pytest.mark.parametrize("k", [64, 300, 4096])
def test_packed_weight_matches_reference(m, k):
    """The front doors on a ``PackedInt8Weight`` equal the plain [K, N]
    call exactly and the JAX ``int8_matmul`` (Pallas in interpret mode)
    and oracle within the f32 tolerance, at the wgmma kernel's M (and K
    300, which takes the tiled kernel on the card)."""
    a_q, b_q, qa, qw = _inputs(m, k, 40, seed=m + k, per_channel=True)
    packed = TK.pack_int8_weight(_t(b_q))
    got = TO.int8_matmul(_t(a_q), packed, _qp(qa), _qp(qw))
    plain = TO.int8_matmul(_t(a_q), _t(b_q), _qp(qa), _qp(qw))
    assert torch.equal(got, plain)
    pallas = JO.int8_matmul(a_q, b_q, qa, qw, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JR.int8_matmul_ref(a_q, b_q, qa, qw)),
        **F32_TOL)
    assert TK.int8_matmul_cuda.launches == TK.int8_matmul_cuda.pack_launches \
        == TK.int8_matmul_cuda.wgmma_launches == 0


@pytest.mark.parametrize("act,requant", [(None, False), ("relu", True),
                                         ("silu", False)])
def test_quantized_dense_on_a_packed_weight(act, requant):
    """``quantized_dense`` on a packed weight equals the plain call and
    the JAX front door (interpret mode): f32 within the tolerance, the
    requantized lattice within one step in under 1 % of elements."""
    rng = np.random.RandomState(17)
    x = rng.randn(2, 40, 256).astype(np.float32)
    w = rng.randn(256, 48).astype(np.float32)
    qx = compute_qparams(jnp.asarray(x))
    qw = compute_qparams(jnp.asarray(w), axis=1)
    w_q = jquantize(jnp.asarray(w), qw)
    out_qp = None
    if requant:
        out_qp = compute_qparams(JR.quantized_dense_ref(
            jnp.asarray(x), w_q, qx, qw, act=act))
    t_out = None if out_qp is None else _qp(out_qp)
    packed = TK.pack_int8_weight(_t(w_q))
    got = TO.quantized_dense(_t(x), packed, _qp(qx), _qp(qw), act=act,
                             out_qp=t_out)
    plain = TO.quantized_dense(_t(x), _t(w_q), _qp(qx), _qp(qw), act=act,
                               out_qp=t_out)
    assert torch.equal(got, plain) and tuple(got.shape) == (2, 40, 48)
    pallas = np.asarray(JO.quantized_dense(jnp.asarray(x), w_q, qx, qw,
                                           act=act, out_qp=out_qp,
                                           interpret=True))
    if requant:
        diff = np.abs(got.numpy().astype(np.int32) - pallas.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(got.numpy(), pallas, **F32_TOL)


def test_wgmma_launchers_need_cuda_tensors():
    a_q, b_q, qa, qw = _inputs(64, 64, 8, seed=18)
    one = torch.ones(())
    packed = TK.pack_int8_weight(_t(b_q))
    with pytest.raises(ValueError, match="CUDA"):
        TK.int8_matmul_wgmma(_t(a_q), packed, one, one, torch.ones(8),
                             torch.ones(8))
    with pytest.raises(ValueError, match="PackedInt8Weight"):
        TK.int8_matmul_wgmma(_t(a_q), _t(b_q), one, one, torch.ones(8),
                             torch.ones(8))
    for b in (_t(b_q), packed):
        with pytest.raises(ValueError, match="CUDA"):
            TK.int8_matmul_cuda(_t(a_q), b, one, one, torch.ones(8),
                                torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        TK.pack_int8_weight_cuda(_t(b_q))
    assert TK.int8_matmul_wgmma.launches == TK.pack_int8_weight_cuda.launches \
        == TK.int8_matmul_cuda.wgmma_launches == 0


def test_library_names_hash_the_shared_headers(tmp_path, monkeypatch):
    """A shared header's edit renames (so rebuilds) every library; a
    source's edit only its own."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    names = _build.sources()
    assert {"int8_matmul", "int8_matmul_sm90", "paged_attention"} <= \
        set(names)
    before = {n: _build._lib_path(n) for n in names}
    hdr = csrc / "int8_epilogue.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in names}
    assert all(before[n] != after[n] for n in names)
    src = csrc / "int8_matmul.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: _build._lib_path(n) for n in names}
    assert again["int8_matmul"] != after["int8_matmul"]
    assert all(again[n] == after[n] for n in names if n != "int8_matmul")
