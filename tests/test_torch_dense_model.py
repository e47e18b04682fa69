"""Port parity: the cacheless LM forward, the dense KV caches,
``q_chunk``, ``split_blocks`` and ``make_segments`` of
``repro_torch.models.transformer`` against ``repro.models.transformer``
on the same numpy-seeded inputs with bridged JAX weights (a 3-layer GQA
model, 4 heads over 2 kv heads; twins of ``tests/test_transformer.py``'s
dense cases and of ``tests/test_int8_kv.py``).

Tolerances: f32 logits to atol 1e-4 (XLA and PyTorch sum the GEMMs in
other orders); fp cache contents to 1e-5; an INT8 cache's lattice equal
in at least 99.9 % of elements and never more than one step apart (an
f32 difference in the last place can move a value across a rounding
boundary); the same function computed two ways inside the port (the
reference test's own check) to 2e-4, and ``q_chunk`` against the whole
block to 1e-6 (the same sums, split by query rows)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.collab import CollaborativeEngine as JCollab  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy, tree_map  # noqa: E402
from repro_torch.core.collab import CollaborativeEngine  # noqa: E402
from repro_torch.core.partition import candidate_partition_points  # noqa: E402,E501
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

CFG = JT.LMConfig(name="tiny-dense", n_layers=3, d_model=32, n_heads=4,
                  n_kv=2, d_ff=64, vocab=128, max_seq=64, remat=False)
TCFG = TT.LMConfig(name="tiny-dense", n_layers=3, d_model=32, n_heads=4,
                   n_kv=2, d_ff=64, vocab=128)
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), CFG)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, CFG.vocab,
                                               (b, s)).astype(np.int32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _assert_lattice_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_forward_shapes_finite_and_equal_to_reference(params):
    jp, tp = params
    toks = _tokens(2, 16)
    jl, jaux = JT.forward(jp, jnp.asarray(toks), CFG)
    tl, taux = TT.forward(tp, torch.tensor(toks), TCFG)
    assert tuple(tl.shape) == (2, 16, CFG.vocab)
    assert bool(torch.isfinite(tl).all())
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0
    assert taux.dtype == torch.float32 and taux.ndim == 0


def test_causality(params):
    """Changing a future token must not affect earlier logits."""
    _, tp = params
    t1 = _tokens(1, 12, seed=3)
    t2 = t1.copy()
    t2[0, -1] = (t2[0, -1] + 1) % CFG.vocab
    l1, _ = TT.forward(tp, torch.tensor(t1), TCFG)
    l2, _ = TT.forward(tp, torch.tensor(t2), TCFG)
    torch.testing.assert_close(l1[0, :-1], l2[0, :-1], atol=1e-5, rtol=0)
    assert not torch.allclose(l1[0, -1], l2[0, -1])


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_prefill_then_decode_matches_forward(params, vector):
    """The dense fp cache path agrees with the cacheless forward, and each
    step with the reference's, at a scalar and at a per-row
    ``cache_index``."""
    jp, tp = params
    b, s = 2, 10
    toks = _tokens(b, s + 1, seed=5)
    full, _ = TT.forward(tp, torch.tensor(toks), TCFG)

    jc = JT.init_cache(CFG, b, max_len=32)
    tc = TT.init_cache(TCFG, b, max_len=32, device="cpu")
    assert tuple(tc["k"].shape) == (CFG.n_layers, b, 32, CFG.n_kv, CFG.hd)
    assert tc["k"].dtype == torch.float32
    jlast, jc = JT.prefill(jp, jnp.asarray(toks[:, :s]), CFG, cache=jc)
    tlast, tc = TT.prefill(tp, torch.tensor(toks[:, :s]), TCFG, cache=tc)
    _close(tlast, jlast)
    torch.testing.assert_close(tlast, full[:, s - 1], atol=2e-4, rtol=2e-4)
    idx = np.full((b,), s, np.int32) if vector else np.int32(s)
    jstep, jc = JT.decode_step(jp, jnp.asarray(toks[:, s]), jc,
                               jnp.asarray(idx), CFG)
    tstep, tc = TT.decode_step(tp, torch.tensor(toks[:, s]), tc,
                               torch.tensor(idx), TCFG)
    _close(tstep, jstep)
    torch.testing.assert_close(tstep, full[:, s], atol=2e-4, rtol=2e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-5, rtol=1e-5)


def test_split_cache_logits_match_monolithic(params):
    """Prefill and one per-row step over two dense caches (edge prefix,
    cloud suffix: ``split_blocks`` at every cut) reproduce ``forward``,
    as ``tests/test_collab_decode.py`` checks the reference."""
    jp, tp = params
    b, s = 2, 8
    toks = _tokens(b, s + 1, seed=4)
    ref, _ = TT.forward(tp, torch.tensor(toks), TCFG)
    rope = TL.rope_table(16, TCFG.hd)
    for cut in range(TCFG.n_layers):
        edge, cloud = TT.split_blocks(tp, TCFG, cut)
        jedge, jcloud = JT.split_blocks(jp, CFG, cut)
        for t, j in ((edge, jedge), (cloud, jcloud)):
            assert TT._n_layers(t) == j["ln1"]["scale"].shape[0]
        ce = TT.init_cache(TCFG, b, 16, layers=cut + 1, device="cpu")
        cc = TT.init_cache(TCFG, b, 16, layers=TCFG.n_layers - cut - 1,
                           device="cpu")
        x = TL.embed(tp["embed"], torch.tensor(toks[:, :s]))
        h, _ = TT.run_blocks(edge, x, TCFG, rope=rope, cache=ce,
                             cache_index=0)
        h, _ = TT.run_blocks(cloud, h, TCFG, rope=rope, cache=cc,
                             cache_index=0)
        torch.testing.assert_close(TT.lm_head(tp, h[:, -1:])[:, 0],
                                   ref[:, s - 1], atol=2e-4, rtol=2e-4)
        pos = torch.full((b,), s, dtype=torch.int32)
        x = TL.embed(tp["embed"], torch.tensor(toks[:, s:s + 1]))
        h, _ = TT.run_blocks(edge, x, TCFG, rope=rope, cache=ce,
                             cache_index=pos)
        h, _ = TT.run_blocks(cloud, h, TCFG, rope=rope, cache=cc,
                             cache_index=pos)
        torch.testing.assert_close(TT.lm_head(tp, h)[:, 0], ref[:, s],
                                   atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="cut_layer"):
        TT.split_blocks(tp, TCFG, TCFG.n_layers)


def test_q_chunk_matches_unchunked_and_reference(params):
    jp, tp = params
    rng = np.random.RandomState(6)
    q = rng.randn(2, 16, 4, 8).astype(np.float32)
    k = rng.randn(2, 24, 4, 8).astype(np.float32)
    v = rng.randn(2, 24, 4, 8).astype(np.float32)
    for off in (8, np.array([8, 3], np.int32)):
        t_off = torch.tensor(off) if isinstance(off, np.ndarray) else off
        whole = TL._sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         causal=True, q_offset=t_off)
        for chunk in (4, 8, 5):        # 5 does not divide 16: no tiling
            got = TL._sdpa(torch.tensor(q), torch.tensor(k),
                           torch.tensor(v), causal=True, q_offset=t_off,
                           q_chunk=chunk)
            torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)
        want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, q_offset=jnp.asarray(off), q_chunk=4)
        _close(whole, want, atol=1e-5)
    # the LM's prefill with a q_chunk config, against the reference's
    toks = _tokens(2, 16, seed=7)
    jcfg = dataclasses.replace(CFG, q_chunk=4)
    tcfg = dataclasses.replace(TCFG, q_chunk=4)
    jl, _ = JT.prefill(jp, jnp.asarray(toks), jcfg,
                       cache=JT.init_cache(jcfg, 2, 32))
    tl, _ = TT.prefill(tp, torch.tensor(toks), tcfg,
                       cache=TT.init_cache(tcfg, 2, 32, device="cpu"))
    tl0, _ = TT.prefill(tp, torch.tensor(toks), TCFG,
                        cache=TT.init_cache(TCFG, 2, 32, device="cpu"))
    _close(tl, jl)
    torch.testing.assert_close(tl, tl0, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_dense_int8_attention_matches_reference(params, vector):
    """One attention layer over a dense INT8 cache: quantized on write
    with per-kv-head scales, dequantized on read, at a scalar index (the
    prefill's slice) and a per-row one; out-of-range rows of the vector
    write are dropped as JAX drops them."""
    jp, tp = params
    b, s, t_len = 3, 4, 12
    rng = np.random.RandomState(8)
    x = rng.randn(b, s, CFG.d_model).astype(np.float32)
    idx = (np.array([2, 10, 7], np.int32) if vector else np.int32(5))
    ks = (0.04 + 0.02 * rng.rand(CFG.n_kv)).astype(np.float32)
    vs = (0.04 + 0.02 * rng.rand(CFG.n_kv)).astype(np.float32)
    k0 = rng.randint(-127, 128, (b, t_len, CFG.n_kv, CFG.hd)).astype(np.int8)
    v0 = rng.randint(-127, 128, (b, t_len, CFG.n_kv, CFG.hd)).astype(np.int8)
    jrope = JL.rope_table(t_len, CFG.hd)
    trope = TL.rope_table(t_len, CFG.hd)
    jattn = jax.tree_util.tree_map(lambda v: v[0], jp["blocks"]["attn"])
    tattn = tree_map(lambda v: v[0], tp["blocks"]["attn"])
    jout, jc = JL.attention(jattn, jnp.asarray(x), n_heads=CFG.n_heads,
                            n_kv=CFG.n_kv, rope=jrope,
                            kv_cache={"k": jnp.asarray(k0),
                                      "v": jnp.asarray(v0)},
                            cache_index=jnp.asarray(idx),
                            kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    tc = {"k": torch.tensor(k0), "v": torch.tensor(v0)}
    tout, tc = TL.attention(tattn, torch.tensor(x), n_heads=CFG.n_heads,
                            n_kv=CFG.n_kv, rope=trope, kv_cache=tc,
                            cache_index=torch.tensor(idx),
                            kv_scales=(torch.tensor(ks), torch.tensor(vs)))
    # JAX's ``take`` fills the RoPE rows of positions past the table with
    # NaN, the port clamps them (ROADMAP C): compare the other rows
    past = (np.asarray(idx)[..., None] + np.arange(s)) >= t_len
    jout = np.asarray(jout)
    assert (np.isnan(jout).any(-1) == np.broadcast_to(past, (b, s))).all()
    assert bool(torch.isfinite(tout).all())
    _close(tout[torch.tensor(~np.broadcast_to(past, (b, s)))],
           jout[~np.broadcast_to(past, (b, s))])
    for k in ("k", "v"):
        assert tc[k].dtype == torch.int8
        _assert_lattice_close(tc[k].numpy(), np.asarray(jc[k]))
    if vector:      # row 1 writes 10, 11 and drops 12, 13
        np.testing.assert_array_equal(tc["k"][1, :10].numpy(), k0[1, :10])


def test_out_of_range_vector_write_is_dropped(params):
    """A verify block past the cache's end (an idle slot's stale
    position) writes nothing there and raises nothing: every position
    the block does not reach keeps its contents, as under JAX's
    scatter."""
    jp, tp = params
    b, s, t_len = 3, 4, 8
    rng = np.random.RandomState(9)
    x = rng.randn(b, s, CFG.d_model).astype(np.float32)
    idx = np.array([6, 8, 11], np.int32)     # partly, wholly past the end
    k0 = rng.randn(b, t_len, CFG.n_kv, CFG.hd).astype(np.float32)
    v0 = rng.randn(b, t_len, CFG.n_kv, CFG.hd).astype(np.float32)
    jattn = jax.tree_util.tree_map(lambda v: v[1], jp["blocks"]["attn"])
    tattn = tree_map(lambda v: v[1], tp["blocks"]["attn"])
    _, jc = JL.attention(jattn, jnp.asarray(x), n_heads=CFG.n_heads,
                         n_kv=CFG.n_kv, rope=JL.rope_table(t_len, CFG.hd),
                         kv_cache={"k": jnp.asarray(k0),
                                   "v": jnp.asarray(v0)},
                         cache_index=jnp.asarray(idx))
    tc = {"k": torch.tensor(k0), "v": torch.tensor(v0)}
    _, tc = TL.attention(tattn, torch.tensor(x), n_heads=CFG.n_heads,
                         n_kv=CFG.n_kv, rope=TL.rope_table(t_len, CFG.hd),
                         kv_cache=tc, cache_index=torch.tensor(idx))
    for k, k_init in (("k", k0), ("v", v0)):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tc[k][0, :6].numpy(), k_init[0, :6])
        np.testing.assert_array_equal(tc[k][1:].numpy(), k_init[1:])


def test_int8_cache_decode_tracks_fp32(params):
    """The dense INT8 cache (scales set to 0.02, step-by-step decode at a
    scalar index) gives the reference's logits, and tracks the fp
    cache as ``tests/test_int8_kv.py`` requires of the reference."""
    jp, tp = params
    toks = np.random.RandomState(0).randint(0, CFG.vocab,
                                            (2, 9)).astype(np.int32)
    tc = TT.init_cache(TCFG, 2, 16, device="cpu")
    _, tc = TT.prefill(tp, torch.tensor(toks[:, :8]), TCFG, cache=tc)
    ref, _ = TT.decode_step(tp, torch.tensor(toks[:, 8]), tc, 8, TCFG)

    jq = JT.init_cache(CFG, 2, 16, quantized=True)
    jq["k_scale"] = jnp.full_like(jq["k_scale"], 0.02)
    jq["v_scale"] = jnp.full_like(jq["v_scale"], 0.02)
    tq = TT.init_cache(TCFG, 2, 16, quantized=True, device="cpu")
    assert tuple(tq["k_scale"].shape) == (CFG.n_layers, CFG.n_kv)
    assert bool((tq["k_scale"] == 0.05).all())
    tq["k_scale"].fill_(0.02)
    tq["v_scale"].fill_(0.02)
    for i in range(9):
        jl, jq = JT.decode_step(jp, jnp.asarray(toks[:, i]), jq,
                                jnp.int32(i), CFG)
        tl, tq = TT.decode_step(tp, torch.tensor(toks[:, i]), tq,
                                torch.tensor(np.int32(i)), TCFG)
        _close(tl, jl)
    assert tq["k"].dtype == torch.int8
    for k in ("k", "v"):
        _assert_lattice_close(tq[k].numpy(), np.asarray(jq[k]))
    rel = float(torch.linalg.norm(tl - ref) / torch.linalg.norm(ref))
    assert rel < 0.25, rel
    agree = float((tl.argmax(-1) == ref.argmax(-1)).float().mean())
    assert agree >= 0.5


def test_int8_cache_is_half_the_bytes():
    def nbytes(c):
        return sum(v.numel() * v.element_size() for v in c.values())

    c32 = TT.init_cache(TCFG, 2, 16, device="cpu")
    c8 = TT.init_cache(TCFG, 2, 16, quantized=True, device="cpu")
    assert nbytes(c8) < nbytes(c32) / 3.5
    jc32 = JT.init_cache(CFG, 2, 16)
    jc8 = JT.init_cache(CFG, 2, 16, quantized=True)
    for t, j in ((c32, jc32), (c8, jc8)):
        assert nbytes(t) == sum(v.size * v.dtype.itemsize
                                for v in j.values())


def test_segments_run_and_align(params):
    jp, tp = params
    m = TT.make_segments(tp, TCFG, seq=16)
    m.verify_alignment()
    jm = JT.make_segments(jp, CFG, seq=16)
    assert [s.name for s in m.segments] == [s.name for s in jm.segments]
    assert m.candidate_names() == [
        c.name for c in candidate_partition_points(
            TT.make_graph(TCFG, batch=1, seq=16))]
    toks = _tokens(1, 16, seed=11)
    out = m.full_apply(torch.tensor(toks))
    ref, _ = TT.forward(tp, torch.tensor(toks), TCFG)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)
    _close(out, jm.full_apply(jnp.asarray(toks)))


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
def test_collaborative_lm_end_to_end(params, calibrated):
    """The paper's ``CollaborativeEngine`` on the LM's segments, cut at
    ``blk1/ffn``: the reference's bytes, calibration names and ranges,
    and an output within the reference test's 15 % of the fp truth and
    within 1e-3 (relative) of the reference engine's."""
    jp, tp = params
    toks = _tokens(1, 16, seed=13)
    calib = [_tokens(1, 16, seed=20 + i) for i in range(2)]
    m = TT.make_segments(tp, TCFG, seq=16)
    jm = JT.make_segments(jp, CFG, seq=16)
    eng = CollaborativeEngine(
        m, "blk1/ffn", device="cpu",
        calib_batches=[torch.tensor(c) for c in calib] if calibrated
        else None)
    jeng = JCollab(jm, "blk1/ffn",
                   calib_batches=[jnp.asarray(c) for c in calib]
                   if calibrated else None)
    truth = m.full_apply(torch.tensor(toks))
    got, rec = eng.infer(torch.tensor(toks))
    jgot, jrec = jeng.infer(jnp.asarray(toks))
    assert rec.precision == jrec.precision == "int8"
    assert rec.blob_bytes == jrec.blob_bytes
    assert eng.edge_download_bytes == jeng.edge_download_bytes
    rel = float(torch.linalg.norm(got - truth) / torch.linalg.norm(truth))
    assert rel < 0.15
    jgot = torch.tensor(np.asarray(jgot))
    assert float(torch.linalg.norm(got - jgot)
                 / torch.linalg.norm(jgot)) < 1e-3
    assert sorted(eng.act_scales) == sorted(jeng.act_scales)
    for name, qp in eng.act_scales.items():
        np.testing.assert_allclose(qp.scale.numpy(),
                                   np.asarray(jeng.act_scales[name].scale),
                                   rtol=1e-5)
    if calibrated:
        assert "attn/q/in" in eng.act_scales
        assert "mlp/wg/in" in eng.act_scales


def test_lm_engine_keeps_token_ids_integer(params):
    """Token ids reach the embed segment as integers on every route:
    ``infer`` (edge and cloud-only), calibration and
    ``last_edge_input``."""
    _, tp = params
    m = TT.make_segments(tp, TCFG, seq=16)
    toks = torch.tensor(_tokens(2, 16, seed=14))
    eng = CollaborativeEngine(m, "embed", device="cpu",
                              calib_batches=[toks])
    assert eng.last_edge_input(toks).dtype == torch.int32
    got, rec = eng.infer(toks)
    ref, _ = TT.forward(tp, toks, TCFG)
    assert rec.blob_bytes == 2 * 16 * TCFG.d_model + 8
    assert tuple(got.shape) == tuple(ref.shape)
    cloud_only = CollaborativeEngine(m, "input", device="cpu")
    got, rec = cloud_only.infer(toks)
    assert rec.precision == "fp32" and rec.blob_bytes == toks.numel() * 4
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
