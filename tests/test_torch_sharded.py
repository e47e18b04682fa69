"""Port parity: tensor-parallel cloud serving of ``repro_torch`` (the
serving mesh, the sharding rules, the sharded paged-attention kernel B3,
the TP transformer and the engines on ``mesh=``) against ``repro``'s
unsharded functions and engines.  ``tests/test_sharded_serve.py`` holds
the JAX package's own sharded kernel and mesh engines bit-exact and
stream-exact to these, so the port is held to them directly.

* The sharded kernel at ``make_serve_mesh(model=4, data=2)`` on the JAX
  test's own inputs: within 1e-5 of JAX's ``paged_flash_mq`` (Pallas
  interpret mode) and bit-exact against the port's unsharded plain
  version; ``n_kv % tp != 0`` takes the unsharded read, and the call
  counter shows it.
* The JAX test's ``shard-tiny`` LM (4 layers, d 32, 4 heads, n_kv 2,
  d_ff 64, vocab 64) with weights bridged by value, cut 1:
  lossless fp streams at tp 1, 2 and 4 (at 4 attention stays whole:
  n_kv 2) with ``spec_k`` 1 and 4 equal the JAX engine's at
  ``mesh=None`` token for token, and every wire byte equals; in the INT8
  default, teacher-forced logits within 1e-4, INT8 pages within one
  lattice step in under 0.1 % of elements, accepted counts and wire
  bytes exact; the cloud-only engine's streams equal JAX's.
* Placement: the cloud suffix splits, the edge and draft blocks do not,
  and each shard's pool holds ``n_kv / tp`` heads.

The JAX engines run in one subprocess with XLA:CPU's asynchronous
dispatch off (ROADMAP C, first fault), as ``test_torch_serve.py`` does.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as JPA  # noqa: E402
from repro.launch import shardings as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy, tree_map  # noqa: E402
from repro_torch.core.costmodel import Channel  # noqa: E402
from repro_torch.kernels import paged_attention as TPA  # noqa: E402
from repro_torch.launch import shardings as TS  # noqa: E402
from repro_torch.launch.mesh import (ServeMesh, engine_device,  # noqa: E402
                                     make_serve_mesh)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import sharding as TSH  # noqa: E402

CFG_KW = dict(name="shard-tiny", n_layers=4, d_model=32, n_heads=4, n_kv=2,
              d_ff=64, vocab=64)
TCFG = TT.LMConfig(**CFG_KW)
COMMON = dict(page_size=8, max_batch=2, max_len=64)
LOSSLESS = dict(a_bits=None, edge_int8=False, cloud_int8=False)
KBPS, RTT_MS = 500.0, 10.0
STAT_FIELDS = ("prefill_calls", "decode_steps", "spec_rounds", "draft_hits",
               "drafted_tokens", "transmitted_bytes", "prefill_bytes",
               "decode_bytes_log", "decode_downlink_bytes")


def _mesh(tp):
    return make_serve_mesh(model=tp, device="cpu")


def _prompts(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TCFG.vocab, n).astype(np.int32) for n in (7, 13)]


def _jcfg():
    return JT.LMConfig(max_seq=64, remat=False, **CFG_KW)


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), _jcfg())
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


_REFERENCE = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
import numpy as np
from repro.core.costmodel import Channel
from repro.models.transformer import LMConfig, init_lm
from repro.serve import engine as JE
CFG = LMConfig(max_seq=64, remat=False, **CFG_KW)
p = init_lm(jax.random.PRNGKey(0), CFG)
def prompts(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32) for n in (7, 13)]
def caches(eng):   # final cache contents, the dump page 0 left out
    named = dict(edge=eng._edge_cache, cloud=eng._cloud_cache,
                 draft=getattr(eng, "_draft_cache", None))
    return {f"{n}.{key}": (np.asarray(v)[:, 1:] if key.endswith("pages")
                           else np.asarray(v)).tolist()
            for n, c in named.items() if c is not None
            for key, v in c.items()}
def run(eng, seed, with_caches=False):
    eng.stats = type(eng.stats)()
    outs = eng.generate(prompts(seed), max_new_tokens=6)
    st = eng.stats
    r = {f: getattr(st, f) for f in STAT_FIELDS}
    r.update(outs=outs, channel_latency_s=st.channel_latency_s)
    if with_caches:
        r["caches"] = caches(eng)
    return r
ch = Channel.from_kbps(KBPS, rtt_ms=RTT_MS)
ref = {}
for k in (1, 4):
    eng = JE.CollaborativeServingEngine(p, CFG, cut_layer=1, spec_k=k,
                                        channel=ch, **COMMON, **LOSSLESS)
    for seed in (0, 1):
        ref[f"lossless_k{k}_s{seed}"] = run(eng, seed)
    eng = JE.CollaborativeServingEngine(p, CFG, cut_layer=1, spec_k=k,
                                        channel=ch, **COMMON)
    ref[f"int8_k{k}"] = run(eng, 0, with_caches=True)
for int8 in (False, True):
    eng = JE.ServingEngine(p, CFG, max_batch=2, max_len=64, paged=True,
                           page_size=8, int8_kv=int8)
    for seed in (0, 1):
        ref[f"cloud_int8{int8}_s{seed}"] = eng.generate(prompts(seed),
                                                       max_new_tokens=6)
json.dump(ref, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' streams, stats and caches, from one subprocess."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = (f"CFG_KW = {CFG_KW!r}\nCOMMON = {COMMON!r}\n"
            f"LOSSLESS = {LOSSLESS!r}\nKBPS = {KBPS!r}\nRTT_MS = {RTT_MS!r}\n"
            f"STAT_FIELDS = {STAT_FIELDS!r}\n" + _REFERENCE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def _assert_lattice_close(got, want):
    """INT8 pages: at most one step apart, in under 0.1 % of elements (a
    one-ulp f32 difference can flip a rounding tie)."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def _whole(cache):
    """A tensor-parallel cache put back together over its kv heads."""
    if isinstance(cache, dict):
        return cache
    return {k: torch.cat([c[k] for c in cache],
                         dim=3 if k.endswith("_pages") else 2)
            for k in cache[0]}


# ---------------------------------------------------------------------------
# The mesh and the sharding rules
# ---------------------------------------------------------------------------


def test_serve_mesh_is_row_major_and_keeps_the_degree():
    m = make_serve_mesh(model=4, data=2, device="cpu")
    assert (m.data, m.model, len(m.devices)) == (2, 4, 8)
    assert m.shape == {"data": 2, "model": 4}
    assert all(d == torch.device("cpu") for d in m.devices)
    # shard i on devices[i % n]: no clamp to the number of devices
    rr = make_serve_mesh(model=3, devices=["cpu", "meta"])
    assert [d.type for d in rr.devices] == ["cpu", "meta", "cpu"]
    assert [d.type for d in rr.model_devices(0)] == ["cpu", "meta", "cpu"]
    with pytest.raises(ValueError):
        ServeMesh((torch.device("cpu"),), 1, 2)
    with pytest.raises(ValueError):
        make_serve_mesh(model=0, device="cpu")


def test_engine_device_takes_one_data_row():
    assert engine_device(None, "cpu") == torch.device("cpu")
    assert engine_device(_mesh(2)) == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        engine_device(make_serve_mesh(model=2, data=2, device="cpu"))
    with pytest.raises(ValueError, match="first device"):
        engine_device(_mesh(2), "meta")


PATHS = [("blocks/attn/wq/w", (3, 32, 64)), ("blocks/attn/wk/w", (3, 32, 16)),
         ("blocks/attn/wo/w", (3, 64, 32)), ("blocks/mlp/wi/w", (3, 32, 96)),
         ("blocks/mlp/wg/w", (3, 32, 96)), ("blocks/mlp/wo/w", (3, 96, 32)),
         ("blocks/ln1/scale", (3, 32)), ("lm_head/w", (32, 100)),
         ("final_norm/scale", (32,))]


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("path,shape", PATHS, ids=[p for p, _ in PATHS])
def test_param_specs_match_reference(path, shape, tp):
    """Where every head group splits whole (n_kv 8 divides tp), the
    port's serving spec is the reference's ``spec_for_param(zero1=True)``
    on the same mesh."""
    mesh = make_serve_mesh(model=tp, data=2, device="cpu")
    want = tuple(JS.spec_for_param(path, shape, mesh, zero1=True))
    want = want + (None,) * (len(shape) - len(want))
    assert TS.spec_for_param(path, shape, mesh, n_kv=8) == want


def test_attention_splits_only_by_whole_kv_heads():
    """n_kv 2 over tp 4 with hd 16: GSPMD splits wk's 32 columns across a
    head, the port keeps attention whole; the embedding stays whole
    where the reference's rule splits its vocab rows."""
    mesh = _mesh(4)
    for path, shape in (("blocks/attn/wk/w", (3, 32, 32)),
                        ("blocks/attn/wq/w", (3, 32, 64)),
                        ("blocks/attn/wo/w", (3, 64, 32))):
        assert "model" in tuple(JS.spec_for_param(path, shape, mesh,
                                                  zero1=True))
        assert TS.spec_for_param(path, shape, mesh, n_kv=2) == \
            (None, None, None)
        assert "model" in TS.spec_for_param(path, shape, mesh, n_kv=4)
    assert tuple(JS.spec_for_param("embed/emb", (64, 32), mesh,
                                   zero1=True))[0] == "model"
    assert TS.spec_for_param("embed/emb", (64, 32), mesh) == (None, None)
    assert TS.attention_splits(4, 1) and not TS.attention_splits(2, 4)


@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (2, 4), (3, 2),
                                        (1, 8)])
def test_pool_and_scale_specs_match_reference(data, model):
    mesh = make_serve_mesh(model=model, data=data, device="cpu")
    for n_pages in (12, 13):
        for n_kv in (2, 4, 8):
            assert TS.paged_pool_spec(mesh, n_pages=n_pages, n_kv=n_kv,
                                      head_dim=16) == tuple(
                JS.paged_pool_spec(mesh, n_pages=n_pages, n_kv=n_kv,
                                   head_dim=16))
            for batch in (2, 3, 4):
                assert TS.paged_scale_spec(mesh, batch=batch,
                                           n_kv=n_kv) == tuple(
                    JS.paged_scale_spec(mesh, batch=batch, n_kv=n_kv))


def test_all_reduce_sum_is_in_shard_order():
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    out = TSH.all_reduce_sum(parts)
    # ((1e8 + 1) - 1e8) in f32 is 0: the order is the shards', fixed
    assert [float(o) for o in out] == [0.0, 0.0, 0.0]
    assert TSH.all_reduce_sum(parts[:1])[0] is parts[0]
    assert TSH.tp_size(None) == 1 and TSH.tp_size(_mesh(4)) == 4


# ---------------------------------------------------------------------------
# The sharded kernel (B3)
# ---------------------------------------------------------------------------


def _kernel_case(n_kv=4):
    """The JAX test's inputs (tests/test_sharded_serve.py)."""
    rng = np.random.RandomState(7)
    B, S, H, HD, PAGE, NP, PPS = 2, 3, 8, 16, 8, 12, 4
    q = rng.randn(B, S, H, HD).astype(np.float32)
    kp = rng.randint(-127, 127, (NP, PAGE, n_kv, HD)).astype(np.int8)
    vp = rng.randint(-127, 127, (NP, PAGE, n_kv, HD)).astype(np.int8)
    bt = rng.permutation(NP)[:B * PPS].reshape(B, PPS).astype(np.int32)
    lens = np.asarray([17, 25], np.int32)
    ks = (np.abs(rng.randn(B, n_kv)) * 0.02).astype(np.float32)
    return q, kp, vp, bt, lens, lens - S, ks, ks


def test_sharded_kernel_matches_reference_and_plain():
    args = _kernel_case()
    targs = [torch.tensor(a) for a in args]
    mesh = make_serve_mesh(model=4, data=2, device="cpu")
    calls = TPA.paged_flash_mq_sharded.calls
    got = TPA.paged_flash_mq_sharded(*targs, mesh=mesh)
    assert TPA.paged_flash_mq_sharded.calls == calls + 1
    assert TPA.paged_flash_mq_sharded.launches == 0   # CPU: plain per shard
    want = JPA.paged_flash_mq(*(jnp.asarray(a) for a in args),
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, TPA.paged_attention_mq_ref(*targs))

    dec = TPA.paged_flash_decode_sharded(targs[0][:, -1], *targs[1:5],
                                         *targs[6:], mesh=mesh)
    want = JPA.paged_flash_decode(jnp.asarray(args[0][:, -1]),
                                  *(jnp.asarray(a) for a in args[1:5]),
                                  *(jnp.asarray(a) for a in args[6:]),
                                  interpret=True)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(dec, TPA.paged_attention_ref(targs[0][:, -1],
                                                    *targs[1:5],
                                                    *targs[6:]))


@pytest.mark.parametrize("data", [1, 2])
def test_sharded_kernel_falls_back_when_heads_do_not_divide(data):
    targs = [torch.tensor(a) for a in _kernel_case(n_kv=2)]
    calls = TPA.paged_flash_mq_sharded.calls
    got = TPA.paged_flash_mq_sharded(
        *targs, mesh=make_serve_mesh(model=4, data=data, device="cpu"))
    assert TPA.paged_flash_mq_sharded.calls == calls
    assert torch.equal(got, TPA.paged_attention_mq_ref(*targs))


def test_set_tp_mesh_routes_both_front_doors():
    targs = [torch.tensor(a) for a in _kernel_case()]
    plain = TPA.paged_multiquery_attention(*targs)
    calls = TPA.paged_flash_mq_sharded.calls
    TPA.set_tp_mesh(_mesh(2))
    try:
        mq = TPA.paged_multiquery_attention(*targs)
        dec = TPA.paged_attention(targs[0][:, -1], *targs[1:5], *targs[6:])
    finally:
        TPA.set_tp_mesh(None)
    assert TPA.paged_flash_mq_sharded.calls == calls + 2
    assert torch.equal(mq, plain)
    assert torch.equal(dec, TPA.paged_attention_ref(targs[0][:, -1],
                                                    *targs[1:5],
                                                    *targs[6:]))


# ---------------------------------------------------------------------------
# The TP transformer, teacher-forced
# ---------------------------------------------------------------------------


def _tp_params(tparams, tp):
    mesh = _mesh(tp)
    return {"embed": tparams["embed"],
            "blocks": TSH.shard_suffix_blocks(tparams["blocks"], mesh,
                                              n_kv=TCFG.n_kv),
            **TSH.shard_tail({"final_norm": tparams["final_norm"],
                              "lm_head": tparams["lm_head"]}, mesh)}


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("int8", [True, False], ids=["int8_pages",
                                                      "fp_pages"])
def test_tp_prefill_and_decode_match_reference(params, int8, tp):
    """Teacher-forced: the TP cloud stack's logits within 1e-4 of the
    unsharded JAX model's, its pages (put back together over the shards'
    kv heads) within one lattice step."""
    jp, tparams = params
    page, per_seq, b, s = 8, 4, 2, 16
    rng = np.random.RandomState(3)
    plens = np.array([16, 9], np.int32)
    toks = rng.randint(0, TCFG.vocab, (b, s)).astype(np.int32)
    n_pages = b * per_seq + 2
    bt = np.stack([rng.choice(np.arange(1, n_pages), per_seq, replace=False)
                   for _ in range(b)]).astype(np.int32)
    jc = JT.init_cache(_jcfg(), b, page * per_seq, paged=True,
                       quantized=int8, page_size=page, num_pages=n_pages)
    tc = TSH.shard_cloud_cache(
        TT.init_cache(TCFG, b, page * per_seq, paged=True, quantized=int8,
                      page_size=page, num_pages=n_pages, device="cpu"),
        _mesh(tp))
    assert isinstance(tc, list) == (tp == 2)          # n_kv 2
    tpp = _tp_params(tparams, tp)
    jl, jc = JT.prefill(jp, jnp.asarray(toks), _jcfg(), cache=jc,
                        block_tables=jnp.asarray(bt),
                        last_pos=jnp.asarray(plens - 1))
    tl, tc = TT.prefill(tpp, torch.tensor(toks), TCFG, cache=tc,
                        block_tables=torch.tensor(bt),
                        last_pos=torch.tensor(plens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    pos = plens.copy()
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jc = JT.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                                _jcfg(), block_tables=jnp.asarray(bt))
        tl, tc = TT.decode_step(tpp, torch.tensor(tok), tc,
                                torch.tensor(pos), TCFG,
                                block_tables=torch.tensor(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    whole = _whole(tc)
    for k in ("k_pages", "v_pages"):
        if int8:
            _assert_lattice_close(whole[k].numpy(), np.asarray(jc[k]))
        else:
            np.testing.assert_allclose(whole[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-5, rtol=1e-5)
    if int8:
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(whole[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-5)


def test_tp_shards_refuse_the_edge_lattice(params):
    tpp = _tp_params(params[1], 2)
    x = torch.zeros((1, 1, TCFG.d_model))
    mlp = tree_map(lambda v: v[0], tpp["blocks"]["mlp"])
    with pytest.raises(ValueError, match="fp cloud only"):
        TL.swiglu(mlp, x, qctx=TL.QuantCtx())


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def _collab(tparams, tp, k, **kw):
    return TE.CollaborativeServingEngine(
        tparams, TCFG, cut_layer=1, spec_k=k,
        channel=Channel.from_kbps(KBPS, rtt_ms=RTT_MS), mesh=_mesh(tp),
        device="cpu", **COMMON, **kw)


def _assert_stats(st, want):
    for f in STAT_FIELDS:
        assert getattr(st, f) == want[f], f
    assert st.channel_latency_s == pytest.approx(want["channel_latency_s"])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_lossless_streams_and_bytes_match_reference(params, reference, tp,
                                                    k, seed):
    want = reference[f"lossless_k{k}_s{seed}"]
    eng = _collab(params[1], tp, k, **LOSSLESS)
    assert eng.generate(_prompts(seed), max_new_tokens=6) == want["outs"]
    _assert_stats(eng.stats, want)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("tp", [1, 2])
def test_int8_default_counts_bytes_and_pages_match_reference(params,
                                                             reference, tp,
                                                             k):
    """INT8 pages on both sides (and the INT8 draft cache): accepted
    counts and wire bytes exact, every INT8 page within one lattice step
    of the reference's, the cloud's put back together over its shards;
    the streams are equal at this size (the teacher-forced logits are
    held by ``test_tp_prefill_and_decode_match_reference``)."""
    want = reference[f"int8_k{k}"]
    eng = _collab(params[1], tp, k)
    assert eng.generate(_prompts(0), max_new_tokens=6) == want["outs"]
    _assert_stats(eng.stats, want)
    named = dict(edge=eng._edge_cache, cloud=_whole(eng._cloud_cache),
                 draft=getattr(eng, "_draft_cache", None))
    got = {f"{n}.{key}": v for n, c in named.items() if c is not None
           for key, v in c.items()}
    assert sorted(got) == sorted(want["caches"])
    for key, v in got.items():
        w = np.asarray(want["caches"][key])
        if key.endswith("pages"):
            _assert_lattice_close(v[:, 1:].numpy(), w)
        else:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_cloud_only_streams_match_reference(params, reference, tp, int8):
    eng = TE.ServingEngine(params[1], TCFG, max_batch=2, max_len=64,
                           paged=True, page_size=8, int8_kv=int8,
                           mesh=_mesh(tp), device="cpu")
    for seed in (0, 1):
        assert eng.generate(_prompts(seed), max_new_tokens=6) == \
            reference[f"cloud_int8{int8}_s{seed}"]


def _has_shards(tree):
    if isinstance(tree, list):
        return True
    return isinstance(tree, dict) and any(_has_shards(v)
                                          for v in tree.values())


def test_placement_splits_the_cloud_suffix_only(params):
    eng = _collab(params[1], 2, 4)
    cb, tail = eng.cloud_blocks, eng.cloud_tail
    assert [len(cb[g]) for g in ("attn", "mlp")] == [2, 2]
    assert isinstance(cb["ln1"], dict) and len(tail["lm_head"]) == 2
    assert tuple(cb["attn"][1]["wq"]["w"].shape) == (2, 32, 16)
    assert tuple(cb["attn"][1]["wo"]["w"].shape) == (2, 16, 32)
    assert tuple(cb["mlp"][0]["wi"]["w"].shape) == (2, 32, 32)
    assert tuple(tail["lm_head"][0]["w"].shape) == (32, 32)
    # a split of a weight on its own device is a view, not a copy
    whole = params[1]["blocks"]["mlp"]["wo"]["w"]
    assert cb["mlp"][1]["wo"]["w"].untyped_storage().data_ptr() == \
        whole.untyped_storage().data_ptr()
    for tree in (eng.edge_blocks, eng.draft_blocks, eng.tail):
        assert not _has_shards(tree)
    assert [tuple(c["k_pages"].shape[3:]) for c in eng._cloud_cache] == \
        [(1, 8), (1, 8)]
    assert all(c["k_pages"].is_contiguous() and
               tuple(c["k_scale"].shape) == (2, 2, 1)
               for c in eng._cloud_cache)
    assert eng._edge_cache["k_pages"].shape[3] == TCFG.n_kv
    # tp 4 over n_kv 2: attention and its pool stay whole, the MLP splits
    eng4 = _collab(params[1], 4, 1)
    assert isinstance(eng4.cloud_blocks["attn"], dict)
    assert isinstance(eng4._cloud_cache, dict)
    assert len(eng4.cloud_blocks["mlp"]) == 4


def test_engines_refuse_a_data_axis(params):
    mesh = make_serve_mesh(model=2, data=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        TE.CollaborativeServingEngine(params[1], TCFG, cut_layer=1,
                                      mesh=mesh, **COMMON)
    with pytest.raises(NotImplementedError, match="A16"):
        TE.ServingEngine(params[1], TCFG, mesh=mesh)


def test_engine_counts_one_sharded_call_per_cloud_layer(params):
    """Serial tp = 2: every cloud layer attends through one sharded call
    per prefill group and per step (on the card, one kernel launch per
    shard); the edge's layers read unsharded."""
    eng = _collab(params[1], 2, 1)
    calls = TPA.paged_flash_mq_sharded.calls
    eng.generate(_prompts(0), max_new_tokens=6)
    st = eng.stats
    assert TPA.paged_flash_mq_sharded.calls - calls == \
        eng.n_cloud * (st.prefill_calls + st.decode_steps)
