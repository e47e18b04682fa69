"""Port parity: the mixture-of-experts LM of ``repro_torch.models.transformer``
against ``repro.models.transformer`` on the same numpy-seeded tokens with
bridged JAX weights (the reference suite's ``tiny-moe``: 2 layers, 4
experts, top 2; and the registered MoE configs).

* ``forward``: logits to atol 1e-4 (XLA and PyTorch sum the GEMMs in
  other orders) and the summed balance loss to 1e-5;
* the MoE case of ``test_prefill_then_decode_matches_forward`` on the
  dense fp cache (the reference test's 2e-4 against the port's own
  ``forward``; 1e-4 against the reference's steps);
* parameter counts: the initialized tree's leaves, the reference's
  ``param_count`` / ``active_param_count`` (exact), and the config
  numbers ``tests/test_configs.py`` asserts;
* ``make_graph``: every node, shape, FLOP count and parameter count
  equal to the reference's graph, and Algorithm 1's pick on qwen3
  ``FULL`` (128-token prompt) the reference's at 2000 to 50 KB/s;
* ``make_segments`` with the paper's ``CollaborativeEngine`` on qwen3
  ``SMOKE``: the reference's blob and download bytes and activation
  names, an output within 1e-3 (relative) of the reference engine's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.core.autotune import AutoTuner as JAutoTuner  # noqa: E402
from repro.core.collab import CollaborativeEngine as JCollab  # noqa: E402
from repro.core.costmodel import (CLOUD_TITANXP_CLASS as J_CLOUD,  # noqa: E402
                                  EDGE_TX2_CLASS as J_EDGE,
                                  Channel as JChannel)
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.core.collab import CollaborativeEngine  # noqa: E402
from repro_torch.core.costmodel import Channel  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

CFG = JT.LMConfig(name="tiny-moe", n_layers=2, d_model=32, n_heads=4,
                  n_kv=4, d_ff=48, vocab=128,
                  moe=JT.MoESpec(n_experts=4, top_k=2), max_seq=64,
                  remat=False)
TCFG = TT.LMConfig(name="tiny-moe", n_layers=2, d_model=32, n_heads=4,
                   n_kv=4, d_ff=48, vocab=128,
                   moe=TT.MoESpec(n_experts=4, top_k=2))
ARCHS = ("qwen3-moe-30b-a3b", "grok-1-314b")


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(1), CFG)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


def _tokens(b, s, seed=0, vocab=CFG.vocab):
    return np.random.RandomState(seed).randint(0, vocab,
                                               (b, s)).astype(np.int32)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def test_forward_logits_and_aux_equal_reference(params):
    jp, tp = params
    toks = _tokens(2, 16)
    jl, jaux = JT.forward(jp, jnp.asarray(toks), CFG)
    tl, taux = TT.forward(tp, torch.tensor(toks), TCFG)
    assert tuple(tl.shape) == (2, 16, CFG.vocab)
    assert bool(torch.isfinite(tl).all()) and bool(torch.isfinite(taux))
    _close(tl, jl)
    assert taux.dtype == torch.float32 and taux.ndim == 0
    assert float(taux) == pytest.approx(float(jaux), abs=1e-5)
    # two blocks, each balance term near 1
    assert 1.0 < float(taux) < 4.0


def test_prefill_then_decode_matches_forward(params):
    """The MoE case of the reference test: prefill and one decode step
    on a dense fp cache agree with the cacheless forward, and with the
    reference's steps."""
    jp, tp = params
    b, s = 2, 10
    toks = _tokens(b, s + 1, seed=5)
    full, _ = TT.forward(tp, torch.tensor(toks), TCFG)
    jc = JT.init_cache(CFG, b, max_len=32)
    tc = TT.init_cache(TCFG, b, max_len=32, device="cpu")
    jlast, jc = JT.prefill(jp, jnp.asarray(toks[:, :s]), CFG, cache=jc)
    tlast, tc = TT.prefill(tp, torch.tensor(toks[:, :s]), TCFG, cache=tc)
    torch.testing.assert_close(tlast, full[:, s - 1], atol=2e-4, rtol=2e-4)
    _close(tlast, jlast)
    jstep, jc = JT.decode_step(jp, jnp.asarray(toks[:, s]), jc,
                               jnp.int32(s), CFG)
    tstep, tc = TT.decode_step(tp, torch.tensor(toks[:, s]), tc, s, TCFG)
    torch.testing.assert_close(tstep, full[:, s], atol=2e-4, rtol=2e-4)
    _close(tstep, jstep)


def _leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    return tree.numel()


def test_param_count_is_the_initialized_tree(params):
    _, tp = params
    assert _leaf_count(tp) == TCFG.param_count() == CFG.param_count()
    assert set(tp["blocks"]) == {"ln1", "attn", "ln2", "moe"}
    for arch in ARCHS:
        tcfg = t_get_arch(arch).smoke
        g = torch.Generator().manual_seed(0)
        tree = TT.init_lm(tcfg, g, device="cpu")
        assert _leaf_count(tree) == tcfg.param_count()
        jtree = JT.init_lm(jax.random.PRNGKey(0), get_arch(arch).smoke)
        shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jtree)
        assert jax.tree_util.tree_map(lambda v: tuple(v.shape), tree) == \
            shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_config_numbers_and_counts_equal_reference(arch):
    j, t = get_arch(arch), t_get_arch(arch)
    assert t.family == j.family == "lm" and t.source == j.source
    for jc, tc in ((j.full, t.full), (j.smoke, t.smoke)):
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
                  "vocab", "head_dim", "rope_base"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert (tc.moe.n_experts, tc.moe.top_k, tc.moe.capacity_factor) == \
            (jc.moe.n_experts, jc.moe.top_k, jc.moe.capacity_factor)
        for f in ("block_param_count", "block_active_param_count",
                  "param_count", "active_param_count"):
            assert getattr(tc, f)() == getattr(jc, f)(), f
    assert t.full.dtype == torch.bfloat16


def test_full_config_numbers():
    qwen, grok = (t_get_arch(a).full for a in ARCHS)
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.n_kv, qwen.hd,
            qwen.d_ff, qwen.vocab, qwen.moe.n_experts, qwen.moe.top_k) == \
        (48, 2048, 32, 4, 128, 768, 151936, 128, 8)
    assert (grok.n_layers, grok.d_model, grok.n_heads, grok.n_kv,
            grok.d_ff, grok.vocab, grok.moe.n_experts, grok.moe.top_k) == \
        (64, 6144, 48, 8, 32768, 131072, 8, 2)
    assert qwen.param_count() == 30_532_110_336
    assert qwen.active_param_count() == 3_353_020_416
    assert qwen.block_param_count() == 623_120_384


@pytest.mark.parametrize("arch", ARCHS)
def test_make_graph_matches_reference(arch):
    jg = JT.make_graph(get_arch(arch).full, batch=1, seq=128)
    tg = TT.make_graph(t_get_arch(arch).full, batch=1, seq=128)

    def rows(g):
        return [(n, g[n].op, g[n].inputs, g[n].out_shape, g[n].flops,
                 g[n].param_elems) for n in g.topo()]

    assert rows(tg) == rows(jg)
    assert tg["blk0/ffn"].op == "moe"


@pytest.mark.parametrize("kbps", [2000.0, 1000.0, 500.0, 250.0, 100.0,
                                  50.0])
def test_auto_cut_on_qwen3_full_matches_reference(kbps):
    cfg = get_arch("qwen3-moe-30b-a3b").full
    best, _ = JAutoTuner(JT.make_graph(cfg, batch=1, seq=128), J_EDGE,
                         J_CLOUD).tune(JChannel.from_kbps(kbps, rtt_ms=20.0))
    want = (int(best.point.split("/")[0][3:])
            if best.point.startswith("blk") else 0)
    point, cut = TLS.auto_cut(t_get_arch("qwen3-moe-30b-a3b").full,
                              Channel.from_kbps(kbps, rtt_ms=20.0),
                              prompt_len=128)
    assert (point, cut) == (best.point, want)


def test_segments_and_collaborative_engine_on_qwen3_smoke():
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg = get_arch(arch).smoke, t_get_arch(arch).smoke
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = _tokens(1, 16, seed=13, vocab=tcfg.vocab)
    m = TT.make_segments(tp, tcfg, seq=16)
    m.verify_alignment()
    jm = JT.make_segments(jp, jcfg, seq=16)
    truth = m.full_apply(torch.tensor(toks))
    ref, _ = TT.forward(tp, torch.tensor(toks), tcfg)
    torch.testing.assert_close(truth, ref, atol=1e-5, rtol=1e-5)
    for cut in ("blk0/ffn", "blk1/ffn"):
        eng = CollaborativeEngine(m, cut, device="cpu")
        jeng = JCollab(jm, cut)
        got, rec = eng.infer(torch.tensor(toks))
        jgot, jrec = jeng.infer(jnp.asarray(toks))
        assert rec.precision == jrec.precision == "int8"
        assert rec.blob_bytes == jrec.blob_bytes
        assert eng.edge_download_bytes == jeng.edge_download_bytes
        jgot = torch.tensor(np.asarray(jgot))
        assert float(torch.linalg.norm(got - jgot)
                     / torch.linalg.norm(jgot)) < 1e-3
        assert float(torch.linalg.norm(got - truth)
                     / torch.linalg.norm(truth)) < 0.15
