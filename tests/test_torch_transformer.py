"""Port parity: ``repro_torch.models.transformer`` against
``repro.models.transformer`` on deepseek-7b ``SMOKE`` with bridged
weights, over paged INT8 and paged fp caches, for the cloud (fp) and the
edge (INT8 fake-quant, per-row activation ranges) forms.

Tolerances: logits to atol 1e-4 (f32; XLA and PyTorch sum the GEMMs in
different orders).  INT8 K/V pages: an f32 difference in the last place
can move a value across a rounding boundary, so the written lattices
must be equal in at least 99.9 % of elements and never more than one
step apart; the per-slot scales to f32 rtol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

CFG = get_arch("deepseek-7b").smoke
TCFG = t_get_arch("deepseek-7b").smoke
PAGE, PER_SEQ = 8, 4


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), CFG)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


def _assert_lattice_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_config_matches_reference():
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
              "hd", "rope_base"):
        assert getattr(TCFG, f) == getattr(CFG, f)
    assert TCFG.block_param_count() == CFG.block_param_count()


@pytest.mark.parametrize("edge", [False, True], ids=["cloud", "edge_int8"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8_pages",
                                                      "fp_pages"])
def test_prefill_and_decode_match(params, int8, edge):
    jp, tp = params
    b, s = 3, 16
    rng = np.random.RandomState(1)
    plens = np.array([16, 11, 5], np.int32)
    toks = rng.randint(0, CFG.vocab, (b, s)).astype(np.int32)
    n_pages = b * PER_SEQ + 2
    bt = np.stack([rng.choice(np.arange(1, n_pages), PER_SEQ,
                              replace=False)
                   for _ in range(b)]).astype(np.int32)
    jq = JL.QuantCtx(act_axis=0) if edge else None
    tq = TL.QuantCtx(act_axis=0) if edge else None

    jc = JT.init_cache(CFG, b, PAGE * PER_SEQ, paged=True, quantized=int8,
                       page_size=PAGE, num_pages=n_pages)
    tc = TT.init_cache(TCFG, b, PAGE * PER_SEQ, paged=True, quantized=int8,
                       page_size=PAGE, num_pages=n_pages, device="cpu")
    jl, jc = JT.prefill(jp, jnp.asarray(toks), CFG, cache=jc, qctx=jq,
                        block_tables=jnp.asarray(bt),
                        last_pos=jnp.asarray(plens - 1))
    tl, tc = TT.prefill(tp, torch.tensor(toks), TCFG, cache=tc, qctx=tq,
                        block_tables=torch.tensor(bt),
                        last_pos=torch.tensor(plens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)

    pos = plens.copy()
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jc = JT.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                                CFG, qctx=jq, block_tables=jnp.asarray(bt))
        tl, tc = TT.decode_step(tp, torch.tensor(tok), tc, torch.tensor(pos),
                                TCFG, qctx=tq, block_tables=torch.tensor(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1

    if int8:
        for k in ("k_pages", "v_pages"):
            _assert_lattice_close(tc[k].numpy(), np.asarray(jc[k]))
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-5)
    else:
        for k in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-5, rtol=1e-5)


def test_rope_and_rmsnorm_match():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    jc, js = JL.rope_table(12, 16)
    tc, ts = TL.rope_table(12, 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    pos = rng.randint(0, 7, (2, 5))
    np.testing.assert_allclose(
        TL.apply_rope(torch.tensor(x), tc[pos], ts[pos]).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jc[pos], js[pos])),
        atol=1e-5)
    w = {"scale": rng.randn(16).astype(np.float32)}
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": torch.tensor(w["scale"])},
                   torch.tensor(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(w["scale"])},
                              jnp.asarray(x))), atol=1e-5, rtol=1e-5)


def test_make_graph_matches_reference():
    jg = JT.make_graph(get_arch("deepseek-7b").full, batch=1, seq=128)
    tg = TT.make_graph(t_get_arch("deepseek-7b").full, batch=1, seq=128)
    def rows(g):
        return [(n, g[n].op, g[n].inputs, g[n].out_shape, g[n].flops,
                 g[n].param_elems) for n in g.topo()]

    assert rows(tg) == rows(jg)
