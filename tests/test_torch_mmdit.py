"""Port parity: the MM-DiT rectified-flow transformer
(``repro_torch.models.mmdit``) against ``repro.models.mmdit``, on the CPU.

Both packages get the same numpy inputs and the same weights: drawn by
the port's ``init_mmdit`` (stacked ``[L, ...]`` block leaves, as JAX's
``vmap`` init stacks them) and handed to JAX as numpy arrays; the two
inits' trees are held equal leaf for leaf at FULL size.  The reference
runs jitted.

Compared exactly: ``make_graph`` node for node and its partition
candidates (one blob and two), the FULL tree's 11,881,251,904 parameters and
``param_count`` (the reference's closed form, 11,863,041,152), and the
names a calibrating ``QuantCtx`` asks for.  With
a tolerance: the f32 forward and ``rf_step`` within ``FORWARD_TOL`` ×
max |ref| (XLA and torch sum in other orders); ``pos_embed_2d`` within
1e-5 absolute (torch's ``pow`` and JAX's differ by an ulp in a few
frequencies).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.models import layers as JLY  # noqa: E402
from repro.models import mmdit as JM  # noqa: E402
from repro_torch.bridge import tree_flatten, tree_map  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import mmdit as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FORWARD_TOL = 2e-4


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jget("flux-dev").smoke, tget("flux-dev").smoke
    tp = TM.init_mmdit(torch.Generator().manual_seed(0), cfg, device="cpu")
    return jcfg, cfg, tree_map(lambda v: jnp.asarray(v.numpy()), tp), tp


def _inputs(cfg, b=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cfg.n_img_tokens, cfg.in_ch).astype(np.float32)
    t = rng.rand(b).astype(np.float32)
    txt = rng.randn(b, cfg.txt_len, cfg.txt_dim).astype(np.float32)
    vec = rng.randn(b, cfg.vec_dim).astype(np.float32)
    return x, t, txt, vec


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_pos_embed_2d():
    for n, d in ((16, 32), (64, 3072), (4096, 64)):
        got = TM.pos_embed_2d(n, d)
        assert got.shape == (n, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(JM.pos_embed_2d(n, d)),
                                   rtol=0, atol=1e-5)


def test_forward_and_rf_step_match_jax(smoke):
    jcfg, cfg, jp, tp = smoke
    x, t, txt, vec = _inputs(cfg)
    want = jax.jit(lambda p, *a: JM.mmdit_forward(p, *a, jcfg))(
        jp, *map(jnp.asarray, (x, t * 1000, txt, vec)))
    got = TM.mmdit_forward(tp, *map(torch.tensor, (x, t * 1000, txt, vec)),
                           cfg)
    assert got.shape == want.shape == (2, cfg.n_img_tokens, cfg.in_ch)
    assert got.dtype == torch.float32
    _close(got, want, FORWARD_TOL)
    dt = np.full(2, 0.25, np.float32)
    want = jax.jit(lambda p, *a: JM.rf_step(p, *a, jcfg))(
        jp, *map(jnp.asarray, (x, t, dt, txt, vec)))
    got = TM.rf_step(tp, *map(torch.tensor, (x, t, dt, txt, vec)), cfg)
    assert got.dtype == torch.float32
    _close(got, want, FORWARD_TOL)


def test_remat_and_per_layer_views_give_the_same_values(smoke):
    """Checkpointed blocks and a list of per-layer trees: loss and every
    gradient bit for bit."""
    _, cfg, _, tp = smoke
    x, t, txt, vec = map(torch.tensor, _inputs(cfg, seed=1))
    out = []
    for remat, listed in ((True, False), (False, False), (False, True)):
        c = dataclasses.replace(cfg, remat=remat)
        p = tree_map(lambda v: v.clone().requires_grad_(True), tp)
        leaves = [v for _, v in tree_flatten(p)]
        q = dict(p)
        if listed:
            q["double"] = TM.layer_views(p["double"])
            q["single"] = TM.layer_views(p["single"])
        loss = TM.mmdit_forward(q, x, t, txt, vec, c).square().mean()
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)


class _Names(JLY.QuantCtx):
    def act(self, name, x):
        self.recorder.setdefault(name, None)
        return x


def test_quant_names_match_jax(smoke):
    jcfg, cfg, jp, tp = smoke
    x, t, txt, vec = _inputs(cfg, seed=2)
    names = _Names(mode="calib", recorder={})
    jax.eval_shape(lambda p: JM.mmdit_forward(
        p, *map(jnp.asarray, (x, t, txt, vec)), jcfg, qctx=names), jp)
    tq = TLY.make_calib_ctx()
    TM.mmdit_forward(tp, *map(torch.tensor, (x, t, txt, vec)), cfg, qctx=tq)
    assert sorted(tq.recorder) == sorted(names.recorder)
    assert {"dbl/img/q/in", "dbl/txt/o/in", "dbl/img/mlp/wi/in",
            "sgl/in/in", "sgl/out/in"} <= set(tq.recorder)


def _rows(g):
    return [(n.name, n.op, list(n.inputs), tuple(n.out_shape), n.flops,
             n.param_elems, n.parametric) for n in (g[k] for k in g.topo())]


def _cand_rows(cands):
    return [(c.name, c.edge_flops, c.edge_param_elems, c.transmit_bytes,
             [(b.source, b.elems, b.precision) for b in c.blobs])
            for c in cands]


@pytest.mark.parametrize("which,batch", [("full", 1), ("full", 4),
                                         ("smoke", 2)])
def test_graph_and_candidates_match(which, batch):
    jcfg = getattr(jget("flux-dev"), which)
    cfg = getattr(tget("flux-dev"), which)
    jg, tg = JM.make_graph(jcfg, batch=batch), TM.make_graph(cfg,
                                                             batch=batch)
    assert _rows(tg) == _rows(jg)
    assert tg.total_flops() == jg.total_flops()
    for blobs in (1, 2):
        tc = TP.candidate_partition_points(tg, max_blobs=blobs)
        assert _cand_rows(tc) == _cand_rows(
            JP.candidate_partition_points(jg, max_blobs=blobs))


def test_full_parameter_tree_and_count_match_jax():
    """11,881,251,904 parameters in bf16, leaf for leaf (the port's drawn
    on the meta device, JAX's traced abstractly)."""
    jcfg, cfg = jget("flux-dev").full, tget("flux-dev").full
    jtree = jax.eval_shape(lambda: JM.init_mmdit(jax.random.PRNGKey(0),
                                                 jcfg))
    tp = TM.init_mmdit(torch.Generator(), cfg, device="meta")
    want = [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    got = [(p, tuple(v.shape), str(v.dtype).split(".")[1])
           for p, v in tree_flatten(tp)]
    assert got == want
    assert sum(v.numel() for _, v in tree_flatten(tp)) == 11_881_251_904
    # the reference's closed form, which leaves out 18,210,752 of them
    assert cfg.param_count() == jcfg.param_count() == 11_863_041_152


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_mmdit(torch.Generator(), tget("flux-dev").smoke)
