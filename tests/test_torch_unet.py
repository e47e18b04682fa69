"""Port parity: the latent-diffusion U-Net (``repro_torch.models.unet``)
against ``repro.models.unet``, on the CPU.

Both packages get the same numpy inputs and the same weights: drawn by
the port's ``init_unet`` and handed to JAX as numpy arrays (JAX's own
init of the SMOKE U-Net takes 15–25 s to run here; the two inits' trees
are held equal leaf for leaf at FULL size).  The reference runs jitted.

Compared exactly: ``make_graph`` node for node and its partition
candidates (one blob and two), the FULL parameter tree shape for shape
(809,896,964 parameters, the port's drawn on the meta device), and the
names a calibrating ``QuantCtx`` records.  With a tolerance: the f32
forward (with and without ``q_chunk``) and ``ddim_step`` within
``FORWARD_TOL`` × max |ref| (XLA and torch sum in other orders);
``ddpm_schedule``'s alphas within 1e-6 relative (torch's ``linspace``
and ``cumprod`` round otherwise than JAX's: up to 3e-7);
``timestep_embed`` within 1e-4 absolute (an ulp of a frequency times a
timestep near 1,000); the forward under a dynamic 8-bit ``QuantCtx``
within ``QUANT_TOL`` × max |ref| (a value on a rounding edge can take
the next lattice point).
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
from repro.models import unet as JU  # noqa: E402
from repro_torch.bridge import tree_flatten, tree_map  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import unet as TU  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FORWARD_TOL = 2e-4
QUANT_TOL = 2e-2


@pytest.fixture(scope="module")
def smoke():
    return _pair(jget("unet-sd15").smoke, tget("unet-sd15").smoke)


def _pair(jcfg, cfg):
    """(JAX config, port config, the weights in JAX, the same in the
    port)."""
    tp = TU.init_unet(torch.Generator().manual_seed(0), cfg, device="cpu")
    return jcfg, cfg, tree_map(lambda v: jnp.asarray(v.numpy()), tp), tp


def _inputs(cfg, b=2, res=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, res, res, cfg.in_ch).astype(np.float32)
    t = rng.randint(0, 1000, (b,)).astype(np.int32)
    ctx = rng.randn(b, cfg.ctx_len, cfg.ctx_dim).astype(np.float32)
    return x, t, ctx


def _jfwd(jp, x, t, ctx, jcfg, qctx=None):
    """The reference's forward, jitted (eager JAX dispatches op by op)."""
    return jax.jit(lambda p, x, t, c: JU.unet_forward(p, x, t, c, jcfg,
                                                      qctx=qctx))(
        jp, *map(jnp.asarray, (x, t, ctx)))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_schedule_and_timestep_embedding():
    jb, ja = JU.ddpm_schedule()
    tb, ta = TU.ddpm_schedule()
    assert ta.dtype == torch.float32 and ta.shape == (1000,)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (8, 256, 320):
        got = TU.timestep_embed(torch.tensor(t), dim)
        assert got.dtype == torch.float32 and got.shape == (5, dim)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(JU.timestep_embed(jnp.asarray(t), dim)),
            rtol=0, atol=1e-4)


@pytest.mark.parametrize("q_chunk", [None, 16])
def test_forward_matches_jax(smoke, q_chunk):
    """8 × 8 latents: 64 tokens at the first stage, four query blocks of
    16 with ``q_chunk``."""
    jcfg, cfg, jp, tp = smoke
    jcfg = dataclasses.replace(jcfg, q_chunk=q_chunk)
    cfg = dataclasses.replace(cfg, q_chunk=q_chunk)
    x, t, ctx = _inputs(cfg)
    want = _jfwd(jp, x, t, ctx, jcfg)
    got = TU.unet_forward(tp, torch.tensor(x), torch.tensor(t),
                          torch.tensor(ctx), cfg)
    assert got.shape == want.shape == (2, 8, 8, cfg.in_ch)
    assert got.dtype == torch.float32
    _close(got, want, FORWARD_TOL)


def test_ddim_step_matches_jax(smoke):
    """A middle step and the last one (``t_prev < 0``: alpha 1)."""
    jcfg, cfg, jp, tp = smoke
    x, _, ctx = _inputs(cfg, seed=1)
    t = np.array([999, 249], np.int32)
    t_prev = np.array([749, -1], np.int32)
    want = jax.jit(lambda p, *a: JU.ddim_step(p, *a, jcfg))(
        jp, *map(jnp.asarray, (x, t, t_prev, ctx)))
    got = TU.ddim_step(tp, *map(torch.tensor, (x, t, t_prev, ctx)), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, FORWARD_TOL)


def test_dynamic_int8_forward_matches_jax(smoke):
    jcfg, cfg, jp, tp = smoke
    x, t, ctx = _inputs(cfg, seed=2)
    want = _jfwd(jp, x, t, ctx, jcfg, JLY.QuantCtx(mode="dynamic"))
    got = TU.unet_forward(tp, torch.tensor(x), torch.tensor(t),
                          torch.tensor(ctx), cfg,
                          qctx=TLY.QuantCtx(mode="dynamic"))
    _close(got, want, QUANT_TOL)
    fp = TU.unet_forward(tp, torch.tensor(x), torch.tensor(t),
                         torch.tensor(ctx), cfg)
    assert not torch.equal(got, fp)               # the lattice took effect


class _Names(JLY.QuantCtx):
    """Records the names a forward asks its context for (while JAX
    traces it) and quantizes nothing."""

    def act(self, name, x):
        self.recorder.setdefault(name, None)
        return x


def test_calibration_names_match_jax(smoke):
    """A calibrating context keys the same activations in both packages
    (the reference traced, no run), with the same ranges over one
    transformer block and one res block (the reference eager)."""
    jcfg, cfg, jp, tp = smoke
    x, t, ctx = _inputs(cfg, seed=3)
    names = _Names(mode="calib", recorder={})
    jax.eval_shape(lambda p: JU.unet_forward(
        p, *map(jnp.asarray, (x, t, ctx)), jcfg, qctx=names), jp)
    tq = TLY.make_calib_ctx()
    TU.unet_forward(tp, *map(torch.tensor, (x, t, ctx)), cfg, qctx=tq)
    assert sorted(tq.recorder) == sorted(names.recorder)
    assert {"tr/sa/q/in", "res/c1/in", "tr/pi/in", "tr/k/in", "conv_in/in",
            "down0/ds/in", "up1/us/in", "conv_out/in"} <= set(tq.recorder)
    temb = np.random.RandomState(5).randn(2, cfg.t_dim).astype(np.float32)
    jq, tq = JLY.make_calib_ctx(), TLY.make_calib_ctx()
    for blk, c in (("down0_0/attn", cfg.ch), ("mid/res1", 2 * cfg.ch)):
        h = np.random.RandomState(c).randn(2, 4, 4, c).astype(np.float32)
        args = (ctx,) if blk.endswith("attn") else (temb,)
        jf, tf = ((JU.xattn_block, TU.xattn_block) if blk.endswith("attn")
                  else (JU.res_block, TU.res_block))
        jf(jp[blk], jnp.asarray(h), *map(jnp.asarray, args), qctx=jq)
        tf(tp[blk], torch.tensor(h), *map(torch.tensor, args), qctx=tq)
    assert sorted(tq.recorder) == sorted(jq.recorder)
    for name, jrec in jq.recorder.items():
        for a, b in ((tq.recorder[name]._min, jrec._min),
                     (tq.recorder[name]._max, jrec._max)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def _rows(g):
    return [(n.name, n.op, list(n.inputs), tuple(n.out_shape), n.flops,
             n.param_elems, n.parametric) for n in (g[k] for k in g.topo())]


def _cand_rows(cands):
    return [(c.name, c.edge_flops, c.edge_param_elems, c.transmit_bytes,
             [(b.source, b.elems, b.precision) for b in c.blobs])
            for c in cands]


@pytest.mark.parametrize("which,batch,latent_res", [
    ("full", 1, None), ("full", 4, 32), ("smoke", 2, None)])
def test_graph_and_candidates_match(which, batch, latent_res):
    jcfg = getattr(jget("unet-sd15"), which)
    cfg = getattr(tget("unet-sd15"), which)
    jg = JU.make_graph(jcfg, batch=batch, latent_res=latent_res)
    tg = TU.make_graph(cfg, batch=batch, latent_res=latent_res)
    assert _rows(tg) == _rows(jg)
    assert tg.total_flops() == jg.total_flops()
    for blobs in (1, 2):
        assert (_cand_rows(TP.candidate_partition_points(tg,
                                                         max_blobs=blobs))
                == _cand_rows(JP.candidate_partition_points(
                    jg, max_blobs=blobs)))


def test_full_parameter_tree_matches_jax():
    """809,896,964 parameters in bf16, leaf for leaf (the port's drawn on
    the meta device, JAX's traced abstractly)."""
    jcfg, cfg = jget("unet-sd15").full, tget("unet-sd15").full
    jtree = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), jcfg))
    tp = TU.init_unet(torch.Generator(), cfg, device="meta")
    want = [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    got = [(p, tuple(v.shape), str(v.dtype).split(".")[1])
           for p, v in tree_flatten(tp)]
    assert got == want
    assert sum(v.numel() for _, v in tree_flatten(tp)) == 809_896_964


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TU.init_unet(torch.Generator(), tget("unet-sd15").smoke)


def test_remat_gives_the_same_gradients(smoke):
    """Checkpointed blocks recompute the same values: loss and every
    gradient bit for bit (remat is off outside autograd)."""
    _, cfg, _, tp = smoke
    x, t, ctx = map(torch.tensor, _inputs(cfg, seed=4))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        p = tree_map(lambda v: v.clone().requires_grad_(True), tp)
        leaves = [v for _, v in tree_flatten(p)]
        loss = TU.unet_forward(p, x, t, ctx, c).square().mean()
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*out):
        assert torch.equal(a, b)
