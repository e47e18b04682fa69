"""Port parity: the LM and ViT losses, the train cell, the ``Trainer``
and the training launcher, against ``repro.models``, ``repro.launch``
and ``repro.train``.

Tolerances (f32): losses within 1e-5 relative; gradients within
``GRAD_SHARE`` of each leaf's largest magnitude (XLA and torch sum the
GEMMs in other orders).  After an AdamW step a parameter moves by about
``lr · sign(g)``: where a near-zero gradient element takes the other
sign in the other package it lands ``2 · lr`` away, so parameters are
held to 1e-6 on all but ``FLIP_SHARE`` of the model's elements and to
``2 · lr`` everywhere (QAT with INT8 gradient compression also moves
where a gradient's lattice point flips: one compression step, which
Adam passes on as at most ``lr``).  Remat on and off, and a restarted
launcher run against an uninterrupted one, are equal bit for bit (with
torch's deterministic kernels: the embedding's backward accumulates
with atomics otherwise, on the CPU too).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.mesh import make_host_mesh, mesh_context  # noqa: E402
from repro.launch.steps import build_cell as jbuild_cell  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import vit as JV  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro.train.qat import make_qat_loss as jmake_qat_loss  # noqa: E402
from repro_torch.bridge import (params_from_numpy, tree_leaves,  # noqa: E402
                                tree_unflatten)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.distributed.checkpoint import latest_step  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train.grads import (value_and_grad_into,  # noqa: E402
                                     zeros_like_tree)
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.qat import make_qat_loss  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

GRAD_SHARE = 1e-4
FLIP_SHARE = 1e-3


@pytest.fixture
def deterministic():
    """The embedding's backward accumulates with atomics on the CPU too
    (a parallel ``index_put_``); bit-for-bit checks run with torch's
    deterministic kernels, the caller's setting restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridge(jparams):
    return params_from_numpy(_np(jparams), device="cpu")


def _flat(tree):
    """JAX tree → (path, numpy leaf) pairs in JAX's order."""
    return [(jax.tree_util.keystr(p), np.asarray(l, np.float32)) for p, l in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_grads(port_tree, jtree):
    for (path, want), got in zip(_flat(jtree), tree_leaves(port_tree)):
        got = got.float().numpy()
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_SHARE * np.abs(want).max(),
                                   err_msg=path)


def _assert_stepped(port_tree, jtree, lr):
    off = n = 0
    for (path, want), got in zip(_flat(jtree), tree_leaves(port_tree)):
        d = np.abs(got.float().numpy() - want)
        assert d.max() <= 2 * lr + 1e-6, path
        off, n = off + int((d > 1e-6).sum()), n + d.size
    assert off <= FLIP_SHARE * n, (off, n)


def _lm_batch(cfg, b=2, s=16, step=0):
    return TokenPipeline(vocab=cfg.vocab, seq_len=s, batch=b,
                         seed=3).batch_at(step)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b"])
def test_lm_loss_and_gradients_match_jax(arch):
    jcfg = jget_arch(arch).smoke
    cfg = get_arch(arch).smoke
    jparams = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    batch = _lm_batch(cfg)
    jl, jg = jax.value_and_grad(JT.lm_loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch), jcfg)
    params = _bridge(jparams)
    acc = zeros_like_tree(params)
    loss = value_and_grad_into(
        lambda p, b: TT.lm_loss(p, b, cfg), params,
        {k: torch.tensor(v) for k, v in batch.items()}, acc)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads(acc, jg)


def test_remat_on_equals_remat_off(deterministic):
    cfg = get_arch("deepseek-7b").smoke
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.tensor(v) for k, v in _lm_batch(cfg).items()}
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        acc = zeros_like_tree(params)
        loss = value_and_grad_into(lambda p, b: TT.lm_loss(p, b, c), params,
                                   batch, acc)
        out.append([loss] + tree_leaves(acc))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    # remat is off outside autograd: serving runs the block plainly
    with torch.no_grad():
        logits, _ = TT.forward(params, batch["tokens"],
                               dataclasses.replace(cfg, remat=True))
    assert logits.grad_fn is None


def test_train_cell_step_matches_reference():
    mesh = make_host_mesh()
    jcell = jbuild_cell("deepseek-7b", "train_4k", mesh, smoke=True)
    cell = TS.build_cell("deepseek-7b", "train_4k", smoke=True, device="cpu")
    assert cell.grad_accum == 2                  # the rule at batch 2
    assert cell.model_flops == jcell.model_flops
    assert {k: (v.shape, str(v.dtype).split(".")[1])
            for k, v in cell.batch_specs.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jcell.args[2].items()}
    jcfg = jget_arch("deepseek-7b").smoke
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jopt = JO.adamw_init(jparams)
    params = _bridge(jparams)
    opt = cell.init_opt(params)
    assert isinstance(opt, TO.AdamWState) and \
        isinstance(jcell.args[1], JO.AdamWState)
    raw = TokenPipeline(vocab=jcfg.vocab, seq_len=64, batch=2).batch_at(0)
    with mesh, mesh_context(mesh):
        jp, jo, jm = jcell.jit()(jparams, jopt,
                                 {k: jnp.asarray(v) for k, v in raw.items()})
    params, opt, m = cell.step_fn(params, opt, {k: torch.tensor(v) for k, v
                                                in raw.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(opt.step) == int(jo.step) == 1
    _assert_stepped(params, jp, TO.AdamWConfig().lr)


@pytest.mark.parametrize("smoke", [True, False])
def test_8bit_choice_matches_reference(smoke):
    jcell = jbuild_cell("deepseek-7b", "train_4k", make_host_mesh(),
                        smoke=smoke)
    cfg = get_arch("deepseek-7b").smoke if smoke else \
        get_arch("deepseek-7b").full
    assert TS.use_8bit_moments(cfg.param_count()) == \
        isinstance(jcell.args[1], JO.AdamW8bitState)
    assert TS.use_8bit_moments(cfg.param_count()) == (not smoke)


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-7b", "train_4k"), ("deepseek-7b", "prefill_32k"),
    ("phi3-medium-14b", "decode_32k"), ("vit-s16", "cls_384"),
    ("resnet-18", "serve_b128")])
def test_shapes_and_input_specs_match_reference(arch, shape):
    from repro.configs import get_arch as jarch, input_specs as jspecs
    from repro_torch.configs import input_specs
    assert dataclasses.asdict(get_arch(arch).shapes[shape]) == \
        dataclasses.asdict(jarch(arch).shapes[shape])
    assert {k: (v.shape, str(v.dtype).split(".")[1])
            for k, v in input_specs(arch, shape).items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jspecs(arch, shape).items()}


def test_moe_and_serving_cells_raise():
    """The MoE train cell (the reference's goes through ``moe_sharded``)
    and the decode cell's sharding variants (A16) raise."""
    with pytest.raises(NotImplementedError, match="moe_sharded"):
        TS.build_cell("qwen3-moe-30b-a3b", "train_4k", smoke=True,
                      device="cpu")
    for variant in ("zero1", "sseq"):
        with pytest.raises(NotImplementedError, match="A16"):
            TS.build_cell("deepseek-7b", "decode_32k", smoke=True,
                          device="cpu", variant=variant)


def test_decode_cell_builds_and_matches_reference():
    """The decode_32k SMOKE cell: the reference's output shapes and
    model flops, and its logits on the same weights, cache and token
    within 1e-5 of the largest."""
    mesh = make_host_mesh()
    jcell = jbuild_cell("deepseek-7b", "decode_32k", mesh, smoke=True)
    cell = TS.build_cell("deepseek-7b", "decode_32k", smoke=True,
                         device="cpu")
    assert cell.kind == "decode" and cell.model_flops == jcell.model_flops
    params = cell.init_params()
    cache = cell.init_state(params)
    token = torch.tensor([3, 17], dtype=torch.int32)
    index = torch.tensor(5, dtype=torch.int32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree_unflatten(
        jax.eval_shape(lambda: jcell.args[0]),
        [v.numpy() for v in tree_leaves(params)]))
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    with mesh, mesh_context(mesh):
        jlogits, jc = jax.jit(jcell.step_fn)(jparams, jcache,
                                             jnp.asarray(token.numpy()),
                                             jnp.asarray(index.numpy()))
    logits, cache = cell.run(params, cache, {"token": token,
                                             "cache_index": index})
    assert logits.shape == jlogits.shape and logits.dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jc["k"]),
                               rtol=0, atol=1e-5)


def _qat_trainer_run(pkg, cfg, params, tcfg_kw, batches):
    if pkg == "jax":
        loss = jmake_qat_loss(lambda p, b, q: JT.lm_loss(p, b, cfg, qctx=q))
        tr = JLOOP.Trainer(loss, params, JLOOP.TrainerConfig(**tcfg_kw))
    else:
        loss = make_qat_loss(lambda p, b, q: TT.lm_loss(p, b, cfg, qctx=q))
        tr = Trainer(loss, params, TrainerConfig(**tcfg_kw))
    hist = tr.fit(iter(batches))
    return tr, hist


def test_qat_trainer_with_compression_and_accumulation_matches_jax():
    jcfg = jget_arch("deepseek-7b").smoke
    cfg = get_arch("deepseek-7b").smoke
    jparams = JT.init_lm(jax.random.PRNGKey(4), jcfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=4, seed=5)
    batches = [{k: v.reshape(2, 2, -1) for k, v in pipe.batch_at(i).items()}
               for i in range(2)]
    kw = dict(n_steps=2, lr=1e-3, warmup=1, grad_accum=2, grad_compress=True,
              log_every=0)
    jtr, jh = _qat_trainer_run("jax", jcfg, jparams, kw, batches)
    ttr, th = _qat_trainer_run("port", cfg, _bridge(jparams), kw, batches)
    assert th[0]["lr"] == jh[0]["lr"] == 0.0          # warm-up step 0
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    _assert_stepped(ttr.params, jtr.params, 1e-3)


def test_trainer_end_to_end_with_ckpt_and_accum(tmp_path):
    gen = torch.Generator().manual_seed(2)
    from repro_torch.models import layers as L
    params = {"l1": L.dense_init(gen, 4, 8, dtype=torch.float32,
                                 device="cpu", bias=True),
              "l2": L.dense_init(gen, 8, 2, dtype=torch.float32,
                                 device="cpu", bias=True)}

    def loss(p, batch):
        h = L.dense(p["l1"], batch["x"], act="relu", name="l1")
        return TT.token_nll(L.dense(p["l2"], h, name="l2"), batch["y"])

    rng = np.random.RandomState(3)

    def data():
        while True:
            x = rng.randn(4, 8, 4).astype(np.float32)   # accum=4
            yield {"x": x, "y": (x.sum(-1) > 0).astype(np.int32)}

    cfg = TrainerConfig(n_steps=12, lr=0.05, warmup=2, grad_accum=4,
                        ckpt_dir=str(tmp_path), ckpt_every=5, log_every=0)
    tr = Trainer(loss, {k: dict(v) for k, v in params.items()}, cfg)
    hist = tr.fit(data())
    assert len(hist) == 12
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert latest_step(tmp_path) == 10
    tr2 = Trainer(loss, params, cfg)
    assert tr2.maybe_restore() == 10
    assert int(tr2.opt.step) == 10


def test_launcher_restart_equals_an_uninterrupted_run(tmp_path, capsys,
                                                     deterministic):
    argv = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu"]
    straight = TTRAIN.main(argv + ["--steps", "4"])
    TTRAIN.main(argv + ["--steps", "2", "--ckpt", str(tmp_path),
                        "--ckpt-every", "2"])
    resumed = TTRAIN.main(argv + ["--steps", "4", "--ckpt", str(tmp_path),
                                  "--ckpt-every", "2"])
    assert "restored checkpoint @ step 2" in capsys.readouterr().out
    assert latest_step(tmp_path) == 4
    for a, b in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TTRAIN.main(["--arch", "deepseek-7b", "--smoke", "--steps", "1"])


# ---------------------------------- ViT -------------------------------------

def _img(batch, res, seed=0):
    return np.random.RandomState(seed).rand(batch, res, res, 3).astype(
        np.float32)


@pytest.mark.parametrize("arch", ["vit-s16", "deit-b"])
def test_vit_cls_loss_and_gradients_match_jax(arch):
    jcfg, cfg = jget_arch(arch).smoke, get_arch(arch).smoke
    jparams = JV.init_vit(jax.random.PRNGKey(2), jcfg)
    batch = {"image": _img(3, cfg.img_res),
             "label": np.array([1, 7, 3], np.int32)}
    jl, jg = jax.value_and_grad(JV.cls_loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch), jcfg)
    params = _bridge(jparams)
    acc = zeros_like_tree(params)
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        acc = zeros_like_tree(params)
        loss = value_and_grad_into(
            lambda p, b: TV.cls_loss(p, b, c), params,
            {k: torch.tensor(v) for k, v in batch.items()}, acc)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        _assert_grads(acc, jg)


def test_vit_loss_decreases():
    cfg = dataclasses.replace(get_arch("vit-s16").smoke, name="tiny-vit")
    p = TV.init_vit(torch.Generator().manual_seed(2), cfg, device="cpu")
    batch = {"image": torch.tensor(_img(4, cfg.img_res)),
             "label": torch.arange(4, dtype=torch.int32) % cfg.n_classes}
    loss = lambda p, b: TV.cls_loss(p, b, cfg)

    def vg(p):
        g = zeros_like_tree(p)
        return float(value_and_grad_into(loss, p, batch, g)), g

    l0, _ = vg(p)
    for _ in range(5):
        _, g = vg(p)
        p = tree_unflatten(p, [a - 0.5 * b for a, b in
                               zip(tree_leaves(p), tree_leaves(g))])
    assert vg(p)[0] < l0


def test_vision_train_cell_steps():
    cell = TS.build_cell("vit-s16", "cls_224", smoke=True, device="cpu")
    params = cell.init_params()
    opt = cell.init_opt(params)
    before = [t.clone() for t in tree_leaves(params)]
    raw = {"image": _img(2, 32), "label": np.array([0, 3], np.int32)}
    params, opt, m = cell.step_fn(params, opt, {k: torch.tensor(v) for k, v
                                                in raw.items()})
    assert np.isfinite(float(m["loss"]))
    assert all(not torch.equal(a, b) for a, b in zip(before,
                                                     tree_leaves(params)))
    rn = TS.build_cell("resnet-18", "cls_224", smoke=True, device="cpu")
    p = rn.init_params()
    p, o, m = rn.step_fn(p, rn.init_opt(p), {k: torch.tensor(v) for k, v
                                             in raw.items()})
    assert np.isfinite(float(m["loss"]))
