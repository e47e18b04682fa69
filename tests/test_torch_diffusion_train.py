"""Port parity: the diffusion train cells and the training launcher's
latent pipeline against ``repro.launch.steps`` and ``repro.launch.train``,
on the CPU.

One SMOKE ``train_256`` step of each family (the U-Net at 64 channels;
f32 AdamW, ``noise`` and ``t`` from the batch) on the same weights and
batch, held to ``tests/test_torch_train.py``'s tolerances: loss within
1e-5 relative (``diffusion_loss`` and ``rf_loss`` too, their own draws
made the batch's), grad norm within 1e-4, parameters within ``2 · lr`` everywhere and 1e-6
on all but ``FLIP_SHARE`` of the elements.  The launcher's batch is the
reference's, key for key and value for value, and both launchers fail
on flux-dev's latent pipeline (``img_res // 8`` cells where the cell
wants ``(img_res // 16)²`` patch tokens).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.launch import train as JTRAIN  # noqa: E402
from repro.launch.mesh import make_host_mesh, mesh_context  # noqa: E402
from repro.launch.steps import build_cell as jbuild_cell  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro_torch.bridge import tree_flatten, tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import mmdit as TM  # noqa: E402
from repro_torch.models import unet as TU  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FLIP_SHARE = 1e-3


def _assert_stepped(port_tree, jtree, lr):
    want = [(jax.tree_util.keystr(p), np.asarray(v, np.float32))
            for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    off = n = 0
    for (path, w), (tpath, got) in zip(want, tree_flatten(port_tree)):
        assert path == tpath
        d = np.abs(got.float().numpy() - w)
        assert d.max() <= 2 * lr + 1e-6, path
        off, n = off + int((d > 1e-6).sum()), n + d.size
    assert off <= FLIP_SHARE * n, (off, n)


def _batch(cell, arch, step=0):
    """The launcher's batch (the reference's pipeline and draws); flux's
    latent, which that pipeline cannot give, drawn here."""
    cfg = get_arch(arch).smoke
    rng = np.random.RandomState(0)
    if arch == "flux-dev":
        lat = np.random.RandomState(1).randn(
            *cell.batch_specs["latent"].shape).astype(np.float32)
        pipe = type("Pipe", (), {"batch_at": lambda self, i: {
            "latent": lat}})()
    else:
        pipe = TTRAIN.pipeline("diffusion", cfg, cell)
    return TTRAIN.batch_for(cell, pipe, step, rng)


@pytest.mark.parametrize("arch,override", [
    ("unet-sd15", {"ch": 64}), ("flux-dev", None)])
def test_train_cell_step_matches_reference(arch, override):
    """The U-Net at 64 channels: at SMOKE's 8 every GroupNorm group is
    one channel, so each bias and timestep projection ahead of one has a
    gradient of rounding noise, which Adam's first step turns into any
    move within ±lr."""
    mesh = make_host_mesh()
    jcell = jbuild_cell(arch, "train_256", mesh, smoke=True,
                        cfg_override=override)
    cell = TS.build_cell(arch, "train_256", smoke=True, device="cpu",
                         cfg_override=override)
    assert cell.model_flops == jcell.model_flops and cell.grad_accum == 1
    params = cell.init_params()
    jparams = tree_map(lambda v: jnp.asarray(v.numpy()), params)
    opt = cell.init_opt(params)
    assert isinstance(opt, TO.AdamWState) and \
        isinstance(jcell.args[1], JO.AdamWState)
    batch = _batch(cell, arch)
    # the loss's own draws (``t``, then the noise) become the batch's, so
    # ``diffusion_loss`` / ``rf_loss`` meet the reference cell's loss
    cfg = get_arch(arch).smoke
    if override:
        cfg = dataclasses.replace(cfg, **override)
    gen = torch.Generator().manual_seed(3)
    x0, b = batch["latent"], batch["latent"].shape[0]
    if arch == "unet-sd15":
        batch["t"] = torch.randint(0, 1000, (b,), generator=gen).int()
        loss_fn = TU.diffusion_loss
    else:
        batch["t"] = torch.rand((b,), generator=gen)
        loss_fn = TM.rf_loss
    batch["noise"] = torch.randn(x0.shape, generator=gen)
    own_loss = loss_fn(params, batch, cfg,
                       generator=torch.Generator().manual_seed(3))
    with mesh, mesh_context(mesh):
        jp, jo, jm = jcell.jit()(jparams, JO.adamw_init(jparams),
                                 {k: jnp.asarray(v.numpy())
                                  for k, v in batch.items()})
    params, opt, m = cell.step_fn(params, opt, batch)
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(own_loss), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(opt.step) == int(jo.step) == 1
    _assert_stepped(params, jp, TO.AdamWConfig().lr)


def test_launcher_batch_is_the_references():
    """U-Net: the pipeline's latent and ctx, then ``t`` and ``noise``
    from one RandomState(0), in the cell's key order."""
    mesh = make_host_mesh()
    jcell = jbuild_cell("unet-sd15", "train_256", mesh, smoke=True)
    cell = TS.build_cell("unet-sd15", "train_256", smoke=True, device="cpu")
    assert list(cell.batch_specs) == list(jcell.args[2]) == [
        "latent", "ctx", "t", "noise"]
    jcfg = jget("unet-sd15").smoke
    jpipe = JTRAIN._pipeline(jget("unet-sd15"), jcfg,
                             {"seq": 0, "batch": 2, "img": jcfg.img_res},
                             True)
    pipe = TTRAIN.pipeline("diffusion", get_arch("unet-sd15").smoke, cell)
    jrng, rng = np.random.RandomState(0), np.random.RandomState(0)
    for step in range(2):
        want = JTRAIN._batch_for(jcell, jpipe, step, jrng)
        got = TTRAIN.batch_for(cell, pipe, step, rng)
        for k in want:
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_launcher_trains_unet_and_fails_on_flux_as_the_reference(capsys):
    TTRAIN.main(["--arch", "unet-sd15", "--smoke", "--steps", "1",
                 "--device", "cpu"])
    assert "step    1 loss=" in capsys.readouterr().out
    with pytest.raises(ValueError, match=r"'latent' is \[2, 8, 8, 8\] "
                       r"\(1024 values\) and the cell wants \[2, 16, 8\]"):
        TTRAIN.main(["--arch", "flux-dev", "--smoke", "--steps", "1",
                     "--device", "cpu"])
    jcfg = jget("flux-dev").smoke
    jcell = jbuild_cell("flux-dev", "train_256", make_host_mesh(),
                        smoke=True)
    jpipe = JTRAIN._pipeline(jget("flux-dev"), jcfg,
                             {"seq": 0, "batch": 2, "img": jcfg.img_res},
                             True)
    with pytest.raises(ValueError, match="cannot reshape array of size "
                       "1024 into shape"):
        JTRAIN._batch_for(jcell, jpipe, 0, np.random.RandomState(0))
