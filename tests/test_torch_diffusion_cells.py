"""Port parity: the diffusion cells (``repro_torch.launch.steps``) against
``repro.launch.steps``, on the CPU.

Exact, for all 8 diffusion cells at SMOKE size and one FULL denoise cell
of each family: the kind, ``model_flops`` (the graph's flops, three
times that to train) and every output leaf's path, shape and dtype (the
reference's from ``jax.eval_shape`` of its cell on the host mesh, the
port's from one run on the meta device).  With a tolerance: one denoise
step of each family on the same weights and inputs, within
``FORWARD_TOL`` × max |ref|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.configs import list_cells as jlist_cells  # noqa: E402
from repro.launch.mesh import make_host_mesh, mesh_context  # noqa: E402
from repro.launch.steps import build_cell as jbuild_cell  # noqa: E402
from repro_torch.bridge import tree_map  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from torch_cells_common import jax_cell, port_cell  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

DIFFUSION = [c for c in jlist_cells() if jget(c[0]).family == "diffusion"]
FORWARD_TOL = 2e-4


@pytest.mark.parametrize("arch,shape", DIFFUSION)
def test_smoke_cell_matches_reference(arch, shape):
    assert port_cell(arch, shape, True) == jax_cell(arch, shape, True)


@pytest.mark.parametrize("arch", ["unet-sd15", "flux-dev"])
def test_full_denoise_cell_matches_reference(arch):
    assert port_cell(arch, "gen_fast", False) == \
        jax_cell(arch, "gen_fast", False)


@pytest.mark.parametrize("arch", ["unet-sd15", "flux-dev"])
def test_denoise_step_matches_reference(arch):
    """gen_fast's step (DDIM stride 250 / Euler dt 1/4) on the port's
    weights, handed to JAX."""
    mesh = make_host_mesh()
    jcell = jbuild_cell(arch, "gen_fast", mesh, smoke=True)
    cell = TS.build_cell(arch, "gen_fast", smoke=True, device="cpu")
    params = cell.init_params()
    rng = np.random.RandomState(7)
    inputs = {}
    for k, spec in cell.batch_specs.items():
        if k == "t":
            arr = (rng.randint(250, 1000, spec.shape)
                   if not spec.dtype.is_floating_point
                   else rng.rand(*spec.shape) * 0.5 + 0.5)
        else:
            arr = rng.randn(*spec.shape)
        inputs[k] = np.asarray(arr).astype(str(spec.dtype).split(".")[1])
    got = cell.run(params, None, {k: torch.tensor(v)
                                  for k, v in inputs.items()})
    jparams = tree_map(lambda v: jnp.asarray(v.numpy()), params)
    with mesh, mesh_context(mesh):
        want = jax.jit(jcell.step_fn)(
            jparams, *[jnp.asarray(inputs[k]) for k in cell.arg_names])
    assert got.shape == want.shape and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FORWARD_TOL * np.abs(want).max())
