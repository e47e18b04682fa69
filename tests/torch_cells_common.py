"""Shared by the cell parity tests: a cell's outputs and ``model_flops``
in both packages, the reference's from ``build_cell`` and
``jax.eval_shape`` on the host mesh, the port's from one run of its
step on the meta device (shapes and dtypes, no storage)."""
import jax

from repro.launch.mesh import make_host_mesh, mesh_context
from repro.launch.steps import build_cell as jbuild_cell
from repro_torch.bridge import tree_flatten
from repro_torch.launch.dryrun import meta_inputs
from repro_torch.launch.steps import build_cell


def jax_cell(arch, shape, smoke):
    """(kind, model_flops, [(path, shape, dtype)] of the outputs)."""
    mesh = make_host_mesh()
    cell = jbuild_cell(arch, shape, mesh, smoke=smoke)
    with mesh, mesh_context(mesh):
        out = jax.eval_shape(cell.step_fn, *cell.args)
    leaves = [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
              for p, v in jax.tree_util.tree_flatten_with_path(out)[0]]
    return cell.kind, cell.model_flops, leaves


def port_cell(arch, shape, smoke):
    cell = build_cell(arch, shape, smoke=smoke, device="meta")
    params = cell.init_params()
    out = cell.run(params, cell.init_state(params), meta_inputs(cell))
    leaves = [(p, tuple(v.shape), str(v.dtype).split(".")[1])
              for p, v in tree_flatten(out)]
    return cell.kind, cell.model_flops, leaves
