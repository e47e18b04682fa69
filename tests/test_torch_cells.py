"""Port parity: the registry's cells (``repro_torch.configs``,
``repro_torch.launch.steps``) and the dry run
(``repro_torch.launch.dryrun``) against ``repro.configs`` and
``repro.launch.steps``, on the CPU.

Exact: the archs and ``list_cells()`` (the 40 assigned cells, in order),
every cell's shape and ``input_specs``, and, for the LM and vision cells
at SMOKE size and one FULL cell each, the kind, ``model_flops`` and
every output leaf's path, shape and dtype (the reference's from
``jax.eval_shape`` of its cell on the host mesh, the port's from one run
on the meta device).  The diffusion cells are in
``tests/test_torch_diffusion_cells.py``, the dry run in
``tests/test_torch_dryrun.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs import list_cells as jlist_cells  # noqa: E402
from repro_torch.configs import get_arch, input_specs  # noqa: E402
from repro_torch.configs import list_archs, list_cells  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from torch_cells_common import jax_cell, port_cell  # noqa: E402

CELLS = jlist_cells()
OTHER = [c for c in CELLS if jget(c[0]).family != "diffusion"]


def test_archs_and_cells_are_the_references():
    assert len(CELLS) == 40
    assert list_cells() == CELLS
    assert list_archs() == jlist_archs()
    assert list_archs(assigned_only=True) == jlist_archs(assigned_only=True)
    assert {a for a in list_archs() if not get_arch(a).assigned} == \
        {"alexnet", "vgg16", "resnet-18", "googlenet"}


@pytest.mark.parametrize("smoke", [False, True])
def test_input_specs_of_every_cell(smoke):
    for arch, shape in CELLS:
        assert dataclasses.asdict(get_arch(arch).shapes[shape]) == \
            dataclasses.asdict(jget(arch).shapes[shape])
        got = {k: (v.shape, str(v.dtype).split(".")[1])
               for k, v in input_specs(arch, shape, smoke=smoke).items()}
        want = {k: (v.shape, str(v.dtype))
                for k, v in jinput_specs(arch, shape, smoke=smoke).items()}
        assert got == want and list(got) == list(want), (arch, shape)


@pytest.mark.parametrize("arch,shape", OTHER)
def test_smoke_cell_matches_reference(arch, shape):
    if jget(arch).family == "lm" and jget(arch).smoke.moe is not None \
            and jget(arch).shapes[shape].kind == "train":
        with pytest.raises(NotImplementedError, match="moe_sharded"):
            port_cell(arch, shape, True)
        return
    assert port_cell(arch, shape, True) == jax_cell(arch, shape, True)


@pytest.mark.parametrize("arch,shape", [("deepseek-7b", "decode_32k"),
                                        ("vit-s16", "serve_b128")])
def test_full_cell_matches_reference(arch, shape):
    assert port_cell(arch, shape, False) == jax_cell(arch, shape, False)


def test_int8kv_decode_cell_and_sharding_variants():
    cell = TS.build_cell("deepseek-7b", "decode_32k", smoke=True,
                         variant="int8kv", device="meta")
    cache = cell.init_state(cell.init_params())
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].shape == (
        get_arch("deepseek-7b").smoke.n_layers,
        get_arch("deepseek-7b").smoke.n_kv)
    for variant in ("zero1", "sseq", "int8kv+sseq"):
        with pytest.raises(NotImplementedError, match="A16"):
            TS.build_cell("deepseek-7b", "decode_32k", smoke=True,
                          variant=variant, device="meta")


def test_cells_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for arch, shape in (("unet-sd15", "gen_fast"), ("flux-dev", "gen_fast"),
                        ("deepseek-7b", "prefill_32k"),
                        ("vit-s16", "serve_b1")):
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.build_cell(arch, shape, smoke=True)
