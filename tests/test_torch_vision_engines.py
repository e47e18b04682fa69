"""Port parity: the collaborative engine (``repro_torch.core.collab``) on
ResNet and ViT against the JAX package's engine, on the CPU, by
``tests/test_torch_cnn_engines.py``'s comparison (its docstring gives
what is compared exactly and what within a tolerance).  The forwards the
engines split, the edge's model download, resnet-18's engines at 224²
and the engines at the published bf16 are in
``tests/test_torch_vision_forward.py``.

Both packages get the same numpy images and weights: numpy draws in the
tree JAX's ``init_*`` gives (``jax.eval_shape``; kernels normal /
√fan-in, norm scales 1 + 0.1·normal, biases 0.1·normal, tokens and
positions 0.02·normal), bridged with ``params_from_numpy``.  Every
engine is calibrated on the same two batches of 2 and runs at a mid cut
of a SMOKE net or at a ViT edge of two blocks.

Exact, beyond the shared comparison: the ``act_scales`` key set of a
ViT edge with two blocks is the reference's, one key per activation name
for all its blocks (``vit.block_apply`` names them alike).  Port alone:
``chip_smoke.py``'s card-against-CPU check run with both engines on the
CPU holds an engine to itself exactly.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_cnn_engines import _engine_pair, _engines_match  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.models import vit as JV  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402

VIT_ACT_KEYS = {"patch/in", "attn/q/in", "attn/k/in", "attn/v/in",
                "attn/o/in", "mlp/wi/in", "mlp/wo/in"}


def _mods(arch):
    """(JAX module, port module) of an arch's family."""
    return (JR, TR) if arch.startswith("resnet") else (JV, TV)


def np_weights(arch, cfg, seed=0):
    """Numpy draws in the tree JAX's init gives for ``cfg`` (its dtype
    kept)."""
    init = JR.init_resnet if arch.startswith("resnet") else JV.init_vit
    shapes = jax.eval_shape(lambda key: init(key, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def one(path, s):
        key = jax.tree_util.keystr(path[-1:])
        if "scale" in key:
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        elif key == "['b']":
            v = 0.1 * rng.randn(*s.shape)
        elif key in ("['cls']", "['pos']"):
            v = 0.02 * rng.randn(*s.shape)
        else:
            lead = 1 if jax.tree_util.keystr(path[:1]) == "['blocks']" else 0
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[lead:-1]))
        return np.asarray(jnp.asarray(v.astype(np.float32), s.dtype))
    return jax.tree_util.tree_map_with_path(one, shapes)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _img(batch, res, seed=0):
    return np.random.RandomState(seed).rand(batch, res, res,
                                            3).astype(np.float32)


def _models(arch, cfg, tcfg, seed=0):
    """(JAX segmented model, the port's) on the same weights."""
    jp = np_weights(arch, cfg, seed)
    jm, tm = _mods(arch)
    return (jm.make_segments(_j(jp), cfg),
            tm.make_segments(params_from_numpy(jp, "cpu"), tcfg))


# -- engines ------------------------------------------------------------------


@pytest.mark.parametrize("arch,cut", [
    ("resnet-18", "s2b0/body"), ("resnet-152", "s2b0/body"),
    ("vit-s16", "blk0/ffn"), ("deit-b", "blk0/ffn"),
    ("vit-h14", "blk0/ffn")])
def test_smoke_engine_at_a_mid_cut_matches_jax(arch, cut):
    """Share ≤ 1 % (measured 0 at every cut), relative L2 1e-3 (measured
    ≤ 1.5e-6)."""
    cfg, tcfg = jget(arch).smoke, tget(arch).smoke
    je, te = _engine_pair(*_models(arch, cfg, tcfg), cut, cfg.img_res)
    _engines_match(je, te, _img(1, cfg.img_res, 0), share=0.01,
                   rel_l2=1e-3)


@pytest.mark.parametrize("arch", ["vit-s16", "deit-b"])
def test_vit_edge_with_two_blocks_shares_its_calibration_keys(arch):
    """At ``blk1/ffn`` both blocks record under the same seven names, as
    in the reference: one static range per name for the whole edge.
    Share ≤ 1 %, relative L2 1e-3."""
    cfg, tcfg = jget(arch).smoke, tget(arch).smoke
    je, te = _engine_pair(*_models(arch, cfg, tcfg), "blk1/ffn",
                          cfg.img_res)
    assert set(te.act_scales) == set(je.act_scales) == VIT_ACT_KEYS
    _engines_match(je, te, _img(1, cfg.img_res, 0), share=0.01,
                   rel_l2=1e-3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,cut,lattices", [("resnet-18", "s2b0/body", 4),
                                               ("vit-s16", "blk1/ffn", 7)])
def test_card_vs_cpu_check_holds_an_engine_to_itself(arch, cut, lattices):
    """``chip_smoke._cnn_card_vs_cpu`` (the ``cnn_path``'s check) with
    both engines on the CPU: every lattice equal, every relative L2 0.
    The last edge segment's lattices are traced one by one, with the
    boundary's: a ViT block holds six static ones (q, k, v, o, wi, wo
    inputs)."""
    tcfg = tget(arch).smoke
    model = _mods(arch)[1].make_segments(
        params_from_numpy(np_weights(arch, jget(arch).smoke, 2), "cpu"), tcfg)
    calib = [torch.tensor(_img(2, tcfg.img_res, s)) for s in (5, 6)]
    res = _chip_smoke()._cnn_card_vs_cpu(model, cut, calib,
                                         torch.tensor(_img(2, tcfg.img_res)))
    forced = res["teacher_forced_lattices"]
    assert forced["lattices"] == lattices
    assert forced["max_step"] == 0
    assert res["same_float_boundary"] == {"lattice_equal": True,
                                          "zero_point_equal": True,
                                          "scale_ulps": 0.0}
    for steps in (res["input_forced_lattice"], res["end_to_end_lattice"]):
        assert steps["max_step"] == 0
    assert res["f32_max_err"] == res["last_edge_rel_l2"] == 0.0
    assert res["int8_rel_l2"] == res["act_scale_max_rel_diff"] == 0.0
