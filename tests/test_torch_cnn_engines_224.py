"""Port parity: the collaborative engine (``repro_torch.core.collab``) at
the cuts of VGG16 and GoogLeNet (224²) against the JAX package's engine,
on the CPU, by ``tests/test_torch_cnn_engines.py``'s comparison (its
docstring gives what is compared exactly and what within a tolerance).
VGG16's weights come from ``init_vgg16`` under ``jax.jit``, GoogLeNet's
are numpy draws in JAX's parameter tree (its JAX init compiles for many
seconds); each net runs at batch 1, each engine calibrated on the same
two batches of 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_cnn_engines import (_engine_pair, _engines_match,  # noqa: E402
                                    _img, _np)

from repro.models import legacy as JL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import legacy as TL  # noqa: E402


@pytest.fixture(scope="module")
def vgg16():
    p = _np(jax.jit(JL.init_vgg16)(jax.random.PRNGKey(0)))
    return (JL.vgg16_segments(jax.tree_util.tree_map(jnp.asarray, p)),
            TL.vgg16_segments(params_from_numpy(p, "cpu")))


@pytest.mark.parametrize("cut,share,rel_l2", [
    ("input", None, 2e-4),      # cloud-only fp32; measured 3.6e-6
    ("conv1_2", 5e-3, 1e-3)])   # the paper's cut; measured 4.6e-5, 8.2e-5
def test_vgg16_engine_matches_jax(vgg16, cut, share, rel_l2):
    je, te = _engine_pair(*vgg16, cut, 224)
    _engines_match(je, te, _img(1, 224, 0), share=share, rel_l2=rel_l2)


def test_googlenet_engine_matches_jax():
    """At the paper's cut ``conv2``: share ≤ 0.5 % (measured 0.055 %,
    one step), relative L2 1e-3 (measured 1.1e-5)."""
    rng = np.random.RandomState(1)

    def draw(s):
        if len(s.shape) == 1:
            return (rng.randn(*s.shape) * 0.01).astype(np.float32)
        return (rng.randn(*s.shape)
                / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    p = jax.tree_util.tree_map(
        draw, jax.eval_shape(JL.init_googlenet, jax.random.PRNGKey(0)))
    je, te = _engine_pair(
        JL.googlenet_segments(jax.tree_util.tree_map(jnp.asarray, p)),
        TL.googlenet_segments(params_from_numpy(p, "cpu")), "conv2", 224)
    _engines_match(je, te, _img(1, 224, 0), share=5e-3, rel_l2=1e-3)
