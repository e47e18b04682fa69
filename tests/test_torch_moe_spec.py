"""Port parity: speculative draft/verify rounds of ``repro_torch.serve``
on qwen3-moe-30b-a3b ``SMOKE`` against the JAX engines
(``tests/torch_moe_common.py``), the JAX weights bridged by value.

* ``spec_k=4`` with fp pages (the INT8 boundary lattice and the INT8
  draft copy still run) at cuts 0 and 1: streams, rounds, accepted and
  drafted counts and every wire byte exactly the reference's.
* ``spec_k=4`` in the INT8 default at cut 1 (where the serial INT8
  stream follows the reference's; at cut 0 it leaves it at a near-tie,
  ``test_torch_moe_serve.py``): the same, exactly.
* The lossless spec stream is the serial stream."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_moe_common as MC  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
CFG, TCFG = get_arch(ARCH).smoke, t_get_arch(ARCH).smoke
RUNS = {run[0]: run for run in (
    ("spec_fp0", ARCH, "collab", 0, 4, "fp_pages", 3, 8),
    ("spec_fp1", ARCH, "collab", 1, 4, "fp_pages", 3, 8),
    ("spec_int8_1", ARCH, "collab", 1, 4, "int8", 2, 6))}


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), CFG)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def reference():
    return MC.reference(RUNS.values())


@pytest.mark.parametrize("key", list(RUNS))
def test_spec_streams_counts_and_bytes_match_reference(params, reference,
                                                       key):
    want = reference[key]
    t = MC.port_engine(params, TCFG, RUNS[key])
    assert MC.generate(t, TCFG, RUNS[key]) == want["outs"]
    MC.assert_stats(t.stats, want)
    assert t.stats.spec_rounds > 0
    assert 0 < t.stats.draft_hits <= t.stats.drafted_tokens


def test_lossless_spec_stream_is_the_serial_stream(params):
    outs = [MC.generate(MC.port_engine(params, TCFG, run), TCFG, run)
            for run in (("", ARCH, "collab", 0, k, "lossless", 5, 7)
                        for k in (1, 4))]
    assert outs[0] == outs[1]
