"""Port parity: the collaborative engine of ``repro_torch.serve`` on
grok-1-314b ``SMOKE`` (4 experts, top 2; no ``head_dim``, d_model 48)
against the JAX engine (``tests/torch_moe_common.py``), the JAX weights
bridged by value.  grok-1's ``FULL`` (316.5 B parameters) fits on no
single card, so this config is held against the reference here only.

* Lossless (fp pages both sides) at cuts 0 and 1: streams identical.
* INT8 default at cuts 0 and 1: every counter and wire byte exact,
  first tokens equal, streams teacher-forced (``NEAR_TIE``).
* ``spec_k=4`` in the INT8 default at cut 0: streams, rounds, accepted
  counts and bytes exactly the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_moe_common as MC  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402

ARCH = "grok-1-314b"
CFG, TCFG = get_arch(ARCH).smoke, t_get_arch(ARCH).smoke
RUNS = {run[0]: run for run in (
    ("lossless0", ARCH, "collab", 0, 1, "lossless", 0, 6),
    ("lossless1", ARCH, "collab", 1, 1, "lossless", 0, 6),
    ("int8_0", ARCH, "collab", 0, 1, "int8", 2, 6),
    ("int8_1", ARCH, "collab", 1, 1, "int8", 2, 6),
    ("spec_int8_0", ARCH, "collab", 0, 4, "int8", 2, 6))}


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), CFG)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def reference():
    return MC.reference(RUNS.values())


@pytest.mark.parametrize("cut", [0, 1])
def test_lossless_streams_identical(params, reference, cut):
    run, want = RUNS[f"lossless{cut}"], reference[f"lossless{cut}"]
    t = MC.port_engine(params, TCFG, run)
    assert MC.generate(t, TCFG, run) == want["outs"]
    MC.assert_stats(t.stats, want)


@pytest.mark.parametrize("cut", [0, 1])
def test_int8_stats_first_tokens_and_teacher_forced_streams(
        params, reference, cut):
    MC.check_int8_run(params, TCFG, RUNS[f"int8_{cut}"],
                      reference[f"int8_{cut}"])


def test_spec_int8_streams_counts_and_bytes_match_reference(params,
                                                            reference):
    want = reference["spec_int8_0"]
    t = MC.port_engine(params, TCFG, RUNS["spec_int8_0"])
    assert MC.generate(t, TCFG, RUNS["spec_int8_0"]) == want["outs"]
    MC.assert_stats(t.stats, want)
    assert 0 < t.stats.draft_hits <= t.stats.drafted_tokens
