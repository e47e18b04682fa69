"""Port parity: the serving engines of ``repro_torch.serve`` on
qwen3-moe-30b-a3b ``SMOKE`` (a mixture-of-experts LM: 8 experts, top 2)
against ``repro.serve.engine``, the JAX weights bridged by value; the
JAX engines run in one subprocess (``tests/torch_moe_common.py``).

* Lossless collaborative configuration (``a_bits=None``, fp pages on
  both sides) at cuts 0 and 1: greedy streams identical to the JAX
  engine's, with more requests than slots and prompt lengths that
  straddle a page boundary; the stream does not depend on the cut.
* INT8 default configuration at cuts 0 and 1: every wire byte and
  ``ServeStats`` counter exactly the reference's and every first token
  equal; the streams teacher-forced — the port's engine commits the
  reference's tokens, and at each decode step its own greedy choice
  must be the reference's token or within ``NEAR_TIE`` (0.05) of it in
  the port's logits.  A one-ulp difference can move an Eq.(1) rounding
  on the INT8 edge, and the cloud (its router too) reads that edge's
  output: at cut 0 the port's free-running stream leaves the
  reference's at such a near-tie.
* Cloud-only engines, dense fp (the reference launcher's default) and
  paged fp: streams identical.
* The bank's prequantized block leaves — attention ``w``, the router's
  ``w`` and the raw expert ``wi``/``wg``/``wo``, each on the lattice
  layer by layer — equal to the reference's ``_prequantize_blocks``
  bit for bit.
* A tensor-parallel cloud (tp 2 on one CPU "mesh"; attention split, the
  ``moe`` group whole on the first device) gives the tp 1 lossless
  stream.
* The launcher serves both MoE archs on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_moe_common as MC  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import policy as JP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import policy as TP  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
CFG, TCFG = get_arch(ARCH).smoke, t_get_arch(ARCH).smoke
RUNS = {run[0]: run for run in (
    ("lossless0", ARCH, "collab", 0, 1, "lossless", 0, 6),
    ("lossless1", ARCH, "collab", 1, 1, "lossless", 0, 6),
    ("int8_0", ARCH, "collab", 0, 1, "int8", 2, 6),
    ("int8_1", ARCH, "collab", 1, 1, "int8", 2, 6),
    ("cloud_dense", ARCH, "cloud_dense", None, 1, None, 4, 6),
    ("cloud_paged", ARCH, "cloud_paged", None, 1, None, 4, 6))}


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), CFG)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


@pytest.fixture(scope="module")
def reference():
    return MC.reference(RUNS.values())


@pytest.mark.parametrize("cut", [0, 1])
def test_lossless_streams_identical(params, reference, cut):
    run, want = RUNS[f"lossless{cut}"], reference[f"lossless{cut}"]
    t = MC.port_engine(params[1], TCFG, run)
    assert MC.generate(t, TCFG, run) == want["outs"]
    MC.assert_stats(t.stats, want)


def test_lossless_stream_does_not_depend_on_the_cut(params):
    """The reference invariant, inside the port, for MoE blocks."""
    outs = [MC.generate(MC.port_engine(params[1], TCFG, run), TCFG,
                        (*run[:6], 1, 5))
            for run in (RUNS["lossless0"], RUNS["lossless1"])]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("cut", [0, 1])
def test_int8_stats_first_tokens_and_teacher_forced_streams(
        params, reference, cut):
    MC.check_int8_run(params[1], TCFG, RUNS[f"int8_{cut}"],
                      reference[f"int8_{cut}"])


@pytest.mark.parametrize("kind", ["cloud_dense", "cloud_paged"])
def test_cloud_only_streams_identical(params, reference, kind):
    t = MC.port_engine(params[1], TCFG, RUNS[kind])
    assert MC.generate(t, TCFG, RUNS[kind]) == reference[kind]["outs"]
    assert t.stats.decode_steps == reference[kind]["decode_steps"]


def test_prequantized_bank_leaves_equal_reference_bit_for_bit(params):
    jp, tp = params
    want = JP._prequantize_blocks(jp["blocks"],
                                  JL.QuantCtx(mode="dynamic", a_bits=8))
    got = TP._prequantize_blocks(tp["blocks"], TL.QuantCtx(a_bits=8))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    moved = 0
    for path, leaf in flat:
        node, orig = got, tp["blocks"]
        for k in path:
            node, orig = node[k.key], orig[k.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        moved += not torch.equal(node, orig.float())
    names = {jax.tree_util.keystr(p) for p, _ in flat}
    assert {"['moe']['router']['w']", "['moe']['wi']", "['moe']['wg']",
            "['moe']['wo']"} <= names
    # every weight leaf moved onto the lattice; the two norms did not
    assert moved == len(flat) - 2


def test_tp2_cloud_gives_the_tp1_stream(params):
    prompts = MC.prompts(TCFG.vocab, 6)
    outs = []
    for tp in (1, 2):
        eng = MC.port_engine(params[1], TCFG, RUNS["lossless0"],
                             mesh=make_serve_mesh(model=tp, device="cpu"))
        if tp == 2:
            assert isinstance(eng.cloud_blocks["attn"], list)
            assert isinstance(eng.cloud_blocks["moe"], dict)
        outs.append(eng.generate(prompts, max_new_tokens=5))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", MC.ARCHS)
def test_cli_serves_moe_on_cpu(capsys, arch):
    for extra in ([], ["--collaborative", "--cut", "0", "--spec-k", "4"]):
        TLS.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "5", "--max-new", "3", *extra])
        assert "first output:" in capsys.readouterr().out
