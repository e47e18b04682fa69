"""Port parity: the serving engines of ``repro_torch.serve`` against
``repro.serve.engine`` on deepseek-7b ``SMOKE`` with bridged weights.

* Lossless collaborative configuration (``a_bits=None``, fp pages on
  both sides): greedy streams identical to the JAX engine's, with more
  requests than slots (continuous batching) and prompt lengths that
  straddle a page boundary, at cuts 0 and 1.
* Default INT8 configuration: ``ServeStats`` wire bytes exactly equal;
  the first token of every request equal.
* Cloud-only paged fp engine: streams identical.
* Algorithm 1 (``--cut auto``) on deepseek-7b ``FULL``: the same cut.

The JAX engines run in one subprocess with XLA:CPU's asynchronous
dispatch switched off before its first computation (the flag has no
effect once the CPU client exists): with it on, the reference engine
races with itself under continuous batching and can emit a different
stream from run to run (ROADMAP C); with it off, it agrees with the
teacher-forced logits and with the port every time."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.core.autotune import AutoTuner as JAutoTuner  # noqa: E402
from repro.core.costmodel import (CLOUD_TITANXP_CLASS as J_CLOUD,  # noqa: E402
                                  EDGE_TX2_CLASS as J_EDGE,
                                  Channel as JChannel)
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.core.costmodel import Channel  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402

CFG = get_arch("deepseek-7b").smoke
TCFG = t_get_arch("deepseek-7b").smoke
# page_size 16: 15/16/17 and 31/33 sit on either side of a page boundary
PLENS = (15, 17, 16, 31, 33, 9)
LOSSLESS = dict(a_bits=None, edge_int8=False, cloud_int8=False)


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), CFG)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32) for n in PLENS]


_REFERENCE = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
import numpy as np
from repro.configs import get_arch
from repro.core.costmodel import Channel
from repro.models import transformer as JT
from repro.serve import engine as JE
CFG = get_arch("deepseek-7b").smoke
p = JT.init_lm(jax.random.PRNGKey(0), CFG)
def prompts(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32)
            for n in PLENS]
def run(eng, seed, n):
    outs = eng.generate(prompts(seed), max_new_tokens=n)
    st = eng.stats
    return dict(outs=outs, prefill_calls=st.prefill_calls,
                decode_steps=st.decode_steps,
                transmitted_bytes=st.transmitted_bytes,
                prefill_bytes=st.prefill_bytes,
                decode_bytes_log=st.decode_bytes_log,
                bytes_per_decode_token=st.bytes_per_decode_token(),
                channel_latency_s=st.channel_latency_s)
ref = {}
for cut in (0, 1):
    ref[f"lossless{cut}"] = run(JE.CollaborativeServingEngine(
        p, CFG, cut_layer=cut, max_len=48, **LOSSLESS), 0, 6)
    ref[f"int8{cut}"] = run(JE.CollaborativeServingEngine(
        p, CFG, cut_layer=cut, max_len=48,
        channel=Channel.from_kbps(100.0, rtt_ms=5.0)), 2, 5)
ref["cloud"] = run(JE.ServingEngine(p, CFG, max_len=48, paged=True), 3, 6)
ref["cloud_int8"] = run(JE.ServingEngine(p, CFG, max_len=48, paged=True,
                                         int8_kv=True), 3, 6)
ref["small_pool"] = run(JE.CollaborativeServingEngine(
    p, CFG, cut_layer=0, max_len=48, num_pages=7, **LOSSLESS), 4, 6)
json.dump(ref, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' streams and wire stats, from one subprocess."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = f"PLENS = {PLENS!r}\nLOSSLESS = {LOSSLESS!r}\n" + _REFERENCE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


@pytest.mark.parametrize("cut", [0, 1])
def test_lossless_streams_identical(params, reference, cut):
    want = reference[f"lossless{cut}"]
    t = TE.CollaborativeServingEngine(params[1], TCFG, cut_layer=cut,
                                      max_len=48, device="cpu", **LOSSLESS)
    assert t.generate(_prompts(0), max_new_tokens=6) == want["outs"]
    assert t.stats.prefill_calls == want["prefill_calls"]
    assert t.stats.decode_steps == want["decode_steps"]


def test_lossless_stream_does_not_depend_on_the_cut(params):
    """The reference invariant, inside the port."""
    _, tp = params
    outs = [TE.CollaborativeServingEngine(
        tp, TCFG, cut_layer=c, max_len=48, device="cpu", **LOSSLESS)
        .generate(_prompts(1), max_new_tokens=5) for c in (0, 1)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("cut", [0, 1])
def test_int8_wire_bytes_and_first_tokens_match(params, reference, cut):
    want = reference[f"int8{cut}"]
    t = TE.CollaborativeServingEngine(
        params[1], TCFG, cut_layer=cut, max_len=48, device="cpu",
        channel=Channel.from_kbps(100.0, rtt_ms=5.0))
    got = t.generate(_prompts(2), max_new_tokens=5)
    ts = t.stats
    assert ts.transmitted_bytes == want["transmitted_bytes"]
    assert ts.prefill_bytes == want["prefill_bytes"]
    assert ts.decode_bytes_log == want["decode_bytes_log"]
    assert ts.bytes_per_decode_token() == want["bytes_per_decode_token"]
    assert ts.channel_latency_s == pytest.approx(want["channel_latency_s"])
    assert [g[0] for g in got] == [w[0] for w in want["outs"]]


def test_cloud_only_paged_fp_streams_identical(params, reference):
    t = TE.ServingEngine(params[1], TCFG, max_len=48, paged=True,
                         device="cpu")
    assert t.generate(_prompts(3), max_new_tokens=6) == \
        reference["cloud"]["outs"]


def test_cloud_only_int8_pages_first_tokens_match(params, reference):
    t = TE.ServingEngine(params[1], TCFG, max_len=48, paged=True,
                         int8_kv=True, device="cpu")
    got = t.generate(_prompts(3), max_new_tokens=6)
    assert [g[0] for g in got] == \
        [w[0] for w in reference["cloud_int8"]["outs"]]


def test_small_pool_backpressures_admission_like_reference(params,
                                                           reference):
    """A pool of 7 pages (2 max-length slots) holds admission back until
    retirements return pages: same admissions, same streams."""
    want = reference["small_pool"]
    t = TE.CollaborativeServingEngine(params[1], TCFG, cut_layer=0,
                                      max_len=48, num_pages=7, device="cpu",
                                      **LOSSLESS)
    assert t.generate(_prompts(4), max_new_tokens=6) == want["outs"]
    assert t.stats.prefill_calls == want["prefill_calls"]
    assert t.stats.decode_steps == want["decode_steps"]


@pytest.mark.parametrize("kbps", [20.0, 250.0, 2000.0, 1e6])
def test_auto_cut_matches_reference_on_full_config(kbps):
    cfg, tcfg = get_arch("deepseek-7b").full, t_get_arch("deepseek-7b").full
    best, _ = JAutoTuner(JT.make_graph(cfg, batch=1, seq=12), J_EDGE,
                         J_CLOUD).tune(JChannel.from_kbps(kbps, rtt_ms=20.0))
    want = (int(best.point.split("/")[0][3:])
            if best.point.startswith("blk") else 0)
    point, cut = TLS.auto_cut(tcfg, Channel.from_kbps(kbps, rtt_ms=20.0),
                              prompt_len=12)
    assert (point, cut) == (best.point, want)


def test_cli_runs_collaborative_on_cpu(capsys):
    TLS.main(["--arch", "deepseek-7b", "--smoke", "--collaborative",
              "--cut", "auto", "--device", "cpu", "--requests", "5",
              "--max-new", "3"])
    out = capsys.readouterr().out
    assert "auto-tuned cut (Algorithm 1)" in out
    assert "first output:" in out


def test_unported_options_raise(params):
    """Only the options still unported raise (``spec_k > 1``, ``mesh``,
    ``sampling=``, ``policy``, ``demand_paged``, ``pressure``,
    ``admission`` and the dense cache layouts are ported; their parity
    tests are in ``test_torch_spec.py``, ``test_torch_sharded.py``,
    ``test_torch_sampling.py``, ``test_torch_adaptive.py``,
    ``test_torch_overload.py`` and ``test_torch_dense_serve.py``; a
    mesh with a data axis and a dense cloud cache on a tensor-parallel
    mesh are not)."""
    _, tp = params
    for kw in (dict(mesh=make_serve_mesh(model=2, data=2, device="cpu")),
               dict(mesh=make_serve_mesh(model=2, device="cpu"),
                    cloud_paged=False)):
        with pytest.raises(NotImplementedError, match="A16"):
            TE.CollaborativeServingEngine(tp, TCFG, cut_layer=0,
                                          device="cpu", **kw)
    for kw in (dict(policy="auto"), dict(demand_paged=True),
               dict(admission="deadline"), dict(edge_paged=False),
               dict(cloud_paged=False),
               dict(edge_paged=False, cloud_paged=False)):
        TE.CollaborativeServingEngine(tp, TCFG, cut_layer=0, device="cpu",
                                      **kw)
    eng = TE.CollaborativeServingEngine(tp, TCFG, cut_layer=0, spec_k=2,
                                        device="cpu")
    assert eng.spec_k == 2
    assert len(eng.generate(_prompts(0)[:1], max_new_tokens=2,
                            sampling=SamplingParams(temperature=0.8))[0]) == 2
