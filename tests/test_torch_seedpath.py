"""Port parity: the seed recompute path (``serve.seedpath``:
``forward`` / ``generate_recompute``) and the cloud-only
``ServingEngine`` over its dense caches, against ``repro.serve.engine``
on a 3-layer GQA model (4 heads over 2 kv heads) with bridged weights
(twins of ``tests/test_collab_decode.py`` and of the dense cases of
``tests/test_paged_attention.py``).

* ``generate_recompute`` at ``a_bits`` 16, 8 and lossless: streams
  identical, raw-total wire bytes (by formula too), channel time and
  steps exact; at ``a_bits=16`` with fp dense caches the incremental
  engine emits the recompute path's stream at every cut.
* ``ServingEngine`` over a dense cache (fp, a bf16 ``cache_dtype``,
  ``int8_kv``): streams identical, ``cache_bytes`` exact; the paged fp
  engine's stream equal to the dense one's, INT8 pages tracking it.

The JAX engines run in one subprocess with XLA:CPU's asynchronous
dispatch switched off before its first computation (ROADMAP C)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.costmodel import Channel  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.transport import _MSG_BYTES, _QP_BYTES  # noqa: E402

TCFG = TT.LMConfig(name="collab-tiny", n_layers=3, d_model=32, n_heads=4,
                   n_kv=2, d_ff=64, vocab=64)
PLENS = (6, 9, 7, 16, 12)
DENSE16 = dict(a_bits=16, edge_paged=False, edge_int8=False,
               cloud_paged=False, cloud_int8=False)
NEW = 6


def _prompts(seed, lens=PLENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TCFG.vocab, n).astype(np.int32) for n in lens]


_REFERENCE = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
import jax.numpy as jnp
import numpy as np
from repro.core.costmodel import Channel
from repro.models import transformer as JT
from repro.serve import engine as JE
CFG = JT.LMConfig(name="collab-tiny", n_layers=3, d_model=32, n_heads=4,
                  n_kv=2, d_ff=64, vocab=64, max_seq=64, remat=False)
p = JT.init_lm(jax.random.PRNGKey(0), CFG)
def prompts(seed, lens=PLENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32) for n in lens]
STATS = ("prefill_calls", "decode_steps", "transmitted_bytes",
         "prefill_bytes", "decode_bytes_log", "prefill_tokens",
         "decode_tokens", "spec_rounds", "drafted_tokens", "draft_hits")
def run(eng, outs):
    st = eng.stats
    d = {k: getattr(st, k) for k in STATS}
    d.update(outs=outs, channel_latency_s=st.channel_latency_s)
    return d
ref = {}
ch = Channel.from_kbps(100.0, rtt_ms=5.0)
for mode, kw in (("a16", dict(a_bits=16)), ("int8", {}),
                 ("lossless", dict(a_bits=None))):
    e = JE.CollaborativeServingEngine(p, CFG, cut_layer=1, max_batch=3,
                                      max_len=64, channel=ch, **kw)
    ref[f"recompute_{mode}"] = run(e, e.generate_recompute(
        prompts(3, (6, 6, 6)), max_new_tokens=8))
for mode, kw in (("fp", {}), ("bf16", dict(cache_dtype=jnp.bfloat16)),
                 ("int8", dict(int8_kv=True))):
    e = JE.ServingEngine(p, CFG, max_batch=2, max_len=40, **kw)
    d = run(e, e.generate(prompts(4), max_new_tokens=NEW))
    d["cache_bytes"] = e.cache_bytes()
    ref[f"cloud_{mode}"] = d
json.dump(ref, sys.stdout)
"""


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), JT.LMConfig(
        name="collab-tiny", n_layers=3, d_model=32, n_heads=4, n_kv=2,
        d_ff=64, vocab=64, max_seq=64, remat=False))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' streams and stats, from one subprocess."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = f"PLENS = {PLENS!r}\nNEW = {NEW}\n" + _REFERENCE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


_STATS = ("prefill_calls", "decode_steps", "transmitted_bytes",
          "prefill_bytes", "decode_bytes_log", "prefill_tokens",
          "decode_tokens", "spec_rounds", "drafted_tokens", "draft_hits")


def _check(eng, outs, want):
    assert outs == want["outs"]
    for k in _STATS:
        assert getattr(eng.stats, k) == want[k], k
    assert eng.stats.channel_latency_s == pytest.approx(
        want["channel_latency_s"], rel=1e-12)


def _collab(params, **kw):
    return TE.CollaborativeServingEngine(params, TCFG, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["a16", "int8", "lossless"])
def test_generate_recompute_matches_reference(params, reference, mode):
    kw = {"a16": dict(a_bits=16), "int8": {}, "lossless": dict(a_bits=None)}
    eng = _collab(params, cut_layer=1, max_batch=3, max_len=64,
                  channel=Channel.from_kbps(100.0, rtt_ms=5.0), **kw[mode])
    prompts = _prompts(3, (6, 6, 6))
    outs = eng.generate_recompute(prompts, max_new_tokens=8)
    want = reference[f"recompute_{mode}"]
    _check(eng, outs, want)
    # raw totals over the growing sequence: one blob, frame and header a
    # step (int16 at a_bits=16, int8 at 8, f32 when lossless)
    item = {"a16": 2, "int8": 1, "lossless": 4}[mode]
    assert eng.stats.transmitted_bytes == sum(
        3 * (6 + i) * TCFG.d_model * item + _QP_BYTES + _MSG_BYTES
        for i in range(8))
    assert eng.stats.decode_steps == 8


def test_incremental_decode_matches_recompute(params, reference):
    """With the 16-bit lattice and fp dense caches the incremental split
    cache decode emits exactly the seed recompute path's greedy tokens
    (``tests/test_collab_decode.py``), on the port as on the
    reference."""
    prompts = _prompts(3, (6, 6, 6))
    for cut in (0, 1, 2):
        inc = _collab(params, cut_layer=cut, max_batch=3, max_len=32,
                      **DENSE16)
        rec = _collab(params, cut_layer=cut, max_batch=3, max_len=32,
                      a_bits=16)
        got = inc.generate(prompts, max_new_tokens=8)
        assert got == rec.generate_recompute(prompts, max_new_tokens=8)
        if cut == 1:
            assert got == reference["recompute_a16"]["outs"]


@pytest.mark.parametrize("mode", ["fp", "bf16", "int8"])
def test_dense_cloud_engine_matches_reference(params, reference, mode):
    kw = {"fp": {}, "bf16": dict(cache_dtype=torch.bfloat16),
          "int8": dict(int8_kv=True)}[mode]
    eng = TE.ServingEngine(params, TCFG, max_batch=2, max_len=40,
                           device="cpu", **kw)
    assert not eng.paged and "k" in eng._cache
    want = reference[f"cloud_{mode}"]
    assert eng.generate(_prompts(4), max_new_tokens=NEW) == want["outs"]
    assert eng.stats.prefill_calls == want["prefill_calls"]
    assert eng.stats.decode_steps == want["decode_steps"]
    assert eng.cache_bytes() == want["cache_bytes"]
    dtype = {"fp": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[mode]
    assert eng._cache["k"].dtype == dtype


def test_paged_and_dense_cloud_engines_agree(params):
    """The fp page pool is a layout change only: its greedy stream is the
    dense engine's; INT8 pages track it and hold about a quarter of its
    bytes on live pages (twins of ``tests/test_paged_attention.py``'s
    dense cases, inside the port)."""
    prompts = _prompts(8, (6, 6, 6, 8))
    dense = TE.ServingEngine(params, TCFG, max_batch=4, max_len=32,
                             device="cpu")
    paged = TE.ServingEngine(params, TCFG, max_batch=4, max_len=32,
                             paged=True, page_size=8, device="cpu")
    ref = dense.generate(prompts, max_new_tokens=6)
    assert paged.generate(prompts, max_new_tokens=6) == ref
    q8 = TE.ServingEngine(params, TCFG, max_batch=4, max_len=32, paged=True,
                          page_size=8, int8_kv=True, device="cpu")
    got = q8.generate(prompts, max_new_tokens=6)
    assert q8._cache["k_pages"].dtype == torch.int8
    agree = sum(a == b for r, g in zip(ref, got) for a, b in zip(r, g))
    assert agree / sum(len(r) for r in ref) >= 0.6, (ref, got)
    assert q8.cache_bytes(live_only=True) < dense.cache_bytes() / 3


def test_cli_cloud_only_runs_the_dense_fp_engine(capsys):
    """The launcher's cloud-only mode builds the engine as the reference
    CLI does (a dense fp cache) and says so."""
    from repro_torch.launch import serve as TLS
    TLS.main(["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
              "--requests", "5", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "cloud-only (dense fp KV): 5 reqs x 3 tokens" in out
    assert "first output:" in out
