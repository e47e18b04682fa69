"""Port parity: the serving engines over the dense KV caches and the seed
recompute path, against ``repro.serve.engine`` on a 3-layer GQA model
(4 heads over 2 kv heads) with bridged weights (twins of the dense
cases of ``tests/test_collab_decode.py``, ``tests/test_spec_decode.py``
and ``tests/test_paged_attention.py``; the seed path and the cloud-only
engine are in ``test_torch_seedpath.py``).

* ``CollaborativeServingEngine`` in all four ``edge_paged`` ×
  ``cloud_paged`` layouts, lossless (``a_bits=None``, fp caches) and in
  the INT8 default: streams identical (INT8 streams too: they matched
  on the first run, so a mismatch is a regression), wire bytes and
  every ``ServeStats`` counter exact, ``edge_cache_bytes`` exact;
  ``spec_k`` 2 and 4 on the dense lossless configuration at a 16-bit
  lattice, draft hits exact.
* A dense engine whose verify blocks run past ``max_len``: the
  out-of-range writes are dropped without an error, streams identical.

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
from repro_torch.serve.resilience import (  # noqa: E402
    ResilientCollaborativeEngine)

TCFG = TT.LMConfig(name="collab-tiny", n_layers=3, d_model=32, n_heads=4,
                   n_kv=2, d_ff=64, vocab=64)
# prompt lengths straddle 8 and 16 (buckets); 5 requests over 3 slots
PLENS = (6, 9, 7, 16, 12)
LAYOUTS = {"pp": (True, True), "pd": (True, False), "dp": (False, True),
           "dd": (False, False)}
LOSSLESS = dict(a_bits=None, edge_int8=False, cloud_int8=False)
DENSE16 = dict(a_bits=16, edge_paged=False, edge_int8=False,
               cloud_paged=False, cloud_int8=False)
NEW = 6
# max_len 24 = 14 + 7 + the k - 1 = 3 positions of draft headroom: a
# slot's last round may leave its position at 23, where an idle slot's
# next verify block writes 23..26
PAST_END_LENS = (14, 13, 14, 9)


def _prompts(seed, lens=PLENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TCFG.vocab, n).astype(np.int32) for n in lens]


_REFERENCE = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
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
    if hasattr(eng, "edge_cache_bytes"):
        d["edge_cache_bytes"] = eng.edge_cache_bytes()
    return d
ref = {}
ch = Channel.from_kbps(100.0, rtt_ms=5.0)
for name, (ep, cp) in LAYOUTS.items():
    for mode, kw in (("lossless", LOSSLESS), ("int8", {})):
        e = JE.CollaborativeServingEngine(
            p, CFG, cut_layer=1, max_batch=3, max_len=40, channel=ch,
            edge_paged=ep, cloud_paged=cp, page_size=8, **kw)
        ref[f"{name}_{mode}"] = run(e, e.generate(prompts(0), max_new_tokens=NEW))
for k in (1, 2, 4):
    e = JE.CollaborativeServingEngine(p, CFG, cut_layer=1, max_batch=3,
                                      max_len=64, spec_k=k, **DENSE16)
    ref[f"dense16_k{k}"] = run(e, e.generate(prompts(2, (6, 9, 7)),
                                             max_new_tokens=8))
e = JE.CollaborativeServingEngine(p, CFG, cut_layer=0, max_batch=3,
                                  max_len=24, spec_k=4, **DENSE16)
ref["past_end"] = run(e, e.generate(prompts(5, PAST_END_LENS),
                                    max_new_tokens=7))
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
    code = (f"PLENS = {PLENS!r}\nLAYOUTS = {LAYOUTS!r}\n"
            f"LOSSLESS = {LOSSLESS!r}\nDENSE16 = {DENSE16!r}\nNEW = {NEW}\n"
            f"PAST_END_LENS = {PAST_END_LENS!r}\n"
            + _REFERENCE)
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


@pytest.mark.parametrize("mode", ["lossless", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_match_reference(params, reference, layout, mode):
    ep, cp = LAYOUTS[layout]
    eng = _collab(params, cut_layer=1, max_batch=3, max_len=40,
                  channel=Channel.from_kbps(100.0, rtt_ms=5.0),
                  edge_paged=ep, cloud_paged=cp, page_size=8,
                  **(LOSSLESS if mode == "lossless" else {}))
    want = reference[f"{layout}_{mode}"]
    _check(eng, eng.generate(_prompts(0), max_new_tokens=NEW), want)
    assert eng.edge_cache_bytes() == want["edge_cache_bytes"]
    assert (eng._pool is None) == (not ep and not cp)
    if not ep:         # the dense layout's footprint, by formula
        elems = 2 * eng.n_edge * 3 * 40 * TCFG.n_kv * TCFG.hd   # k and v
        int8 = mode == "int8"
        assert eng.edge_cache_bytes() == (
            elems * (1 if int8 else 4)
            + (2 * eng.n_edge * TCFG.n_kv * 4 if int8 else 0))


def test_lossless_stream_does_not_depend_on_the_layout(reference):
    outs = [reference[f"{n}_lossless"]["outs"] for n in LAYOUTS]
    assert all(o == outs[0] for o in outs)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_on_dense_lossless_matches_reference_and_serial(params,
                                                             reference, k):
    eng = _collab(params, cut_layer=1, max_batch=3, max_len=64, spec_k=k,
                  **DENSE16)
    want = reference[f"dense16_k{k}"]
    _check(eng, eng.generate(_prompts(2, (6, 9, 7)), max_new_tokens=8),
           want)
    assert want["outs"] == reference["dense16_k1"]["outs"]


def test_cloud_int8_is_ignored_on_a_dense_cloud_cache(params):
    """Reference behaviour, reproduced: with ``cloud_paged=False`` the
    cloud's cache is fp whatever ``cloud_int8`` says."""
    outs, caches = [], []
    for c8 in (True, False):
        eng = _collab(params, cut_layer=1, max_batch=3, max_len=40,
                      cloud_paged=False, cloud_int8=c8)
        outs.append(eng.generate(_prompts(6), max_new_tokens=NEW))
        caches.append(eng._cloud_cache)
    assert outs[0] == outs[1]
    for c in caches:
        assert set(c) == {"k", "v"} and c["k"].dtype == torch.float32


def test_dense_edge_int8_scales_stay_fixed(params):
    """Reference behaviour, reproduced: nothing calibrates the dense
    INT8 edge cache's scales (0.05 each), while its lattice is written."""
    eng = _collab(params, cut_layer=1, max_batch=3, max_len=40,
                  edge_paged=False)
    eng.generate(_prompts(7), max_new_tokens=NEW)
    c = eng._edge_cache
    assert c["k"].dtype == torch.int8 and bool((c["k"] != 0).any())
    for k in ("k_scale", "v_scale"):
        assert tuple(c[k].shape) == (eng.n_edge, TCFG.n_kv)
        assert bool((c[k] == 0.05).all())


def test_out_of_range_idle_slot_writes_are_dropped(params, reference,
                                                   monkeypatch):
    """``max_len`` 24 with ``spec_k=4``: idle slots' verify blocks start
    at a stale position near the end and run past the dense caches'
    end; those writes are dropped (no error), and the streams and
    counters are the reference's."""
    from repro_torch.models import layers as TL
    past = []
    write = TL._write_dense

    def spy(cache, kh, vh, cache_index, *a):
        if torch.is_tensor(cache_index) and cache_index.ndim == 1:
            past.append(int((cache_index + kh.shape[1]).max())
                        > cache["k"].shape[1])
        return write(cache, kh, vh, cache_index, *a)

    monkeypatch.setattr(TL, "_write_dense", spy)
    eng = _collab(params, cut_layer=0, max_batch=3, max_len=24, spec_k=4,
                  **DENSE16)
    outs = eng.generate(_prompts(5, PAST_END_LENS), max_new_tokens=7)
    assert any(past)
    _check(eng, outs, reference["past_end"])


def test_collab_default_quantized_edge_tracks_fp_dense_edge(params):
    prompts = _prompts(9, (6, 6, 6))
    fp = _collab(params, cut_layer=1, max_batch=3, max_len=32,
                 edge_paged=False, edge_int8=False, cloud_paged=False,
                 cloud_int8=False)
    q8 = _collab(params, cut_layer=1, max_batch=3, max_len=32)
    assert q8._edge_cache["k_pages"].dtype == torch.int8
    ref = fp.generate(prompts, max_new_tokens=6)
    got = q8.generate(prompts, max_new_tokens=6)
    agree = sum(a == b for r, g in zip(ref, got) for a, b in zip(r, g))
    assert agree / sum(len(r) for r in ref) >= 0.6, (ref, got)


def test_dense_layouts_refused_where_the_reference_is_paged_only(params):
    for kw in (dict(edge_paged=False), dict(cloud_paged=False)):
        with pytest.raises(ValueError, match="paged KV layouts"):
            ResilientCollaborativeEngine(params, TCFG, cut_layer=0,
                                         device="cpu", **kw)
