"""Port parity: speculative draft/verify rounds of
``repro_torch.serve`` against ``repro.serve`` (mirrors
``tests/test_spec_decode.py``), on the JAX suite's ``spec-tiny`` LM with
weights from the JAX ``init_lm`` bridged by value.

* fp pages on both sides (the INT8 boundary lattice and the INT8 draft
  copy still run): streams for every k equal the non-speculative stream
  and the JAX engine's exactly, and so do the per-run accepted counts
  (``spec_rounds``, ``draft_hits``) and every wire byte.
* Lossless configuration (``a_bits=None``): streams for k in {2, 4}
  equal the non-speculative ones and the JAX engine's.
* ``spec_k=1`` builds no draft machinery and is the serial engine.
* INT8 default configuration (INT8 pages on both sides, INT8 draft
  cache): for every k the streams equal the JAX engine's token for
  token, and so do the accepted counts and every wire byte, so the
  verify's INT8 page writes at S = k and the draft cache are held to the
  reference, not only to the port's own serial stream.  Were a stream
  to diverge at an INT8 near-tie, the ROADMAP's rule would compare it
  teacher-forced instead; at this size none does.
* ``spec_k="auto"`` picks the reference's k.
* The draft-cache rebuild reproduces the incrementally drafted K/V.

The JAX engines run in one subprocess with XLA:CPU's asynchronous
dispatch off (ROADMAP C, first fault), as ``test_torch_serve.py`` does."""
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
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.models.transformer import LMConfig  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.transport import (_MSG_BYTES, _QP_BYTES,  # noqa: E402
                                         _TOK_BYTES)

CFG_KW = dict(name="spec-tiny", n_layers=3, d_model=32, n_heads=4, n_kv=2,
              d_ff=64, vocab=64)
TCFG = LMConfig(**CFG_KW)
PAGE = 8
FP_PAGED = dict(edge_int8=False, cloud_int8=False)
LOSSLESS = dict(a_bits=None, edge_int8=False, cloud_int8=False)
PLENS = (7, 8, 9, 15, 16)


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TCFG.vocab, n).astype(np.int32) for n in lens]


_REFERENCE = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
import numpy as np
from repro.core.costmodel import Channel
from repro.models.transformer import LMConfig, init_lm
from repro.serve import engine as JE
CFG = LMConfig(max_seq=64, remat=False, **CFG_KW)
p = init_lm(jax.random.PRNGKey(0), CFG)
def prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32) for n in lens]
def caches(eng):   # final cache contents, the dump page 0 left out
    named = dict(edge=eng._edge_cache, cloud=eng._cloud_cache,
                 draft=getattr(eng, "_draft_cache", None))
    return {f"{n}.{key}": (np.asarray(v)[:, 1:] if key.endswith("pages")
                           else np.asarray(v)).tolist()
            for n, c in named.items() if c is not None
            for key, v in c.items()}
def run(k, kw, lens, seed, n, max_batch=2, channel=None):
    eng = JE.CollaborativeServingEngine(
        p, CFG, cut_layer=1, max_batch=max_batch, max_len=64,
        page_size=PAGE, spec_k=k, channel=channel, **kw)
    outs = eng.generate(prompts(lens, seed), max_new_tokens=n)
    st = eng.stats
    return dict(outs=outs, caches=caches(eng) if not kw else None, spec_k=eng.spec_k, spec_rounds=st.spec_rounds,
                draft_hits=st.draft_hits, drafted_tokens=st.drafted_tokens,
                decode_steps=st.decode_steps,
                transmitted_bytes=st.transmitted_bytes,
                decode_bytes_log=st.decode_bytes_log,
                decode_downlink_bytes=st.decode_downlink_bytes,
                channel_latency_s=st.channel_latency_s)
ch = Channel.from_kbps(100, rtt_ms=50)
ref = {}
for k in (1, 2, 4, 8):
    ref[f"fp{k}"] = run(k, FP_PAGED, PLENS, 1, 6, channel=ch)
for k in (2, 4):
    ref[f"lossless{k}"] = run(k, LOSSLESS, (6, 9, 7), 2, 8, max_batch=3)
for k in (1, 2, 4, 8):
    ref[f"int8_{k}"] = run(k, {}, PLENS, 4, 12, channel=ch)
ref["auto_slow"] = JE.CollaborativeServingEngine(
    p, CFG, cut_layer=1, max_batch=2, max_len=64, page_size=PAGE,
    spec_k="auto", channel=ch).spec_k
ref["auto_fast"] = JE.CollaborativeServingEngine(
    p, CFG, cut_layer=1, max_batch=2, max_len=64, page_size=PAGE,
    spec_k="auto").spec_k
json.dump(ref, sys.stdout)
"""


@pytest.fixture(scope="module")
def params():
    from repro.models.transformer import LMConfig as JLMConfig
    p = JT.init_lm(jax.random.PRNGKey(0),
                   JLMConfig(max_seq=64, remat=False, **CFG_KW))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' streams and stats, from one subprocess."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = (f"CFG_KW = {CFG_KW!r}\nPAGE = {PAGE!r}\nPLENS = {PLENS!r}\n"
            f"FP_PAGED = {FP_PAGED!r}\nLOSSLESS = {LOSSLESS!r}\n"
            + _REFERENCE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def _engine(params, k, *, max_batch=2, channel=None, **kw):
    return TE.CollaborativeServingEngine(
        params, TCFG, cut_layer=1, max_batch=max_batch, max_len=64,
        page_size=PAGE, spec_k=k, channel=channel, device="cpu", **kw)


def _assert_lattice_close(got, want):
    """INT8 pages: at most one step apart, in under 0.1 % of elements (a
    one-ulp f32 difference can flip a rounding tie)."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def _slow():
    return Channel.from_kbps(100, rtt_ms=50)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_fp_pages_streams_counts_and_bytes_match_reference(params, reference,
                                                           k):
    want = reference[f"fp{k}"]
    eng = _engine(params, k, channel=_slow(), **FP_PAGED)
    got = eng.generate(_prompts(PLENS, 1), max_new_tokens=6)
    assert got == want["outs"] == reference["fp1"]["outs"]
    st = eng.stats
    for f in ("spec_rounds", "draft_hits", "drafted_tokens", "decode_steps",
              "transmitted_bytes", "decode_bytes_log",
              "decode_downlink_bytes"):
        assert getattr(st, f) == want[f], f
    assert st.channel_latency_s == pytest.approx(want["channel_latency_s"])


@pytest.mark.parametrize("k", [2, 4])
def test_lossless_streams_equal_nonspeculative_and_reference(params,
                                                             reference, k):
    prompts = _prompts((6, 9, 7), 2)
    base = _engine(params, 1, max_batch=3, **LOSSLESS).generate(
        prompts, max_new_tokens=8)
    eng = _engine(params, k, max_batch=3, **LOSSLESS)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == base == reference[f"lossless{k}"]["outs"]
    assert eng.stats.draft_hits == reference[f"lossless{k}"]["draft_hits"]


def test_k1_is_the_serial_engine(params):
    eng = _engine(params, 1)
    assert not hasattr(eng, "_draft_cache") and eng.draft_blocks is None
    assert eng._round_headroom() == 0 and eng._round_width() == 1
    default = TE.CollaborativeServingEngine(
        params, TCFG, cut_layer=1, max_batch=2, max_len=64, page_size=PAGE,
        device="cpu")
    prompts = _prompts((6, 9), 5)
    assert eng.generate(prompts, max_new_tokens=4) == \
        default.generate(prompts, max_new_tokens=4)
    assert eng.stats.spec_rounds == 0
    assert eng.stats.transmitted_bytes == default.stats.transmitted_bytes


def test_mid_round_retirement_trims_budget(params):
    """A k=8 round overshoots a 3-token budget: the slot retires with
    exactly its budget, the tokens still the serial ones."""
    prompts = _prompts((7, 9), 4)
    ref = _engine(params, 1, **FP_PAGED).generate(prompts, max_new_tokens=3)
    got = _engine(params, 8, **FP_PAGED).generate(prompts, max_new_tokens=3)
    assert got == ref and all(len(g) == 3 for g in got)


def _int8_run(params, reference, k):
    """The INT8 default engine at ``k`` against the JAX engine's run:
    every token, accepted count and wire byte equal."""
    want = reference[f"int8_{k}"]
    eng = _engine(params, k, channel=_slow())
    got = eng.generate(_prompts(PLENS, 4), max_new_tokens=12)
    assert got == want["outs"]
    st = eng.stats
    for f in ("spec_rounds", "draft_hits", "drafted_tokens", "decode_steps",
              "transmitted_bytes", "decode_bytes_log",
              "decode_downlink_bytes"):
        assert getattr(st, f) == want[f], f
    assert st.channel_latency_s == pytest.approx(want["channel_latency_s"])
    # the INT8 pages every phase wrote (prefill, draft, verify at S = k),
    # stale rejected positions included: the same lattice as the
    # reference's, up to one step at a rounding tie
    named = dict(edge=eng._edge_cache, cloud=eng._cloud_cache,
                 draft=getattr(eng, "_draft_cache", None))
    got_c = {f"{n}.{key}": v for n, c in named.items() if c is not None
             for key, v in c.items()}
    assert sorted(got_c) == sorted(want["caches"])
    for key, v in got_c.items():
        w = np.asarray(want["caches"][key])
        if key.endswith("pages"):
            _assert_lattice_close(v[:, 1:].numpy(), w)
        else:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5)
    return eng


@pytest.mark.parametrize("k", [1, 2, 8])
def test_int8_default_streams_counts_and_bytes_match_reference(params,
                                                               reference, k):
    _int8_run(params, reference, k)


def test_int8_default_tracks_serial_and_reference(params, reference):
    k = 4
    eng = _int8_run(params, reference, k)
    st = eng.stats
    assert st.spec_rounds > 0 and 0 < st.draft_hits < st.drafted_tokens
    # every round ships k framed int8 deltas + k-1 drafts per live row
    per_row = k * (TCFG.d_model + _QP_BYTES) + (k - 1) * _TOK_BYTES
    assert all((b - _MSG_BYTES) % per_row == 0 and b > _MSG_BYTES
               for b in st.decode_bytes_log)
    assert len(st.decode_bytes_log) == st.spec_rounds == st.decode_steps


def test_spec_round_wire_accounting(params):
    k, new = 4, 6
    eng = _engine(params, k, max_batch=1, channel=Channel.from_kbps(100),
                  **FP_PAGED)
    outs = eng.generate(_prompts((9,), 6), max_new_tokens=new)
    s = eng.stats
    assert len(outs[0]) == new
    rounds = s.decode_steps
    assert s.spec_rounds == rounds
    up = k * (TCFG.d_model + _QP_BYTES) + (k - 1) * _TOK_BYTES + _MSG_BYTES
    assert s.decode_bytes_log == [up] * rounds
    assert s.decode_downlink_bytes == rounds * (_TOK_BYTES + 1 + _MSG_BYTES)
    assert s.decode_tokens == new - 1
    assert s.drafted_tokens == rounds * (k - 1)
    tel = eng.transport.telemetry
    assert tel.n_rounds == rounds
    assert 0.0 <= tel.acceptance(prior=-1.0) <= 1.0


def test_auto_spec_k_matches_reference(params, reference):
    assert _engine(params, "auto", channel=_slow()).spec_k == \
        reference["auto_slow"] > 1
    assert _engine(params, "auto").spec_k == reference["auto_fast"] == 1


def test_rebuilt_draft_cache_matches_drafted_one(params):
    """Lossless pages: rebuilding every live slot's draft K/V from its
    committed prefix after two rounds reproduces what the rounds wrote at
    the committed positions (f32, prefill vs incremental summation
    order), and the stream stays the serial one."""
    class Probe(TE.CollaborativeServingEngine):
        rounds = 0
        checked = 0

        def _after_round(self, n_active, committed):
            self.rounds += 1
            if self.rounds != 2:
                return
            before = {k: v.clone() for k, v in self._draft_cache.items()}
            self._rebuild_draft_caches()
            for s, (r, c) in self._sched_active.items():
                n_pos = len(r.prompt) + c - 1
                pages = self._pool.bt[s, :-(-n_pos // PAGE)]
                for key in ("k_pages", "v_pages"):
                    a = before[key][:, pages].reshape(
                        before[key].shape[0], -1, TCFG.n_kv, TCFG.hd)
                    b = self._draft_cache[key][:, pages].reshape(a.shape)
                    torch.testing.assert_close(b[:, :n_pos], a[:, :n_pos],
                                               rtol=1e-5, atol=1e-5)
                self.checked += 1

    prompts = _prompts((7, 12), 8)
    eng = Probe(params, TCFG, cut_layer=1, max_batch=2, max_len=64,
                page_size=PAGE, spec_k=2, device="cpu", **LOSSLESS)
    got = eng.generate(prompts, max_new_tokens=8)
    assert eng.checked == 2 and eng.stats.draft_rebuilds == 1
    assert got == _engine(params, 1, **LOSSLESS).generate(prompts,
                                                          max_new_tokens=8)


def test_spec_k_rejects_bad_values(params):
    for bad in (0, -1, "fast", 2.0):
        with pytest.raises(ValueError, match="spec_k"):
            _engine(params, bad)


def test_cli_runs_speculative_on_cpu(capsys):
    TLS.main(["--arch", "deepseek-7b", "--smoke", "--collaborative",
              "--cut", "0", "--spec-k", "4", "--device", "cpu",
              "--requests", "5", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "speculative rounds: spec_k=4" in out
    assert "first output:" in out
