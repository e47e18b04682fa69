"""Port parity: sampled serving (``repro_torch.serve.sampling`` and the
``*_sample`` phases) against ``repro.serve`` (mirrors
``tests/test_sampled_spec.py``), on the JAX suite's ``sampled-tiny`` LM
(3 layers, d 32, vocab 64, page 8) with weights from the JAX
``init_lm`` bridged by value.

The port implements JAX's **partitionable** threefry layout, so every
JAX run here sets ``jax_threefry_partitionable=True`` explicitly: the
comparison then holds on any jax version, whatever its default.

Tolerances:

* key words, random bits, uniforms, drawn tokens, ``n_commit``, wire
  bytes and round counts: exact;
* Gumbel noise: 2e-6 absolute (``log`` differs by an ulp or two between
  XLA and torch); the draws built on it are compared exactly;
* ``filtered_probs``: 1e-6 absolute.  softmax, sort and cumsum add up
  in another order than XLA, so a token whose exclusive cumulative mass
  lies within rounding of ``top_p`` can fall on either side; such a
  token's own mass is below the tolerance here;
* lossless streams (``a_bits=None``, fp caches) at k 1, 2 and 4, and at
  tp 2 on a CPU mesh: identical to the JAX engine's.  Under INT8 the
  first token (output index 0, the ``CLOUD`` key at prefill), the wire
  bytes and the round counts are compared.

The JAX engines run in one subprocess with XLA:CPU's asynchronous
dispatch off (ROADMAP C), as ``test_torch_spec.py`` does."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.serve import sampling as JS  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models.transformer import LMConfig  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import sampling as S  # noqa: E402
from repro_torch.serve.transport import (_MSG_BYTES, _QP_BYTES,  # noqa: E402
                                         _TOK_BYTES)

CFG_KW = dict(name="sampled-tiny", n_layers=3, d_model=32, n_heads=4,
              n_kv=2, d_ff=64, vocab=64)
TCFG = LMConfig(**CFG_KW)
PAGE = 8
LOSSLESS = dict(a_bits=None, edge_int8=False, cloud_int8=False)
SP = S.SamplingParams(temperature=0.8, top_p=0.9, seed=11)
SP_KW = dict(temperature=0.8, top_p=0.9, seed=11)
# at temperature 0.05 the INT8 draft's q and the cloud's p differ enough
# at this size for the verify to reject drafts (at 0.8 it accepts all)
COLD = 0.05
LENS, PSEED, NEW = (6, 9, 7, 8), 3, 10
MIXED_LENS, MIXED_SEED = (7, 9, 8, 6), 6
GUMBEL_ATOL = 2e-6
PROBS_ATOL = 1e-6


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TCFG.vocab, n).astype(np.int32) for n in lens]


_REFERENCE = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_threefry_partitionable", True)
import numpy as np
from repro.models.transformer import LMConfig, init_lm
from repro.serve import engine as JE
CFG = LMConfig(max_seq=64, remat=False, **CFG_KW)
p = init_lm(jax.random.PRNGKey(0), CFG)
SPJ = JE.SamplingParams(**SP_KW)
def prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32) for n in lens]
def run(k, kw, lens, seed, n, sampling):
    eng = JE.CollaborativeServingEngine(
        p, CFG, cut_layer=1, max_batch=4, max_len=64, page_size=PAGE,
        spec_k=k, **kw)
    outs = eng.generate(prompts(lens, seed), max_new_tokens=n,
                        sampling=sampling)
    st = eng.stats
    return dict(outs=outs, spec_rounds=st.spec_rounds,
                draft_hits=st.draft_hits, drafted_tokens=st.drafted_tokens,
                decode_steps=st.decode_steps,
                transmitted_bytes=st.transmitted_bytes,
                decode_bytes_log=st.decode_bytes_log)
ref = {}
for k in (1, 2, 4):
    ref[f"lossless{k}"] = run(k, LOSSLESS, LENS, PSEED, NEW, SPJ)
    ref[f"int8_{k}"] = run(k, {}, LENS, PSEED, NEW, SPJ)
    ref[f"int8_cold{k}"] = run(k, {}, LENS, PSEED, NEW, JE.SamplingParams(
        **dict(SP_KW, temperature=COLD)))
ref["mixed"] = run(4, LOSSLESS, MIXED_LENS, MIXED_SEED, 6,
                   [None, SPJ, JE.SamplingParams(temperature=0.0), SPJ])
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
    """The JAX engines' sampled streams and stats, from one subprocess."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = "".join(f"{n} = {v!r}\n" for n, v in (
        ("CFG_KW", CFG_KW), ("PAGE", PAGE), ("LOSSLESS", LOSSLESS),
        ("SP_KW", SP_KW), ("COLD", COLD), ("LENS", LENS), ("PSEED", PSEED),
        ("NEW", NEW), ("MIXED_LENS", MIXED_LENS),
        ("MIXED_SEED", MIXED_SEED))) + _REFERENCE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


@pytest.fixture
def partitionable():
    """In-process JAX draws in the partitionable threefry layout, the
    flag restored afterwards."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _engine(params, k, *, max_batch=4, **kw):
    cfg = dict(LOSSLESS)
    cfg.update(kw)
    return TE.CollaborativeServingEngine(
        params, TCFG, cut_layer=1, max_batch=max_batch, max_len=64,
        page_size=PAGE, spec_k=k, device="cpu", **cfg)


def _tv(counts_a, counts_b):
    pa = counts_a / counts_a.sum()
    pb = counts_b / counts_b.sum()
    return 0.5 * float(np.abs(pa - pb).sum())


# ---------------------------------------------------------------------------
# threefry keys, bits, uniforms and the draws, against JAX
# ---------------------------------------------------------------------------


SEEDS = np.asarray([0, 1, 2 ** 31 - 1, 7, 12345, 2 ** 30 + 3], np.int64)


def _triples():
    seeds = np.repeat(SEEDS, 64)
    idx = np.tile(np.arange(64), len(SEEDS))
    return seeds, idx


@pytest.mark.parametrize("stream", [S.DRAFT, S.ACCEPT, S.RESID, S.CLOUD])
def test_keys_bits_and_uniforms_equal_jax(partitionable, stream):
    """``token_keys`` (PRNGKey, two fold_ins), the 32-bit random bits of
    a 64-wide draw and ``uniform_rows``, bit for bit."""
    seeds, idx = _triples()
    jk = np.asarray(JS.token_keys(jnp.asarray(seeds, jnp.int32),
                                  jnp.asarray(idx, jnp.int32), stream))
    tk = S.token_keys(torch.tensor(seeds), torch.tensor(idx), stream)
    np.testing.assert_array_equal(tk.numpy(), jk.astype(np.int64))
    ju = np.asarray(JS.uniform_rows(jnp.asarray(jk)))
    tu = S.uniform_rows(tk).numpy()
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))
    assert ((tu >= 0) & (tu < 1)).all()
    jb = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (64,)))(
        jnp.asarray(jk)))
    np.testing.assert_array_equal(S._random_bits(tk, 64).numpy(),
                                  jb.astype(np.int64))


def test_gumbel_noise_matches_jax(partitionable):
    seeds, idx = _triples()
    jk = np.asarray(JS.token_keys(jnp.asarray(seeds, jnp.int32),
                                  jnp.asarray(idx, jnp.int32), S.CLOUD))
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (100,)))(
        jnp.asarray(jk)))
    tg = S._gumbel(torch.tensor(jk.astype(np.int64)), 100).numpy()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=GUMBEL_ATOL)


def _logits_case(case):
    rng = np.random.RandomState(4)
    n, V = 32, 64
    logits = (rng.randn(n, V) * 2).astype(np.float32)
    temps = np.full(n, 0.8, np.float32)
    top_ps = np.full(n, 0.9, np.float32)
    if case == "top_p_one":
        top_ps[:] = 1.0
    elif case == "greedy_rows":
        temps[::3] = 0.0
    elif case == "ties_at_threshold":
        # five tokens tie at the threshold: their exclusive cumulative
        # masses straddle top_p, and every tied token is kept
        logits[:, :] = -4.0
        logits[:, 0] = 2.0
        logits[:, 1:6] = 1.0
        temps[:] = 1.0
        p = np.exp(logits[0] - logits[0].max())
        p /= p.sum()
        sp = np.sort(p)[::-1]
        top_ps[:] = (np.cumsum(sp) - sp)[3]
    return logits, temps, top_ps


@pytest.mark.parametrize("case", ["nucleus", "top_p_one", "greedy_rows",
                                  "ties_at_threshold"])
def test_filtered_probs_matches_jax(case):
    logits, temps, top_ps = _logits_case(case)
    jp = np.asarray(JS.filtered_probs(jnp.asarray(logits),
                                      jnp.asarray(temps),
                                      jnp.asarray(top_ps)))
    tp = S.filtered_probs(torch.tensor(logits), torch.tensor(temps),
                          torch.tensor(top_ps)).numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_allclose(tp.sum(-1), 1.0, atol=1e-5)
    greedy = temps <= 0
    np.testing.assert_array_equal(
        tp[greedy], np.eye(logits.shape[1])[logits[greedy].argmax(-1)])
    if case == "ties_at_threshold":
        assert ((tp[:, :6] > 0).all() and (tp[:, 6:] == 0).all())


@pytest.mark.parametrize("case", ["nucleus", "greedy_rows"])
def test_sample_rows_matches_jax(partitionable, case):
    """The same probability rows and keys draw the same tokens."""
    logits, temps, top_ps = _logits_case(case)
    p = np.asarray(JS.filtered_probs(jnp.asarray(logits), jnp.asarray(temps),
                                     jnp.asarray(top_ps)))
    n = p.shape[0]
    jk = JS.token_keys(jnp.arange(n, dtype=jnp.int32) * 3,
                       jnp.arange(n, dtype=jnp.int32), S.CLOUD)
    want = np.asarray(JS.sample_rows(jnp.asarray(p), jk))
    got = S.sample_rows(torch.tensor(p),
                        torch.tensor(np.asarray(jk).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_grade_and_correct_matches_jax(partitionable):
    """Mixed sampled / greedy rows, drafts from q: committed tokens and
    counts equal JAX's exactly."""
    B, k, V = 64, 4, 16
    rng = np.random.RandomState(7)

    def probs(scale):
        x = rng.randn(B, k, V) * scale
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    p, q = probs(1.5), probs(1.5)
    seeds = rng.randint(0, 2 ** 31 - 1, B).astype(np.int32)
    offs = rng.randint(0, 40, B).astype(np.int32)
    d = np.stack([[rng.choice(V, p=q[b, i] / q[b, i].sum())
                   for i in range(k)] for b in range(B)]).astype(np.int32)
    sampled = np.arange(B) % 4 != 0
    greedy_t = p.argmax(-1).astype(np.int32)
    d[~sampled, :2] = greedy_t[~sampled, :2]     # greedy rows accept some
    jt, jn = JS.grade_and_correct(*map(jnp.asarray, (p, q, d, sampled,
                                                     greedy_t, seeds, offs)))
    tt, tn = S.grade_and_correct(*map(torch.tensor, (p, q, d, sampled,
                                                     greedy_t, seeds, offs)))
    jn, tn = np.asarray(jn), tn.numpy()
    np.testing.assert_array_equal(tn, jn)
    assert 1 in tn and k in tn
    committed = np.arange(k)[None] < jn[:, None]
    np.testing.assert_array_equal(tt.numpy()[committed],
                                  np.asarray(jt)[committed])


# ---------------------------------------------------------------------------
# the reference's distribution gates, inside the port
# ---------------------------------------------------------------------------


def test_grade_and_correct_matches_target_distribution():
    """Committed tokens are distributed per the cloud's filtered
    distribution p whatever the draft distribution q — the graded
    position (accept or residual) and the all-accepted bonus."""
    B, k, V = 4096, 2, 8
    rng = np.random.RandomState(3)
    p1 = torch.softmax(torch.tensor(rng.randn(V) * 1.5,
                                    dtype=torch.float32), -1)
    q1 = torch.softmax(torch.tensor(rng.randn(V) * 1.5,
                                    dtype=torch.float32), -1)
    p = p1[None, None].expand(B, k, V).contiguous()
    q = q1[None, None].expand(B, k, V).contiguous()
    seeds = torch.arange(B, dtype=torch.int32)
    offs = torch.zeros(B, dtype=torch.int32)
    d0 = S.sample_rows(q1[None].expand(B, V),
                       S.token_keys(seeds, offs, S.DRAFT))
    d = torch.stack([d0, torch.zeros_like(d0)], dim=1)
    args = (p, q, d, torch.ones(B, dtype=torch.bool),
            torch.zeros(B, k, dtype=torch.int32), seeds, offs)
    toks, n_commit = (t.numpy() for t in S.grade_and_correct(*args))
    target = p1.numpy()
    freq0 = np.bincount(toks[:, 0], minlength=V).astype(float)
    assert 0.5 * np.abs(freq0 / B - target).sum() < 0.05
    want_acc = float(np.minimum(target, q1.numpy()).sum())
    assert abs((n_commit - 1).mean() - want_acc) < 0.05
    bonus = toks[n_commit == 2, 1]
    freq1 = np.bincount(bonus, minlength=V).astype(float)
    assert 0.5 * np.abs(freq1 / len(bonus) - target).sum() < 0.08
    toks2, n2 = (t.numpy() for t in S.grade_and_correct(*args))
    np.testing.assert_array_equal(toks, toks2)
    np.testing.assert_array_equal(n_commit, n2)


def test_grade_and_correct_accepts_everything_when_q_equals_p():
    B, k, V = 256, 4, 8
    p1 = torch.softmax(torch.tensor(np.random.RandomState(0).randn(V),
                                    dtype=torch.float32), -1)
    p = p1[None, None].expand(B, k, V).contiguous()
    seeds = torch.arange(B, dtype=torch.int32)
    idx = torch.repeat_interleave(seeds, k)
    pos = torch.arange(k).repeat(B)
    d = S.sample_rows(p.reshape(B * k, V),
                      S.token_keys(idx, pos, S.DRAFT)).reshape(B, k)
    _, n_commit = S.grade_and_correct(
        p, p, d, torch.ones(B, dtype=torch.bool),
        torch.zeros(B, k, dtype=torch.int32), seeds,
        torch.zeros(B, dtype=torch.int32))
    assert int(n_commit.min()) == k


def test_filtered_probs_nucleus_and_greedy_rows():
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0]] * 3)
    p = S.filtered_probs(logits, torch.tensor([1.0, 1.0, 0.0]),
                         torch.tensor([1.0, 0.6, 0.5])).numpy()
    full = np.exp([0, 1, 2, 3]) / np.exp([0, 1, 2, 3]).sum()
    assert np.allclose(p[0], full, atol=1e-6)          # top_p=1: softmax
    assert p[1][3] > 0 and p[1][0] == p[1][1] == 0     # nucleus drops tail
    assert np.isclose(p[1].sum(), 1.0, atol=1e-6)      # renormalized
    assert np.array_equal(p[2], [0, 0, 0, 1])          # greedy row: onehot


def test_spec_sampling_matches_serial_distribution(params):
    """spec_k=4 rejection-sampled streams and serial (k=1) cloud-sampled
    streams of one prompt are draws of the same process: output index 0
    bit for bit, the pooled later tokens within a TV distance, and far
    from the greedy point mass (the power check)."""
    prompt = _prompts([6], seed=2)[0]

    def streams(eng, n_calls=4, batch=8):
        out = []
        for c in range(n_calls):
            samps = [S.SamplingParams(temperature=0.9, top_p=0.95,
                                      seed=c * batch + i)
                     for i in range(batch)]
            out += eng.generate([prompt] * batch, max_new_tokens=8,
                                sampling=samps)
        return out

    s4 = streams(_engine(params, 4, max_batch=8))
    s1 = streams(_engine(params, 1, max_batch=8))
    assert [s[0] for s in s4] == [s[0] for s in s1]
    pool4 = np.bincount(np.concatenate([s[1:] for s in s4]),
                        minlength=TCFG.vocab).astype(float)
    pool1 = np.bincount(np.concatenate([s[1:] for s in s1]),
                        minlength=TCFG.vocab).astype(float)
    assert _tv(pool4, pool1) < 0.30
    greedy = np.zeros(TCFG.vocab)
    greedy[np.argmax(pool1)] = pool1.sum()
    assert _tv(pool4, greedy) > 0.45


# ---------------------------------------------------------------------------
# engines against the JAX engines
# ---------------------------------------------------------------------------


_STATS = ("spec_rounds", "drafted_tokens", "draft_hits", "decode_steps",
          "transmitted_bytes", "decode_bytes_log")


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_lossless_sampled_streams_match_reference(params, reference, k, tp):
    """Lossless: every sampled token, round count, accepted draft and
    wire byte equals the JAX engine's; at tp 2 (the cloud suffix, head
    and pool split over two CPU shards) too."""
    want = reference[f"lossless{k}"]
    kw = {} if tp == 1 else dict(mesh=make_serve_mesh(model=tp,
                                                      device="cpu"))
    eng = _engine(params, k, **kw)
    got = eng.generate(_prompts(LENS, PSEED), max_new_tokens=NEW,
                       sampling=SP)
    assert got == want["outs"]
    for f in _STATS:
        assert getattr(eng.stats, f) == want[f], f
    if k > 1:
        assert eng.stats.spec_rounds > 0


@pytest.mark.parametrize("temp", [0.8, COLD])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_int8_first_token_and_wire_bytes_match_reference(params, reference,
                                                         k, temp):
    """INT8 default: output index 0 (the ``CLOUD`` draw at prefill),
    every wire byte and the accepted drafts equal the JAX engine's; at
    temperature 0.05 the rounds reject drafts, so the residual and bonus
    draws decide the rounds' lengths."""
    want = reference[f"int8_{k}" if temp == 0.8 else f"int8_cold{k}"]
    eng = _engine(params, k, a_bits=8, edge_int8=True, cloud_int8=True)
    got = eng.generate(_prompts(LENS, PSEED), max_new_tokens=NEW,
                       sampling=S.SamplingParams(**dict(SP_KW,
                                                        temperature=temp)))
    assert [o[0] for o in got] == [o[0] for o in want["outs"]]
    for f in _STATS:
        assert getattr(eng.stats, f) == want[f], f
    if k > 1 and temp == COLD:
        assert eng.stats.draft_hits < eng.stats.drafted_tokens


def test_mixed_batch_greedy_rows_stay_bitwise(params, reference):
    """Greedy requests co-batched with sampled ones ride the sampled
    phases' argmax branch: their streams equal the all-greedy run's, and
    every row equals the JAX engine's mixed run."""
    prompts = _prompts(MIXED_LENS, MIXED_SEED)
    eng = _engine(params, 4)
    ref = eng.generate(prompts, max_new_tokens=6)
    mixed = eng.generate(prompts, max_new_tokens=6,
                         sampling=[None, SP, S.SamplingParams(), SP])
    assert mixed[0] == ref[0] and mixed[2] == ref[2]
    assert mixed[1] != ref[1]
    assert mixed == reference["mixed"]["outs"]


_SAMPLED_PHASES = ("_cloud_prefill_sample_impl", "_cloud_decode_sample_impl",
                   "_spec_draft_sample_impl", "_verify_sample_impl")


@pytest.mark.parametrize("k", [1, 4])
def test_temperature0_never_calls_a_sampled_phase(params, k):
    """``sampling=None``, ``temperature=0`` and no argument commit the
    same stream, and greedy traffic never enters a sampled phase."""
    eng = _engine(params, k)

    def refuse(*a, **kw):
        raise AssertionError("greedy traffic entered a sampled phase")

    for name in _SAMPLED_PHASES:
        setattr(eng, name, refuse)
    prompts = _prompts((7, 9, 8), seed=5)
    pre = eng.generate(prompts, max_new_tokens=6)
    none = eng.generate(prompts, max_new_tokens=6, sampling=None)
    t0 = eng.generate(prompts, max_new_tokens=6,
                      sampling=S.SamplingParams(temperature=0.0, seed=99))
    assert pre == none == t0


def test_sampled_streams_deterministic_and_seed_sensitive(params):
    prompts = _prompts((6, 9), seed=4)
    got_a = _engine(params, 4).generate(prompts, max_new_tokens=8,
                                        sampling=SP)
    e_b = _engine(params, 4)
    assert e_b.generate(prompts, max_new_tokens=8, sampling=SP) == got_a
    other = e_b.generate(prompts, max_new_tokens=8,
                         sampling=S.SamplingParams(temperature=0.8,
                                                   top_p=0.9, seed=12))
    assert other != got_a


def test_engine_charges_q_rows_on_sampled_spec_rounds(params):
    """One live sampled slot: the decode uplink is exactly rounds x
    (k-row f32 blob + drafts + the k-1 graded q rows + framing)."""
    eng = _engine(params, 4, max_batch=1)
    eng.generate(_prompts([6], seed=10), max_new_tokens=9, sampling=SP)
    k, D, V = 4, TCFG.d_model, TCFG.vocab
    per_round = (k * (D * 4 + _QP_BYTES) + (k - 1) * _TOK_BYTES
                 + (k - 1) * V * 4 + _MSG_BYTES)
    assert eng.stats.spec_rounds >= 2
    assert eng.stats.decode_bytes == eng.stats.spec_rounds * per_round


def test_generate_rejects_a_sampling_list_of_another_length(params):
    with pytest.raises(ValueError, match="sampling entries"):
        _engine(params, 1).generate(_prompts((6, 7), 1), max_new_tokens=2,
                                    sampling=[SP])


def test_cloud_only_engine_refuses_sampling(params):
    eng = TE.ServingEngine(params, TCFG, max_batch=2, max_len=64,
                           paged=True, page_size=PAGE, device="cpu")
    with pytest.raises(ValueError, match="cloud-only baseline is greedy"):
        eng.generate(_prompts((6,), 1), max_new_tokens=2, sampling=SP)
    # temperature 0 is greedy, which the baseline serves
    assert len(eng.generate(_prompts((6,), 1), max_new_tokens=2,
                            sampling=S.SamplingParams())[0]) == 2


def test_cli_samples_in_collaborative_mode_on_cpu(capsys):
    TLS.main(["--arch", "deepseek-7b", "--smoke", "--collaborative",
              "--cut", "0", "--spec-k", "2", "--device", "cpu",
              "--requests", "3", "--max-new", "4", "--temperature", "0.8",
              "--top-p", "0.9", "--sample-seed", "5"])
    out = capsys.readouterr().out
    assert ("sampling: temperature=0.8 top_p=0.9 seeds 5..7 (exact cloud "
            "distribution via rejection-sampled verify)") in out
    assert "first output:" in out


def test_cli_refuses_sampling_without_collaborative():
    with pytest.raises(SystemExit, match="needs --collaborative"):
        TLS.main(["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
                  "--temperature", "0.8"])
