"""Shared by the MoE serving parity tests (``tests/test_torch_moe_serve.py``,
``test_torch_moe_spec.py``, ``test_torch_moe_grok.py``): the runs the
port's engines are held to the JAX engines with, on the mixture-of-
experts ``SMOKE`` configs with the JAX ``init_lm`` weights (key 0)
bridged by value.

A run is ``(key, arch, engine, cut, spec_k, conf, prompt seed,
max_new)``: ``engine`` is ``"collab"`` (the collaborative engine at
``cut`` over the channel below), ``"cloud_dense"`` or ``"cloud_paged"``
(the cloud-only engine); ``conf`` names the options in ``CONFS``.
``reference(runs)`` runs them on the JAX engines in one subprocess with
XLA:CPU's asynchronous dispatch off (ROADMAP C) and returns each run's
streams and ``ServeStats`` counters; ``port_engine`` builds the port's
twin of a run's engine."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ARCHS = ("qwen3-moe-30b-a3b", "grok-1-314b")
# page_size 16: 15/16/17 and 31/33 sit on either side of a page boundary
PLENS = (15, 17, 16, 31, 33, 9)
CONFS = {"lossless": dict(a_bits=None, edge_int8=False, cloud_int8=False),
         "fp_pages": dict(edge_int8=False, cloud_int8=False),
         "int8": {}}
KBPS, RTT_MS = 100.0, 5.0
MAX_LEN = 48
# the largest logit gap, in the port's own logits, by which the port's
# greedy token may beat the reference's at a teacher-forced INT8 step
NEAR_TIE = 0.05
STATS = ("prefill_calls", "decode_steps", "transmitted_bytes",
         "prefill_bytes", "decode_bytes_log", "spec_rounds", "draft_hits",
         "drafted_tokens")


def prompts(vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in PLENS]


_RUNNER = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
import numpy as np
from repro.configs import get_arch
from repro.core.costmodel import Channel
from repro.models import transformer as JT
from repro.serve import engine as JE
def prompts(vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in PLENS]
params, ref = {}, {}
for key, arch, engine, cut, k, conf, seed, n in RUNS:
    cfg = get_arch(arch).smoke
    if arch not in params:
        params[arch] = JT.init_lm(jax.random.PRNGKey(0), cfg)
    p = params[arch]
    if engine == "collab":
        eng = JE.CollaborativeServingEngine(
            p, cfg, cut_layer=cut, max_len=MAX_LEN, spec_k=k,
            channel=Channel.from_kbps(KBPS, rtt_ms=RTT_MS), **CONFS[conf])
    else:
        eng = JE.ServingEngine(p, cfg, max_len=MAX_LEN,
                               paged=engine == "cloud_paged")
    outs = eng.generate(prompts(cfg.vocab, seed), max_new_tokens=n)
    st = eng.stats
    ref[key] = dict(outs=outs, channel_latency_s=st.channel_latency_s,
                    **{s: getattr(st, s) for s in STATS})
json.dump(ref, sys.stdout)
"""


def reference(runs):
    """The JAX engines' streams and stats for ``runs``, keyed by run."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    consts = dict(RUNS=list(runs), PLENS=PLENS, CONFS=CONFS, KBPS=KBPS,
                  RTT_MS=RTT_MS, MAX_LEN=MAX_LEN, STATS=STATS)
    code = "".join(f"{k} = {v!r}\n" for k, v in consts.items()) + _RUNNER
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def port_engine(tp, tcfg, run, **kw):
    """The port's engine of ``run`` on the bridged params ``tp``."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve import engine as TE
    _, _, engine, cut, k, conf, _, _ = run
    if engine == "collab":
        return TE.CollaborativeServingEngine(
            tp, tcfg, cut_layer=cut, max_len=MAX_LEN, spec_k=k,
            channel=Channel.from_kbps(KBPS, rtt_ms=RTT_MS), device="cpu",
            **CONFS[conf], **kw)
    return TE.ServingEngine(tp, tcfg, max_len=MAX_LEN,
                            paged=engine == "cloud_paged", device="cpu")


def generate(eng, tcfg, run):
    return eng.generate(prompts(tcfg.vocab, run[6]), max_new_tokens=run[7])


def assert_stats(st, want, keys=STATS):
    for k in keys:
        assert getattr(st, k) == want[k], k
    assert st.channel_latency_s == pytest.approx(want["channel_latency_s"])


class Forced:
    """While active, the engine's serial cloud decode commits the
    reference's token at each live slot's output index, and records for
    each (request, index) the port's own greedy token and its logit
    margin over the reference's token in the port's logits."""

    def __init__(self, eng, want):
        self.eng, self.want, self.at = eng, want, {}

    def __enter__(self):
        eng = self.eng

        def cloud_decode(blocks, tail, blob, qp, cache, pos, bt):
            logits = eng._cloud_decode_logits(blocks, tail, blob, qp, cache,
                                              pos, bt).float()
            nxt = torch.argmax(logits, -1).to(torch.int32)
            for slot, (r, c) in eng._sched_active.items():
                ref = self.want[r.uid][c]
                self.at[r.uid, c] = (int(nxt[slot]), float(
                    logits[slot, nxt[slot]] - logits[slot, ref]))
                nxt[slot] = ref
            return nxt, torch.clamp(pos + 1, max=eng.max_len - 1)

        eng._cloud_decode = cloud_decode
        return self

    def __exit__(self, *exc):
        del self.eng._cloud_decode


def check_int8_run(tp, tcfg, run, want):
    """The INT8 default's rule: every counter and wire byte exact, every
    first token equal, and the stream teacher-forced — each step's port
    choice the reference's token or within ``NEAR_TIE`` of it."""
    free = port_engine(tp, tcfg, run)
    got = generate(free, tcfg, run)
    assert_stats(free.stats, want)
    assert [g[0] for g in got] == [w[0] for w in want["outs"]]
    forced = port_engine(tp, tcfg, run)
    with Forced(forced, want["outs"]) as f:
        assert generate(forced, tcfg, run) == want["outs"]
    assert_stats(forced.stats, want)
    assert len(f.at) == sum(len(o) - 1 for o in want["outs"])
    for (u, c), (tok, margin) in f.at.items():
        assert tok == want["outs"][u][c] or 0.0 <= margin <= NEAR_TIE, \
            (u, c, tok, margin)
    return got, f.at
