"""Shared by ``tests/test_torch_chaos.py`` and ``test_torch_resilience.py``:
the JAX chaos suite's ``chaos-tiny`` LM and the runs both files hold the
port's resilient engine to the JAX one with.

``RUNNER`` is one source both packages execute (in this process for the
port, in a subprocess for JAX, whose engines run with asynchronous
dispatch off, ROADMAP C): engines are built once per configuration and
reset between runs, as the JAX suite reuses its module-scoped engines,
and every run returns its streams, every ``ServeStats`` field after each
wave, the degradation and resync phase calls, the ``round_log``, the
simulated clock and the transport's sequence number and loss rate."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

CFG_KW = dict(name="chaos-tiny", n_layers=3, d_model=32, n_heads=4, n_kv=2,
              d_ff=64, vocab=64)
PAGE = 8
LOSSLESS = dict(a_bits=None, edge_int8=False, cloud_int8=False,
                page_size=PAGE, max_batch=2, max_len=64)
INT8 = dict(page_size=PAGE, max_batch=2, max_len=64)
BASE = dict(kbps=500, rtt_ms=10)
# name: (resilient, spec_k, configuration)
ENGINES = {"oracle": (False, 1, "lossless"), "r1": (True, 1, "lossless"),
           "r2": (True, 2, "lossless"), "r4": (True, 4, "lossless"),
           "i1": (True, 1, "int8"), "i2": (True, 2, "int8")}
# name: engine, FaultyChannel kwargs (None: the plain base channel),
# transport ("tight": one retry at a 0.1 s fallback deadline), waves of
# (prompt lengths, prompt seed, max_new), and options
RUNS = {
    # tests/test_chaos_serve.py l.307-394
    "outage_serial": dict(engine="r1", faults=dict(
        seed=3, outages=[(0.05, 0.6)]), waves=[((9, 7, 11), 2, 12)]),
    "outage_admission": dict(engine="r2", tight=True, faults=dict(
        seed=5, outages=[(0.0, 1.2)]), waves=[((9, 9, 9, 9), 0, 12)]),
    "heavy_drops": dict(engine="r4", faults=dict(seed=11, drop_p=0.15),
                        waves=[((9, 7), 4, 10)]),
    "post_recovery": dict(engine="r2", tight=True, faults=dict(
        seed=5, outages=[(0.0, 0.5)]),
        waves=[((9, 9), 6, 12), ((7, 7), 7, 6)]),
    "int8_corrupt": dict(engine="i2", tight=True, faults=dict(
        seed=9, corrupt_p=0.3, outages=[(0.05, 0.35)]),
        waves=[((9, 7, 8), 8, 16)]),
    "naive": dict(engine="oracle", plain=True, faults=dict(
        seed=0, outages=[(0.05, 1.5)], rto_s=0.2), waves=[((9, 7), 2, 8)]),
    # tests/test_overload_serve.py::test_preemption_under_outage_resilient
    "preempt_outage": dict(engine="r2", faults=dict(
        seed=0, outages=[(0.05, 0.2)]), demand=True,
        pressure=[(0.02, 0.3, 0)], waves=[((6, 7, 9), 3, 10)]),
    # sampled serving through an outage (the edge-only sampled twins)
    "sampled_outage": dict(engine="r1", sampled=True, faults=dict(
        seed=3, outages=[(0.05, 0.6)]), waves=[((9, 7, 11), 2, 12)]),
    "sampled_admission": dict(engine="r1", sampled=True, tight=True,
                              faults=dict(seed=5, outages=[(0.0, 0.5)]),
                              waves=[((9, 9, 9), 0, 10)]),
    # an outage that outlasts the traffic: every request finishes on the
    # edge, and each retired slot drops its replay buffer
    "never_back": dict(engine="r1", faults=dict(
        seed=3, outages=[(0.05, 100.0)]), waves=[((9, 7, 11), 2, 12)]),
    # the INT8 default at k = 1 through two outages and drops
    "int8_serial": dict(engine="i1", faults=dict(
        seed=4, drop_p=0.05, outages=[(0.06, 0.4), (0.7, 1.2)]),
        waves=[((9, 7, 11), 5, 20)]),
}
# the fault-free streams the lossless runs must equal, on the oracle
ORACLES = {name: dict(engine="oracle", faults=None, waves=spec["waves"],
                      sampled=spec.get("sampled", False))
           for name, spec in RUNS.items()
           if ENGINES[spec["engine"]][2] == "lossless"}

RUNNER = '''
import dataclasses

def prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, n).astype(np.int32) for n in lens]

def base():
    return Channel.from_kbps(BASE["kbps"], rtt_ms=BASE["rtt_ms"])

def engine(cache, name):
    if name not in cache:
        resilient, k, conf = ENGINES[name]
        kw = dict(LOSSLESS if conf == "lossless" else INT8, **DEV_KW)
        cls = ResilientCollaborativeEngine if resilient \\
            else CollaborativeServingEngine
        eng = cls(PARAMS, CFG, cut_layer=1, spec_k=k, channel=base(), **kw)
        install_counters(eng)
        cache[name] = eng
    return cache[name]

def run_spec(cache, spec):
    eng = engine(cache, spec["engine"])
    fch = base() if spec["faults"] is None else FaultyChannel(
        base(), **spec["faults"])
    if spec.get("plain") or spec["faults"] is None:
        tr = Transport(fch)
    elif spec.get("tight"):
        tr = ReliableTransport(fch, max_retries=1, fallback_deadline_s=0.1)
    else:
        tr = ReliableTransport(fch)
    eng.transport = tr
    eng.stats = ServeStats()
    eng.demand_paged = spec.get("demand", False)
    eng.pressure = (PressureSchedule(spec["pressure"])
                    if spec.get("pressure") else None)
    if hasattr(eng, "round_log"):
        eng.round_log.clear()
        eng.cloud_down, eng._down_since, eng._rounds_down = False, None, 0
        eng._replay, eng._live_slots = {}, set()
    reset_counts(eng)
    waves = []
    for lens, seed, max_new in spec["waves"]:
        samp = ([SamplingParams(temperature=0.8, top_p=0.9, seed=10 + i)
                 for i in range(len(lens))] if spec.get("sampled") else None)
        outs = eng.generate(prompts(lens, seed), max_new_tokens=max_new,
                            sampling=samp)
        waves.append(dict(
            outs=[[int(t) for t in o] for o in outs],
            stats=dataclasses.asdict(eng.stats), calls=phase_counts(eng),
            cloud_down=bool(getattr(eng, "cloud_down", False))))
    if eng.pressure is not None:
        eng.pressure.apply(eng._pool.allocator, float("inf"))
    a = eng._pool.allocator
    out = dict(waves=waves, clock_s=getattr(fch, "clock_s", None),
               pages_back=(a.num_free == a.num_pages - 1 and not a.live),
               seq=getattr(tr, "seq", None),
               loss_rate=tr.telemetry.loss_rate,
               round_log=list(getattr(eng, "round_log", [])),
               faults=dict(getattr(fch, "faults", {})),
               attempts=getattr(fch, "attempts", None),
               replay_slots=sorted(int(s) for s in getattr(eng, "_replay",
                                                           {})))
    eng.demand_paged, eng.pressure = False, None
    return out

def run(cache, name):
    return run_spec(cache, RUNS[name])

def oracle(cache, name):
    return run_spec(cache, ORACLES[name])

def start_examples(cache):
    """The JAX suite's Hypothesis property runs its examples one after
    another on one reused engine (``run_example``), with a tight
    transport whose rng, telemetry and seq carry over."""
    eng = engine(cache, "r2")
    eng.transport = ReliableTransport(FaultyChannel(base(), seed=0),
                                      max_retries=1, fallback_deadline_s=0.1)

def run_example(cache, example):
    """One example: a fresh fault schedule, stats and outage state."""
    drop_p, out_start, out_len, plens, seed = example
    eng = engine(cache, "r2")
    eng.channel = FaultyChannel(base(), seed=seed, drop_p=drop_p,
                                outages=[(out_start, out_start + out_len)])
    eng.stats = ServeStats()
    eng.round_log.clear()
    eng.cloud_down, eng._down_since = False, None
    eng._rounds_down, eng._replay = 0, {}
    reset_counts(eng)
    outs = eng.generate(prompts(plens, seed % 97), max_new_tokens=8)
    return dict(outs=[[int(t) for t in o] for o in outs],
                stats=dataclasses.asdict(eng.stats), calls=phase_counts(eng),
                clock_s=eng.channel.clock_s, round_log=list(eng.round_log),
                seq=eng.transport.seq)

def example_oracle(cache, example):
    plens, seed = example[3], example[4]
    return run_spec(cache, dict(engine="oracle", faults=None,
                                waves=[(plens, seed % 97, 8)]))
'''

_REFERENCE = '''
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_threefry_partitionable", True)
import numpy as np
from repro.core.costmodel import Channel
from repro.models.transformer import LMConfig, init_lm
from repro.serve import (CollaborativeServingEngine, FaultyChannel,
                         PressureSchedule, ReliableTransport,
                         ResilientCollaborativeEngine, SamplingParams,
                         ServeStats, Transport)
CFG = LMConfig(max_seq=64, remat=False, **CFG_KW)
PARAMS = init_lm(jax.random.PRNGKey(0), CFG)
DEV_KW = {}

def install_counters(eng):
    eng._calls = {"edge_only": 0, "resync": 0}
    def counted(fn, key):
        def call(*a, **k):
            eng._calls[key] += 1
            return fn(*a, **k)
        return call
    if hasattr(eng, "_edge_only_step"):
        eng._edge_only_step = counted(eng._edge_only_step, "edge_only")
        eng._resync_replay = counted(eng._resync_replay, "resync")
        eng._resync_prefill = counted(eng._resync_prefill, "resync")
        samp_jit = eng._samp_jit
        def samp(name, impl, **kw):
            fn = samp_jit(name, impl, **kw)
            return counted(fn, "edge_only") if name == "edge_only_step" \\
                else fn
        eng._samp_jit = samp

def reset_counts(eng):
    eng._calls = {"edge_only": 0, "resync": 0}

def phase_counts(eng):
    return dict(eng._calls)

exec(RUNNER)
cache = {}
job = json.loads(JOB)
out = {}
for name in job.get("runs", []):
    out[name] = run(cache, name)
for name in job.get("oracles", []):
    out["oracle:" + name] = oracle(cache, name)
if "examples" in job:
    start_examples(cache)
    out["examples"] = [run_example(cache, ex) for ex in job["examples"]]
    out["example_oracles"] = [example_oracle(cache, ex)
                              for ex in job["examples"]]
json.dump(out, sys.stdout)
'''


def reference(job: dict) -> dict:
    """Run ``job`` (``runs``, ``oracles``, ``examples``) on the JAX engines
    in one subprocess; returns their results, JSON-decoded."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    consts = dict(CFG_KW=CFG_KW, LOSSLESS=LOSSLESS, INT8=INT8, BASE=BASE,
                  ENGINES=ENGINES, RUNS=RUNS, ORACLES=ORACLES, RUNNER=RUNNER,
                  JOB=json.dumps(job))
    code = "".join(f"{k} = {v!r}\n" for k, v in consts.items()) + _REFERENCE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def port_runner(params) -> dict:
    """``RUNNER``'s functions bound to the port's engines on the CPU."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.models.transformer import LMConfig
    from repro_torch.serve import (CollaborativeServingEngine, FaultyChannel,
                                   PressureSchedule, ReliableTransport,
                                   ResilientCollaborativeEngine,
                                   SamplingParams, ServeStats, Transport)

    def reset_counts(eng):
        eng.phase_calls = {"edge_only": 0, "resync": 0}

    ns = dict(np=np, Channel=Channel, FaultyChannel=FaultyChannel,
              PressureSchedule=PressureSchedule,
              ReliableTransport=ReliableTransport,
              ResilientCollaborativeEngine=ResilientCollaborativeEngine,
              CollaborativeServingEngine=CollaborativeServingEngine,
              SamplingParams=SamplingParams, ServeStats=ServeStats,
              Transport=Transport, CFG=LMConfig(**CFG_KW), PARAMS=params,
              DEV_KW={"device": "cpu"}, ENGINES=ENGINES, RUNS=RUNS,
              ORACLES=ORACLES, LOSSLESS=LOSSLESS, INT8=INT8, BASE=BASE,
              install_counters=lambda eng: None, reset_counts=reset_counts,
              phase_counts=lambda eng: dict(eng.phase_calls))
    exec(RUNNER, ns)
    return ns


def jsonable(x):
    """``x`` as it comes back from the reference's JSON (tuples become
    lists), so the two sides compare with ``==``."""
    return json.loads(json.dumps(x))


def bridged_params():
    """The JAX ``init_lm`` weights of ``chaos-tiny`` (seed 0), bridged to
    torch on the CPU by value."""
    import jax

    from repro.models import transformer as JT
    from repro_torch.bridge import params_from_numpy
    p = JT.init_lm(jax.random.PRNGKey(0),
                   JT.LMConfig(max_seq=64, remat=False, **CFG_KW))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
