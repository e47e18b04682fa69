"""Shared by the fleet parity tests (``tests/test_torch_fleet_*.py``): the
JAX fleet suite's ``fleet-tiny`` LM and the runs the port's
``FleetServingEngine`` is held to the JAX one with.

``RUNNER`` is one source both packages execute (in this process for the
port, in a subprocess for JAX, whose engines run with asynchronous
dispatch off, ROADMAP C).  A run is a fleet of tenants (name, channel,
cut, k, quota, policy) and per-tenant prompts; it returns every
tenant's streams, every ``ServeStats`` field, the fleet's
``round_calls``, each channel's clock, faults and attempts, each
request's admission and finish times and preemptions, whether every
page came back, the quota peaks and each auto policy's decisions."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

CFG_KW = dict(name="fleet-tiny", n_layers=3, d_model=32, n_heads=4, n_kv=2,
              d_ff=64, vocab=64)
PAGE = 8
CONFS = {"lossless": dict(a_bits=None, edge_int8=False, cloud_int8=False,
                          page_size=PAGE, max_len=64),
         "int8": dict(page_size=PAGE, max_len=64)}
FAST = ["plain", 2000, 20]
SLOW = ["plain", 500, 60]
# the sampled traffic of tests/test_sampled_spec.py
SP = dict(temperature=0.8, top_p=0.9, seed=11)


def tenant(name, ch, cut, k, **kw):
    return dict(name=name, ch=ch, cut=cut, k=k, **kw)


# name: fleet configuration, tenants, per-tenant (prompt lengths, seed),
# max_new and options — tests/test_fleet_serve.py and
# tests/test_sampled_spec.py, test by test
RUNS = {
    "int8_isolation": dict(
        conf="int8", max_batch=4,
        tenants=[tenant("a", FAST, 0, 1), tenant("b", SLOW, 1, 4)],
        work={"a": ([7, 5, 9], 3), "b": ([7, 5, 9], 4)}, max_new=12),
    "shared_bank": dict(
        conf="int8", max_batch=4,
        tenants=[tenant("a", FAST, 1, 2), tenant("b", SLOW, 1, 2),
                 tenant("c", SLOW, 2, 1)],
        work={"a": ([6], 0), "b": ([6], 1), "c": ([6], 2)}, max_new=4),
    "quota": dict(
        conf="int8", max_batch=4, peaks=True,
        tenants=[tenant("hog", FAST, 1, 1, max_pages=2),
                 tenant("meek", SLOW, 1, 1)],
        work={"hog": ([6] * 4, 0), "meek": ([6] * 2, 1)}, max_new=8),
    "preemption": dict(
        conf="int8", max_batch=4, num_pages=9, demand_paged=True,
        tenants=[tenant("hog", FAST, 1, 1), tenant("meek", SLOW, 1, 1)],
        work={"hog": ([6] * 3, 0), "meek": ([6], 1)}, max_new=18),
    "gauges": dict(
        conf="int8", max_batch=2,
        tenants=[tenant("a", FAST, 1, 2)],
        work={"a": ([6, 6], 0)}, max_new=8),
    "chaos_outage": dict(
        conf="int8", max_batch=4,
        tenants=[tenant("storm", ["faulty", 500, 40, dict(
                     seed=7, drop_p=0.2, corrupt_p=0.1,
                     outages=[(0.05, 0.8)], rto_s=0.1)], 1, 2),
                 tenant("calm", ["faulty", 2000, 20, dict(seed=11)], 1, 2)],
        work={"storm": ([6, 6], 0), "calm": ([6, 6], 1)}, max_new=8),
    "chaos_all": dict(
        conf="int8", max_batch=8,
        tenants=[tenant(f"e{i}", ["faulty", 1000, 30, dict(
                     seed=i, drop_p=0.1 * (i % 3), stall_p=0.05 * i,
                     stall_s=0.05)], 1, 2) for i in range(4)],
        work={f"e{i}": ([6, 6], i) for i in range(4)}, max_new=8),
    "sampled_cobatch": dict(
        conf="lossless", max_batch=4,
        tenants=[tenant("a", None, 1, 4), tenant("b", None, 1, 4)],
        work={"a": ([6, 9], 8), "b": ([7], 9)}, max_new=8,
        sampling={"a": True, "b": False}),
    # one auto tenant over a link that drifts from fast to slow, beside
    # a fixed tenant; the auto tenant's six requests through four slots
    # drain it mid-run, so a pending switch waits and then applies
    "auto_drift": dict(
        conf="int8", max_batch=4,
        tenants=[tenant("auto", ["drift", [[0.0, 100000.0, 1.0],
                                           [0.2, 50.0, 100.0]]], 1, 1,
                        policy="auto"),
                 tenant("fixed", SLOW, 1, 1)],
        work={"auto": ([7, 9, 8, 15, 6, 12], 9), "fixed": ([6, 7], 5)},
        max_new=8),
}
# the lossless property's fleet (tests/test_fleet_serve.py l.62-82)
EXAMPLE_TENANTS = (("a", FAST), ("b", SLOW))

RUNNER = '''
import dataclasses

def prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab, int(n)).astype(np.int32)
            for n in lens]

def channel(desc):
    if desc is None:
        return None
    if desc[0] == "plain":
        return Channel.from_kbps(desc[1], rtt_ms=desc[2])
    if desc[0] == "faulty":
        return FaultyChannel(Channel.from_kbps(desc[1], rtt_ms=desc[2]),
                             **desc[3])
    return DriftingChannel([(t, Channel.from_kbps(kbps, rtt_ms=rtt))
                            for t, kbps, rtt in desc[1]])

def build(spec):
    tenants = [TenantSpec(t["name"], channel(t["ch"]), cut_layer=t["cut"],
                          spec_k=t["k"], max_pages=t.get("max_pages"),
                          policy=t.get("policy"))
               for t in spec["tenants"]]
    kw = dict(CONFS[spec["conf"]], **DEV_KW)
    for opt in ("num_pages", "demand_paged"):
        if opt in spec:
            kw[opt] = spec[opt]
    return FleetServingEngine(PARAMS, CFG, tenants,
                              max_batch=spec["max_batch"], **kw)

def track_peaks(fleet):
    peaks = {n: 0 for n in fleet._tenants}
    orig = fleet._pool.admit
    def admit(slots, plens, max_news, padded_len, owner=None):
        out = orig(slots, plens, max_news, padded_len, owner=owner)
        for n in peaks:
            peaks[n] = max(peaks[n], fleet._pool.owner_pages(n))
        return out
    fleet._pool.admit = admit
    return peaks

def run_spec(spec):
    fleet = build(spec)
    peaks = track_peaks(fleet) if spec.get("peaks") else None
    samp = spec.get("sampling") or {}
    reqs = {}
    for name, (lens, seed) in spec["work"].items():
        sp = SamplingParams(**SP) if samp.get(name) else None
        reqs[name] = [Request(uid=i, prompt=p,
                              max_new_tokens=spec["max_new"], sampling=sp)
                      for i, p in enumerate(prompts(lens, seed))]
    outs = fleet.generate_requests(reqs)
    a = fleet._pool.allocator
    res = dict(
        outs={n: [[int(t) for t in o] for o in v] for n, v in outs.items()},
        stats={n: dataclasses.asdict(t.stats)
               for n, t in fleet._tenants.items()},
        fleet_stats=dataclasses.asdict(fleet.stats),
        round_calls=fleet.round_calls,
        clocks={n: getattr(t.transport.channel, "clock_s", None)
                for n, t in fleet._tenants.items()},
        faults={n: dict(getattr(t.transport.channel, "faults", {}))
                for n, t in fleet._tenants.items()},
        attempts={n: getattr(t.transport.channel, "attempts", None)
                  for n, t in fleet._tenants.items()},
        reqs={n: [dict(preemptions=r.preemptions, admit_s=r.admit_s,
                       finish_s=r.finish_s, done=r.done) for r in v]
              for n, v in reqs.items()},
        state={n: [t.cut, t.spec_k] for n, t in fleet._tenants.items()},
        history={n: [vars(d) for d in t.policy.history]
                 for n, t in fleet._tenants.items()
                 if t.policy is not None},
        pages_back=(a.num_free == a.num_pages - 1 and not a.live),
        owner_pages={n: fleet._pool.owner_pages(n)
                     for n in fleet._tenants},
        free_pages=fleet._pool.free_pages(),
        peaks=peaks)
    return fleet, res

def run(name):
    return run_spec(RUNS[name])[1]

def example_spec(example):
    """One draw of the lossless property (tests/test_fleet_serve.py
    l.62-82): tenants a and b at (cut, k), three prompts each of 3-11
    tokens, 10 new tokens."""
    cut_a, cut_b, k_a, k_b, seed = example
    cuts, ks = dict(a=cut_a, b=cut_b), dict(a=k_a, b=k_b)
    return dict(conf="lossless", max_batch=4,
                tenants=[dict(name=n, ch=ch, cut=cuts[n], k=ks[n])
                         for n, ch in EXAMPLE_TENANTS],
                example_seed=seed, max_new=10)

def example_prompts(spec):
    rng = np.random.RandomState(spec["example_seed"])
    out = {}
    for n in ("a", "b"):
        lens = rng.randint(3, 12, 3)
        out[n] = [rng.randint(0, CFG.vocab, int(l)).astype(np.int32)
                  for l in lens]
    return out

def run_example(example):
    spec = example_spec(example)
    fleet = build(spec)
    outs = fleet.generate(example_prompts(spec), max_new_tokens=10)
    return dict(
        outs={n: [[int(t) for t in o] for o in v] for n, v in outs.items()},
        stats={n: dataclasses.asdict(t.stats)
               for n, t in fleet._tenants.items()},
        round_calls=fleet.round_calls)
'''

_REFERENCE = '''
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_threefry_partitionable", True)
import numpy as np
from repro.core.costmodel import Channel
from repro.models.transformer import LMConfig, init_lm
from repro.serve import (FaultyChannel, DriftingChannel, FleetServingEngine,
                         Request, SamplingParams, TenantSpec)
CFG = LMConfig(max_seq=64, remat=False, **CFG_KW)
PARAMS = init_lm(jax.random.PRNGKey(0), CFG)
DEV_KW = {}
exec(RUNNER)
job = json.loads(JOB)
out = {name: run(name) for name in job.get("runs", [])}
out["examples"] = [run_example(ex) for ex in job.get("examples", [])]
json.dump(out, sys.stdout)
'''


def reference(job: dict) -> dict:
    """Run ``job`` (``runs``, ``examples``) on the JAX fleet in one
    subprocess; returns its results, JSON-decoded."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    consts = dict(CFG_KW=CFG_KW, CONFS=CONFS, RUNS=RUNS, SP=SP,
                  EXAMPLE_TENANTS=EXAMPLE_TENANTS, RUNNER=RUNNER,
                  JOB=json.dumps(job))
    code = "".join(f"{k} = {v!r}\n" for k, v in consts.items()) + _REFERENCE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900,
                         env={"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
                              "PATH": ""})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def port_runner(params) -> dict:
    """``RUNNER``'s functions bound to the port's fleet on the CPU."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.models.transformer import LMConfig
    from repro_torch.serve import (DriftingChannel, FaultyChannel,
                                   FleetServingEngine, Request,
                                   SamplingParams, TenantSpec)
    ns = dict(np=np, Channel=Channel, FaultyChannel=FaultyChannel,
              DriftingChannel=DriftingChannel,
              FleetServingEngine=FleetServingEngine, Request=Request,
              SamplingParams=SamplingParams, TenantSpec=TenantSpec,
              CFG=LMConfig(**CFG_KW), PARAMS=params,
              DEV_KW={"device": "cpu"}, CONFS=CONFS, RUNS=RUNS, SP=SP,
              EXAMPLE_TENANTS=EXAMPLE_TENANTS)
    exec(RUNNER, ns)
    return ns


def jsonable(x):
    """``x`` as it comes back from the reference's JSON (tuples become
    lists), so the two sides compare with ``==``."""
    return json.loads(json.dumps(x))


def bridged_params():
    """The JAX ``init_lm`` weights of ``fleet-tiny`` (seed 0), bridged to
    torch on the CPU by value."""
    import jax

    from repro.models import transformer as JT
    from repro_torch.bridge import params_from_numpy
    p = JT.init_lm(jax.random.PRNGKey(0),
                   JT.LMConfig(max_seq=64, remat=False, **CFG_KW))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def solo(params, spec_tenant, conf, prompts, max_new, *, max_batch=2,
         sampling=None, channel=None):
    """The port's solo engine for one tenant of a run, as the JAX suite
    builds it (``max_batch`` 2 unless given)."""
    from repro_torch.models.transformer import LMConfig
    from repro_torch.serve import CollaborativeServingEngine
    eng = CollaborativeServingEngine(
        params, LMConfig(**CFG_KW), cut_layer=spec_tenant["cut"],
        spec_k=spec_tenant["k"], channel=channel, max_batch=max_batch,
        device="cpu", **CONFS[conf])
    return eng.generate(prompts, max_new_tokens=max_new, sampling=sampling)
