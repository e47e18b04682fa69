"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. ``device``     — the card's name and power limit.
2. ``build``      — compile every hand-written CUDA kernel from
                    ``src/repro_torch/kernels/csrc``.
3. ``kernels``    — each kernel against its plain PyTorch version on the
                    card, at the shapes the main path gives it: error,
                    kernel / plain times and the roofline bound.
4. ``main_path``  — ``CollaborativeServingEngine`` on deepseek-7b at full
                    width and depth (bf16, random seeded weights), INT8
                    paged KV on both sides of cut 14, timed in turns with
                    the cloud-only ``ServingEngine`` on the same weights;
                    every kernel's launch count on each run is checked.
                    Then one ``torch.profiler`` window of each engine on
                    the same traffic, after all the timed runs.
5. ``path_parity``— the lossless engine at full width, 2 layers, f32, on
                    the card and on the CPU: the greedy streams must match
                    (or, at a near-tie, the teacher-forced logits).

Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` name and
power-limit line, and last the ``{"ok": true, "device": ...}`` line.
Needs no network; exits non-zero without printing a result when no CUDA
device is present or the repository's ``src/`` is missing.
"""
from __future__ import annotations

import json
import math
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_FLOPS = 67e12                  # H100 SXM f32 peak outside tensor cores
KERNEL_TOL = 1e-4                  # |kernel - plain| / max|plain|


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 30, warm: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``
    calls, after ``warm`` warm-up calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Mean device time of one ``fn`` call in ms with the host out of the
    way: ``iters`` calls captured in one CUDA graph, replayed ``reps``
    times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (iters * reps)


# ---------------------------------------------------------------------------
# Phase 1-2: device and build
# ---------------------------------------------------------------------------


def _host_cpu() -> str:
    """The host CPU's model name (the host-bound main path follows it)."""
    try:
        for ln in Path("/proc/cpuinfo").read_text().splitlines():
            if ln.startswith("model name"):
                return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         host_cpu=_host_cpu(), host_cores=len(os.sched_getaffinity(0)))
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    sources = sorted(p.stem for p in _build._CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = {name: _build.build(name) for name in sources}
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", sources=sources, seconds=secs, ptxas=ptxas)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _paged_case(name, *, b, s, n_heads, n_kv, hd, page, lengths, q_start,
                page_dtype, scales, seed, copies):
    """Random inputs for one paged-attention shape; ``copies`` distinct
    page pools so timed launches stream from device memory, not L2."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    per_seq = max(1, math.ceil(max(max(lengths), max(q_start) + s) / page))
    n_pages = b * per_seq + 1
    shape = (n_pages, page, n_kv, hd)

    def pool():
        if page_dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        return torch.randn(shape, generator=g, device="cuda").to(page_dtype)

    pools = [(pool(), pool()) for _ in range(copies)]
    # every row gets its own shuffled pages (never the dump page 0)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    bt = perm[:b * per_seq].reshape(b, per_seq).to(torch.int32)
    q = torch.randn((b, s, n_heads, hd), generator=g, device="cuda")
    ks = vs = None
    if scales:
        ks = torch.rand((b, n_kv), generator=g, device="cuda") * 0.04 + 0.01
        vs = torch.rand((b, n_kv), generator=g, device="cuda") * 0.04 + 0.01
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    return dict(name=name, q=q, pools=pools, bt=bt, lens=lens, qs=qs, ks=ks,
                vs=vs)


def _paged_work(c) -> tuple:
    """(bytes, flops) this call's data needs: each valid K/V position of
    each row read once, q read and out written once; QK and AV over the
    valid (query, key) pairs."""
    q, (kp, _), bt = c["q"], c["pools"][0], c["bt"]
    b, s, n_heads, hd = q.shape
    n_kv = kp.shape[2]
    lens = c["lens"].cpu().numpy()
    qs = c["qs"].cpu().numpy()
    span = bt.shape[1] * kp.shape[1]
    kv_pos = pairs = 0
    for i in range(b):
        qpos = qs[i] + np.arange(s)
        n_valid = np.clip(np.minimum(qpos + 1, lens[i]), 0, span)
        pairs += int(n_valid.sum())
        kv_pos += int(min(lens[i], qs[i] + s, span)) if lens[i] > 0 else 0
    nbytes = (2 * kv_pos * n_kv * hd * kp.element_size()
              + 2 * q.numel() * 4 + bt.numel() * 4 + 2 * b * 4
              + (2 * b * n_kv * 4 if c["ks"] is not None else 0))
    flops = 4 * pairs * n_heads * hd
    return nbytes, flops


def _sdpa_pregathered(c):
    """``scaled_dot_product_attention`` on K/V gathered and dequantized
    beforehand — a yardstick only; the port never calls it."""
    import torch.nn.functional as F
    q, (kp, vp), bt = c["q"], c["pools"][0], c["bt"]
    b, s, n_heads, hd = q.shape
    _, page, n_kv, _ = kp.shape
    span = bt.shape[1] * page
    k = kp[bt.long()].reshape(b, span, n_kv, hd).float()
    v = vp[bt.long()].reshape(b, span, n_kv, hd).float()
    if c["ks"] is not None:
        k = k * c["ks"][:, None, :, None]
        v = v * c["vs"][:, None, :, None]
    pos = torch.arange(span, device="cuda")
    qpos = c["qs"].long()[:, None] + torch.arange(s, device="cuda")[None]
    mask = ((pos[None, None] <= qpos[:, :, None])
            & (pos[None, None] < c["lens"].long()[:, None, None]))[:, None]
    qt, kt, vt = (q.transpose(1, 2), k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous())
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=n_heads != n_kv)


def phase_kernels() -> list:
    from repro_torch.kernels import paged_attention as PA
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain version's
    torch.backends.cudnn.allow_tf32 = False          # reference precision
    lengths_dec = [160, 0, 97, 131]
    cases = []
    for dt, sc in ((torch.int8, True), (torch.bfloat16, False)):
        tag = "int8" if dt == torch.int8 else "bf16"
        cases.append(_paged_case(
            f"deepseek7b_decode_{tag}", b=4, s=1, n_heads=32, n_kv=32,
            hd=128, page=16, lengths=lengths_dec,
            q_start=[max(n - 1, 0) for n in lengths_dec], page_dtype=dt,
            scales=sc, seed=1, copies=24))
        cases.append(_paged_case(
            f"deepseek7b_prefill_{tag}", b=4, s=128, n_heads=32, n_kv=32,
            hd=128, page=16, lengths=[128, 100, 128, 77], q_start=[0] * 4,
            page_dtype=dt, scales=sc, seed=2, copies=8))
    cases.append(_paged_case(
        "phi3_medium_gqa_decode_int8", b=4, s=1, n_heads=40, n_kv=10,
        hd=128, page=16, lengths=lengths_dec,
        q_start=[max(n - 1, 0) for n in lengths_dec],
        page_dtype=torch.int8, scales=True, seed=3, copies=24))
    cases.append(_paged_case(
        "phi3_medium_gqa_prefill_int8", b=4, s=128, n_heads=40, n_kv=10,
        hd=128, page=16, lengths=[128, 100, 128, 77], q_start=[0] * 4,
        page_dtype=torch.int8, scales=True, seed=4, copies=8))

    results = []
    for c in cases:
        launches0 = PA.paged_flash_mq.launches
        kp, vp = c["pools"][0]
        args = (c["bt"], c["lens"], c["qs"], c["ks"], c["vs"])
        out = PA.paged_flash_mq(c["q"], kp, vp, *args)
        torch.cuda.synchronize()
        plain = PA.paged_attention_mq_ref(c["q"], kp, vp, *args)
        err = float((out - plain).abs().max())
        scale = float(plain.abs().max())
        tol = KERNEL_TOL * max(scale, 1.0)
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"{c['name']}: kernel vs plain max abs err "
                                 f"{err} > tol {tol}")
        zero_rows = (c["lens"] == 0).nonzero().flatten()
        if len(zero_rows) and float(out[zero_rows].abs().max()) != 0.0:
            raise AssertionError(f"{c['name']}: length-0 row is not 0")
        it = iter(range(10 ** 9))
        n = len(c["pools"])

        def run_kernel():
            k_, v_ = c["pools"][next(it) % n]
            PA.paged_flash_mq(c["q"], k_, v_, *args)

        def run_plain():
            k_, v_ = c["pools"][next(it) % n]
            PA.paged_attention_mq_ref(c["q"], k_, v_, *args)

        sdpa = _sdpa_pregathered(c)
        # plain, kernel, kernel, plain: the two versions in turns.  The
        # device times replay CUDA graphs; the call times are eager calls
        # back to back, where the host's per-call work shows
        plain_ms = graph_ms(run_plain)
        kernel_ms = graph_ms(run_kernel)
        kernel_call_ms = cuda_ms(run_kernel)
        kernel_ms = min(kernel_ms, graph_ms(run_kernel))
        plain_ms = min(plain_ms, graph_ms(run_plain))
        plain_call_ms = cuda_ms(run_plain, iters=10)
        sdpa_ms = graph_ms(sdpa)
        nbytes, flops = _paged_work(c)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        r = dict(shape=c["name"], q=list(c["q"].shape),
                 pages=list(kp.shape), page_dtype=str(kp.dtype),
                 max_abs_err=err, max_abs_plain=scale, tol=tol,
                 kernel_ms=kernel_ms, plain_ms=plain_ms,
                 kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
                 check_launches=PA.paged_flash_mq.launches - launches0,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, flops=flops, library_ms=None,
                 sdpa_pregathered_ms=sdpa_ms)
        emit("kernels", **r)
        results.append(r)
    return results


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------


def profile_window(fn, unprofiled_wall_s: float, top: int = 8) -> dict:
    """Device time of one ``fn`` call under ``torch.profiler``.

    Only device events (kernels, copies, memsets) are summed: a CPU
    operator's row carries the device time of the kernels it launched,
    so adding it would count that time twice.  Everything runs on one
    stream, so the sum is the device's busy time.  The idle share is
    taken against ``unprofiled_wall_s``, the wall time of the same
    traffic without the profiler, whose own host work would add idle
    time; the profiled window's wall time is reported beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    attn_us = sum(r[0] for r in rows if "paged_flash_mq" in r[1])
    rows.sort(reverse=True)
    return dict(profiled_wall_s=wall, unprofiled_wall_s=unprofiled_wall_s,
                device_busy_s=busy_us / 1e6,
                device_idle_share=1.0 - busy_us / 1e6 / unprofiled_wall_s,
                device_events=sum(r[2] for r in rows),
                distinct_kernels=len(rows),
                paged_flash_mq_ms=attn_us / 1e3,
                paged_flash_mq_share=attn_us / busy_us if busy_us else None,
                top=[dict(name=k[:80], device_ms=us / 1e3, count=c,
                          share=us / busy_us)
                     for us, k, c in rows[:top]])


def _prompts(n, plen, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, plen).astype(np.int32) for _ in range(n)]


def phase_main_path() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.core.costmodel import (CLOUD_TITANXP_CLASS, Channel,
                                            EDGE_TX2_CLASS)
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.transformer import init_lm, make_graph
    from repro_torch.serve.engine import (CollaborativeServingEngine,
                                          ServingEngine)

    cfg = get_arch("deepseek-7b").full
    n_req, plen, max_new, cut, reps = 8, 128, 32, 14, 3
    channel = Channel.from_kbps(250.0, rtt_ms=20.0)
    best, _ = AutoTuner(make_graph(cfg, batch=1, seq=plen), EDGE_TX2_CLASS,
                        CLOUD_TITANXP_CLASS).tune(channel)
    print(json.dumps({"phase": "algorithm1", "arch": cfg.name,
                      "channel_kbps": 250.0, "rtt_ms": 20.0,
                      "pick": best.point}), flush=True)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_lm(cfg, gen, device="cuda")
    max_len = plen + max_new + 24
    eng = CollaborativeServingEngine(params, cfg, cut_layer=cut,
                                     channel=channel, max_len=max_len,
                                     device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cloud = ServingEngine(params, cfg, max_len=max_len, device="cuda")
    prompts = _prompts(n_req, plen, cfg.vocab, seed=0)
    for e in (eng, cloud):
        e.generate(prompts[:1], max_new_tokens=2)      # warm-up: cuBLAS etc.
    torch.cuda.synchronize()

    def timed(e):
        """One run of the main path's traffic; the kernel's launch count
        is set to 0 just before and read just after."""
        e.stats = type(e.stats)()
        PA.paged_flash_mq.launches = 0
        t0 = time.perf_counter()
        outs = e.generate(prompts, max_new_tokens=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = PA.paged_flash_mq.launches
        st = e.stats
        expect = cfg.n_layers * (st.prefill_calls + st.decode_steps)
        if launches != expect:
            raise AssertionError(f"paged_flash_mq launched {launches} times "
                                 f"on the main path, expected {expect}")
        if not all(len(o) == max_new and all(0 <= t < cfg.vocab for t in o)
                   for o in outs):
            raise AssertionError("main path produced malformed streams")
        return dict(outs=outs, wall=wall, launches=launches, stats=st)

    # collaborative and cloud-only in turns, so a slow stretch of the
    # host shows in both and in the spread of the repeats
    runs = {"collab": [], "cloud": []}
    for _ in range(reps):
        runs["collab"].append(timed(eng))
        runs["cloud"].append(timed(cloud))

    def summary(rs):
        walls = [r["wall"] for r in rs]
        n_tok = sum(len(o) for o in rs[0]["outs"])
        return dict(tokens=n_tok, wall_s_reps=walls,
                    tokens_per_s_reps=[n_tok / w for w in walls],
                    tokens_per_s=n_tok / statistics.median(walls),
                    streams_repeat_identical=all(
                        r["outs"] == rs[0]["outs"] for r in rs))

    first, st = runs["collab"][0], runs["collab"][0]["stats"]
    res = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=str(cfg.dtype), cut=cut, edge_blocks=eng.n_edge,
               cloud_blocks=eng.n_cloud, requests=n_req, slots=4,
               prompt_len=plen, max_new=max_new, reduced=None,
               setup_s=setup_s, reps=reps, **summary(runs["collab"]),
               prefill_calls=st.prefill_calls, decode_steps=st.decode_steps,
               launches=first["launches"],
               expected_launches=cfg.n_layers * (st.prefill_calls
                                                 + st.decode_steps),
               transmitted_bytes=st.transmitted_bytes,
               prefill_bytes=st.prefill_bytes,
               bytes_per_decode_token=st.bytes_per_decode_token(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_output=first["outs"][0])
    emit("main_path", **res)
    cfirst = runs["cloud"][0]
    emit("cloud_only", arch=cfg.name, pages=str(cfg.dtype), reps=reps,
         **summary(runs["cloud"]), launches=cfirst["launches"],
         first_output=cfirst["outs"][0],
         first_token_agree_with_collab=sum(
             a[0] == b[0] for a, b in zip(first["outs"], cfirst["outs"])))

    # the profiler's windows come after every timed run: its host work
    # and state stay out of the tokens/s above
    for tag, key, e in (("main_path_profile", "collab", eng),
                        ("cloud_only_profile", "cloud", cloud)):
        emit(tag, requests=n_req, max_new=max_new, **profile_window(
            lambda: e.generate(prompts, max_new_tokens=max_new),
            statistics.median(r["wall"] for r in runs[key])))
    del eng, cloud
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 5: the same engine on the card and on the CPU
# ---------------------------------------------------------------------------


PARITY_TOL = 2e-3      # f32 logits, card vs CPU: GEMM summation order


def _teacher_forced(params, cfg, tokens, device):
    """Last-position logits of ``tokens`` through a fresh paged fp cache."""
    from repro_torch.models import transformer as TF
    n = len(tokens)
    page = 16
    width = -(-n // page)
    cache = TF.init_cache(cfg, 1, width * page, paged=True, layers=None,
                          page_size=page, num_pages=width + 1, device=device)
    bt = torch.arange(1, width + 1, dtype=torch.int32,
                      device=device)[None]
    toks = torch.tensor(np.asarray(tokens, np.int32)[None], device=device)
    logits, _ = TF.prefill(params, toks, cfg, cache=cache, block_tables=bt)
    return logits[0].double().cpu()


def phase_path_parity() -> None:
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import CollaborativeServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("deepseek-7b").full, n_layers=2,
                              dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p_gpu = init_lm(cfg, gen, device="cuda")
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    prompts = [np.random.RandomState(5 + i).randint(0, cfg.vocab, n)
               .astype(np.int32) for i, n in enumerate((20, 17, 33, 9, 16))]
    kw = dict(cut_layer=0, max_len=64, a_bits=None, edge_int8=False,
              cloud_int8=False)
    streams = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        eng = CollaborativeServingEngine(p, cfg, device=dev, **kw)
        streams[dev] = eng.generate(prompts, max_new_tokens=8)
    checked = []
    for pr, a, b in zip(prompts, streams["cuda"], streams["cpu"]):
        if a == b:
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        ctx = list(pr) + b[:i]
        lg = _teacher_forced(p_gpu, cfg, ctx, "cuda")
        lc = _teacher_forced(p_cpu, cfg, ctx, "cpu")
        diff = float((lg - lc).abs().max())
        top2 = torch.topk(lc, 2).values
        gap = float(top2[0] - top2[1])
        if diff > PARITY_TOL or gap > 2 * PARITY_TOL:
            raise AssertionError(
                f"card and CPU streams diverge at step {i} without a "
                f"near-tie: logits diff {diff}, CPU top-2 gap {gap}")
        checked.append(dict(step=i, logits_diff=diff, top2_gap=gap))
    emit("path_parity", arch=cfg.name, layers=cfg.n_layers,
         dtype="float32", requests=len(prompts),
         identical=streams["cuda"] == streams["cpu"],
         near_ties=checked, tol=PARITY_TOL)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels",),
                    help="stop after the kernels phase (a quick check of a "
                         "kernel change); prints no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    smi = phase_device()
    phase_build()
    kres = phase_kernels()
    if args.only == "kernels":
        return 0
    main_res = phase_main_path()
    phase_path_parity()
    # the summary row is the shape the main path launches most: decode
    dec = next(r for r in kres if r["shape"] == "deepseek7b_decode_int8")
    print(json.dumps({"kernels": [{
        "name": "paged_flash_mq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:213",
        "launches": main_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kres),
        "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None, "shape": dec["shape"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
