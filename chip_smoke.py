"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. ``device``     — the card's name and power limit.
2. ``build``      — compile every hand-written CUDA kernel from
                    ``src/repro_torch/kernels/csrc``, one ``nvcc`` per
                    source, all started together.
3. ``kernels``    — each kernel against its plain PyTorch version on the
                    card: ``paged_flash_mq`` at the shapes the main path
                    gives it (decode, prefill, speculative verify), its
                    tensor-parallel form ``paged_flash_mq_sharded`` at
                    the same int8 shapes split over 2 and 4 shards of
                    the one card (per-shard and summed times, the
                    per-shard bound), the fused ``int8_matmul`` at
                    deepseek-7b's edge GEMM shapes; error, kernel /
                    plain times and the roofline bound.
4. ``quantized_dense`` — the INT8 GEMM's front door at full width on the
                    main path's own activations and layer-0 weights,
                    against its plain version and the f32 product.
5. ``main_path``  — ``CollaborativeServingEngine`` on deepseek-7b at full
                    width and depth (bf16, random seeded weights), INT8
                    paged KV on both sides of cut 14, timed in turns with
                    the cloud-only ``ServingEngine`` on the same weights;
                    every kernel's launch count on each run is checked.
                    Then one ``torch.profiler`` window of each engine on
                    the same traffic, after all the timed runs.
6. ``spec_path``  — the same engine, weights and traffic with speculative
                    draft/verify rounds (``spec_k=4``), full width and
                    depth: tokens/s, rounds, acceptance, wire bytes, and
                    the launch count the rounds imply; then one
                    ``torch.profiler`` window of its traffic.  Then,
                    untimed, where the spec stream first leaves the
                    serial one, with each side's top-2 logit gap there.
7. ``tp_path``    — the same engine, weights and traffic with the cloud
                    tensor-parallel over ``make_serve_mesh(model=2)`` on
                    the one card, serially and with ``spec_k=4`` (three
                    timed repeats each, a profile of the serial run),
                    then ``model=4`` serially once: tokens/s, launches,
                    sharded calls, wire bytes, peak memory; the launch
                    counts and the serial wire bytes are asserted.
8. ``path_parity``— the collaborative engine at full width, 2 layers, f32,
                    on the card and on the CPU: lossless serial and
                    speculative streams must match the CPU's serial one
                    (or, at a near-tie, the teacher-forced logits); in
                    the INT8 default the ``spec_k=4`` stream must equal
                    the serial one on each device, and the card's
                    decisions the CPU's up to a tie; at tp = 2 on the
                    card, the lossless stream against tp = 1 and the
                    CPU's tp = 2 up to near-ties, and the INT8
                    ``spec_k=4`` stream equal to the serial one on each
                    device.

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
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
KERNEL_TOL = 1e-4                  # |kernel - plain| / max|plain|
INT8_RTOL, INT8_ATOL = 1e-5, 1e-4  # the JAX suite's f32 epilogue tolerance


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase, with the seconds since the script began
    (where the time limit goes)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}),
          flush=True)


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
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    sources = sorted(p.stem for p in _build._CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(_build.build, sources)))
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
    # speculative verify: k = 4 queries per row at lengths - 4
    lengths_ver = [164, 100, 131, 36]
    cases.append(_paged_case(
        "deepseek7b_verify_int8", b=4, s=4, n_heads=32, n_kv=32, hd=128,
        page=16, lengths=lengths_ver, q_start=[n - 4 for n in lengths_ver],
        page_dtype=torch.int8, scales=True, seed=5, copies=24))
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


def phase_sharded_kernels() -> list:
    """``paged_flash_mq_sharded`` (B3) on the one card at deepseek-7b's
    int8 decode, verify (S = 4) and prefill (S = 128) shapes, split over
    tp = 2 and 4 shards of ``make_serve_mesh``.  The reference signature
    (split, one launch per shard, put back together) is held against the
    plain version on the whole tensors; then each shard's own launch is
    timed over contiguous kv-head slices cut beforehand (the slicing
    copies stay outside the timed rows), beside the plain version on the
    same slices and the shard's bound.  The page pools are made in 4 x
    the unsharded rows' copies, so a tp = 4 shard's launches still
    stream from device memory, not from L2."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch.mesh import make_serve_mesh
    lengths_dec = [160, 0, 97, 131]
    lengths_ver = [164, 100, 131, 36]
    shapes = (("decode", 1, lengths_dec, [max(n - 1, 0) for n in lengths_dec],
               24, 31),
              ("verify", 4, lengths_ver, [n - 4 for n in lengths_ver], 24, 32),
              ("prefill", 128, [128, 100, 128, 77], [0] * 4, 8, 33))
    results = []
    for name, s, lens, q0, copies, seed in shapes:
        c = _paged_case(f"deepseek7b_{name}_int8", b=4, s=s, n_heads=32,
                        n_kv=32, hd=128, page=16, lengths=lens, q_start=q0,
                        page_dtype=torch.int8, scales=True, seed=seed,
                        copies=4 * copies)
        kp, vp = c["pools"][0]
        args = (c["bt"], c["lens"], c["qs"], c["ks"], c["vs"])
        plain = PA.paged_attention_mq_ref(c["q"], kp, vp, *args)
        scale = float(plain.abs().max())
        tol = KERNEL_TOL * max(scale, 1.0)
        for tp in (2, 4):
            launches0 = PA.paged_flash_mq.launches
            sharded0 = PA.paged_flash_mq_sharded.launches
            out = PA.paged_flash_mq_sharded(c["q"], kp, vp, *args,
                                            mesh=make_serve_mesh(model=tp))
            torch.cuda.synchronize()
            launches = PA.paged_flash_mq_sharded.launches - sharded0
            if launches != tp or PA.paged_flash_mq.launches - launches0 != tp:
                raise AssertionError(f"{c['name']} tp {tp}: {launches} "
                                     f"sharded launches, expected {tp}")
            err = float((out - plain).abs().max())
            if not (math.isfinite(err) and err <= tol):
                raise AssertionError(f"{c['name']} tp {tp}: sharded vs "
                                     f"plain max abs err {err} > tol {tol}")
            zero_rows = (c["lens"] == 0).nonzero().flatten()
            if len(zero_rows) and float(out[zero_rows].abs().max()) != 0.0:
                raise AssertionError(f"{c['name']} tp {tp}: length-0 row "
                                     f"is not 0")
            hq = 32 // tp
            shard_rows = []
            for m in range(tp):
                h = slice(m * hq, (m + 1) * hq)
                sq = c["q"][:, :, h].contiguous()
                pools = [(k_[:, :, h].contiguous(), v_[:, :, h].contiguous())
                         for k_, v_ in c["pools"]]
                sks = c["ks"][:, h].contiguous()
                svs = c["vs"][:, h].contiguous()
                sargs = (c["bt"], c["lens"], c["qs"], sks, svs)
                it = iter(range(10 ** 9))

                def run_kernel():
                    k_, v_ = pools[next(it) % len(pools)]
                    PA.paged_flash_mq(sq, k_, v_, *sargs)

                def run_plain():
                    k_, v_ = pools[next(it) % len(pools)]
                    PA.paged_attention_mq_ref(sq, k_, v_, *sargs)

                plain_ms = graph_ms(run_plain)
                kernel_ms = graph_ms(run_kernel)
                kernel_ms = min(kernel_ms, graph_ms(run_kernel))
                plain_ms = min(plain_ms, graph_ms(run_plain))
                nbytes, flops = _paged_work(dict(
                    q=sq, pools=pools[:1], bt=c["bt"], lens=c["lens"],
                    qs=c["qs"], ks=sks))
                shard_rows.append((kernel_ms, plain_ms, nbytes, flops))
                del pools
            t_bytes = shard_rows[0][2] / HBM_BYTES_PER_S * 1e3
            t_ops = shard_rows[0][3] / F32_FLOPS * 1e3
            r = dict(kernel="paged_flash_mq_sharded",
                     shape=f"{c['name']}_tp{tp}", tp=tp,
                     q=list(c["q"].shape), pages=list(kp.shape),
                     shard_pages=[kp.shape[0], kp.shape[1], 32 // tp,
                                  kp.shape[3]],
                     max_abs_err=err, max_abs_plain=scale, tol=tol,
                     launches=launches,
                     shard_kernel_ms=[x[0] for x in shard_rows],
                     kernel_ms=statistics.mean(x[0] for x in shard_rows),
                     sum_kernel_ms=sum(x[0] for x in shard_rows),
                     plain_ms=statistics.mean(x[1] for x in shard_rows),
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     shard_bytes=shard_rows[0][2],
                     shard_flops=shard_rows[0][3],
                     library_ms=None)
            emit("kernels", **r)
            results.append(r)
        del c
    torch.cuda.empty_cache()
    return results


def _int8_case(name, m, k, n, *, seed, act=None, bias=False,
               requant=False, identity=False):
    """Random int8 operands at one GEMM shape: per-channel weight scales
    and non-zero zero points on both sides (unit scales and zero zero
    points for ``identity``), and enough distinct B copies that timed
    launches stream B from device memory, not from the 50 MB L2."""
    from repro_torch.core.quant import QuantParams
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = max(2, math.ceil(150e6 / (k * n)))

    def ints(shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    if identity:
        qa = qb = QuantParams(scale=torch.tensor(1.0, device="cuda"),
                              zero_point=torch.tensor(0.0, device="cuda"))
    else:
        qa = QuantParams(scale=torch.tensor(0.02, device="cuda"),
                         zero_point=torch.tensor(3.0, device="cuda"))
        qb = QuantParams(
            scale=torch.rand((n,), generator=g, device="cuda") * 1e-3 + 1e-4,
            zero_point=torch.randint(-6, 7, (n,), generator=g,
                                     device="cuda").float(), axis=1)
    return dict(name=name, a=ints((m, k)), bs=[ints((k, n))
                                              for _ in range(copies)],
                qa=qa, qb=qb, act=act, requant=requant, identity=identity,
                bias=(torch.randn((n,), generator=g, device="cuda")
                      if bias else None))


def phase_int8_kernels() -> list:
    """``int8_matmul`` against its plain version at deepseek-7b's edge
    GEMM shapes: M = 4 (one decode step of 4 slots) and M = 512 (one
    prefill of 4 x 128), (K, N) the attention projections, gate/up and
    down; then one case each for bias + silu, gelu, requant to int8 after
    relu and after bias + gelu, and the identity epilogue, which must be
    exact."""
    from repro_torch.core.quant import compute_qparams
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import ops, ref
    cases = [_int8_case(f"int8mm_m{m}_{k}x{n}", m, k, n, seed=10 + i)
             for i, (m, (k, n)) in enumerate(
                 (m, kn) for m in (4, 512)
                 for kn in ((4096, 4096), (4096, 11008), (11008, 4096)))]
    cases += [
        _int8_case("int8mm_m512_4096x11008_bias_silu", 512, 4096, 11008,
                   seed=20, act="silu", bias=True),
        _int8_case("int8mm_m4_4096x11008_gelu", 4, 4096, 11008, seed=21,
                   act="gelu"),
        _int8_case("int8mm_m512_11008x4096_requant_int8", 512, 11008, 4096,
                   seed=22, act="relu", requant=True),
        _int8_case("int8mm_m512_4096x4096_bias_gelu_requant_int8", 512, 4096,
                   4096, seed=24, act="gelu", bias=True, requant=True),
        _int8_case("int8mm_m512_1024x4096_identity", 512, 1024, 4096,
                   seed=23, identity=True),
    ]
    results = []
    for c in cases:
        a, b0, qa, qb = c["a"], c["bs"][0], c["qa"], c["qb"]
        m, k = a.shape
        n = b0.shape[1]
        kw = dict(bias=c["bias"], act=c["act"])
        if c["requant"]:
            kw["out_qp"] = compute_qparams(ref.int8_matmul_ref(a, b0, qa, qb,
                                                               **kw))
        launches0 = IK.int8_matmul_cuda.launches
        out = ops.int8_matmul(a, b0, qa, qb, **kw)
        torch.cuda.synchronize()
        if IK.int8_matmul_cuda.launches != launches0 + 1:
            raise AssertionError(f"{c['name']}: the front door did not "
                                 f"launch the kernel exactly once")
        plain = ref.int8_matmul_ref(a, b0, qa, qb, **kw)
        if out.dtype != plain.dtype or out.shape != plain.shape:
            raise AssertionError(f"{c['name']}: {out.dtype} {out.shape} vs "
                                 f"plain {plain.dtype} {plain.shape}")
        diff = (out.double() - plain.double()).abs()
        err = float(diff.max())
        if c["identity"]:
            tol, ok = 0.0, bool(torch.equal(out, plain))
        elif c["requant"]:
            frac = float((diff > 0).double().mean())
            tol, ok = 1.0, err <= 1.0 and frac < 0.01
        else:
            bound = INT8_ATOL + INT8_RTOL * plain.double().abs()
            tol = float(bound.max())
            ok = bool((diff <= bound).all()) and math.isfinite(err)
        if not ok:
            raise AssertionError(f"{c['name']}: kernel vs plain max abs "
                                 f"err {err} > tol {tol}")
        it = iter(range(10 ** 9))
        nb = len(c["bs"])

        def run_kernel():
            ops.int8_matmul(a, c["bs"][next(it) % nb], qa, qb, **kw)

        def run_plain():
            ref.int8_matmul_ref(a, c["bs"][next(it) % nb], qa, qb, **kw)

        # torch._int_mm (cuBLASLt s8 x s8 -> s32, no epilogue) as a
        # yardstick: it needs more than 16 rows, so M = 4 is padded to 32
        a_mm = a if m > 16 else torch.cat(
            [a, torch.zeros((32 - m, k), dtype=torch.int8, device="cuda")])

        def run_int_mm():
            return torch._int_mm(a_mm, c["bs"][next(it) % nb])

        if c["identity"]:
            acc = run_int_mm()[:m].float()
            if not torch.equal(out, acc):
                raise AssertionError(f"{c['name']}: identity epilogue "
                                     f"differs from torch._int_mm")
        plain_ms = graph_ms(run_plain, iters=5)
        kernel_ms = graph_ms(run_kernel)
        kernel_call_ms = cuda_ms(run_kernel)
        kernel_ms = min(kernel_ms, graph_ms(run_kernel))
        plain_ms = min(plain_ms, graph_ms(run_plain, iters=5))
        int_mm_ms = graph_ms(run_int_mm)
        nbytes = (m * k + k * n + m * n * out.element_size()
                  + 4 * n * (3 if c["bias"] is not None else 2))
        ops_n = 2 * m * k * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_n / INT8_OPS * 1e3
        r = dict(kernel="int8_matmul", shape=c["name"], m=m, k=k, n=n,
                 act=c["act"], bias=c["bias"] is not None,
                 out_dtype=str(out.dtype), max_abs_err=err, tol=tol,
                 kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
                 plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, ops=ops_n, library_ms=None,
                 int_mm_ms=int_mm_ms,
                 int_mm_rows=a_mm.shape[0], b_copies=nb)
        emit("kernels", **r)
        results.append(r)
        del c["bs"]
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 4: the INT8 GEMM's front door at full width
# ---------------------------------------------------------------------------


def _rel_l2(a, b) -> float:
    return float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()))


def phase_quantized_dense(params, cfg) -> dict:
    """The INT8 GEMM's front door at full width: the main path's prompts
    (4 x 128 rows) embedded and rmsnormed, through layer 0's ``wq``,
    gate/up ``wi`` and down ``wo`` (the SwiGLU product of the f32 path as
    its input) of the seeded deepseek-7b, each quantized per channel.
    Held against the plain version, and against the f32 product within
    the noise the two INT8 lattices predict: rounding x and w to steps
    dx and dw[j] adds (M dx^2 |w|^2 + |x|^2 sum_j dw[j]^2) / 12 to the
    squared error of x @ w."""
    import torch.nn.functional as F
    from repro_torch.core.quant import compute_qparams, quantize
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as ML

    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = params["blocks"]
    toks = torch.tensor(np.stack(_prompts(8, 128, cfg.vocab, seed=0)[:4]),
                        device="cuda")
    x = ML.rmsnorm({"scale": blocks["ln1"]["scale"][0]},
                   ML.embed(params["embed"], toks)).float()
    x = x.reshape(-1, cfg.d_model)
    wq, wi, wg, wo = (blocks["attn"]["wq"]["w"][0].float(),
                      blocks["mlp"]["wi"]["w"][0].float(),
                      blocks["mlp"]["wg"]["w"][0].float(),
                      blocks["mlp"]["wo"]["w"][0].float())
    hidden = (x @ wi) * F.silu(x @ wg)
    rows = []
    for name, inp, w in (("wq", x, wq), ("w1_gate_up", x, wi),
                         ("w2_down", hidden, wo)):
        qx, qw = compute_qparams(inp), compute_qparams(w, axis=1)
        w_q = quantize(w, qw)
        launches0 = IK.int8_matmul_cuda.launches
        got = ops.quantized_dense(inp, w_q, qx, qw)
        torch.cuda.synchronize()
        launches = IK.int8_matmul_cuda.launches - launches0
        want = ref.quantized_dense_ref(inp, w_q, qx, qw)
        truth = inp @ w
        diff = (got - want).abs()
        bound = INT8_ATOL + INT8_RTOL * want.abs()
        rel = _rel_l2(got, truth)
        noise = float(torch.sqrt(
            (inp.shape[0] * qx.scale.double() ** 2 * (w.double() ** 2).sum()
             + (inp.double() ** 2).sum() * (qw.scale.double() ** 2).sum())
            / 12) / torch.linalg.norm(truth.double()))
        r = dict(weight=name, x=list(inp.shape), w=list(w.shape),
                 launches=launches, max_abs_err_vs_plain=float(diff.max()),
                 tol_vs_plain=float(bound.max()),
                 rel_l2_vs_f32=rel, predicted_rel_l2=noise,
                 plain_rel_l2_vs_f32=_rel_l2(want, truth),
                 within_1pct=rel < 0.01)
        if launches != 1:
            raise AssertionError(f"quantized_dense {name}: {launches} "
                                 f"launches, expected 1")
        if not bool((diff <= bound).all()):
            raise AssertionError(f"quantized_dense {name}: kernel vs plain "
                                 f"max abs err {float(diff.max())}")
        if not rel <= 1.1 * noise:
            raise AssertionError(f"quantized_dense {name}: rel L2 {rel} vs "
                                 f"f32 above 1.1 x the lattice noise {noise}")
        rows.append(r)
    res = dict(arch=cfg.name, layer=0, rows=rows)
    emit("quantized_dense", **res)
    del blocks, x, hidden, wq, wi, wg, wo
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 5: the main path at full width
# ---------------------------------------------------------------------------


def profile_window(fn, unprofiled_wall_s: float, top: int = 8) -> dict:
    """Device time of one ``fn`` call under ``torch.profiler``.

    Only device events (kernels, copies, memsets) are summed: a CPU
    operator's row carries the device time of the kernels it launched,
    so adding it would count that time twice.  Everything runs on one
    stream, so the sum is the device's busy time.  The idle share is
    taken against ``unprofiled_wall_s``, the wall time of the same
    traffic without the profiler, whose own host work would add idle
    time; the profiled window's wall time is reported beside it.

    The device events are summed straight from the profiler's raw
    results: ``key_averages()`` first builds the whole CPU operator
    tree in Python, and with it a window took 90–265 s on the H100
    machine's host at these event counts — most of the script's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e3
            acc[1] += 1
    rows = [(us, k, c) for k, (us, c) in by_name.items()]
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


def _timed(e, prompts, max_new, vocab, expect, what) -> dict:
    """One run of ``prompts`` through engine ``e``: the kernels' launch
    counts (and the sharded form's calls) are set to 0 just before and
    read just after, and ``paged_flash_mq``'s must equal
    ``expect(stats)``, the count the engine's code implies."""
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import paged_attention as PA
    e.stats = type(e.stats)()
    PA.paged_flash_mq.launches = 0
    PA.paged_flash_mq_sharded.calls = 0
    PA.paged_flash_mq_sharded.launches = 0
    IK.int8_matmul_cuda.launches = 0
    t0 = time.perf_counter()
    outs = e.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_flash_mq.launches
    st = e.stats
    if launches != expect(st):
        raise AssertionError(f"{what}: paged_flash_mq launched {launches} "
                             f"times, expected {expect(st)} "
                             f"({st.prefill_calls} prefills, "
                             f"{st.decode_steps} decode steps)")
    if not all(len(o) == max_new and all(0 <= t < vocab for t in o)
               for o in outs):
        raise AssertionError(f"{what} produced malformed streams")
    return dict(outs=outs, wall=wall, launches=launches,
                sharded_calls=PA.paged_flash_mq_sharded.calls,
                sharded_launches=PA.paged_flash_mq_sharded.launches,
                int8_matmul_launches=IK.int8_matmul_cuda.launches, stats=st)


def phase_main_path(params, cfg) -> dict:
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.core.costmodel import (CLOUD_TITANXP_CLASS, Channel,
                                            EDGE_TX2_CLASS)
    from repro_torch.models.transformer import make_graph
    from repro_torch.serve.engine import (CollaborativeServingEngine,
                                          ServingEngine)

    n_req, plen, max_new, cut, reps = 8, 128, 32, 14, 3
    channel = Channel.from_kbps(250.0, rtt_ms=20.0)
    best, _ = AutoTuner(make_graph(cfg, batch=1, seq=plen), EDGE_TX2_CLASS,
                        CLOUD_TITANXP_CLASS).tune(channel)
    print(json.dumps({"phase": "algorithm1", "arch": cfg.name,
                      "channel_kbps": 250.0, "rtt_ms": 20.0,
                      "pick": best.point}), flush=True)

    t0 = time.perf_counter()
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
        # every layer attends once per prefill call and once per step
        return _timed(e, prompts, max_new, cfg.vocab,
                      lambda st: cfg.n_layers * (st.prefill_calls
                                                 + st.decode_steps),
                      "main path")

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
               int8_matmul_launches=first["int8_matmul_launches"],
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
    # untimed: the serial decisions, for phase 6's divergence report
    with _CommittedDecisions(eng, "_cloud_decode") as dec:
        res["logged_outs"] = eng.generate(prompts, max_new_tokens=max_new)
    res["decisions"] = dec.at
    del eng, cloud
    torch.cuda.empty_cache()
    res["outs"] = first["outs"]
    return res


# ---------------------------------------------------------------------------
# Phase 6: speculative rounds on the main path
# ---------------------------------------------------------------------------


def phase_spec_path(params, cfg, main_res: dict) -> dict:
    """The main path's engine, weights and traffic with ``spec_k=4``:
    each decode step becomes a round of 4 drafted positions on the edge
    and one verify of 4 queries (``paged_flash_mq`` at S = 4) on the
    cloud.  Three timed repeats; the launch count is the one the code
    implies: every layer attends once per prefill call on each side plus
    once more in the draft suffix's prefill, and once per drafted
    position on the edge (prefix and draft suffix) plus once per verify
    on the cloud."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve.engine import CollaborativeServingEngine

    n_req, plen, max_new, cut, reps, k = 8, 128, 32, 14, 3, 4
    channel = Channel.from_kbps(250.0, rtt_ms=20.0)
    t0 = time.perf_counter()
    eng = CollaborativeServingEngine(params, cfg, cut_layer=cut,
                                     channel=channel,
                                     max_len=plen + max_new + 24, spec_k=k,
                                     device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = _prompts(n_req, plen, cfg.vocab, seed=0)
    eng.generate(prompts[:1], max_new_tokens=2)           # warm-up
    torch.cuda.synchronize()
    n_layers, n_cloud = cfg.n_layers, eng.n_cloud
    runs = []
    for _ in range(reps):
        runs.append(_timed(
            eng, prompts, max_new, cfg.vocab,
            lambda st: (st.prefill_calls * (n_layers + n_cloud)
                        + st.spec_rounds * (k * n_layers + n_cloud)),
            "spec path"))
        st = runs[-1]["stats"]
        if st.spec_rounds != st.decode_steps:
            raise AssertionError(f"spec path: {st.spec_rounds} rounds in "
                                 f"{st.decode_steps} decode steps")
    first, st = runs[0], runs[0]["stats"]
    serial = main_res["outs"]
    # the prefill is the serial engine's own, so first tokens are equal;
    # later tokens may differ at near-ties: the verify runs k rows per
    # slot where the serial step runs one, so its sums round otherwise.
    # Phase 8 holds the INT8 spec stream to the serial one at 2 layers
    if [o[0] for o in first["outs"]] != [o[0] for o in serial]:
        raise AssertionError("spec path: first tokens differ from the "
                             "serial main path's")
    agree = sum(a == b for o, s_ in zip(first["outs"], serial)
                for a, b in zip(o, s_)) / sum(len(o) for o in serial)
    walls = [r["wall"] for r in runs]
    n_tok = sum(len(o) for o in first["outs"])
    res = dict(arch=cfg.name, layers=n_layers, cut=cut, spec_k=k,
               requests=n_req, slots=4, prompt_len=plen, max_new=max_new,
               reduced=None, setup_s=setup_s, reps=reps, tokens=n_tok,
               wall_s_reps=walls, tokens_per_s_reps=[n_tok / w for w in walls],
               tokens_per_s=n_tok / statistics.median(walls),
               serial_tokens_per_s=main_res["tokens_per_s"],
               streams_repeat_identical=all(r["outs"] == first["outs"]
                                            for r in runs),
               token_agreement_with_serial=agree,
               prefill_calls=st.prefill_calls, spec_rounds=st.spec_rounds,
               drafted_tokens=st.drafted_tokens, draft_hits=st.draft_hits,
               acceptance_rate=st.acceptance_rate(),
               tokens_per_round=st.decode_tokens / max(st.spec_rounds, 1),
               launches=first["launches"],
               int8_matmul_launches=first["int8_matmul_launches"],
               transmitted_bytes=st.transmitted_bytes,
               prefill_bytes=st.prefill_bytes,
               bytes_per_decode_token=st.bytes_per_decode_token(),
               channel_latency_s=st.channel_latency_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_output=first["outs"][0])
    emit("spec_path", **res)
    # as for the serial path, the profiler's window comes after the
    # timed runs
    emit("spec_path_profile", requests=n_req, max_new=max_new,
         **profile_window(
             lambda: eng.generate(prompts, max_new_tokens=max_new),
             statistics.median(walls)))
    with _CommittedDecisions(eng, "_verify_impl") as dec:
        logged = eng.generate(prompts, max_new_tokens=max_new)
    emit("spec_divergence", **_divergence(
        main_res["logged_outs"], main_res["decisions"], logged, dec.at))
    del eng
    torch.cuda.empty_cache()
    res["outs"] = first["outs"]
    return res


class _CommittedDecisions:
    """While active, record each decision ``eng``'s cloud makes inside
    its method ``phase`` (the serial ``_cloud_decode`` or the spec
    ``_verify_impl``): argmax, top logit and top-2 gap of output index
    ``c + j`` of the request in each live slot, ``c`` being its tokens
    committed before the round and ``j`` the row's place in the round.
    A position a round computes but does not commit is computed again by
    a later round, so each position's last record is its committed
    one."""

    def __init__(self, eng, phase: str):
        self.eng, self.phase, self.at = eng, phase, {}

    def __enter__(self):
        from repro_torch.models import transformer as TF
        eng, orig_head = self.eng, TF.lm_head
        orig_phase = getattr(eng, self.phase)
        inside = [False]

        def head(tail, x):
            logits = orig_head(tail, x)
            if inside[0]:
                top, idx = torch.topk(logits.float(), 2, dim=-1)
                top, idx = top.cpu().numpy(), idx.cpu().numpy()
                for slot, (r, c) in eng._sched_active.items():
                    for j in range(top.shape[1]):
                        self.at[r.uid, c + j] = (
                            int(idx[slot, j, 0]), float(top[slot, j, 0]),
                            float(top[slot, j, 0] - top[slot, j, 1]))
            return logits

        def phase(*args, **kw):
            inside[0] = True
            try:
                return orig_phase(*args, **kw)
            finally:
                inside[0] = False

        self._tf, self._orig_head = TF, orig_head
        TF.lm_head = head
        setattr(eng, self.phase, phase)
        return self

    def __exit__(self, *exc):
        self._tf.lm_head = self._orig_head
        delattr(self.eng, self.phase)


def _divergence(serial, serial_at, spec, spec_at) -> dict:
    """Where each request's spec stream first leaves its serial stream:
    the position, both tokens, each engine's top-2 gap there, and the
    largest difference of the two engines' top logits over the agreeing
    positions before it (the noise a tie has to be read against).  A
    report: nothing here is asserted."""
    rows = []
    for uid, (a, b) in enumerate(zip(serial, spec)):
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        row = dict(request=uid, first_divergent=i,
                   agreement=sum(x == y for x, y in zip(a, b)) / len(a))
        if i is not None:
            sa, sb = serial_at[uid, i], spec_at[uid, i]
            noise = max((abs(serial_at[uid, j][1] - spec_at[uid, j][1])
                         for j in range(1, i)), default=0.0)
            row.update(serial_token=a[i], spec_token=b[i],
                       serial_top2_gap=sa[2], spec_top2_gap=sb[2],
                       top_logit_noise_before=noise,
                       gap_within_noise=min(sa[2], sb[2]) <= noise)
        rows.append(row)
    gaps = sorted(v[2] for v in serial_at.values())
    return dict(requests=rows, diverged=sum(r["first_divergent"] is not None
                                            for r in rows),
                median_serial_top2_gap=gaps[len(gaps) // 2] if gaps else None)


# ---------------------------------------------------------------------------
# Phase 7: the cloud tensor-parallel on the one card
# ---------------------------------------------------------------------------


def phase_tp_path(params, cfg, main_res: dict, spec_res: dict) -> dict:
    """The main path's engine, weights and traffic with the cloud suffix,
    its head and its INT8 page pool split over ``make_serve_mesh(model=
    tp)`` shards of the one card (the edge unchanged on the card):
    serially at tp = 2 (three timed repeats, then a profile window),
    with ``spec_k=4`` at tp = 2 (three repeats), serially at tp = 4
    (one).  Every cloud layer's attention is one sharded call of tp
    kernel launches, so ``paged_flash_mq`` launches (prefill calls +
    steps) x (edge layers + tp x cloud layers) times serially — 2,880 at
    tp = 2 and 4,800 at tp = 4 for this traffic, against 1,920 at
    tp = 1 — and ``prefill calls x (layers + tp x cloud layers) + rounds
    x (k x layers + tp x cloud layers)`` with rounds; asserted, with the
    sharded calls and launches.  The serial wire bytes must equal the
    tp = 1 engine's: the mesh moves no byte of the link."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.engine import CollaborativeServingEngine

    n_req, plen, max_new, cut = 8, 128, 32, 14
    channel = Channel.from_kbps(250.0, rtt_ms=20.0)
    prompts = _prompts(n_req, plen, cfg.vocab, seed=0)
    n_layers = cfg.n_layers
    out = {}
    for tag, tp, k, reps in (("serial_tp2", 2, 1, 3), ("spec_tp2", 2, 4, 3),
                             ("serial_tp4", 4, 1, 1)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = CollaborativeServingEngine(
            params, cfg, cut_layer=cut, channel=channel,
            max_len=plen + max_new + 24, spec_k=k,
            mesh=make_serve_mesh(model=tp))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_cloud = eng.n_cloud
        eng.generate(prompts[:1], max_new_tokens=2)           # warm-up
        torch.cuda.synchronize()
        if k == 1:
            def expect(st, tp=tp, n_cloud=n_cloud):
                return ((st.prefill_calls + st.decode_steps)
                        * (n_layers - n_cloud + tp * n_cloud))

            def rounds(st):
                return st.decode_steps
        else:
            def expect(st, tp=tp, n_cloud=n_cloud, k=k):
                return (st.prefill_calls * (n_layers + tp * n_cloud)
                        + st.spec_rounds * (k * n_layers + tp * n_cloud))

            def rounds(st):
                return st.spec_rounds
        runs = []
        for _ in range(reps):
            r = _timed(eng, prompts, max_new, cfg.vocab, expect,
                       f"tp path {tag}")
            st = r["stats"]
            calls = n_cloud * (st.prefill_calls + rounds(st))
            if (r["sharded_calls"], r["sharded_launches"]) != (calls,
                                                                tp * calls):
                raise AssertionError(
                    f"tp path {tag}: {r['sharded_calls']} sharded calls and "
                    f"{r['sharded_launches']} shard launches, expected "
                    f"{calls} and {tp * calls}")
            runs.append(r)
        first, st = runs[0], runs[0]["stats"]
        if k == 1 and st.transmitted_bytes != main_res["transmitted_bytes"]:
            raise AssertionError(
                f"tp path {tag}: {st.transmitted_bytes} wire bytes, the "
                f"tp = 1 engine's {main_res['transmitted_bytes']}")
        base = main_res["outs"] if k == 1 else spec_res["outs"]
        walls = [r["wall"] for r in runs]
        n_tok = sum(len(o) for o in first["outs"])
        res = dict(arch=cfg.name, layers=n_layers, cut=cut, tp=tp, spec_k=k,
                   cloud_blocks=n_cloud, requests=n_req, slots=4,
                   prompt_len=plen, max_new=max_new, reduced=None,
                   setup_s=setup_s, reps=reps, tokens=n_tok,
                   wall_s_reps=walls,
                   tokens_per_s_reps=[n_tok / w for w in walls],
                   tokens_per_s=n_tok / statistics.median(walls),
                   tp1_tokens_per_s=(main_res if k == 1
                                     else spec_res)["tokens_per_s"],
                   streams_repeat_identical=all(r["outs"] == first["outs"]
                                                for r in runs),
                   token_agreement_with_tp1=sum(
                       a == b for o, o1 in zip(first["outs"], base)
                       for a, b in zip(o, o1)) / n_tok,
                   prefill_calls=st.prefill_calls,
                   decode_steps=st.decode_steps, spec_rounds=st.spec_rounds,
                   acceptance_rate=(st.acceptance_rate() if k > 1
                                    else None),
                   launches=first["launches"],
                   expected_launches=expect(st),
                   sharded_calls=first["sharded_calls"],
                   sharded_launches=first["sharded_launches"],
                   int8_matmul_launches=first["int8_matmul_launches"],
                   transmitted_bytes=st.transmitted_bytes,
                   tp1_transmitted_bytes=(main_res if k == 1
                                          else spec_res)["transmitted_bytes"],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   first_output=first["outs"][0])
        emit("tp_path", run=tag, **res)
        if tag == "serial_tp2":
            emit("tp_path_profile", run=tag, requests=n_req, max_new=max_new,
                 **profile_window(
                     lambda: eng.generate(prompts, max_new_tokens=max_new),
                     statistics.median(walls)))
        out[tag] = res
        del eng, runs, first
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the same engine on the card and on the CPU
# ---------------------------------------------------------------------------


PARITY_TOL = 2e-3      # f32 logits, card vs CPU: GEMM summation order
# INT8 default, card vs CPU: a one-ulp difference flips a rounding of the
# Eq.(1) lattice now and then, and the flips move the logits far more
INT8_NOISE_TOL = 0.25


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


def _near_ties(card, cpu, prompts, p_gpu, p_cpu, cfg) -> list:
    """Hold the card's greedy streams to the CPU's: equal, or else at the
    first divergence both devices' teacher-forced f32 logits agree
    within ``PARITY_TOL`` and the CPU's top two lie within twice it."""
    checked = []
    for pr, a, b in zip(prompts, card, cpu):
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
    return checked


class _Decisions:
    """While active, log the argmax and top-2 logits of every
    ``lm_head`` row the engines compute (prefill, draft and verify)."""

    def __enter__(self):
        from repro_torch.models import transformer as TF
        self.log, self._tf, orig = [], TF, TF.lm_head

        def logged(tail, x):
            logits = orig(tail, x)
            top, idx = torch.topk(logits.float(), 2, dim=-1)
            self.log.append((idx[..., 0].cpu().numpy(),
                             top.double().cpu().numpy()))
            return logits

        self._orig, TF.lm_head = orig, logged
        return self

    def __exit__(self, *exc):
        self._tf.lm_head = self._orig


def _int8_divergence(card, cpu) -> dict:
    """Walk two devices' decision logs in step.  Until the first row
    whose argmax differs, the top logits of every row must agree within
    ``INT8_NOISE_TOL``; at that row, one device's top two must lie
    closer together than the largest difference seen so far (a tie
    within the devices' own noise)."""
    noise = 0.0
    for n, ((ia, va), (ib, vb)) in enumerate(zip(card, cpu)):
        if ia.shape != ib.shape:
            raise AssertionError(f"INT8 decision {n}: shapes {ia.shape} "
                                 f"vs {ib.shape} before any divergence")
        same = ia == ib
        if same.any():
            noise = max(noise, float(np.abs(va[..., 0] - vb[..., 0])[same]
                                     .max()))
        if noise > INT8_NOISE_TOL:
            raise AssertionError(f"INT8 card vs CPU logits differ by "
                                 f"{noise} > {INT8_NOISE_TOL}")
        if not same.all():
            j = tuple(np.argwhere(~same)[0])
            gaps = (float(va[j][0] - va[j][1]), float(vb[j][0] - vb[j][1]))
            if min(gaps) > noise:
                raise AssertionError(
                    f"INT8 card and CPU diverge at decision {n} without a "
                    f"tie: top-2 gaps {gaps}, noise {noise}")
            return dict(decision=n, of=len(cpu), top2_gaps=gaps,
                        noise=noise)
    if len(card) != len(cpu):
        raise AssertionError("INT8 decision logs differ in length")
    return dict(decision=None, of=len(cpu), noise=noise)


def phase_path_parity() -> None:
    """The collaborative engine at full width, 2 layers, f32, on the card
    and on the CPU (the CPU port is held to the JAX engines by
    ``tests/test_torch_serve.py`` and ``tests/test_torch_spec.py``):

    * lossless, serial and ``spec_k=4``: both card streams against the
      CPU's serial stream, up to near-ties (``_near_ties``);
    * the INT8 default (INT8 pages on both sides, INT8 draft cache):
      on each device the ``spec_k=4`` stream must equal the serial one,
      as the JAX engines' do (the verify's INT8 page writes at S = 4,
      the draft cache and the accept counts feed every committed
      token); the card's serial decisions are held to the CPU's up to
      the first tie (``_int8_divergence``);
    * the cloud tensor-parallel over ``make_serve_mesh(model=2)``: the
      card's lossless stream against the card's tp = 1 stream and the
      CPU's tp = 2 stream, up to near-ties; in the INT8 default the
      ``spec_k=4`` stream equal to the serial one on each device."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_serve_mesh
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
    lossless = dict(a_bits=None, edge_int8=False, cloud_int8=False)
    runs, logs = {}, {}
    for tag, dev, p, kw in (
            ("lossless", "cuda", p_gpu, lossless),
            ("lossless", "cpu", p_cpu, lossless),
            ("lossless_spec", "cuda", p_gpu, dict(lossless, spec_k=4)),
            ("int8", "cuda", p_gpu, {}), ("int8", "cpu", p_cpu, {}),
            ("int8_spec", "cuda", p_gpu, dict(spec_k=4)),
            ("int8_spec", "cpu", p_cpu, dict(spec_k=4)),
            ("lossless_tp2", "cuda", p_gpu, lossless),
            ("lossless_tp2", "cpu", p_cpu, lossless),
            ("int8_tp2", "cuda", p_gpu, {}), ("int8_tp2", "cpu", p_cpu, {}),
            ("int8_spec_tp2", "cuda", p_gpu, dict(spec_k=4)),
            ("int8_spec_tp2", "cpu", p_cpu, dict(spec_k=4))):
        if tag.endswith("_tp2"):
            kw = dict(kw, mesh=make_serve_mesh(model=2, device=dev))
        eng = CollaborativeServingEngine(p, cfg, device=dev, cut_layer=0,
                                         max_len=64, **kw)
        with _Decisions() as d:
            runs[tag, dev] = (eng.generate(prompts, max_new_tokens=8),
                              eng.stats)
        logs[tag, dev] = d.log
    cpu_serial = runs["lossless", "cpu"][0]
    checked = {tag: _near_ties(runs[tag, "cuda"][0], cpu_serial, prompts,
                               p_gpu, p_cpu, cfg)
               for tag in ("lossless", "lossless_spec")}
    tp2 = runs["lossless_tp2", "cuda"][0]
    checked["tp2_vs_tp1"] = _near_ties(tp2, runs["lossless", "cuda"][0],
                                       prompts, p_gpu, p_cpu, cfg)
    checked["tp2_vs_cpu_tp2"] = _near_ties(
        tp2, runs["lossless_tp2", "cpu"][0], prompts, p_gpu, p_cpu, cfg)
    for dev in ("cuda", "cpu"):
        for sfx in ("", "_tp2"):
            if runs["int8_spec" + sfx, dev][0] != runs["int8" + sfx, dev][0]:
                raise AssertionError(f"INT8 spec stream differs from the "
                                     f"serial one on {dev}{sfx}")
    div = _int8_divergence(logs["int8", "cuda"], logs["int8", "cpu"])
    card, cpu = runs["int8", "cuda"][0], runs["int8", "cpu"][0]
    emit("path_parity", arch=cfg.name, layers=cfg.n_layers,
         dtype="float32", requests=len(prompts), tol=PARITY_TOL,
         identical=runs["lossless", "cuda"][0] == cpu_serial,
         near_ties=checked["lossless"],
         spec_identical=runs["lossless_spec", "cuda"][0] == cpu_serial,
         spec_near_ties=checked["lossless_spec"],
         int8_spec_equals_serial=True,
         int8_spec_draft_hits={dev: runs["int8_spec", dev][1].draft_hits
                               for dev in ("cuda", "cpu")},
         int8_spec_drafted=runs["int8_spec", "cpu"][1].drafted_tokens,
         int8_card_vs_cpu_identical=card == cpu,
         int8_card_vs_cpu_first_token_equal=[a[0] == b[0]
                                             for a, b in zip(card, cpu)],
         int8_divergence=div, int8_noise_tol=INT8_NOISE_TOL,
         tp2_identical_to_tp1=tp2 == runs["lossless", "cuda"][0],
         tp2_near_ties_vs_tp1=checked["tp2_vs_tp1"],
         tp2_identical_to_cpu_tp2=tp2 == runs["lossless_tp2", "cpu"][0],
         tp2_near_ties_vs_cpu_tp2=checked["tp2_vs_cpu_tp2"],
         int8_tp2_spec_equals_serial=True,
         int8_tp2_equals_tp1={dev: runs["int8_tp2", dev][0]
                              == runs["int8", dev][0]
                              for dev in ("cuda", "cpu")})


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
    sres = phase_sharded_kernels()
    ires = phase_int8_kernels()
    if args.only == "kernels":
        return 0
    # one seeded set of deepseek-7b weights for phases 4-6
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_lm
    cfg = get_arch("deepseek-7b").full
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    torch.cuda.synchronize()
    emit("weights", arch=cfg.name, seed=0, init_s=time.perf_counter() - t0,
         gb=torch.cuda.memory_allocated() / 1e9)
    phase_quantized_dense(params, cfg)
    main_res = phase_main_path(params, cfg)
    spec_res = phase_spec_path(params, cfg, main_res)
    tp_res = phase_tp_path(params, cfg, main_res, spec_res)
    del params
    torch.cuda.empty_cache()
    phase_path_parity()
    # each summary row is the kernel's main-path shape: the decode step
    # of 4 slots (int8_matmul: gate/up at M = 4; the serving path does
    # not call it, so its main-path count is 0 — read, not assumed)
    dec = next(r for r in kres if r["shape"] == "deepseek7b_decode_int8")
    sdec = next(r for r in sres
                if r["shape"] == "deepseek7b_decode_int8_tp2")
    mm = next(r for r in ires if r["shape"] == "int8mm_m4_4096x11008")
    print(json.dumps({"kernels": [{
        "name": "paged_flash_mq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:213",
        "launches": main_res["launches"],
        "spec_path_launches": spec_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kres),
        "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None, "shape": dec["shape"]}, {
        # B3: per-shard numbers (each shard's launch, its bound); the
        # launches are the shard launches of the serial tp = 2 run
        "name": "paged_flash_mq_sharded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:304",
        "launches": tp_res["serial_tp2"]["sharded_launches"],
        "tp4_launches": tp_res["serial_tp4"]["sharded_launches"],
        "spec_path_launches": tp_res["spec_tp2"]["sharded_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in sres),
        "ms": sdec["kernel_ms"], "sum_ms": sdec["sum_kernel_ms"],
        "plain_ms": sdec["plain_ms"], "bound_ms": sdec["bound_ms"],
        "bound_by": sdec["bound_by"], "library_ms": None, "tp": 2,
        "shape": sdec["shape"]}, {
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:139",
        "launches": main_res["int8_matmul_launches"],
        "spec_path_launches": spec_res["int8_matmul_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in ires
                           if r["out_dtype"] == "torch.float32"),
        "ms": mm["kernel_ms"], "plain_ms": mm["plain_ms"],
        "bound_ms": mm["bound_ms"], "bound_by": mm["bound_by"],
        "library_ms": None, "int_mm_ms": mm["int_mm_ms"],
        "shape": mm["shape"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
