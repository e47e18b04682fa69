"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. ``device``     — the card's name and power limit.
2. ``build``      — compile every hand-written CUDA kernel from
                    ``src/repro_torch/kernels/csrc``, one ``nvcc`` per
                    source, all started together on a thread of their
                    own; each kernel's registers and spills (``-Xptxas
                    -v``), and opcode counts of the split-K and wgmma
                    INT8 kernels' SASS.  Phase 12 (``cnn_path``, which
                    launches no kernel of the port) runs on the card
                    while ``nvcc`` compiles; the ``build`` line follows
                    it.
3. ``kernels``    — each kernel against its plain PyTorch version on the
                    card: ``paged_flash_mq`` at the shapes the main path
                    gives it (decode, prefill, speculative verify, the
                    resilient engine's resync replay, the fleet's
                    verify with rows on the dump page), at
                    qwen3-moe's group of 8 (decode on the split kernel,
                    a ``spec_k=4`` verify and a prefill on the
                    tensor-core kernel) and at
                    a 4,096-position decode, its tensor-parallel form
                    ``paged_flash_mq_sharded`` at the same int8 shapes
                    split over 2 and 4 shards of the one card (per-shard
                    and summed times, the per-shard bound), the fused
                    ``int8_matmul`` at deepseek-7b's edge GEMM shapes
                    (its split-K cluster kernel at M <= 32 and its wgmma
                    kernel at M 512 on packed weights, each checked bit
                    for bit against the tiled kernel and timed beside
                    it, ``prev_ms``; the front door on an unpacked weight,
                    pack included; ``torch._int_mm`` with B N- and
                    K-major as yardsticks); error, kernel / plain times
                    and the roofline bound; the pack kernel against its
                    plain version.  Then ``int8_threshold``: split-K
                    against tiled at M = 1 .. 32, the split-K kernel over
                    cluster sizes, and wgmma against tiled (and split-K
                    at 32) at M = 32 .. 512 with the wgmma plans at 512;
                    ``int8_floor``: each design's launch floor;
                    ``int8_epilogues``: the wgmma and tiled kernels per
                    activation and output type.
                    ``paged_flash_mq`` runs its split-KV kernel at decode
                    and verify (with the split count) and its tensor-core
                    kernel at prefill; at every shape the first port's
                    tiled kernel (``paged_flash_mq_tiled``) is checked
                    and timed beside it (``prev_ms``), and the
                    tensor-core kernel must be the faster of the two.
4. ``quantized_dense`` — the INT8 GEMM's front door at full width on the
                    main path's own activations and layer-0 weights
                    (packed once: one wgmma launch and no pack a weight),
                    against its plain version and the f32 product.
5. ``main_path``  — ``CollaborativeServingEngine`` on deepseek-7b at full
                    width and depth (bf16, random seeded weights), INT8
                    paged KV on both sides of cut 14, timed in turns with
                    the cloud-only ``ServingEngine`` on the same weights;
                    every kernel's launch count on each run is checked
                    (the tensor-core prefill kernel's among them).
                    Then one ``torch.profiler`` window of the
                    collaborative engine on the same traffic, after all
                    the timed runs (the cloud-only engine's: cut for
                    time, PERF.md §5 keeps its numbers).
6. ``spec_path``  — the same engine, weights and traffic with speculative
                    draft/verify rounds (``spec_k=4``), full width and
                    depth: tokens/s, rounds, acceptance, wire bytes, and
                    the launch count the rounds imply (no profile
                    window: cut for time, PERF.md §5 keeps AN's).
                    Then, untimed, where the spec stream first leaves the
                    serial one, with each side's top-2 logit gap there;
                    every first token held to the serial one by its
                    prefill logits (``_index0``: equal in the same
                    prefill group, else a near-tie).
7. ``sampled_path`` — the same engine, weights and traffic, sampled
                    (``temperature=0.8, top_p=0.9``, request i with seed
                    i), serially and with ``spec_k=4``, each on two fresh
                    engines (one timed run each; no profile window, cut
                    for time): tokens/s, acceptance, tokens per round,
                    B1 launches (split and tensor-core; asserted at the
                    greedy paths' formulas).  Checked: the fresh
                    engines' streams identical; a ``temperature=0`` run
                    equal to the greedy main path, entering no sampled
                    phase; serial and spec equal at output index 0
                    (``_index0``, as in the spec path); the
                    card's threefry keys, uniforms and a [16, 102400] draw
                    equal to the CPU's (``sampling_ops``); wire bytes equal
                    to the greedy serial run's and, with ``spec_k=4``, to
                    the rounds' greedy framing plus the f32 draft rows.
8. ``tp_path``    — the same engine, weights and traffic with the cloud
                    tensor-parallel over ``make_serve_mesh(model=2)`` on
                    the one card, serially and with ``spec_k=4``, then
                    ``model=4`` serially, one timed run each: tokens/s, launches,
                    sharded calls, wire bytes, peak memory; the launch
                    counts and the serial wire bytes are asserted.
9. ``adaptive_path`` — the online control loop on the same weights at
                    full width and depth, 8 requests x 32 new tokens:
                    (a) ``policy="auto"`` from cut 14 over a
                    ``DriftingChannel`` (250 KB/s at 20 ms, then 50 KB/s
                    at 100 ms): the predicted single switch to cut 0 on
                    the first turn, no hold, no k switch, each decision
                    equal to ``tune_cut_and_k``'s, stream and wire bytes
                    equal to a fixed cut-0 engine's; (b) a scripted
                    policy: a warm k raise (draft rebuild), a drained
                    switch to cut 28, a drop to k 1 and a warm raise
                    back, the counts asserted, the requests served
                    before the switch equal to a fixed cut-14 engine's.
                    Tokens/s, simulated channel s, decisions, launches.
10. ``overload_path`` — demand paging, deadline admission and a pool
                    squeeze on the same weights at full width and
                    depth: 8 requests x 64 new tokens, half at priority
                    1, arriving 1 s apart, on half the worst-case pages;
                    asserted: at least one preemption, the two doomed
                    requests shed, every other request its whole
                    budget, the simulated clock equal to channel time
                    plus stall waits, every page back; tokens/s and
                    B1's split and tensor-core launches beside a
                    worst-case engine on the same traffic.
10b. ``resilient_path`` — ``ResilientCollaborativeEngine`` on the same
                    weights and traffic at full width and depth over the
                    main path's link with 5 % drops and two outage
                    windows, at ``spec_k=1`` and ``spec_k=4``, beside
                    the plain engine stalling through the windows:
                    tokens/s, simulated channel s, edge-only tokens,
                    resyncs, outage s, retries, timeouts, B1 launches by
                    phase (the resync replay's tensor-core kernel at
                    ``q_start > 0`` asserted); every budget served, two
                    resyncs, the cloud up and every page back at the
                    end, the k = 1 counts equal to a CPU rehearsal, and
                    the tokens before the first outage equal to the
                    fault-free streams.
10c. ``fleet_path`` — ``FleetServingEngine`` on the same weights at full
                    width and depth: four tenants (cuts 14 and 28, k 4
                    and 1, the reference benchmark's links, one a storm
                    with drops and an outage), 2 requests x 32 new
                    tokens each, 8 slots; asserted: every budget, every
                    page back, finite caches, each tenant's stream equal
                    to a solo engine's at the fleet's batch shape, the
                    k = 1 counters and the storm's clock equal to a CPU
                    rehearsal, calm tenants fault-free, B1 launches by
                    phase as the group calls imply; then a cross-tenant
                    preemption run (hog preempted, meek never, counts as
                    rehearsed).  Reported: round calls, tokens/s beside
                    the solo engines run one after another, peak memory,
                    where the tenants' own solo streams (at 8 and 2
                    slots) leave the fleet's.
10d. ``dense_path`` — the dense KV caches on the same weights at full
                    width and depth, cut 14, the main path's traffic:
                    (a) the collaborative engine with dense caches on
                    both sides (INT8 edge, fp cloud) timed in turns with
                    the paged engine (wire bytes, prefill calls and
                    decode steps equal, ``edge_cache_bytes`` by formula:
                    asserted), (b) at ``spec_k=4``, (c) the cloud-only
                    engine dense and paged in turns, (d) the seed
                    recompute path (wire bytes by formula; at a 16-bit
                    lattice each first token held to the dense
                    incremental engine's by prefill logits), (e) the
                    paper's ``CollaborativeEngine`` on the LM's block
                    segments at ``blk14/ffn``, batch 1 and 4, (f) card
                    against CPU at 3 layers (``path_parity_dense``, run
                    by phase 11's process:
                    dense INT8 attention at a scalar and a per-row
                    index, ``_sdpa``'s ``q_chunk``, the dense lossless
                    and seed streams, the dense INT8 decisions).  Every
                    kernel's launches over (a)-(e) read and asserted 0.
10f. ``train_path`` — training, last on the deepseek-7b weights (it
                    updates them), inside
                    ``torch.use_deterministic_algorithms(True,
                    warn_only=True)``: (a) the reference's train cell at
                    full width and depth, ``train_4k`` at seq 4096 with
                    the global batch cut 256 → 4 (accumulation 4 of 1 x
                    4096), remat, 8-bit AdamW (the rule's pick and the
                    reference's state shapes asserted), lr 3e-4, one
                    warm and two timed steps: losses and grad norms
                    finite, every weight matrix moved and every leaf's
                    moment non-zero (asserted; a bf16 norm scale of 1.0
                    need not move at lr 3e-4); step s,
                    tokens/s, model flops/s against the bf16 peak, peak
                    memory, a checkpoint's bytes (computed), one more
                    step under the profiler (device busy, idle share,
                    top kernels); (b) QAT
                    through the ``Trainer`` at 2 of the 30 layers (INT8
                    gradient compression, f32 AdamW, cosine schedule,
                    accumulation 2, 4 steps), one async checkpoint in a
                    temporary directory (free disk checked first)
                    restored by a fresh ``Trainer`` bit for bit
                    (asserted), its bytes and seconds, fp and
                    INT8-lattice eval losses; (c) card against CPU at 3
                    layers, f32: the STE's forward and gradient mask
                    (equal), a train-cell step (within
                    ``TRAIN_LOSS_RTOL``, ``2 lr`` and
                    ``TRAIN_FLIP_SHARE``) and a QAT ``Trainer`` step
                    (``QAT_LOSS_RTOL``, ``QAT_FLIP_SHARE``: activation
                    lattice flips), a ``TrainSupervisor`` run with
                    two worker failures equal to an uninterrupted one
                    (and whether two runs agree with determinism off).
                    Every kernel's launches read and asserted 0.
10e. ``moe_path`` — qwen3-moe-30b-a3b at its published width (bf16,
                    128 experts, top 8; seeded random weights drawn on
                    the card a layer at a time) on the main path's
                    traffic, after deepseek-7b's weights are released:
                    (a) the collaborative engine at cut 2, all 48
                    layers, one timed run (wire bytes by formula,
                    B1's split and tensor-core launches as the schedule
                    implies, no B4 launch: asserted; tokens/s, peak
                    memory, a profile window), (b) the cloud-only engine
                    over bf16 pages, (c) ``spec_k=4`` at 12 of the 48
                    layers (the verify's 32 rows a kv head on the
                    tensor-core kernel, asserted), and
                    ``path_parity_moe`` (run by phase 11's process): a
                    3-layer full-width f32 model
                    on the card and the CPU — ``moe`` at a 4-row decode
                    and a 512-row prefill that overflows capacity
                    (routing and drops equal up to gate near-ties,
                    outputs within ``MOE_TOL``, two card runs bit
                    identical) and the engines' streams and decisions
                    up to near-ties.  Device memory is back under 1 GB
                    after (a)-(c) (asserted).
10g. ``diffusion_path`` — (run during the build, after phase 12; (d)
                    after phase 11's process is joined, on the deepseek-7b
                    weights; (e) in that process) the diffusion families
                    at their published widths (bf16, seeded weights):
                    (a) unet-sd15's ``gen_fast`` 4-step DDIM sampler at
                    batch 16, 512², through the denoise cell, and
                    ``gen_1024`` at batch 4 (the ``q_chunk`` path), one
                    warm and one timed step; (b) flux-dev, all 19 + 38
                    blocks: ``gen_fast``'s 4 Euler steps at batch 16 and
                    ``gen_1024`` at batch 4 (4,608 tokens); (c) the train
                    cells: unet-sd15 ``train_256`` at batch 8 (f32 AdamW,
                    the rule's pick asserted), flux-dev ``train_256`` at
                    2 + 2 of its blocks, batch 2: losses finite, every
                    weight matrix moved; (d) deepseek-7b's ``prefill_32k``
                    cell at batch 1 and ``decode_32k`` at batch 2 on a
                    32,768-position dense cache; (e) card against CPU in
                    f32 (``diffusion_path_parity``: one denoise step of
                    unet-sd15 at full widths, one res block a stage, 128²,
                    and of flux-dev at full width, 1 + 1 blocks, 256²).
                    Step s, images/s, model flops/s against the bf16
                    peak, peak memory; one profiled step a model (device
                    busy, idle share, top kernels).  Every kernel's
                    launches over (a)-(d) read and asserted 0.
11. ``path_parity``— (with ``path_parity_dense``, ``path_parity_moe`` and
                    ``diffusion_path_parity``:
                    in a process of its own, ``ParityWorker``, from the
                    end of phase 3 until before phase 10f; its lines
                    are printed when it is joined)
                    the collaborative engine at full width, 2 layers, f32,
                    on the card and on the CPU: lossless serial and
                    speculative streams must match the CPU's serial one
                    (or, at a near-tie, the teacher-forced logits), and a
                    lossless sampled stream the CPU's exactly; in
                    the INT8 default the ``spec_k=4`` stream must equal
                    the serial one on each device, and the card's
                    decisions the CPU's up to a tie; at tp = 2 on the
                    card, the lossless stream against tp = 1 and the
                    CPU's tp = 2 up to near-ties, and the INT8
                    ``spec_k=4`` stream equal to the serial one on each
                    device.  Then ``path_parity_control`` at 3 layers:
                    a scripted cut switch with warm k raises against the
                    fixed-cut stream, a demand-paged engine preempting
                    under a pool squeeze against the worst-case engine,
                    and each card stream against the CPU's (equal, or a
                    near-tie at the first divergence); then
                    ``path_parity_resilient``: the resilient engine
                    through drops and two outages, lossless at k = 1 and
                    4 and sampled at k = 1, equal to the fault-free
                    streams on each device, its k = 1 counters and
                    ``round_log`` equal card vs CPU; then
                    ``path_parity_fleet``: the four-tenant fleet,
                    lossless, equal to the solo engines on each device,
                    its streams and counters card vs CPU.
12. ``cnn_path`` — (run during the build, before phase 3)
                    collaborative split inference of the image models
                    (``core.collab``): the paper's AlexNet, VGG16 and
                    GoogLeNet, and ResNet-18, ResNet-152, ViT-S/16,
                    DeiT-B and ViT-H/14, at full width and depth (but
                    ViT-H/14 at 8 of its 32 blocks and ResNet-152 at
                    26 of its 50, ``CNN_DEPTH``) and
                    their published resolutions, f32 (the one departure
                    from the published configs, which say bf16 for all
                    of them but ResNet-18: the reference's engine fails
                    in bf16), seeded random weights; at every engine
                    cut a calibrated INT8-edge / fp32-cloud engine: edge
                    and cloud ms and images/s at batch 1 and 32, blob
                    bytes (asserted against the graph at every cut),
                    int8 download, fp32 error; Algorithm 1's Table 3
                    picks (asserted: the JAX package's); AlexNet
                    ``conv5``, GoogLeNet ``conv2``, ResNet-18
                    ``s1b0/body`` and ViT-S/16 ``blk0/ffn`` card
                    against CPU (fp32 output, scales, the boundary
                    lattice of one float tensor exact, the last edge
                    segment's lattices teacher-forced one by one, its
                    float output, INT8 output; the lattice with only
                    the segment's input forced and end to end
                    reported).  No kernel is on this path (launches
                    read: 0).

Then a ``{"kernels": [...]}`` summary line (each row with its
``cnn_path_launches``, ``adaptive_path_launches``,
``overload_path_launches``, ``resilient_path_launches``,
``fleet_path_launches``, ``dense_path_launches``,
``train_path_launches``, ``moe_path_launches`` and
``diffusion_path_launches``), the
``nvidia-smi`` name and
power-limit line, and last the ``{"ok": true, "device": ...}`` line.
Needs no network; exits non-zero without printing a result when no CUDA
device is present or the repository's ``src/`` is missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import platform
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_FLOPS = 67e12                  # H100 SXM f32 peak outside tensor cores
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
# bf16 tensor-core products the prefill kernel issues per f32 product:
# q and the weights split into hi + lo, f32 pages' K and V too
TC_PRODUCTS = {torch.int8: 2, torch.bfloat16: 2, torch.float32: 3}
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
KERNEL_TOL = 1e-4                  # |kernel - plain| / max|plain|
INT8_RTOL, INT8_ATOL = 1e-5, 1e-4  # the JAX suite's f32 epilogue tolerance
# Algorithm 1's pick on each of the paper's CNNs at its Table 3 bandwidth
# (KB/s), as the JAX package computes it (tests/test_torch_legacy.py
# holds these against it); the paper's own cuts are conv5, conv1_2, conv2
# and, for ResNet-18, res4a
TABLE3_PICKS = {"alexnet": (250, "conv1"), "vgg16": (240, "input"),
                "googlenet": (180, "fc"), "resnet-18": (70, "head")}


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


def start_build():
    """Start the build on a thread of its own and return its future: every
    hand-written kernel compiled (``_build.build_all``: one ``nvcc`` per
    source, all started together), then the SASS reports.  The card is
    free meanwhile: ``main`` runs the CNN path, which launches no kernel
    of the port, while ``nvcc`` compiles."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def work():
        t0 = time.perf_counter()
        logs = _build.build_all()
        secs = time.perf_counter() - t0
        return dict(
            sources=sorted(logs), seconds=secs,
            ptxas=[f"{name}: {use}" for log in logs.values()
                   for name, use in _ptxas_report(log)],
            ptxas_warnings=[ln.strip() for log in logs.values()
                            for ln in log.splitlines() if "warning" in ln],
            splitk_sass=_sass_counts(
                _build._lib_path("int8_matmul"),
                "int8_matmul_splitk_kernelILi0ELi0ELi1E"),
            wgmma_sass=_sass_counts(
                _build._lib_path("int8_matmul_sm90"),
                "int8_matmul_wgmma_kernelILi0ELi0ELi128E"),
            wgmma_sass_sizes=_sass_sizes(_build._lib_path("int8_matmul_sm90"),
                                         "int8_matmul_wgmma_kernel"),
            reports_s=time.perf_counter() - t0 - secs)

    pool = ThreadPoolExecutor(1)
    fut = pool.submit(work)
    pool.shutdown(wait=False)
    return fut


def phase_build(build) -> None:
    """Wait for ``start_build``'s future and print its line; a failed
    ``nvcc`` raises here."""
    t0 = time.perf_counter()
    fields = build.result()
    emit("build", **fields, waited_s=time.perf_counter() - t0)


def _ptxas_report(log: str) -> list:
    """(kernel, "N registers, S spill bytes") per entry function of an
    ``nvcc -Xptxas -v`` log, the kernel named by its template arguments."""
    import re
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill stores" in ln:
            spill = ln.strip().split(", ", 1)[-1]
        elif "Used" in ln and "registers" in ln and name:
            rows.append((name, ln.split("Used", 1)[1].strip() + "; "
                         + spill))
            name = None
    return rows


def _kernel_name(mangled: str) -> str:
    """``name<i, j, ..>`` of a mangled kernel: the length-prefixed
    identifier ending in ``_kernel`` and its integer template arguments."""
    import re
    for m in re.finditer(r"\d+", mangled):
        ident = mangled[m.end():m.end() + int(m.group())]
        if ident.endswith("_kernel") and ident.isidentifier():
            args = re.findall(r"Li(\d+)E", mangled[m.end() + len(ident):])
            return ident + "<" + ",".join(args) + ">"
    return mangled


@functools.lru_cache(maxsize=None)
def _sass(lib) -> str:
    """``cuobjdump -sass`` of a built library, or "" where there is none."""
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" \
        / "cuobjdump"
    if not tool.exists():
        return ""
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout


def _sass_sizes(lib, kernel: str) -> dict:
    """Instructions in the SASS of every instance of ``kernel``, by its
    template arguments."""
    import re
    sizes = {}
    for part in _sass(lib).split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        if kernel in name:
            sizes[_kernel_name(name)] = len(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?[A-Z]", part))
    return sizes


def _sass_counts(lib, function: str) -> dict:
    """Opcode counts in the SASS of the one kernel whose mangled name
    holds ``function`` (``cuobjdump -sass`` of the built library; static
    counts over the whole kernel), or a reason where none is possible."""
    import re
    out = _sass(lib)
    if not out:
        return {"error": "cuobjdump not found"}
    body = None
    for part in out.split("Function : ")[1:]:
        if function in part.split("\n", 1)[0]:
            body = part
    if body is None:
        return {"error": f"{function} not in the SASS"}
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     body)
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    keep = ("PRMT", "IMMA", "IDP", "LDS", "LDGSTS", "LDSM", "BAR", "UCGABAR_ARV",
            "UCGABAR_WAIT", "LD", "STG", "IGMMA", "UTMALDG", "SYNCS", "WARPGROUP")
    return dict(total=len(ops), **{k: counts.get(k, 0) for k in keep})


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
    """(bytes, flops) this call's data needs: the K/V positions of each
    page that some row's valid span reaches, read once however many rows
    reach them (rows on a zeroed block-table row all read the dump page
    0), q read and out written once; QK and AV over the valid (query,
    key) pairs."""
    q, (kp, _), bt = c["q"], c["pools"][0], c["bt"]
    b, s, n_heads, hd = q.shape
    page, n_kv = kp.shape[1], kp.shape[2]
    lens = c["lens"].cpu().numpy()
    qs = c["qs"].cpu().numpy()
    table = bt.cpu().numpy()
    span = table.shape[1] * page
    used, pairs = {}, 0          # page id -> positions read in it
    for i in range(b):
        qpos = qs[i] + np.arange(s)
        n_valid = np.clip(np.minimum(qpos + 1, lens[i]), 0, span)
        pairs += int(n_valid.sum())
        kv = int(min(lens[i], qs[i] + s, span)) if lens[i] > 0 else 0
        for j in range(-(-kv // page)):
            pid = int(table[i, j])
            used[pid] = max(used.get(pid, 0), min(page, kv - j * page))
    kv_pos = sum(used.values())
    nbytes = (2 * kv_pos * n_kv * hd * kp.element_size()
              + 2 * q.numel() * 4 + bt.numel() * 4 + 2 * b * 4
              + (2 * b * n_kv * 4 if c["ks"] is not None else 0))
    flops = 4 * pairs * n_heads * hd
    return nbytes, flops


def _ops_ms(flops, plan, page_dtype) -> float:
    """The operations term of a paged call's bound, in ms: f32 products
    at the CUDA-core rate for the split kernel (``plan`` set), bf16
    tensor-core products (``TC_PRODUCTS`` per f32 product) at the dense
    bf16 rate for the tensor-core kernel."""
    if plan:
        return flops / F32_FLOPS * 1e3
    return flops * TC_PRODUCTS[page_dtype] / BF16_FLOPS * 1e3


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


def _split_plan(PA, q, k_pages, bt):
    """(chunk, n_splits) of the split kernel at this call's shape, or None
    where ``paged_flash_mq`` takes the tensor-core kernel (more than 16
    query rows per kv head)."""
    b, s, n_heads, _ = q.shape
    n_kv = k_pages.shape[2]
    if s * (n_heads // n_kv) > PA._SPLIT_ROWS:
        return None
    return PA._plan_splits(b, n_kv, bt.shape[1], k_pages.shape[1])


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
    # the resilient engine's resync replay: R = 24 buffered rows per slot
    # from each slot's own resume position (tensor-core kernel at
    # q_start > 0), one slot riding along at position 0 on a zeroed
    # block-table row (it reads and writes the dump page)
    replay = _paged_case(
        "deepseek7b_replay_int8", b=4, s=24, n_heads=32, n_kv=32, hd=128,
        page=16, lengths=[124, 148, 164, 24], q_start=[100, 124, 140, 0],
        page_dtype=torch.int8, scales=True, seed=7, copies=8)
    replay["bt"][3] = 0
    cases.append(replay)
    # the fleet's verify: one (cut, k = 4) group's round over the whole
    # slot axis, the rows of the other groups riding along on zeroed
    # block-table rows (``_PagedPool.table_for``: they read and write the
    # dump page)
    lengths_fleet = [164, 100, 131, 36, 150, 140, 60, 170]
    fleet = _paged_case(
        "deepseek7b_fleet_verify_int8", b=8, s=4, n_heads=32, n_kv=32,
        hd=128, page=16, lengths=lengths_fleet,
        q_start=[n - 4 for n in lengths_fleet], page_dtype=torch.int8,
        scales=True, seed=8, copies=24)
    fleet["bt"][1::2] = 0
    cases.append(fleet)
    cases.append(_paged_case(
        "phi3_medium_gqa_decode_int8", b=4, s=1, n_heads=40, n_kv=10,
        hd=128, page=16, lengths=lengths_dec,
        q_start=[max(n - 1, 0) for n in lengths_dec],
        page_dtype=torch.int8, scales=True, seed=3, copies=24))
    cases.append(_paged_case(
        "phi3_medium_gqa_prefill_int8", b=4, s=128, n_heads=40, n_kv=10,
        hd=128, page=16, lengths=[128, 100, 128, 77], q_start=[0] * 4,
        page_dtype=torch.int8, scales=True, seed=4, copies=8))
    # qwen3-moe-30b-a3b's attention: 32 query heads over 4 kv heads (a
    # group of 8), hd 128 — decode stacks 8 rows on the split kernel,
    # a spec_k=4 verify 32 and a prefill 1,024 on the tensor-core kernel
    cases.append(_paged_case(
        "qwen3moe_decode_int8", b=4, s=1, n_heads=32, n_kv=4, hd=128,
        page=16, lengths=lengths_dec,
        q_start=[max(n - 1, 0) for n in lengths_dec],
        page_dtype=torch.int8, scales=True, seed=9, copies=24))
    cases.append(_paged_case(
        "qwen3moe_verify_int8", b=4, s=4, n_heads=32, n_kv=4, hd=128,
        page=16, lengths=lengths_ver, q_start=[n - 4 for n in lengths_ver],
        page_dtype=torch.int8, scales=True, seed=10, copies=24))
    cases.append(_paged_case(
        "qwen3moe_prefill_int8", b=4, s=128, n_heads=32, n_kv=4, hd=128,
        page=16, lengths=[128, 100, 128, 77], q_start=[0] * 4,
        page_dtype=torch.int8, scales=True, seed=11, copies=8))
    # a long context: the split kernel's chunk grows past one tile, the
    # tiled kernel walks 128 tiles in series; 4 pool copies of 134 MB
    lengths_long = [4096, 3000, 4096, 1024]
    cases.append(_paged_case(
        "deepseek7b_decode_int8_ctx4096", b=4, s=1, n_heads=32, n_kv=32,
        hd=128, page=16, lengths=lengths_long,
        q_start=[n - 1 for n in lengths_long], page_dtype=torch.int8,
        scales=True, seed=6, copies=4))

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

        def run_prev():
            k_, v_ = c["pools"][next(it) % n]
            PA.paged_flash_mq_tiled(c["q"], k_, v_, *args)

        sdpa = _sdpa_pregathered(c)
        plan = _split_plan(PA, c["q"], kp, c["bt"])
        # plain, tiled, kernel, kernel, tiled, plain: the versions in
        # turns.  The device times replay CUDA graphs; the call times are
        # eager calls back to back, where the host's per-call work shows.
        # The first port's tiled kernel (the serving path's kernel at
        # every shape until the split and tensor-core designs) is checked
        # and timed beside the kernel
        prev_out = PA.paged_flash_mq_tiled(c["q"], kp, vp, *args)
        torch.cuda.synchronize()
        prev = dict(prev_max_abs_err=float((prev_out - plain).abs().max()))
        if not prev["prev_max_abs_err"] <= tol:
            raise AssertionError(f"{c['name']}: tiled kernel vs plain "
                                 f"max abs err {prev['prev_max_abs_err']}"
                                 f" > tol {tol}")
        plain_ms = graph_ms(run_plain)
        prev["prev_ms"] = graph_ms(run_prev)
        kernel_ms = graph_ms(run_kernel)
        kernel_call_ms = cuda_ms(run_kernel)
        kernel_ms = min(kernel_ms, graph_ms(run_kernel))
        prev["prev_ms"] = min(prev["prev_ms"], graph_ms(run_prev))
        prev["prev_call_ms"] = cuda_ms(run_prev)
        plain_ms = min(plain_ms, graph_ms(run_plain))
        plain_call_ms = cuda_ms(run_plain, iters=10)
        sdpa_ms = graph_ms(sdpa)
        if not plan and not kernel_ms < prev["prev_ms"]:
            raise AssertionError(f"{c['name']}: tensor-core kernel {kernel_ms}"
                                 f" ms, not below the tiled kernel's "
                                 f"{prev['prev_ms']}")
        nbytes, flops = _paged_work(c)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = _ops_ms(flops, plan, kp.dtype)
        r = dict(shape=c["name"], q=list(c["q"].shape),
                 pages=list(kp.shape), page_dtype=str(kp.dtype),
                 max_abs_err=err, max_abs_plain=scale, tol=tol,
                 kernel_ms=kernel_ms, plain_ms=plain_ms,
                 kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
                 check_launches=PA.paged_flash_mq.launches - launches0,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, flops=flops, library_ms=None,
                 sdpa_pregathered_ms=sdpa_ms,
                 kernel_design="split" if plan else "tensor_core",
                 n_splits=plan[1] if plan else None,
                 chunk=plan[0] if plan else None, **prev)
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

                def run_prev():
                    k_, v_ = pools[next(it) % len(pools)]
                    PA.paged_flash_mq_tiled(sq, k_, v_, *sargs)

                plan = _split_plan(PA, sq, pools[0][0], c["bt"])
                plain_ms = graph_ms(run_plain)
                prev_ms = graph_ms(run_prev)
                kernel_ms = graph_ms(run_kernel)
                kernel_ms = min(kernel_ms, graph_ms(run_kernel))
                prev_ms = min(prev_ms, graph_ms(run_prev))
                plain_ms = min(plain_ms, graph_ms(run_plain))
                nbytes, flops = _paged_work(dict(
                    q=sq, pools=pools[:1], bt=c["bt"], lens=c["lens"],
                    qs=c["qs"], ks=sks))
                shard_rows.append((kernel_ms, plain_ms, nbytes, flops,
                                   prev_ms))
                del pools
            if not plan and any(x[0] >= x[4] for x in shard_rows):
                raise AssertionError(f"{c['name']} tp {tp}: a shard's "
                                     f"tensor-core launch is not below the "
                                     f"tiled kernel's")
            t_bytes = shard_rows[0][2] / HBM_BYTES_PER_S * 1e3
            t_ops = _ops_ms(shard_rows[0][3], plan, kp.dtype)
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
                     # the first port's tiled kernel on the same shards
                     prev_ms=statistics.mean(x[4] for x in shard_rows),
                     sum_prev_ms=sum(x[4] for x in shard_rows),
                     shard_prev_ms=[x[4] for x in shard_rows],
                     kernel_design="split" if plan else "tensor_core",
                     n_splits=plan[1] if plan else None,
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


def _int_mm_layouts(a, bs, m):
    """``torch._int_mm`` (cuBLASLt s8 x s8 -> s32, no epilogue) as a
    yardstick, timed with B as the kernels take it (N-major, "NN") and
    K-major ("TN", ``b.t().contiguous().t()``, the layout cuBLASLt's int8
    kernels want).  It needs more than 16 rows: smaller M is padded to 32.
    Returns (A as timed, {layout: ms}); the TN copies are made before
    either timing."""
    k = a.shape[1]
    a_mm = a if m > 16 else torch.cat(
        [a, torch.zeros((32 - m, k), dtype=torch.int8, device="cuda")])
    tn = [b.t().contiguous().t() for b in bs]
    it = iter(range(10 ** 9))
    res = {}
    for tag, b_list in (("nn", bs), ("tn", tn)):
        res[tag] = graph_ms(lambda: torch._int_mm(
            a_mm, b_list[next(it) % len(b_list)]))
    del tn
    return a_mm, res


def phase_int8_kernels() -> tuple:
    """``int8_matmul`` against its plain version at deepseek-7b's edge
    GEMM shapes: M = 4 (one decode step of 4 slots), M = 1 and 16 (one
    slot; a 4 x 4 draft) and M = 512 (one prefill of 4 x 128), (K, N) the
    attention projections, gate/up and down; then one case each for bias
    + silu, gelu, requant to int8 after relu and after bias + gelu, and
    the identity epilogue, which must be exact.  At M <= 32 the front
    door runs the split-K kernel on the [K, N] weight, at M 512 the wgmma
    kernel on the weight packed once (one GEMM launch, no pack); each row
    also runs the tiled kernel (the first design) on the same arguments,
    which must agree bit for bit, and times it beside it (``prev_ms``),
    with the plan.  M 512 rows also time the front door on the unpacked
    [K, N] weight, pack included (``unpacked_call_ms``), and the wgmma
    launcher alone on arguments prepared once (``launcher_ms``).  Then the pack
    kernel against its plain version at each M 512 row's (K, N).
    Returns (GEMM rows, pack rows)."""
    from repro_torch.core.quant import compute_qparams
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import ops, ref
    cases = [_int8_case(f"int8mm_m{m}_{k}x{n}", m, k, n, seed=10 + i)
             for i, (m, (k, n)) in enumerate(
                 (m, kn) for m in (4, 512)
                 for kn in ((4096, 4096), (4096, 11008), (11008, 4096)))]
    cases += [
        _int8_case("int8mm_m1_4096x11008", 1, 4096, 11008, seed=25),
        _int8_case("int8mm_m16_4096x11008", 16, 4096, 11008, seed=26),
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
    max_clusters = IK._build.load(
        "int8_matmul").int8_matmul_splitk_max_clusters
    cuda = IK.int8_matmul_cuda

    def counts():
        return (cuda.launches, cuda.splitk_launches, cuda.wgmma_launches,
                cuda.pack_launches)

    results, packs = [], []
    for c in cases:
        a, b0, qa, qb = c["a"], c["bs"][0], c["qa"], c["qb"]
        m, k = a.shape
        n = b0.shape[1]
        kw = dict(bias=c["bias"], act=c["act"])
        if c["requant"]:
            kw["out_qp"] = compute_qparams(ref.int8_matmul_ref(a, b0, qa, qb,
                                                               **kw))
        design = "splitk" if m <= IK._SPLITK_MAX_M else "wgmma"
        # the wgmma kernel's rows run on weights packed once, up front
        ws = c["bs"] if design == "splitk" else [IK.pack_int8_weight(b)
                                                 for b in c["bs"]]
        before = counts()
        out = ops.int8_matmul(a, ws[0], qa, qb, **kw)
        torch.cuda.synchronize()
        want = (before[0] + 1, before[1] + (design == "splitk"),
                before[2] + (design == "wgmma"), before[3])
        if counts() != want:
            raise AssertionError(f"{c['name']}: the front door did not "
                                 f"launch the {design} kernel exactly once "
                                 f"(and pack nothing): {before} -> "
                                 f"{counts()}")
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
            ops.int8_matmul(a, ws[next(it) % nb], qa, qb, **kw)

        def run_plain():
            ref.int8_matmul_ref(a, c["bs"][next(it) % nb], qa, qb, **kw)

        args, kargs = ops.kernel_args(a, b0, qa, qb, **kw)

        def run_prev():
            IK.int8_matmul_tiled(a, c["bs"][next(it) % nb], *args[2:],
                                 **kargs)

        def run_unpacked():
            ops.int8_matmul(a, c["bs"][next(it) % nb], qa, qb, **kw)

        def run_launcher():
            IK.int8_matmul_wgmma(a, ws[next(it) % nb], *args[2:], **kargs)

        # the tiled kernel on the front door's own arguments: bit for bit,
        # since every design runs one epilogue on exact int32 sums
        if not torch.equal(IK.int8_matmul_tiled(*args, **kargs), out):
            raise AssertionError(f"{c['name']}: {design} and tiled kernels "
                                 f"differ")
        prev = dict(kernel_design=design, bitwise_equal_prev=True)
        if design == "splitk":
            plan = IK._plan_splitk(m, k, n)
            prev.update(cluster=plan[0], slice_k=plan[1], smem_bytes=plan[2],
                        max_active_clusters=max_clusters(m, n, *plan[:2]))
        else:
            plan = IK._plan_wgmma(m, k, n)
            prev.update(bn=plan[0], grid=plan[1], smem_bytes=plan[2])
            # the front door on the [K, N] weight packs it for the call
            before = counts()
            if not torch.equal(ops.int8_matmul(a, b0, qa, qb, **kw), out):
                raise AssertionError(f"{c['name']}: the unpacked call "
                                     f"differs")
            if counts() != (before[0] + 1, before[1], before[2] + 1,
                            before[3] + 1):
                raise AssertionError(f"{c['name']}: the unpacked call did "
                                     f"not pack once and launch once")
        a_mm, int_mm = _int_mm_layouts(a, c["bs"], m)
        if c["identity"]:
            if not torch.equal(out, torch._int_mm(a_mm, b0)[:m].float()):
                raise AssertionError(f"{c['name']}: identity epilogue "
                                     f"differs from torch._int_mm")
        # plain, tiled, kernel, kernel, tiled, plain: the versions in turns
        plain_ms = graph_ms(run_plain, iters=5)
        prev["prev_ms"] = graph_ms(run_prev)
        kernel_ms = graph_ms(run_kernel)
        kernel_call_ms = cuda_ms(run_kernel)
        kernel_ms = min(kernel_ms, graph_ms(run_kernel))
        prev["prev_ms"] = min(prev["prev_ms"], graph_ms(run_prev))
        prev["prev_call_ms"] = cuda_ms(run_prev)
        plain_ms = min(plain_ms, graph_ms(run_plain, iters=5))
        if design == "wgmma":
            prev["unpacked_call_ms"] = graph_ms(run_unpacked)
            # the kernel alone, on arguments prepared once (the front door
            # prepares them per call: broadcasts of a per-tensor scale)
            prev["launcher_ms"] = graph_ms(run_launcher)
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
                 int_mm_ms=int_mm["nn"], int_mm_tn_ms=int_mm["tn"],
                 int_mm_rows=a_mm.shape[0], b_copies=nb, **prev)
        emit("kernels", **r)
        results.append(r)
        if design == "wgmma" and (k, n) not in {(p["k"], p["n"])
                                                for p in packs}:
            packs.append(_pack_row(c["bs"], k, n))
        del c["bs"], ws
    torch.cuda.empty_cache()
    return results, packs


def _pack_row(bs, k, n) -> dict:
    """The pack kernel against its plain version (``w.t().contiguous()``
    and an int32 colsum; exact) on weight copies ``bs`` [K, N], timed
    plain, kernel, kernel, plain; its bound is one read of w and one
    write of the copy and the colsum."""
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import ref
    got = IK.pack_int8_weight_cuda(bs[0])
    nk, colsum = ref.pack_int8_weight_ref(bs[0])
    torch.cuda.synchronize()
    if not (torch.equal(got.nk, nk) and torch.equal(got.colsum, colsum)):
        raise AssertionError(f"pack {k}x{n}: kernel and plain differ")
    it = iter(range(10 ** 9))

    def run_kernel():
        IK.pack_int8_weight_cuda(bs[next(it) % len(bs)])

    def run_plain():
        ref.pack_int8_weight_ref(bs[next(it) % len(bs)])

    plain_ms = graph_ms(run_plain)
    kernel_ms = min(graph_ms(run_kernel), graph_ms(run_kernel))
    plain_ms = min(plain_ms, graph_ms(run_plain))
    nbytes = 2 * k * n + 4 * n
    r = dict(kernel="int8_pack_weight", shape=f"pack_{k}x{n}", k=k, n=n,
             max_abs_err=0.0, kernel_ms=kernel_ms, plain_ms=plain_ms,
             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             bytes=nbytes, library_ms=None)
    emit("kernels", **r)
    return r


def phase_int8_threshold() -> list:
    """The front door's rows threshold and each design's plan, measured:
    at deepseek-7b's three edge GEMM shapes, the split-K kernel
    (``int8_matmul_splitk``, its own plan) and the tiled kernel in turns
    at M = 1, 4, 8, 16 and 32, then the split-K kernel at M = 4 and 16
    over cluster sizes 1, 2, 3, 4, 6 and 8 (``cluster_ms``); then the
    wgmma kernel (``int8_matmul_wgmma`` on packed weights) against the
    tiled kernel, and the split-K kernel at M = 32, at M = 32, 48, 64,
    128, 256 and 512, with the wgmma plans (128- and 192-column tiles,
    persistent or one CTA a tile) at 512 (``plan_ms``).  f32 out,
    per-channel scales, no bias; CUDA-graph replayed, B streamed from
    device memory.  First each design's launch floor (``int8_floor``):
    split-K and tiled at M 4, K 128, N 64; wgmma at M 64, K 128, N
    128."""
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import ops
    rows = []
    # the launch floor: one CTA of one stage, one output tile
    c = _int8_case("floor", 4, 128, 64, seed=29)
    args, kargs = ops.kernel_args(c["a"], c["bs"][0], c["qa"], c["qb"])
    floor = dict(m=4, k=128, n=64, splitk_ms=graph_ms(
        lambda: IK.int8_matmul_splitk(*args, **kargs)), tiled_ms=graph_ms(
        lambda: IK.int8_matmul_tiled(*args, **kargs)))
    c = _int8_case("floor_wgmma", 64, 128, 128, seed=28)
    args, kargs = ops.kernel_args(c["a"], IK.pack_int8_weight(c["bs"][0]),
                                  c["qa"], c["qb"])
    floor.update(wgmma_m=64, wgmma_k=128, wgmma_n=128, wgmma_ms=graph_ms(
        lambda: IK.int8_matmul_wgmma(*args, **kargs)))
    emit("int8_floor", **floor)
    for i, (k, n) in enumerate(((4096, 4096), (4096, 11008), (11008, 4096))):
        c = _int8_case(f"{k}x{n}", 32, k, n, seed=30 + i)
        nb = len(c["bs"])
        it = iter(range(10 ** 9))
        args, kargs = ops.kernel_args(c["a"], c["bs"][0], c["qa"], c["qb"])
        per_m = {}
        for m in (1, 4, 8, 16, 32):
            a = c["a"][:m].contiguous()

            def splitk(cluster=None, a=a):
                IK.int8_matmul_splitk(a, c["bs"][next(it) % nb], *args[2:],
                                      cluster=cluster, **kargs)

            def tiled(a=a):
                IK.int8_matmul_tiled(a, c["bs"][next(it) % nb], *args[2:],
                                     **kargs)

            t_ms = graph_ms(tiled)
            s_ms = min(graph_ms(splitk), graph_ms(splitk))
            t_ms = min(t_ms, graph_ms(tiled))
            per_m[m] = dict(splitk_ms=s_ms, tiled_ms=t_ms,
                            plan=list(IK._plan_splitk(m, k, n)))
            if m in (4, 16):
                per_m[m]["cluster_ms"] = {
                    cl: graph_ms(lambda cl=cl: splitk(cl))
                    for cl in (1, 2, 3, 4, 6, 8)}
        row = dict(k=k, n=n, per_m=per_m,
                   splitk_faster_at=[m for m, v in per_m.items()
                                     if v["splitk_ms"] < v["tiled_ms"]])
        emit("int8_threshold", **row)
        rows.append(row)
        del c
    torch.cuda.empty_cache()
    for i, (k, n) in enumerate(((4096, 4096), (4096, 11008), (11008, 4096))):
        c = _int8_case(f"{k}x{n}", 512, k, n, seed=40 + i)
        nb = len(c["bs"])
        packed = [IK.pack_int8_weight(b) for b in c["bs"]]
        it = iter(range(10 ** 9))
        args, kargs = ops.kernel_args(c["a"], c["bs"][0], c["qa"], c["qb"])
        per_m = {}
        for m in (32, 48, 64, 128, 256, 512):
            a = c["a"][:m].contiguous()

            def wgmma(a=a, **plan):
                IK.int8_matmul_wgmma(a, packed[next(it) % nb], *args[2:],
                                     **plan, **kargs)

            def tiled(a=a):
                IK.int8_matmul_tiled(a, c["bs"][next(it) % nb], *args[2:],
                                     **kargs)

            def splitk(a=a):
                IK.int8_matmul_splitk(a, c["bs"][next(it) % nb], *args[2:],
                                      **kargs)

            kernels = dict(wgmma=wgmma, tiled=tiled)
            if m <= IK._SPLITK_MAX_M:
                kernels["splitk"] = splitk
            # in turns, each twice, the lower time kept
            v = {f"{name}_ms": graph_ms(fn) for name, fn in kernels.items()}
            for name, fn in reversed(kernels.items()):
                v[f"{name}_ms"] = min(v[f"{name}_ms"], graph_ms(fn))
            v["fastest"] = min(kernels, key=lambda name: v[f"{name}_ms"])
            v["wgmma_plan"] = list(IK._plan_wgmma(m, k, n))
            if m == 512:
                v["plan_ms"] = {
                    f"bn{bn}_{'persistent' if pers else 'per_tile'}":
                        graph_ms(lambda bn=bn, pers=pers: wgmma(
                            bn=bn, persistent=pers))
                    for bn in IK._WG_BNS for pers in (True, False)}
            per_m[m] = v
        row = dict(k=k, n=n, per_m=per_m,
                   fastest={m: v["fastest"] for m, v in per_m.items()})
        emit("int8_threshold_wgmma", **row)
        rows.append(row)
        del c, packed
    torch.cuda.empty_cache()
    return rows


def phase_int8_epilogues() -> list:
    """What each epilogue costs: the wgmma and tiled kernels at M 512 on
    the attention projection's and gate/up's (K, N), with bias, for each
    activation (none, relu, gelu, silu) with f32 and with int8 out
    (``int8_epilogues``; CUDA-graph replayed, B streamed)."""
    from repro_torch.core.quant import compute_qparams
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import ops, ref
    rows = []
    for i, (k, n) in enumerate(((4096, 4096), (4096, 11008))):
        c = _int8_case(f"{k}x{n}", 512, k, n, seed=50 + i, bias=True)
        nb = len(c["bs"])
        packed = [IK.pack_int8_weight(b) for b in c["bs"]]
        it = iter(range(10 ** 9))
        ms = {}
        for act in (None, "relu", "gelu", "silu"):
            for out in ("f32", "int8"):
                kw = dict(bias=c["bias"], act=act)
                if out == "int8":
                    kw["out_qp"] = compute_qparams(ref.int8_matmul_ref(
                        c["a"], c["bs"][0], c["qa"], c["qb"], **kw))
                args, kargs = ops.kernel_args(c["a"], c["bs"][0], c["qa"],
                                              c["qb"], **kw)
                ms[f"{act or 'none'}_{out}"] = dict(
                    wgmma_ms=graph_ms(lambda: IK.int8_matmul_wgmma(
                        c["a"], packed[next(it) % nb], *args[2:], **kargs)),
                    tiled_ms=graph_ms(lambda: IK.int8_matmul_tiled(
                        c["a"], c["bs"][next(it) % nb], *args[2:], **kargs)))
        row = dict(m=512, k=k, n=n, bias=True, ms=ms)
        emit("int8_epilogues", **row)
        rows.append(row)
        del c, packed
    torch.cuda.empty_cache()
    return rows


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
    its input) of the seeded deepseek-7b, each quantized per channel and
    packed once (one wgmma launch and no pack a weight).
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
    cuda = IK.int8_matmul_cuda
    for name, inp, w in (("wq", x, wq), ("w1_gate_up", x, wi),
                         ("w2_down", hidden, wo)):
        qx, qw = compute_qparams(inp), compute_qparams(w, axis=1)
        w_q = quantize(w, qw)
        packed = IK.pack_int8_weight(w_q)   # once, as a loader would
        before = (cuda.launches, cuda.wgmma_launches, cuda.pack_launches)
        got = ops.quantized_dense(inp, packed, qx, qw)
        torch.cuda.synchronize()
        launches, wgmma_launches, pack_launches = (
            cuda.launches - before[0], cuda.wgmma_launches - before[1],
            cuda.pack_launches - before[2])
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
                 launches=launches, wgmma_launches=wgmma_launches,
                 pack_launches=pack_launches,
                 max_abs_err_vs_plain=float(diff.max()),
                 tol_vs_plain=float(bound.max()),
                 rel_l2_vs_f32=rel, predicted_rel_l2=noise,
                 plain_rel_l2_vs_f32=_rel_l2(want, truth),
                 within_1pct=rel < 0.01)
        if (launches, wgmma_launches, pack_launches) != (1, 1, 0):
            raise AssertionError(f"quantized_dense {name}: {launches} "
                                 f"launches, {wgmma_launches} wgmma, "
                                 f"{pack_launches} packs; expected 1, 1, "
                                 f"0")
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
    machine's host at these event counts — most of the script's time.
    Only the device's activity is recorded: the sums read nothing else,
    and parsing the CPU operators' events when the window closes took
    several times the profiled traffic's own wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    # paged_flash_mq's kernels: the split-KV one (decode, verify) and the
    # tensor-core one (prefill, ``paged_flash_mq_tc_kernel``); the tiled
    # one (``paged_flash_mq_kernel``) is off the serving path
    split_us = sum(r[0] for r in rows if "paged_flash_split" in r[1])
    tc_us = sum(r[0] for r in rows if "paged_flash_mq_tc" in r[1])
    # device memsets: among them the split launches' counter zeroing
    memsets = [r for r in rows if "memset" in r[1].lower()]
    attn_us = split_us + sum(r[0] for r in rows if "paged_flash_mq" in r[1])
    rows.sort(reverse=True)
    return dict(profiled_wall_s=wall, unprofiled_wall_s=unprofiled_wall_s,
                device_busy_s=busy_us / 1e6,
                device_idle_share=1.0 - busy_us / 1e6 / unprofiled_wall_s,
                device_events=sum(r[2] for r in rows),
                distinct_kernels=len(rows),
                paged_flash_mq_ms=attn_us / 1e3,
                paged_flash_mq_share=attn_us / busy_us if busy_us else None,
                paged_flash_split_ms=split_us / 1e3,
                paged_flash_tc_ms=tc_us / 1e3,
                memset_ms=sum(r[0] for r in memsets) / 1e3,
                memset_count=sum(r[2] for r in memsets),
                top=[dict(name=k[:80], device_ms=us / 1e3, count=c,
                          share=us / busy_us)
                     for us, k, c in rows[:top]])


def _prompts(n, plen, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, plen).astype(np.int32) for _ in range(n)]


def _reset_launch_counts() -> None:
    """Every kernel wrapper's launch count (and the sharded form's calls)
    to 0."""
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import paged_attention as PA
    PA.paged_flash_mq.launches = 0
    PA.paged_flash_mq.tc_launches = 0
    PA.paged_flash_mq_sharded.calls = 0
    PA.paged_flash_mq_sharded.launches = 0
    IK.int8_matmul_cuda.launches = 0
    IK.int8_matmul_cuda.splitk_launches = 0
    IK.int8_matmul_cuda.wgmma_launches = 0
    IK.int8_matmul_cuda.pack_launches = 0
    IK.pack_int8_weight_cuda.launches = 0


def _launch_counts() -> dict:
    """Each summary row's launch count, by the row's kernel name."""
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import paged_attention as PA
    return {"paged_flash_mq": PA.paged_flash_mq.launches,
            "paged_flash_mq_tc": PA.paged_flash_mq.tc_launches,
            "paged_flash_mq_sharded": PA.paged_flash_mq_sharded.launches,
            "int8_matmul": IK.int8_matmul_cuda.launches,
            "int8_matmul_wgmma": IK.int8_matmul_cuda.wgmma_launches,
            "int8_pack_weight": IK.pack_int8_weight_cuda.launches,
            "int8_matmul_splitk": IK.int8_matmul_cuda.splitk_launches}


def _counted(e, fn) -> dict:
    """``fn()`` on engine ``e`` with fresh stats, every kernel's launch
    count (and the sharded form's calls) set to 0 just before and read
    just after, and the wall time to the device's end."""
    from repro_torch.kernels import int8_matmul as IK
    from repro_torch.kernels import paged_attention as PA
    e.stats = type(e.stats)()
    _reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(e.device)
    wall = time.perf_counter() - t0
    return dict(out=out, wall=wall, launches=PA.paged_flash_mq.launches,
                tc_launches=PA.paged_flash_mq.tc_launches,
                sharded_calls=PA.paged_flash_mq_sharded.calls,
                sharded_launches=PA.paged_flash_mq_sharded.launches,
                int8_matmul_launches=IK.int8_matmul_cuda.launches,
                int8_matmul_splitk_launches=(
                    IK.int8_matmul_cuda.splitk_launches),
                int8_matmul_wgmma_launches=IK.int8_matmul_cuda.wgmma_launches,
                int8_pack_launches=IK.pack_int8_weight_cuda.launches,
                by_row=_launch_counts(), stats=e.stats)


def _timed(e, prompts, max_new, vocab, expect, what, sampling=None) -> dict:
    """One run of ``prompts`` through engine ``e`` (with ``sampling``,
    sampled), counted by ``_counted``: ``paged_flash_mq``'s launches
    must equal ``expect(stats)``, the count the engine's code implies,
    or, where ``expect`` is None, be above 0."""
    r = _counted(e, lambda: e.generate(prompts, max_new_tokens=max_new,
                                       sampling=sampling))
    r["outs"] = r.pop("out")
    st, launches, tc_launches = r["stats"], r["launches"], r["tc_launches"]
    if st.prefill_calls and not tc_launches:
        raise AssertionError(f"{what}: {st.prefill_calls} prefills launched "
                             f"the tensor-core kernel no time")
    want = launches > 0 if expect is None else launches == expect(st)
    if not want:
        raise AssertionError(f"{what}: paged_flash_mq launched {launches} "
                             f"times, expected "
                             f"{'> 0' if expect is None else expect(st)} "
                             f"({st.prefill_calls} prefills, "
                             f"{st.decode_steps} decode steps)")
    if not all(len(o) == max_new and all(0 <= t < vocab for t in o)
               for o in r["outs"]):
        raise AssertionError(f"{what} produced malformed streams")
    return r


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
    cloud = ServingEngine(params, cfg, max_len=max_len, paged=True,
                          device="cuda")
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
               tc_launches=first["tc_launches"],
               expected_launches=cfg.n_layers * (st.prefill_calls
                                                 + st.decode_steps),
               int8_matmul_launches=first["int8_matmul_launches"],
               int8_matmul_splitk_launches=first[
                   "int8_matmul_splitk_launches"],
               int8_matmul_wgmma_launches=first[
                   "int8_matmul_wgmma_launches"],
               int8_pack_launches=first["int8_pack_launches"],
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

    # the profiler's window comes after every timed run: its host work
    # and state stay out of the tokens/s above.  The cloud-only engine's
    # window is cut for time (PERF.md §5 keeps its numbers)
    prof = profile_window(
        lambda: eng.generate(prompts, max_new_tokens=max_new),
        statistics.median(r["wall"] for r in runs["collab"]))
    emit("main_path_profile", requests=n_req, max_new=max_new, **prof)
    res["profiles"] = {"collab": prof}
    # untimed: the serial decisions, for phase 6's divergence report
    with _CommittedDecisions(eng, "_cloud_decode") as dec, \
            _PrefillGroups(eng) as pg:
        res["logged_outs"] = eng.generate(prompts, max_new_tokens=max_new)
    res["decisions"], res["prefill"] = dec.at, pg
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
    cloud.  One timed run (the script's time limit); the launch count
    is the one the code implies: every layer attends once per prefill call on each side plus
    once more in the draft suffix's prefill, and once per drafted
    position on the edge (prefix and draft suffix) plus once per verify
    on the cloud.  Untimed, under ``_CommittedDecisions`` and
    ``_PrefillGroups``: every request's first token is held to the
    serial engine's by ``_index0`` (equal, with bit-equal logits, where
    it was prefilled in the same group; else a near-tie)."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve.engine import CollaborativeServingEngine

    n_req, plen, max_new, cut, reps, k = 8, 128, 32, 14, 1, 4
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
    # later tokens may differ at near-ties: the verify runs k rows per
    # slot where the serial step runs one, so its sums round otherwise.
    # Phase 11 holds the INT8 spec stream to the serial one at 2 layers;
    # first tokens are checked below, against the prefill groups
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
               tc_launches=first["tc_launches"],
               int8_matmul_launches=first["int8_matmul_launches"],
               int8_matmul_splitk_launches=first[
                   "int8_matmul_splitk_launches"],
               int8_matmul_wgmma_launches=first[
                   "int8_matmul_wgmma_launches"],
               int8_pack_launches=first["int8_pack_launches"],
               transmitted_bytes=st.transmitted_bytes,
               prefill_bytes=st.prefill_bytes,
               bytes_per_decode_token=st.bytes_per_decode_token(),
               channel_latency_s=st.channel_latency_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_output=first["outs"][0])
    emit("spec_path", **res)
    # no profile window here: cut for time (its numbers stay in PERF.md
    # §5, run AN)
    with _CommittedDecisions(eng, "_verify_impl") as dec, \
            _PrefillGroups(eng) as pg:
        logged = eng.generate(prompts, max_new_tokens=max_new)
    # spec rounds retire requests at other turns than serial steps, so
    # later requests may be prefilled in other groups than on the serial
    # engine: every first token is held to the serial one by _index0
    serial_logged, serial_pg = main_res["logged_outs"], main_res["prefill"]
    index0 = _index0("spec path", serial_logged, serial_pg, logged, pg)
    emit("spec_divergence", prefill_groups=pg.groups,
         serial_prefill_groups=serial_pg.groups, index0=index0,
         **_divergence(serial_logged, main_res["decisions"], logged,
                       dec.at, index0))
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


class _PrefillGroups:
    """While active, record the requests of each prefill call ``eng``
    makes (uids in row order) and, per request, the f32 logits its first
    token comes from (kept on the device: no sync is added).  A request
    gets the same prefill logits on two engines when it is prefilled in
    the same group on both: the same rows through the same GEMM
    shapes."""

    def __init__(self, eng):
        self.eng, self.groups, self.logits = eng, [], {}

    def __enter__(self):
        eng = self.eng
        orig, orig_body = eng._prefill_group, eng._cloud_prefill_body

        def prefill_group(group, *args, **kw):
            self.groups.append(tuple(r.uid for r in group))
            return orig(group, *args, **kw)

        def body(*args, **kw):
            logits = orig_body(*args, **kw)
            for uid, row in zip(self.groups[-1], logits.float()):
                self.logits[uid] = row.clone()
            return logits

        eng._prefill_group, eng._cloud_prefill_body = prefill_group, body
        return self

    def __exit__(self, *exc):
        del self.eng._prefill_group, self.eng._cloud_prefill_body
        self.eng = None           # the record must not keep the engine


def _same_groups(a, b) -> set:
    """The requests prefilled in the same group in both records."""
    return {u for g in a if g in b for u in g}


def _index0(what, a_outs, a_pg, b_outs, b_pg) -> list:
    """Hold output index 0 of every request on two engines to each
    other, by the prefill logits ``_PrefillGroups`` recorded on both.  A
    request prefilled in the same group on both must get bit-equal
    logits and the same token.  One prefilled in another group runs
    through GEMMs of another row count, which may round otherwise: its
    top logits, and its logits at either engine's token, must agree
    within ``INT8_NOISE_TOL`` (the bound ``_int8_divergence`` puts on
    two devices' agreeing rows).  So where two greedy tokens differ,
    the engines' margins between them sum to at most twice that
    difference: a near-tie.  Raises, or returns one row per request
    (top-2 gaps, the difference at the tokens, the row's largest)."""
    same = _same_groups(a_pg.groups, b_pg.groups)
    rows = []
    for u, (x, y) in enumerate(zip(a_outs, b_outs)):
        la, lb = a_pg.logits[u].double().cpu(), b_pg.logits[u].double().cpu()
        ta, tb = int(x[0]), int(y[0])
        top_a, top_b = torch.topk(la, 2).values, torch.topk(lb, 2).values
        diff = max(abs(float(la[t] - lb[t])) for t in (ta, tb))
        diff = max(diff, abs(float(top_a[0] - top_b[0])))
        row = dict(request=u, same_group=u in same, tokens=[ta, tb],
                   top2_gaps=[float(top_a[0] - top_a[1]),
                              float(top_b[0] - top_b[1])],
                   logit_diff=diff,
                   row_max_diff=float((la - lb).abs().max()))
        ok = (ta == tb and torch.equal(la, lb)) if u in same else (
            diff <= INT8_NOISE_TOL)
        if not ok:
            raise AssertionError(f"{what}: output index 0 of request {u} "
                                 f"differs beyond a near-tie: {row}")
        rows.append(row)
    return rows


def _divergence(serial, serial_at, spec, spec_at, index0) -> dict:
    """Where each request's spec stream first leaves its serial stream:
    the position, both tokens, each engine's top-2 gap there, and the
    largest difference of the two engines' top logits over the agreeing
    positions before it (the noise a tie has to be read against); at
    position 0, the prefill's token, the gaps and the logits' difference
    from ``index0`` (``_index0``'s rows, which assert it).  A report:
    nothing here is asserted."""
    rows = []
    for uid, (a, b) in enumerate(zip(serial, spec)):
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        row = dict(request=uid, first_divergent=i,
                   agreement=sum(x == y for x, y in zip(a, b)) / len(a))
        if i == 0:
            r0 = index0[uid]
            row.update(serial_token=a[0], spec_token=b[0],
                       serial_top2_gap=r0["top2_gaps"][0],
                       spec_top2_gap=r0["top2_gaps"][1],
                       prefill_logit_diff=r0["logit_diff"],
                       same_prefill_group=r0["same_group"],
                       gap_within_noise=min(r0["top2_gaps"])
                       <= r0["logit_diff"])
        elif i is not None:
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
# Phase 7: sampled serving on the main path
# ---------------------------------------------------------------------------


SAMPLE_T, SAMPLE_P = 0.8, 0.9       # the sampled path's temperature, top-p
# the phases only sampled traffic may enter (serve.phases, serve.spec)
SAMPLED_PHASES = ("_cloud_prefill_sample_impl", "_cloud_decode_sample_impl",
                  "_spec_draft_sample_impl", "_verify_sample_impl")


class _Calls:
    """While active, record the positional arguments of every call of
    ``eng``'s methods ``names``."""

    def __init__(self, eng, names):
        self.eng, self.names = eng, names
        self.args = {n: [] for n in names}

    def __enter__(self):
        for n in self.names:
            def wrap(*a, _orig=getattr(self.eng, n), _n=n, **kw):
                self.args[_n].append(a)
                return _orig(*a, **kw)
            setattr(self.eng, n, wrap)
        return self

    def __exit__(self, *exc):
        for n in self.names:
            delattr(self.eng, n)


def phase_sampling_ops(vocab: int) -> dict:
    """Check 4 of the sampled path: the threefry keys, uniforms and
    categorical draws of ``serve.sampling`` on CUDA tensors against the
    CPU port's, bit for bit — 4,096 (seed, index, stream) triples and a
    [16, vocab] draw — and their times on the card (graph-free, eager:
    the engines call them so)."""
    from repro_torch.serve import sampling as SS
    rng = np.random.RandomState(0)
    n = 4096
    seeds = torch.tensor(rng.randint(0, 2 ** 31 - 1, n))
    idx = torch.tensor(rng.randint(0, 1 << 20, n))
    streams = torch.tensor(rng.randint(0, 4, n))
    keys_c = torch.empty((n, 2), dtype=torch.int64)
    keys_g = torch.empty((n, 2), dtype=torch.int64, device="cuda")
    for st in range(4):
        m = streams == st
        keys_c[m] = SS.token_keys(seeds[m], idx[m], st)
        keys_g[m.cuda()] = SS.token_keys(seeds[m].cuda(), idx[m].cuda(), st)
    if not torch.equal(keys_g.cpu(), keys_c):
        raise AssertionError("sampling: token_keys differ card vs CPU")
    u_c, u_g = SS.uniform_rows(keys_c), SS.uniform_rows(keys_g)
    if not torch.equal(u_g.cpu().view(torch.int32), u_c.view(torch.int32)):
        raise AssertionError("sampling: uniform_rows differ card vs CPU")
    logits = torch.tensor(rng.randn(16, vocab).astype(np.float32) * 3)
    temps, top_ps = torch.full((16,), SAMPLE_T), torch.full((16,), SAMPLE_P)
    p = SS.filtered_probs(logits, temps, top_ps)
    d_c = SS.sample_rows(p, keys_c[:16])
    p_g, k_g = p.cuda(), keys_g[:16]
    d_g = SS.sample_rows(p_g, k_g)
    if not torch.equal(d_g.cpu(), d_c):
        raise AssertionError(f"sampling: sample_rows differ card vs CPU: "
                             f"{d_g.cpu().tolist()} vs {d_c.tolist()}")
    lg, tg, pg = logits.cuda(), temps.cuda(), top_ps.cuda()
    res = dict(triples=n, vocab=vocab, rows=16, keys_equal=True,
               uniforms_equal=True, draws_equal=True,
               draws=d_c.tolist(),
               token_keys_ms=cuda_ms(lambda: SS.token_keys(
                   seeds.cuda(), idx.cuda(), SS.CLOUD)),
               sample_rows_ms=cuda_ms(lambda: SS.sample_rows(p_g, k_g)),
               filtered_probs_ms=cuda_ms(
                   lambda: SS.filtered_probs(lg, tg, pg)),
               filtered_probs_max_abs_err=float(
                   (SS.filtered_probs(lg, tg, pg).cpu() - p).abs().max()))
    emit("sampling_ops", **res)
    return res


def _wire_formula(st, rounds_n, *, n_req, plen, d_model, vocab, k):
    """The wire bytes a sampled spec run owes, from the reference's
    framing alone, as (greedy part, sampled part): each prefill call
    ships its rows' int8 blobs (one byte an element, a scale and zero
    point a row) and returns a token a row, a header each way; each
    round ships a row's k int8 deltas and k-1 graded drafts and returns
    a token and the accept mask a row, a header each way; and every
    sampled row (all rows here) also ships its k-1 graded positions' f32
    draft distributions."""
    from repro_torch.serve.transport import _MSG_BYTES, _QP_BYTES, _TOK_BYTES
    prefill = (n_req * (plen * d_model + _QP_BYTES + _TOK_BYTES)
               + 2 * st.prefill_calls * _MSG_BYTES)
    rounds = sum(n * (k * (d_model + _QP_BYTES) + (k - 1) * _TOK_BYTES)
                 + _MSG_BYTES + n * (_TOK_BYTES + -(-k // 8)) + _MSG_BYTES
                 for n in rounds_n)
    return prefill + rounds, sum(n * (k - 1) * vocab * 4 for n in rounds_n)


def phase_sampled_path(params, cfg, main_res: dict, spec_res: dict) -> dict:
    """The main path's engine, weights and traffic, sampled: every
    request at ``temperature=0.8, top_p=0.9`` with seed = its index,
    serially (k = 1) and with ``spec_k=4`` (rejection-sampled verify).
    Each mode runs on two fresh engines, one timed run each (after a
    warm-up); no profile window (cut for time; PERF.md §5 keeps run
    AN's).  B1's
    launches must be the greedy paths' formulas: sampling adds no
    attention.  Checks, each raising:

    1. the two fresh engines draw identical streams;
    2. a ``temperature=0`` run of the serial engine commits the main
       path's greedy streams bit for bit, entering no sampled phase;
    3. the serial and spec streams agree at output index 0 (both the
       prefill's ``CLOUD`` draw) by ``_index0``: the same draw from
       bit-equal logits for every request prefilled in the same group on
       both engines; logits within ``INT8_NOISE_TOL`` for one prefilled
       in another group (spec rounds retire requests at other turns);
    4. ``phase_sampling_ops``: the card's keys, uniforms and draws equal
       the CPU's;
    5. wire bytes: the serial run's equal the greedy serial run's, the
       spec run's equal ``_wire_formula`` over its rounds;
    (6 is in ``phase_path_parity``: a lossless sampled stream, card
    against CPU)."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve.engine import CollaborativeServingEngine
    from repro_torch.serve.sampling import SamplingParams

    ops = phase_sampling_ops(cfg.vocab)
    n_req, plen, max_new, cut = 8, 128, 32, 14
    channel = Channel.from_kbps(250.0, rtt_ms=20.0)
    prompts = _prompts(n_req, plen, cfg.vocab, seed=0)
    samps = [SamplingParams(temperature=SAMPLE_T, top_p=SAMPLE_P, seed=i)
             for i in range(n_req)]
    n_layers = cfg.n_layers
    out = {}
    for tag, k, greedy in (("serial", 1, main_res), ("spec", 4, spec_res)):
        runs, eng = [], None
        for _ in range(2):
            eng = None                 # one engine on the card at a time
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = CollaborativeServingEngine(
                params, cfg, cut_layer=cut, channel=channel,
                max_len=plen + max_new + 24, spec_k=k, device="cuda")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            n_cloud = eng.n_cloud
            eng.generate(prompts[:1], max_new_tokens=2,
                         sampling=samps[:1])                  # warm-up
            torch.cuda.synchronize()
            if k == 1:
                def expect(st):
                    return n_layers * (st.prefill_calls + st.decode_steps)
            else:
                def expect(st, n_cloud=n_cloud, k=k):
                    return (st.prefill_calls * (n_layers + n_cloud)
                            + st.spec_rounds * (k * n_layers + n_cloud))
            with _Calls(eng, ("_round",) + SAMPLED_PHASES) as calls, \
                    _PrefillGroups(eng) as pg:
                r = _timed(eng, prompts, max_new, cfg.vocab, expect,
                           f"sampled {tag} path", sampling=samps)
            r["prefill"] = pg
            st = r["stats"]
            r["rounds_n"] = [len(a[2]) for a in calls.args["_round"]]
            used = {n: len(calls.args[n]) for n in SAMPLED_PHASES}
            del calls
            want = ({"_cloud_prefill_sample_impl": st.prefill_calls,
                     "_cloud_decode_sample_impl": st.decode_steps}
                    if k == 1 else
                    {"_cloud_prefill_sample_impl": st.prefill_calls,
                     "_spec_draft_sample_impl": st.spec_rounds,
                     "_verify_sample_impl": st.spec_rounds})
            if any(used[n] != want.get(n, 0) for n in SAMPLED_PHASES):
                raise AssertionError(f"sampled {tag} path: sampled phase "
                                     f"calls {used}, expected {want}")
            r.update(setup_s=setup_s, sampled_phase_calls=used,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            runs.append(r)
        a, b = runs
        if a["outs"] != b["outs"]:                                # check 1
            raise AssertionError(f"sampled {tag} path: two fresh engines "
                                 f"drew different streams")
        for r in runs:                                            # check 5
            st = r["stats"]
            if k == 1:
                want_bytes, q_bytes = main_res["transmitted_bytes"], 0
            else:
                if not st.spec_rounds == st.decode_steps == len(
                        r["rounds_n"]):
                    raise AssertionError(f"sampled spec path: "
                                         f"{st.spec_rounds} rounds in "
                                         f"{st.decode_steps} steps")
                base, q_bytes = _wire_formula(
                    st, r["rounds_n"], n_req=n_req, plen=plen,
                    d_model=cfg.d_model, vocab=cfg.vocab, k=k)
                want_bytes = base + q_bytes
            if st.transmitted_bytes != want_bytes:
                raise AssertionError(
                    f"sampled {tag} path: {st.transmitted_bytes} wire "
                    f"bytes, expected {want_bytes}")
        st = a["stats"]
        if k == 1:
            with _Calls(eng, SAMPLED_PHASES) as calls:            # check 2
                t0_outs = eng.generate(
                    prompts, max_new_tokens=max_new,
                    sampling=SamplingParams(temperature=0.0, seed=7))
            entered = {n: len(v) for n, v in calls.args.items() if v}
            del calls
            if t0_outs != main_res["outs"] or entered:
                raise AssertionError(
                    f"sampled serial path: temperature=0 run differs from "
                    f"the greedy main path or entered {entered}")
        walls = [r["wall"] for r in runs]
        n_tok = sum(len(o) for o in a["outs"])
        res = dict(arch=cfg.name, layers=n_layers, cut=cut, spec_k=k,
                   temperature=SAMPLE_T, top_p=SAMPLE_P, seeds=[0, n_req - 1],
                   requests=n_req, slots=4, prompt_len=plen,
                   max_new=max_new, reduced=None,
                   setup_s=[r["setup_s"] for r in runs], tokens=n_tok,
                   wall_s_reps=walls,
                   tokens_per_s_reps=[n_tok / w for w in walls],
                   tokens_per_s=n_tok / statistics.median(walls),
                   greedy_tokens_per_s=greedy["tokens_per_s"],
                   fresh_engines_identical=True,
                   prefill_calls=st.prefill_calls,
                   decode_steps=st.decode_steps, spec_rounds=st.spec_rounds,
                   drafted_tokens=st.drafted_tokens,
                   draft_hits=st.draft_hits,
                   acceptance_rate=(st.acceptance_rate() if k > 1
                                    else None),
                   tokens_per_round=st.decode_tokens / max(st.decode_steps,
                                                           1),
                   tokens_per_slot_round=st.decode_tokens / max(
                       sum(a["rounds_n"]), 1),
                   launches=a["launches"], tc_launches=a["tc_launches"],
                   split_launches=a["launches"] - a["tc_launches"],
                   expected_launches=expect(st),
                   sampled_phase_calls=a["sampled_phase_calls"],
                   int8_matmul_launches=a["int8_matmul_launches"],
                   transmitted_bytes=st.transmitted_bytes,
                   channel_latency_s=st.channel_latency_s,
                   expected_transmitted_bytes=want_bytes,
                   greedy_transmitted_bytes=greedy["transmitted_bytes"],
                   q_row_bytes=q_bytes,
                   peak_mem_gb=max(r["peak_mem_gb"] for r in runs),
                   first_output=a["outs"][0])
        if k == 1:
            res["temperature0_equals_greedy"] = True
        emit("sampled_path", run=tag, **res)
        # no profile windows here: cut for time (their numbers stay in
        # PERF.md §5, run AN)
        res.update(outs=a["outs"], prefill=a["prefill"])
        out[tag] = res
        del eng, runs, a, b
    torch.cuda.empty_cache()
    emit("sampled_index0", requests=_index0(                     # check 3
        "sampled path", out["serial"]["outs"], out["serial"]["prefill"],
        out["spec"]["outs"], out["spec"]["prefill"]))
    out["ops"] = ops
    return out


# ---------------------------------------------------------------------------
# Phase 8: the cloud tensor-parallel on the one card
# ---------------------------------------------------------------------------


def phase_tp_path(params, cfg, main_res: dict, spec_res: dict) -> dict:
    """The main path's engine, weights and traffic with the cloud suffix,
    its head and its INT8 page pool split over ``make_serve_mesh(model=
    tp)`` shards of the one card (the edge unchanged on the card):
    serially at tp = 2, with ``spec_k=4`` at tp = 2 and serially at
    tp = 4, one timed run each and no profile window (the script's time
    limit; PERF.md §5 keeps an earlier profile's numbers).  Every
    cloud layer's attention is one sharded call of tp kernel launches,
    so ``paged_flash_mq`` launches (prefill calls +
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
    for tag, tp, k, reps in (("serial_tp2", 2, 1, 1), ("spec_tp2", 2, 4, 1),
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
                   tc_launches=first["tc_launches"],
                   expected_launches=expect(st),
                   sharded_calls=first["sharded_calls"],
                   sharded_launches=first["sharded_launches"],
                   int8_matmul_launches=first["int8_matmul_launches"],
                   int8_matmul_splitk_launches=first[
                       "int8_matmul_splitk_launches"],
                   int8_matmul_wgmma_launches=first[
                       "int8_matmul_wgmma_launches"],
                   transmitted_bytes=st.transmitted_bytes,
                   tp1_transmitted_bytes=(main_res if k == 1
                                          else spec_res)["transmitted_bytes"],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   first_output=first["outs"][0])
        emit("tp_path", run=tag, **res)
        out[tag] = res
        del eng, runs, first
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 9: the online control loop at full width
# ---------------------------------------------------------------------------


# the drifting link of the auto-policy run: the main path's 250 KB/s at
# 20 ms, then from DRIFT_AT_S simulated seconds 50 KB/s at 100 ms
DRIFT_AT_S = 20.0


class _ScriptedPolicy:
    """A duck-typed policy, as the JAX suite's ``ScriptedPolicy``: ``(cut0,
    1)`` for ``after`` turns, then ``(cut1, k)`` — the raise applies at
    once, rebuilding the live slots' draft caches, and the cut switch
    waits for the drain.  ``after`` turns on ``cut1`` it drops to k 1, and
    ``after`` turns later raises back to k with live slots (a second
    rebuild).  With ``cut1=None`` only the first raise, at ``cut0``."""
    k_between_requests_only = False

    def __init__(self, cut0: int, cut1, k: int, after: int):
        self.cut0, self.cut1, self.k, self.after = cut0, cut1, k, after
        self.cuts = (cut0,) if cut1 is None else (cut0, cut1)
        self.ks = (1, k)
        self.calls = self.on_new = 0
        self.history = []

    def decide(self, telemetry, *, cut, spec_k, **kw):
        from repro_torch.serve.policy import Decision
        self.calls += 1
        if self.cut1 is not None and cut == self.cut1:
            self.on_new += 1
        if self.on_new == 0:
            tgt = ((self.cut0, 1) if self.calls <= self.after
                   else (self.cut0 if self.cut1 is None else self.cut1,
                         self.k))
        elif self.on_new <= self.after:
            tgt = (self.cut1, self.k)
        elif self.on_new <= 2 * self.after:
            tgt = (self.cut1, 1)
        else:
            tgt = (self.cut1, self.k)
        return Decision(cut=tgt[0], spec_k=tgt[1], s_per_token=0.0,
                        current_s_per_token=0.0, bandwidth_bytes_per_s=0.0,
                        rtt_s=0.0, acceptance=1.0)


def _sum_rows(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_adaptive_path(params, cfg, main_res: dict, *, device="cuda",
                        cut=14, cut_hi=28, n_req=8, plen=128,
                        max_new=32) -> dict:
    """The collaborative engine's online control loop at full width and
    depth, 8 requests x 32 new tokens after 128-token prompts, 4 slots,
    INT8 paged KV on both sides, page 16 (8 requests for the script's
    time limit: the scripted policy's second wave is still live when it
    raises k back).

    (a) ``policy="auto"`` from cut ``cut`` over a ``DriftingChannel``
    (250 KB/s at 20 ms, then 50 KB/s at 100 ms from ``DRIFT_AT_S``).
    Predicted from the cost model (the reference's TX2-class edge and
    TitanXP-class cloud): cut 0 with k 1 at every channel on the way, so
    one cut switch to cut 0 on the first, drained turn, no hold and no k
    switch.  Asserted, with every decision equal to
    ``autotune.tune_cut_and_k`` at the telemetry it was taken on (and
    at the final telemetry), and the stream, wire bytes and channel time
    equal to a fixed cut-0 engine's on the same traffic; launches as the
    serial step's (layers x (prefills + steps)).  Then the same traffic
    again on the same engine (the link now slow): steady-state tokens/s
    and no switch.

    (b) ``_ScriptedPolicy(cut, cut_hi, 4)``: a warm raise out of k 1 at
    ``cut`` (draft rebuild), a drained switch to ``cut_hi``, a drop to
    k 1 and a warm raise back to 4 — asserted as one cut switch, three k
    switches, two rebuilds and at least one hold; every request its
    whole budget; the requests admitted before the switch equal, token
    for token, a fixed-``cut`` engine's that raises k at the same turn
    (their share equal to the serial main path's is reported).

    The launch counts of (a)'s and (b)'s control-loop runs are summed by
    summary row; the comparison engines' runs do not count."""
    from repro_torch.core.autotune import tune_cut_and_k
    from repro_torch.core.costmodel import (CLOUD_TITANXP_CLASS, Channel,
                                            EDGE_TX2_CLASS)
    from repro_torch.serve.engine import CollaborativeServingEngine
    from repro_torch.serve.transport import DriftingChannel

    max_len = plen + max_new + 24
    prompts = _prompts(n_req, plen, cfg.vocab, seed=0)
    n_layers = cfg.n_layers

    def drift():
        return DriftingChannel([(0.0, Channel.from_kbps(250.0, rtt_ms=20.0)),
                                (DRIFT_AT_S,
                                 Channel.from_kbps(50.0, rtt_ms=100.0))])

    def serial(st):
        return n_layers * (st.prefill_calls + st.decode_steps)

    # (a) the auto policy
    ch = drift()
    t0 = time.perf_counter()
    eng = CollaborativeServingEngine(params, cfg, cut_layer=cut, channel=ch,
                                     max_len=max_len, policy="auto",
                                     device=device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    pol = eng.policy
    auto = _timed(eng, prompts, max_new, cfg.vocab, serial, "adaptive auto")
    st = auto["stats"]
    grid = dict(batch=eng.max_batch, cuts=pol.cuts, ks=pol.ks,
                edge=EDGE_TX2_CLASS, cloud=CLOUD_TITANXP_CLASS.scaled(1))
    decisions = []
    for d in pol.history:
        best, _ = tune_cut_and_k(
            cfg, channel=Channel(bandwidth_bytes_per_s=d.bandwidth_bytes_per_s,
                                 rtt_s=d.rtt_s),
            acceptance=d.acceptance, **grid)
        decisions.append(dict(cut=d.cut, spec_k=d.spec_k,
                              s_per_token=d.s_per_token,
                              replaced_s_per_token=d.current_s_per_token,
                              bandwidth_bytes_per_s=d.bandwidth_bytes_per_s,
                              rtt_s=d.rtt_s, tuner=[best.cut, best.k]))
    final_ch = eng.telemetry.channel(pol.fallback_channel)
    final, _ = tune_cut_and_k(cfg, channel=final_ch,
                              acceptance=eng.telemetry.acceptance(
                                  pol.acceptance_prior), **grid)
    got = dict(cut_switches=st.cut_switches, policy_holds=st.policy_holds,
               spec_k_switches=st.spec_k_switches, cut=eng.cut,
               spec_k=eng.spec_k,
               decisions=[(d["cut"], d["spec_k"]) for d in decisions],
               tuner=[tuple(d["tuner"]) for d in decisions],
               final_tuner=(final.cut, final.k))
    want = dict(cut_switches=1, policy_holds=0, spec_k_switches=0, cut=0,
                spec_k=1, decisions=[(0, 1)], tuner=[(0, 1)],
                final_tuner=(0, 1))
    if got != want:
        raise AssertionError(f"adaptive auto: {got}, predicted {want}")
    clock = ch.clock_s
    auto_res = dict(
        setup_s=setup_s, wall_s=auto["wall"],
        tokens_per_s=sum(map(len, auto["outs"])) / auto["wall"],
        simulated_channel_s=clock, drift_at_s=DRIFT_AT_S,
        channel_latency_s=st.channel_latency_s,
        transmitted_bytes=st.transmitted_bytes,
        prefill_calls=st.prefill_calls, decode_steps=st.decode_steps,
        launches=auto["launches"], tc_launches=auto["tc_launches"],
        decisions=decisions,
        telemetry=dict(bandwidth_bytes_per_s=final_ch.bandwidth_bytes_per_s,
                       rtt_s=final_ch.rtt_s),
        **{k: got[k] for k in ("cut_switches", "policy_holds",
                               "spec_k_switches")})
    launches_a = auto["by_row"]
    # the same traffic again on the same engine, now on the slow link:
    # steady-state tokens/s, and still no switch
    again = _timed(eng, prompts, max_new, cfg.vocab, serial, "adaptive auto")
    ast = again["stats"]
    if (ast.cut_switches, ast.spec_k_switches, ast.policy_holds,
            len(pol.history)) != (0, 0, 0, 1):
        raise AssertionError(f"adaptive auto, second run: switches "
                             f"{ast.cut_switches} / {ast.spec_k_switches}, "
                             f"holds {ast.policy_holds}, history "
                             f"{pol.history}")
    auto_res.update(second_run_tokens_per_s=sum(map(len, again["outs"]))
                    / again["wall"], second_run_wall_s=again["wall"],
                    second_run_channel_latency_s=ast.channel_latency_s,
                    second_run_streams_equal=again["outs"] == auto["outs"])
    del eng, pol, again
    _free(device)
    fixed = CollaborativeServingEngine(params, cfg, cut_layer=0,
                                       channel=drift(), max_len=max_len,
                                       device=device)
    ref = _timed(fixed, prompts, max_new, cfg.vocab, serial, "fixed cut 0")
    fst = ref["stats"]
    for f in ("transmitted_bytes", "decode_bytes_log", "prefill_bytes",
              "channel_latency_s"):
        if getattr(fst, f) != getattr(st, f):
            raise AssertionError(f"adaptive auto: {f} differs from the "
                                 f"fixed cut-0 engine's")
    if ref["outs"] != auto["outs"]:
        raise AssertionError("adaptive auto: streams differ from the "
                             "fixed cut-0 engine's")
    auto_res.update(fixed_cut0_tokens_per_s=sum(map(len, ref["outs"]))
                    / ref["wall"], fixed_cut0_wall_s=ref["wall"],
                    streams_equal_fixed_cut0=True,
                    wire_equal_fixed_cut0=True)
    del fixed, ref
    _free(device)

    # (b) the scripted policy: warm raise, drained cut switch, drop, raise
    after = 3
    pol = _ScriptedPolicy(cut, cut_hi, 4, after)
    eng = CollaborativeServingEngine(
        params, cfg, cut_layer=cut, channel=Channel.from_kbps(250.0,
                                                              rtt_ms=20.0),
        max_len=max_len, policy=pol, device=device)
    admitted_at = []
    orig_admit = eng._admit

    def admit(toks, *a, **kw):
        admitted_at.append((eng.cut, toks.shape[0]))
        return orig_admit(toks, *a, **kw)

    eng._admit = admit
    scr = _timed(eng, prompts, max_new, cfg.vocab, None, "adaptive scripted")
    del eng._admit        # the wrapper holds the engine: free it with it
    st = scr["stats"]
    got = dict(cut_switches=st.cut_switches,
               spec_k_switches=st.spec_k_switches,
               draft_rebuilds=st.draft_rebuilds, cut=eng.cut,
               spec_k=eng.spec_k, holds=st.policy_holds >= 1)
    want = dict(cut_switches=1, spec_k_switches=3, draft_rebuilds=2,
                cut=cut_hi, spec_k=4, holds=True)
    if got != want:
        raise AssertionError(f"adaptive scripted: {got}, scripted {want}")
    n_before = sum(n for c, n in admitted_at if c == cut)
    launches_b = scr["by_row"]
    scr_res = dict(wall_s=scr["wall"],
                   tokens_per_s=sum(map(len, scr["outs"])) / scr["wall"],
                   policy_holds=st.policy_holds, spec_rounds=st.spec_rounds,
                   acceptance_rate=st.acceptance_rate(),
                   prefill_calls=st.prefill_calls,
                   decode_steps=st.decode_steps,
                   launches=scr["launches"], tc_launches=scr["tc_launches"],
                   admitted_before_switch=n_before,
                   transmitted_bytes=st.transmitted_bytes,
                   **{k: got[k] for k in ("cut_switches", "spec_k_switches",
                                          "draft_rebuilds")})
    del eng
    _free(device)
    fixed = CollaborativeServingEngine(
        params, cfg, cut_layer=cut, channel=Channel.from_kbps(250.0,
                                                              rtt_ms=20.0),
        max_len=max_len, policy=_ScriptedPolicy(cut, None, 4, after),
        device=device)
    ref = _timed(fixed, prompts[:n_before], max_new, cfg.vocab, None,
                 "fixed cut, same raise")
    if n_before < 1 or ref["outs"] != scr["outs"][:n_before]:
        raise AssertionError(f"adaptive scripted: the {n_before} requests "
                             f"admitted before the switch differ from the "
                             f"fixed-cut engine's")
    serial_outs = main_res["outs"][:n_before]
    scr_res.update(before_switch_equal_fixed_cut=True,
                   before_switch_agreement_with_serial=sum(
                       a == b for o, s_ in zip(scr["outs"], serial_outs)
                       for a, b in zip(o, s_))
                   / max(1, sum(map(len, serial_outs))))
    del fixed, ref
    _free(device)
    launches = _sum_rows(launches_a, launches_b)
    if not (launches["paged_flash_mq"] and launches["paged_flash_mq_tc"]):
        raise AssertionError(f"adaptive path: B1 launches {launches}")
    res = dict(arch=cfg.name, layers=n_layers, d_model=cfg.d_model,
               requests=n_req, slots=4, prompt_len=plen, max_new=max_new,
               start_cut=cut, reduced=None, auto=auto_res, scripted=scr_res,
               launches=launches)
    emit("adaptive_path", **res)
    return res


# ---------------------------------------------------------------------------
# Phase 10: overload serving at full width
# ---------------------------------------------------------------------------


# the overload run's pool squeeze: (start, end, free pages) in simulated
# seconds, mid-run (while every request still decoding has pages to grow)
OVERLOAD_WINDOW = (6.0, 12.0, 0)


def phase_overload_path(params, cfg, *, device="cuda", cut=14) -> dict:
    """Overload-robust serving at full width and depth: 8 requests x 64
    new tokens after 128-token prompts arriving 1 s apart on the
    simulated clock, every second one at priority 1, 4 slots, INT8 paged
    KV, page 16, over ``FaultyChannel(250 KB/s, 20 ms, seed 0)`` with no
    faults, on a pool of half the worst-case pages (24 usable against
    48: the JAX suite's 2x oversubscription), with ``demand_paged=True``,
    ``admission="deadline"`` and a ``PressureSchedule`` squeezing the
    pool to 0 free pages over ``OVERLOAD_WINDOW``.  Requests 2 and 4
    (priority 0) carry deadlines below their predicted finish alone, 3
    and 5 (priority 1) deadlines far above it with every other request's
    budget queued ahead.

    Asserted: at least one preemption; exactly the two doomed requests
    shed; every other request its whole budget; no deadline missed; the
    simulated clock equal to channel time plus charged stall waits (to
    1e-9 relative: the two are summed in other orders); every page back
    on the free list; launches as the serial step's (layers x (prefills
    + steps), replays among the prefills) with the tensor-core kernel
    once a layer a prefill.  Reported beside a worst-case-reservation
    engine on the same traffic (no admission policy, no squeeze):
    tokens/s, B1's split and tensor-core launches, and the share of the
    served tokens equal to its streams (an INT8 replay recalibrates over
    the longer prefix and may flip a near-tie, as the reference says)."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve import (FaultyChannel, LinkTelemetry,
                                   PressureSchedule, Request)
    from repro_torch.serve.engine import CollaborativeServingEngine
    from repro_torch.serve.policy import DeadlineAdmission

    n_req, plen, max_new, page, slots = 8, 128, 64, 16, 4
    max_len = plen + max_new + 24
    worst_pages = slots * -(-(plen + max_new) // page)
    num_pages = worst_pages // 2 + 1
    base = Channel.from_kbps(250.0, rtt_ms=20.0)
    prompts = _prompts(n_req, plen, cfg.vocab, seed=1)
    n_layers = cfg.n_layers
    adm = DeadlineAdmission(cfg, batch=slots, fallback_channel=base)

    def predict(i, queue):
        return adm.predict_finish(LinkTelemetry(), now=float(i), cut=cut,
                                  spec_k=1, plen=plen, max_new=max_new,
                                  slots=slots, queue_tokens=queue)

    tight, loose = (2, 4), (3, 5)
    deadlines = {i: float(i) + 0.5 for i in tight}
    deadlines.update({i: float(i) + 1000.0 for i in loose})
    alone = {i: predict(i, 0.0) for i in tight}
    crowded = {i: predict(i, float((n_req - 1) * max_new)) for i in loose}
    if not (all(deadlines[i] < alone[i] for i in tight)
            and all(deadlines[i] > crowded[i] for i in loose)):
        raise AssertionError(f"overload: deadlines {deadlines} do not "
                             f"straddle the predictions {alone} {crowded}")

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=max_new,
                        priority=i % 2, arrival_s=float(i),
                        deadline_s=deadlines.get(i))
                for i, p in enumerate(prompts)]

    def serial(st):
        return n_layers * (st.prefill_calls + st.decode_steps)

    runs = {}
    for tag, kw in (("robust", dict(demand_paged=True, admission="deadline",
                                    pressure=PressureSchedule(
                                        [OVERLOAD_WINDOW]))),
                    ("worst_case", {})):
        fch = FaultyChannel(base, seed=0)
        eng = CollaborativeServingEngine(
            params, cfg, cut_layer=cut, channel=fch, max_len=max_len,
            page_size=page, num_pages=num_pages, device=device, **kw)
        reqs = requests()
        r = _counted(eng, lambda: eng.generate_requests(reqs))
        st = r["stats"]
        if r["launches"] != serial(st) or \
                r["tc_launches"] != n_layers * st.prefill_calls:
            raise AssertionError(
                f"overload {tag}: {r['launches']} launches "
                f"({r['tc_launches']} tensor-core), expected {serial(st)} "
                f"({n_layers * st.prefill_calls})")
        if eng.pressure is not None:
            eng.pressure.apply(eng._pool.allocator, float("inf"))
        a = eng._pool.allocator
        served = [q for q in reqs if not q.shed]
        runs[tag] = dict(
            reqs=reqs, stats=st, clock_s=fch.clock_s, wall=r["wall"],
            launches=r["launches"], tc_launches=r["tc_launches"],
            by_row=r["by_row"], pages_back=(a.num_free == a.num_pages - 1
                                            and not a.live),
            tokens=sum(len(q.out_tokens) for q in served))
        del eng
        _free(device)
    rob, worst = runs["robust"], runs["worst_case"]
    st = rob["stats"]
    shed = sorted(q.uid for q in rob["reqs"] if q.shed)
    full = all(len(q.out_tokens) == max_new and q.done
               for q in rob["reqs"] if not q.shed)
    decomposed = math.isclose(rob["clock_s"],
                              st.channel_latency_s + st.stall_wait_s,
                              rel_tol=1e-9)
    checks = dict(preempted=st.preemptions >= 1, shed=shed,
                  full_budgets=full, deadline_misses=st.deadline_misses,
                  clock_decomposes=decomposed, pages_back=rob["pages_back"],
                  worst_pages_back=worst["pages_back"],
                  worst_full=all(len(q.out_tokens) == max_new
                                 for q in worst["reqs"]))
    want = dict(preempted=True, shed=list(tight), full_budgets=True,
                deadline_misses=0, clock_decomposes=True, pages_back=True,
                worst_pages_back=True, worst_full=True)
    if checks != want:
        raise AssertionError(f"overload: {checks}, expected {want}")
    pairs = [(q.out_tokens, w.out_tokens)
             for q, w in zip(rob["reqs"], worst["reqs"]) if not q.shed]
    agree = sum(a == b for o, w in pairs for a, b in zip(o, w)) / max(
        1, sum(len(o) for o, _ in pairs))
    res = dict(
        arch=cfg.name, layers=n_layers, cut=cut, requests=n_req,
        slots=slots, prompt_len=plen, max_new=max_new, page=page,
        num_pages=num_pages, worst_case_pages=worst_pages,
        window=list(OVERLOAD_WINDOW), reduced=None,
        deadlines=deadlines, predicted_alone=alone,
        predicted_behind_all=crowded,
        shed=shed, preemptions=st.preemptions,
        preemptions_by_request={q.uid: q.preemptions for q in rob["reqs"]},
        stall_wait_s=st.stall_wait_s, queue_wait_s=st.queue_wait_s,
        channel_latency_s=st.channel_latency_s,
        simulated_clock_s=rob["clock_s"],
        clock_minus_parts_s=rob["clock_s"] - st.channel_latency_s
        - st.stall_wait_s,
        finish_s={q.uid: q.finish_s for q in rob["reqs"]},
        prefill_calls=st.prefill_calls, decode_steps=st.decode_steps,
        pool_utilization_peak=st.pool_utilization_peak,
        wall_s=rob["wall"], tokens=rob["tokens"],
        tokens_per_s=rob["tokens"] / rob["wall"],
        split_launches=rob["launches"] - rob["tc_launches"],
        tc_launches=rob["tc_launches"],
        worst_case=dict(wall_s=worst["wall"], tokens=worst["tokens"],
                        tokens_per_s=worst["tokens"] / worst["wall"],
                        split_launches=worst["launches"]
                        - worst["tc_launches"],
                        tc_launches=worst["tc_launches"],
                        prefill_calls=worst["stats"].prefill_calls,
                        decode_steps=worst["stats"].decode_steps,
                        deadline_misses=worst["stats"].deadline_misses,
                        simulated_clock_s=worst["clock_s"]),
        token_share_equal_worst_case=agree, launches=rob["by_row"])
    emit("overload_path", **res)
    return res


# ---------------------------------------------------------------------------
# Phase 10b: the resilient engine at full width
# ---------------------------------------------------------------------------


# the resilient run's faults on the simulated clock: a 5 % drop rate and
# two outage windows (start, end) in seconds — the first opens in the
# first wave's decode and closes after each live slot has buffered 17-31
# boundary rows (so the replay runs at S > 16: the tensor-core kernel at
# q_start > 0), the second covers the second wave's admission (the
# calibrating resync).  Picked, and the counts below taken, from a CPU
# rehearsal of the same traffic at d_model 4096 (``rehearse_resilient``)
RESILIENT_DROP_P = 0.05
RESILIENT_OUTAGES = ((19.0, 20.1), (21.7, 22.7))
# the reliable transport's deadline until its telemetry locks on: the
# first prefill's 2.1 MB take 8.4 s at 250 KB/s, which the default 0.5 s
# would count as lost on every attempt
RESILIENT_FALLBACK_DEADLINE_S = 10.0
# the rehearsal's counts at spec_k = 1, which depend only on wire bytes
RESILIENT_REHEARSAL = dict(
    prefill_calls=2, decode_steps=62, decode_tokens=248,
    edge_only_tokens=160, resyncs=2, retries=10, timeouts=31,
    corrupt_msgs=0, outage_s=12.135839999999988,
    channel_latency_s=34.19603098911199, transmitted_bytes=5203232,
    decode_bytes=3104224, clock_s=34.19603098911199,
    faults={"drop": 4, "corrupt": 0, "stall": 0, "outage": 27},
    phase_calls={"_edge_prefill": 2, "_cloud_prefill": 1,
                 "_draft_prefill_impl": 2, "_edge_decode": 0,
                 "_edge_only_logits": 62, "_cloud_decode": 23,
                 "_spec_draft_impl": 0, "_verify_impl": 0,
                 "_resync_replay_impl": 1, "_resync_prefill_impl": 1},
    replay_lens={"_resync_replay_impl": [23],
                 "_resync_prefill_impl": [143]},
    edge_only_calls=62, resync_calls=2, seq=50, rounds_down=41,
    committed_before_outage=[(0, 6), (1, 6), (2, 6), (3, 6), (4, 0),
                             (5, 0), (6, 0), (7, 0)])
# the B1 launches each phase makes per call, by design (S * group > 16
# takes the tensor-core kernel): phase -> (layers, kernel)
RESILIENT_PHASES = ("_edge_prefill", "_cloud_prefill", "_draft_prefill_impl",
                    "_edge_decode", "_edge_only_logits", "_cloud_decode",
                    "_spec_draft_impl", "_verify_impl",
                    "_resync_replay_impl", "_resync_prefill_impl")


class _PhaseLaunches:
    """While active, count each call of ``eng``'s phases ``names`` and
    the B1 launches (split and tensor-core) made inside it, with the
    replay length R of each resync phase call and the draft length k of
    each ``_spec_draft_impl`` call."""

    def __init__(self, eng, names):
        self.eng, self.names = eng, names
        self.calls = {n: 0 for n in names}
        self.split = {n: 0 for n in names}
        self.tc = {n: 0 for n in names}
        self.replay_lens = {n: [] for n in names if n.startswith("_resync")}
        self.draft_ks = []

    def __enter__(self):
        from repro_torch.kernels import paged_attention as PA
        fn = PA.paged_flash_mq
        for n in self.names:
            def wrap(*a, _orig=getattr(self.eng, n), _n=n, **kw):
                l0, t0 = fn.launches, fn.tc_launches
                out = _orig(*a, **kw)
                self.calls[_n] += 1
                self.tc[_n] += fn.tc_launches - t0
                self.split[_n] += fn.launches - l0 - (fn.tc_launches - t0)
                if _n.startswith("_resync"):
                    self.replay_lens[_n].append(int(a[1].shape[1]))
                elif _n == "_spec_draft_impl":
                    self.draft_ks.append(int(a[0]))
                return out
            setattr(self.eng, n, wrap)
        return self

    def __exit__(self, *exc):
        for n in self.names:
            delattr(self.eng, n)


def _resilient_run(params, cfg, *, device, cut, spec_k, kind) -> dict:
    """The resilient path's traffic — 8 requests x 32 new tokens after
    128-token prompts, 4 slots, INT8 paged KV, page 16 — on a fresh
    engine over ``FaultyChannel(250 KB/s, 20 ms, seed 0)`` with
    ``RESILIENT_DROP_P`` and ``RESILIENT_OUTAGES``.  ``kind``:
    ``"resilient"`` (``ResilientCollaborativeEngine``) or ``"naive"``
    (the plain engine, whose blocking channel stalls through the
    windows).  Returns the streams, counters, phase calls and launches,
    and each request's tokens committed before the first outage."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve import (CollaborativeServingEngine, FaultyChannel,
                                   ReliableTransport, Request,
                                   ResilientCollaborativeEngine)

    n_req, plen, max_new, page = 8, 128, 32, 16
    fch = FaultyChannel(Channel.from_kbps(250.0, rtt_ms=20.0), seed=0,
                        drop_p=RESILIENT_DROP_P,
                        outages=[list(w) for w in RESILIENT_OUTAGES])
    kw = dict(cut_layer=cut, channel=fch, spec_k=spec_k, page_size=page,
              max_len=plen + max_new + 24, device=device)
    if kind == "resilient":
        eng = ResilientCollaborativeEngine(
            params, cfg, transport=ReliableTransport(
                fch, fallback_deadline_s=RESILIENT_FALLBACK_DEADLINE_S),
            **kw)
    else:
        eng = CollaborativeServingEngine(params, cfg, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(_prompts(n_req, plen, cfg.vocab, seed=0))]
    before = {}
    if kind == "resilient":
        def enter(pos, _orig=eng._enter_outage):
            if not before:
                before.update({r.uid: (r.max_new_tokens if r.done else 0)
                               for r in reqs})
                before.update({r.uid: c for r, c in
                               eng._sched_active.values()})
            _orig(pos)
        eng._enter_outage = enter
    names = [n for n in RESILIENT_PHASES if hasattr(eng, n)]
    with _PhaseLaunches(eng, names) as ph:
        r = _counted(eng, lambda: eng.generate_requests(reqs))
    st = r["stats"]
    a = eng._pool.allocator
    out = dict(
        kind=kind, spec_k=spec_k, outs=[q.out_tokens for q in reqs],
        wall_s=r["wall"], tokens=sum(len(q.out_tokens) for q in reqs),
        full_budgets=all(len(q.out_tokens) == max_new for q in reqs),
        stats=st, clock_s=fch.clock_s, faults=dict(fch.faults),
        launches=r["launches"], tc_launches=r["tc_launches"],
        by_row=r["by_row"], phase_calls=dict(ph.calls),
        phase_split=dict(ph.split), phase_tc=dict(ph.tc),
        replay_lens=dict(ph.replay_lens),
        pages_back=a.num_free == a.num_pages - 1 and not a.live,
        n_layers=cfg.n_layers, n_edge=eng.n_edge, n_cloud=eng.n_cloud,
        committed_before_outage=before)
    if kind == "resilient":
        del eng._enter_outage
        out.update(cloud_down=eng.cloud_down, round_log=list(eng.round_log),
                   edge_only_calls=eng.phase_calls["edge_only"],
                   resync_calls=eng.phase_calls["resync"],
                   seq=eng.transport.seq,
                   loss_rate=eng.transport.telemetry.loss_rate)
    del eng
    _free(device)
    return out


def _resilient_counts(run: dict) -> dict:
    """A run's schedule: what depends only on wire bytes at spec_k = 1
    (the CPU rehearsal's numbers)."""
    st = run["stats"]
    return dict(prefill_calls=st.prefill_calls, decode_steps=st.decode_steps,
                decode_tokens=st.decode_tokens,
                edge_only_tokens=st.edge_only_tokens, resyncs=st.resyncs,
                retries=st.retries, timeouts=st.timeouts,
                corrupt_msgs=st.corrupt_msgs, outage_s=st.outage_s,
                channel_latency_s=st.channel_latency_s,
                transmitted_bytes=st.transmitted_bytes,
                decode_bytes=st.decode_bytes, clock_s=run["clock_s"],
                faults=run["faults"], phase_calls=run["phase_calls"],
                replay_lens=run["replay_lens"],
                edge_only_calls=run.get("edge_only_calls"),
                resync_calls=run.get("resync_calls"), seq=run.get("seq"),
                rounds_down=sum(e["cloud_down"]
                                for e in run.get("round_log", [])),
                committed_before_outage=sorted(
                    run["committed_before_outage"].items()))


def _expected_phase_launches(run: dict) -> dict:
    """The B1 launches each phase's calls imply: (split, tensor-core)."""
    n_layers, n_edge, n_cloud = run["n_layers"], run["n_edge"], \
        run["n_cloud"]
    k, calls = run["spec_k"], run["phase_calls"]
    per = {"_edge_prefill": (0, n_edge), "_cloud_prefill": (0, n_cloud),
           "_draft_prefill_impl": (0, n_cloud), "_edge_decode": (n_edge, 0),
           "_edge_only_logits": (n_layers, 0), "_cloud_decode": (n_cloud, 0),
           "_spec_draft_impl": (k * n_layers, 0),
           "_verify_impl": (n_cloud, 0), "_resync_prefill_impl": (0, n_cloud)}
    want = {n: (calls[n] * per[n][0], calls[n] * per[n][1])
            for n in calls if n in per}
    if "_resync_replay_impl" in calls:
        lens = run["replay_lens"]["_resync_replay_impl"]
        want["_resync_replay_impl"] = (
            n_cloud * sum(r <= 16 for r in lens),
            n_cloud * sum(r > 16 for r in lens))
    return want


def phase_resilient_path(params, cfg, *, fault_free=None, device="cuda",
                         cut=14) -> dict:
    """The resilient engine on the main path's weights and traffic at
    full width and depth: ``ResilientCollaborativeEngine`` at
    ``spec_k=1`` and ``spec_k=4`` and the plain engine (the naive
    baseline, k = 1) on the same fault schedule (``_resilient_run``),
    each on a fresh engine freed before the next; ``fault_free`` maps k
    to the fault-free streams of the same requests (the main and spec
    paths'), else they are run here.

    Asserted: every request its whole budget; at least two resyncs and
    the cloud up at the end; every page back; each phase's B1 launches
    those its calls imply (``_expected_phase_launches``; every launch of
    the run inside one of them), with at least one tensor-core launch
    from a resync replay; at spec_k = 1 every count equal to the CPU
    rehearsal's (``RESILIENT_REHEARSAL``); the tokens each request
    committed before the first outage equal to the fault-free engine's;
    the naive engine's streams equal to the fault-free serial ones.
    Reported: tokens/s, simulated channel s, edge-only tokens, resyncs,
    outage s, retries, timeouts, B1 split and tensor-core launches with
    the resync phases' apart."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve import CollaborativeServingEngine

    fault_free = dict(fault_free or {})
    for k in (1, 4):
        if k not in fault_free:
            eng = CollaborativeServingEngine(
                params, cfg, cut_layer=cut, spec_k=k,
                channel=Channel.from_kbps(250.0, rtt_ms=20.0),
                max_len=128 + 32 + 24, device=device)
            fault_free[k] = eng.generate(
                _prompts(8, 128, cfg.vocab, seed=0), max_new_tokens=32)
            del eng
            _free(device)
    runs = {}
    for tag, k, kind in (("k1", 1, "resilient"), ("k4", 4, "resilient"),
                         ("naive", 1, "naive")):
        runs[tag] = _resilient_run(params, cfg, device=device, cut=cut,
                                   spec_k=k, kind=kind)
    checks, res = {}, dict(arch=cfg.name, layers=cfg.n_layers, cut=cut,
                           requests=8, slots=4, prompt_len=128, max_new=32,
                           page=16, drop_p=RESILIENT_DROP_P,
                           outages=[list(w) for w in RESILIENT_OUTAGES],
                           reduced=None)
    for tag, run in runs.items():
        st = run["stats"]
        want = _expected_phase_launches(run)
        got = {n: (run["phase_split"][n], run["phase_tc"][n]) for n in want}
        attributed = sum(s + t for s, t in got.values())
        checks[tag] = dict(
            full_budgets=run["full_budgets"], pages_back=run["pages_back"],
            phase_launches_as_designed=got == want,
            every_launch_in_a_phase=attributed == run["launches"])
        replay_tc = run["phase_tc"].get("_resync_replay_impl", 0)
        if run["kind"] == "resilient":
            k = run["spec_k"]
            ff = fault_free[k]
            n0 = run["committed_before_outage"]
            checks[tag].update(
                resyncs=st.resyncs >= (2 if k == 1 else 1),
                cloud_up=not run["cloud_down"],
                committed_before_outage=sum(n0.values()) > 0,
                before_outage_equal_fault_free=all(
                    run["outs"][u][:n] == ff[u][:n] for u, n in n0.items()))
            if k == 1:
                # the schedule the rehearsal fixed: both resync flavours,
                # the replay at R = 23 on the tensor-core kernel
                checks[tag].update(
                    replay_tc_launch=replay_tc > 0,
                    counts_equal_rehearsal=(_resilient_counts(run)
                                            == RESILIENT_REHEARSAL))
        else:
            checks[tag]["streams_equal_fault_free"] = \
                run["outs"] == fault_free[1]
        res[tag] = dict(
            spec_k=run["spec_k"], kind=run["kind"], wall_s=run["wall_s"],
            tokens=run["tokens"], tokens_per_s=run["tokens"] / run["wall_s"],
            simulated_channel_s=st.channel_latency_s,
            simulated_clock_s=run["clock_s"],
            edge_only_tokens=st.edge_only_tokens, resyncs=st.resyncs,
            outage_s=st.outage_s, retries=st.retries, timeouts=st.timeouts,
            prefill_calls=st.prefill_calls, decode_steps=st.decode_steps,
            spec_rounds=st.spec_rounds, draft_hits=st.draft_hits,
            transmitted_bytes=st.transmitted_bytes, faults=run["faults"],
            split_launches=run["launches"] - run["tc_launches"],
            tc_launches=run["tc_launches"],
            resync_split_launches=sum(
                run["phase_split"].get(n, 0) for n in
                ("_resync_replay_impl", "_resync_prefill_impl")),
            resync_tc_launches=sum(
                run["phase_tc"].get(n, 0) for n in
                ("_resync_replay_impl", "_resync_prefill_impl")),
            replay_tc_launches=replay_tc,
            phase_calls=run["phase_calls"], replay_lens=run["replay_lens"],
            committed_before_outage=run["committed_before_outage"],
            counts=_resilient_counts(run), checks=checks[tag])
    res["launches"] = _sum_rows(runs["k1"]["by_row"], runs["k4"]["by_row"])
    emit("resilient_path", **res)
    bad = {t: {c: v for c, v in ch.items() if v is not True}
           for t, ch in checks.items()}
    if any(bad.values()):
        raise AssertionError(f"resilient path: failed checks {bad}")
    return res


def rehearse_resilient() -> dict:
    """The resilient path's spec_k = 1 schedule on this host's CPU: the
    same traffic and faults on a 2-layer model of deepseek-7b's width
    (d_model 4096, so the same wire bytes; a small vocabulary and FFN,
    which the schedule does not see), cut 0.  Prints and returns
    ``_resilient_counts``: ``RESILIENT_REHEARSAL``.  Run with
    ``python3 -c "import chip_smoke as c; c.rehearse_resilient()"``."""
    cfg, params = _rehearsal_model(2)
    run = _resilient_run(params, cfg, device="cpu", cut=0, spec_k=1,
                         kind="resilient")
    counts = _resilient_counts(run)
    print(repr(counts), flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 10c: the fleet at full width
# ---------------------------------------------------------------------------


# the fleet's tenants — name, cut, k, link (KB/s, RTT ms) — on the links
# of the reference's BENCH_fleet_serve.json; every channel is a
# FaultyChannel seeded with the tenant's index, fault-free but for the
# storm's, which drops FLEET_DROP_P of its messages and is down over
# FLEET_OUTAGES (picked on the CPU rehearsal, ``rehearse_fleet``, to fall
# mid-stream: after its prefill, before its last step)
FLEET_TENANTS = (("edge0", 14, 4, 2000.0, 20.0),
                 ("edge1", 14, 4, 1000.0, 40.0),
                 ("edge2", 14, 1, 500.0, 60.0),
                 ("edge3", 28, 1, 250.0, 80.0))
FLEET_STORM = "edge3"
FLEET_DROP_P = 0.05
FLEET_OUTAGES = ((6.0, 7.0),)
FLEET_PLEN, FLEET_NEW, FLEET_REQS = 128, 32, 2
FLEET_MAX_LEN = FLEET_PLEN + FLEET_NEW + 24
FLEET_SLOTS, FLEET_PAGE = 8, 16
# the rehearsal's counts: the k = 1 tenants' (they depend only on wire
# bytes) and the storm channel's
FLEET_REHEARSAL = {
    "edge2": dict(prefill_calls=1, prefill_tokens=256, decode_steps=31,
                  decode_tokens=62, transmitted_bytes=1307392,
                  prefill_bytes=1048656, decode_bytes=256432,
                  downlink_bytes=2304, channel_latency_s=6.454784000000012,
                  stall_wait_s=0.0),
    "edge3": dict(prefill_calls=1, prefill_tokens=256, decode_steps=31,
                  decode_tokens=62, transmitted_bytes=1307392,
                  prefill_bytes=1048656, decode_bytes=256432,
                  downlink_bytes=2304, channel_latency_s=12.34956799999999,
                  stall_wait_s=0.0),
    "storm": dict(faults={"drop": 1, "corrupt": 0, "stall": 0, "outage": 1},
                  attempts=66, clock_s=12.34956799999999)}
# the cross-tenant preemption run: two tenants at cut 14, k 1, "hog"
# with 3 requests and "meek" with 1, 4 slots, demand-paged on a pool
# whose 36 usable pages hold the four admissions (9 pages each) but not
# their growth to 10: the first page fault mid-decode must preempt
FLEET_PREEMPT_PAGES = 37
FLEET_PREEMPT_REHEARSAL = {
    "hog": dict(preemptions=1, prefill_calls=2, prefill_tokens=528,
                decode_steps=46, decode_tokens=93,
                transmitted_bytes=2550924),
    "meek": dict(preemptions=0, prefill_calls=1, prefill_tokens=128,
                 decode_steps=31, decode_tokens=31,
                 transmitted_bytes=655744)}
FLEET_PHASES = ("_edge_prefill", "_cloud_prefill", "_draft_prefill_impl",
                "_edge_decode", "_cloud_decode", "_spec_draft_impl",
                "_verify_impl")


def _fleet_specs(tenants, cuts, outages):
    """``TenantSpec``s of ``tenants`` (name, cut, k, KB/s, RTT ms), each
    cut mapped through ``cuts``, on fresh channels."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve import FaultyChannel, TenantSpec
    specs = []
    for i, (name, cut, k, kbps, rtt) in enumerate(tenants):
        base = Channel.from_kbps(kbps, rtt_ms=rtt)
        ch = (FaultyChannel(base, seed=i, drop_p=FLEET_DROP_P,
                            outages=[list(w) for w in outages])
              if name == FLEET_STORM else FaultyChannel(base, seed=i))
        specs.append(TenantSpec(name, ch, cut_layer=cuts.get(cut, cut),
                                spec_k=k))
    return specs


def _fleet_prompts(tenants, vocab, lens=None) -> dict:
    """Each tenant's prompts: ``FLEET_REQS`` of ``FLEET_PLEN`` tokens, or
    of ``lens[name]``, seeded by the tenant's index."""
    out = {}
    for i, (name, *_rest) in enumerate(tenants):
        rng = np.random.RandomState(20 + i)
        ns = lens[name] if lens else [FLEET_PLEN] * FLEET_REQS
        out[name] = [rng.randint(0, vocab, n).astype(np.int32) for n in ns]
    return out


def _cache_finite(runtimes) -> bool:
    return all(bool(torch.isfinite(v).all())
               for rt in runtimes
               for c in (rt._edge_cache, rt._cloud_cache, rt._draft_cache)
               if c is not None
               for v in c.values() if v.is_floating_point())


def _fleet_run(params, cfg, *, device, specs, prompts, max_new,
               max_batch=FLEET_SLOTS, max_len=FLEET_MAX_LEN,
               page=FLEET_PAGE, logits=False, **kw) -> dict:
    """One run of a fresh ``FleetServingEngine`` over ``specs`` with
    every kernel's launch count set to 0 just before it and read just
    after: the streams, each tenant's counters and channel, the round
    calls, and each runtime's phase calls with the B1 launches (split
    and tensor-core) made inside them; with ``logits`` also each
    committed index's logits (``_CommittedLogits``)."""
    from repro_torch.serve import FleetServingEngine
    fleet = FleetServingEngine(params, cfg, specs, max_batch=max_batch,
                               max_len=max_len, page_size=page,
                               device=device, **kw)
    for c in sorted({s.cut_layer for s in specs}):
        fleet._runtime(c)
    phs = {c: _PhaseLaunches(rt, FLEET_PHASES)
           for c, rt in fleet._runtimes.items()}
    for ph in phs.values():
        ph.__enter__()
    rec = _CommittedLogits(fleet, fleet=True) if logits else None
    if rec:
        rec.__enter__()
    cuda = torch.device(device).type == "cuda"
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t0 = time.perf_counter()
        outs = fleet.generate(prompts, max_new_tokens=max_new)
        _sync(device)
        wall = time.perf_counter() - t0
        by_row = _launch_counts()
    finally:
        if rec:
            rec.__exit__()
        for ph in phs.values():
            ph.__exit__()
            ph.eng = None
    a = fleet._pool.allocator
    tenants = fleet._tenants
    res = dict(
        outs=outs, wall=wall, by_row=by_row,
        logits=rec.rows if rec else None,
        tokens=sum(len(o) for v in outs.values() for o in v),
        stats={n: t.stats for n, t in tenants.items()},
        clocks={n: t.transport.channel.clock_s for n, t in tenants.items()},
        faults={n: dict(t.transport.channel.faults)
                for n, t in tenants.items()},
        attempts={n: t.transport.channel.attempts
                  for n, t in tenants.items()},
        round_calls=fleet.round_calls, num_pages=a.num_pages,
        pages_back=a.num_free == a.num_pages - 1 and not a.live,
        owner_pages={n: fleet._pool.owner_pages(n) for n in tenants},
        finite=_cache_finite(fleet._runtimes.values()),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        runtimes={c: dict(n_edge=rt.n_edge, n_cloud=rt.n_cloud,
                          calls=dict(phs[c].calls),
                          split=dict(phs[c].split), tc=dict(phs[c].tc),
                          draft_ks=list(phs[c].draft_ks))
                  for c, rt in fleet._runtimes.items()})
    del fleet
    _free(device)
    return res


def _fleet_launch_checks(run, n_layers) -> dict:
    """B1's launches against what the phase calls imply, per runtime
    and phase: (split, tensor-core); every launch inside a phase; every
    round a decode or a draft call."""
    got, want = {}, {}
    for c, rt in run["runtimes"].items():
        e, cl = rt["n_edge"], rt["n_cloud"]
        per = {"_edge_prefill": (0, e), "_cloud_prefill": (0, cl),
               "_draft_prefill_impl": (0, cl), "_edge_decode": (e, 0),
               "_cloud_decode": (cl, 0), "_verify_impl": (cl, 0)}
        for n, calls in rt["calls"].items():
            got[f"{c}{n}"] = (rt["split"][n], rt["tc"][n])
            want[f"{c}{n}"] = ((sum(rt["draft_ks"]) * n_layers, 0)
                               if n == "_spec_draft_impl" else
                               (calls * per[n][0], calls * per[n][1]))
    attributed = sum(s + t for s, t in got.values())
    rounds = sum(rt["calls"]["_edge_decode"] + rt["calls"]["_spec_draft_impl"]
                 for rt in run["runtimes"].values())
    return dict(phase_launches_as_designed=got == want,
                every_launch_in_a_phase=attributed
                == run["by_row"]["paged_flash_mq"],
                rounds_are_group_calls=rounds == run["round_calls"],
                tc_launches_are_prefills=sum(t for _, t in got.values())
                == run["by_row"]["paged_flash_mq_tc"])


def _fleet_counts(run) -> dict:
    """The schedule a CPU rehearsal fixes: the k = 1 tenants' counters
    (byte-driven), the storm channel's faults, attempts and clock."""
    keep = ("prefill_calls", "prefill_tokens", "decode_steps",
            "decode_tokens", "transmitted_bytes", "prefill_bytes",
            "decode_bytes", "downlink_bytes", "channel_latency_s",
            "stall_wait_s")
    out = {n: {f: getattr(run["stats"][n], f) for f in keep}
           for n, _c, k, *_r in FLEET_TENANTS if k == 1}
    out["storm"] = dict(faults=run["faults"][FLEET_STORM],
                        attempts=run["attempts"][FLEET_STORM],
                        clock_s=run["clocks"][FLEET_STORM])
    return out


def _preempt_specs():
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve import FaultyChannel, TenantSpec
    return [TenantSpec("hog", FaultyChannel(
                Channel.from_kbps(2000.0, rtt_ms=20.0), seed=0),
                cut_layer=14, spec_k=1),
            TenantSpec("meek", FaultyChannel(
                Channel.from_kbps(500.0, rtt_ms=60.0), seed=1),
                cut_layer=14, spec_k=1)]


def _preempt_run(params, cfg, *, device, cuts) -> dict:
    specs = _preempt_specs()
    for s in specs:
        s.cut_layer = cuts.get(s.cut_layer, s.cut_layer)
    prompts = _fleet_prompts((("hog",), ("meek",)), cfg.vocab,
                             lens={"hog": [FLEET_PLEN] * 3,
                                   "meek": [FLEET_PLEN]})
    return _fleet_run(params, cfg, device=device, specs=specs,
                      prompts=prompts, max_new=FLEET_NEW, max_batch=4,
                      num_pages=FLEET_PREEMPT_PAGES, demand_paged=True)


def _preempt_counts(run) -> dict:
    keep = ("preemptions", "prefill_calls", "prefill_tokens",
            "decode_steps", "decode_tokens", "transmitted_bytes")
    return {n: {f: getattr(st, f) for f in keep}
            for n, st in run["stats"].items()}


class _CommittedLogits:
    """While active, keep on the device the f32 logits each committed
    output index of every request of ``eng`` came from: ``rows[key, i]``,
    ``key`` the request's uid on a solo engine and (tenant, uid) on a
    fleet.  Index 0 comes from the prefill, index ``c + j`` from row j
    of a decode or verify round over a slot whose request had ``c``
    tokens committed before it; a round that computes a position again
    overwrites it, so each position's last record is its committed one.
    Only copies on the device: no host sync is added."""

    def __init__(self, eng, fleet: bool = False):
        self.eng, self.fleet, self.rows = eng, fleet, {}
        self._undo = []

    def _key(self, r):
        return (r.tenant, r.uid) if self.fleet else r.uid

    def _wrap(self, obj, name, make):
        own = obj.__dict__.get(name)        # a module's or an instance's
        setattr(obj, name, make(getattr(obj, name)))
        self._undo.append((obj, name, own))

    def __enter__(self):
        from repro_torch.models import transformer as TF
        eng, rows = self.eng, self.rows
        pending, inside = [], []      # prefill keys; decode round slots

        def keep(key, i, row):
            rows[key, i] = row.to(torch.float32, copy=True)

        def head(orig):
            def fn(tail, x):
                logits = orig(tail, x)
                if inside:
                    for slot in inside[-1]:
                        r, c = eng._sched_active[slot]
                        for j in range(logits.shape[1]):
                            keep(self._key(r), c + j, logits[slot, j])
                return logits
            return fn

        def round_phase(orig, slots):
            def fn(*args, **kw):
                inside.append(slots())
                try:
                    return orig(*args, **kw)
                finally:
                    inside.pop()
            return fn

        def prefill_body(orig):
            def fn(*args, **kw):
                logits = orig(*args, **kw)
                for n, key in enumerate(pending.pop(0)):
                    if key is not None:
                        keep(key, 0, logits[n])
                return logits
            return fn

        def admit(orig):
            # a resumed request's index 0 is its parked token, not the
            # prefill's
            def fn(group, *args, **kw):
                pending.append([None if r._parked is not None
                                else self._key(r) for r in group])
                return orig(group, *args, **kw)
            return fn

        self._wrap(TF, "lm_head", head)
        if self.fleet:
            group = [()]

            def group_round(orig):
                def fn(runtime, k, slots_g, *args, **kw):
                    group[0] = [int(s) for s in slots_g]
                    return orig(runtime, k, slots_g, *args, **kw)
                return fn

            self._wrap(eng, "_admit_group", admit)
            self._wrap(eng, "_group_round", group_round)
            for rt in eng._runtimes.values():
                self._wrap(rt, "_cloud_prefill_body", prefill_body)
                for name in ("_cloud_decode_merge_impl",
                             "_verify_merge_impl"):
                    self._wrap(rt, name, lambda o: round_phase(
                        o, lambda: group[0]))
        else:
            self._wrap(eng, "_prefill_group", admit)
            self._wrap(eng, "_cloud_prefill_body", prefill_body)
            for name in ("_cloud_decode", "_verify_impl"):
                self._wrap(eng, name, lambda o: round_phase(
                    o, lambda: list(eng._sched_active)))
        return self

    def __exit__(self, *exc):
        for obj, name, own in reversed(self._undo):
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        self._undo, self.eng = [], None


def _solo_runs(params, cfg, *, device, jobs, num_pages=None,
               logits=False, max_len=FLEET_MAX_LEN, max_new=FLEET_NEW,
               **kw) -> dict:
    """Solo ``CollaborativeServingEngine`` runs: ``jobs`` maps a tag to
    (cut, k, max_batch, channel, prompts); one engine per (cut, k,
    max_batch), on ``num_pages`` at the fleet's ``max_batch``, reused
    with a fresh transport and stats, freed before the next.  Returns
    per tag the streams, stats, wall, and with ``logits`` each committed
    index's logits (``_CommittedLogits``)."""
    from repro_torch.serve import CollaborativeServingEngine, Transport
    from repro_torch.serve.stats import ServeStats
    out = {}
    keys = sorted({j[:3] for j in jobs.values()})
    for cut, k, mb in keys:
        eng = CollaborativeServingEngine(
            params, cfg, cut_layer=cut, spec_k=k, max_batch=mb,
            max_len=max_len, page_size=FLEET_PAGE,
            num_pages=num_pages if mb == FLEET_SLOTS else None,
            device=device, **kw)
        for tag, (c_, k_, mb_, ch, prompts) in jobs.items():
            if (c_, k_, mb_) != (cut, k, mb):
                continue
            eng.transport, eng.stats = Transport(ch), ServeStats()
            rec = _CommittedLogits(eng) if logits else None
            t0 = time.perf_counter()
            with rec or contextlib.nullcontext():
                outs = eng.generate(prompts, max_new_tokens=max_new)
            _sync(device)
            out[tag] = dict(outs=outs, stats=eng.stats,
                            logits=rec.rows if rec else None,
                            wall=time.perf_counter() - t0)
        del eng
        _free(device)
    return out


def _fleet_divergence(tenant, fleet, solo) -> dict:
    """Where each of ``tenant``'s fleet streams first leaves its stream
    on a solo engine, read from the committed logits both runs recorded
    (``_CommittedLogits``): each computed that index after the same
    tokens, through GEMMs of other row counts where the request was
    prefilled in another group or batch.  A row is a near-tie, as
    ``_index0`` holds a request prefilled in another group, when the two
    top logits and each run's logits at either run's token agree within
    ``INT8_NOISE_TOL``; ``recorded`` says each run's logits give its own
    token.  Also the top-2 gaps there and the largest difference of the
    top logits over the agreeing indices before it."""
    rows = []
    for uid, (x, y) in enumerate(zip(fleet["outs"][tenant], solo["outs"])):
        i = next((j for j in range(min(len(x), len(y))) if x[j] != y[j]),
                 None)
        row = dict(request=uid, first_divergent=i)
        if i is not None:
            la = fleet["logits"][(tenant, uid), i].double().cpu()
            lb = solo["logits"][uid, i].double().cpu()
            ta, tb = int(x[i]), int(y[i])
            top_a, top_b = torch.topk(la, 2).values, torch.topk(lb, 2).values
            diff = max(abs(float(la[t] - lb[t])) for t in (ta, tb))
            diff = max(diff, abs(float(top_a[0] - top_b[0])))
            noise = max((abs(float(fleet["logits"][(tenant, uid), j].max()
                                   - solo["logits"][uid, j].max()))
                         for j in range(i)), default=0.0)
            row.update(tokens=[ta, tb],
                       top2_gaps=[float(top_a[0] - top_a[1]),
                                  float(top_b[0] - top_b[1])],
                       logit_diff=diff,
                       row_max_diff=float((la - lb).abs().max()),
                       top_logit_noise_before=noise,
                       recorded=bool(la[ta] == top_a[0]
                                     and lb[tb] == top_b[0]),
                       near_tie=diff <= INT8_NOISE_TOL)
        rows.append(row)
    return dict(equal=fleet["outs"][tenant] == solo["outs"], requests=rows)


def phase_fleet_path(params, cfg, *, device="cuda") -> dict:
    """The fleet on the main path's weights at full width and depth:
    ``FleetServingEngine`` with the four ``FLEET_TENANTS`` (cuts 14 and
    28, k 4 and 1), 2 requests x 32 new tokens after 128-token prompts
    each, all arriving at 0, 8 slots, INT8 paged KV, page 16: three
    (cut, k) groups a turn.  Then the cross-tenant preemption run.

    Asserted: every budget filled and every page back; the caches
    finite; each tenant's stream equal, bit for bit, to its requests on
    a solo ``CollaborativeServingEngine`` of the same cut and k at the
    fleet's batch shape (``max_batch``, ``num_pages``, page size, and
    the prefill group its requests were admitted in — cuBLAS picks a
    GEMM's algorithm by its row count); the k = 1 tenants' counters and
    the storm channel's faults, attempts and clock equal to the CPU
    rehearsal's (``FLEET_REHEARSAL``); the calm tenants with no fault
    and clocks below the storm's; B1's split and tensor-core launches
    those the phase calls imply, every launch inside a phase, every
    round one group call; each tenant's own requests alone on a solo
    engine at the fleet's batch shape (prefilled without their
    co-tenants), wherever they leave the fleet's stream, leaving it at
    a near-tie within ``INT8_NOISE_TOL`` (``_fleet_divergence``, the
    rule ``_index0`` holds a request prefilled in another group to).
    Preemption: hog preempted, meek never, every budget filled, every
    page back, the counts equal to the rehearsal's
    (``FLEET_PREEMPT_REHEARSAL``).

    Reported: round calls beside the solo engines' rounds; tokens/s of
    the fleet and of the solo engines (each tenant's own requests at
    the fleet's batch shape) run one after another, both recording
    their committed logits; peak memory; the own requests' first
    divergences with their gaps and logit differences; the same for
    each tenant's stream on a solo engine at ``max_batch`` 2 (the
    reference test's shape)."""
    from repro_torch.core.costmodel import Channel

    n_layers = cfg.n_layers
    prompts = _fleet_prompts(FLEET_TENANTS, cfg.vocab)
    run = _fleet_run(params, cfg, device=device,
                     specs=_fleet_specs(FLEET_TENANTS, {}, FLEET_OUTAGES),
                     prompts=prompts, max_new=FLEET_NEW, logits=True)
    outs = run["outs"]
    # the solo engines: each tenant's own requests (timed) and at
    # max_batch 2 on its own link; and the requests of each cut-14
    # admission group at k 4 and at k 1 on edge0's link
    links = {name: Channel.from_kbps(kbps, rtt_ms=rtt)
             for name, _c, _k, kbps, rtt in FLEET_TENANTS}
    group14 = [p for name, c, *_r in FLEET_TENANTS if c == 14
               for p in prompts[name]]
    own = {name: (c, k, FLEET_SLOTS, links[name], prompts[name])
           for name, c, k, *_r in FLEET_TENANTS}
    shaped = {"group14_k4": (14, 4, FLEET_SLOTS, links["edge0"], group14),
              "group14_k1": (14, 1, FLEET_SLOTS, links["edge0"], group14)}
    solo = _solo_runs(params, cfg, device=device, jobs={**own, **shaped},
                      num_pages=run["num_pages"], logits=True)
    mb2 = _solo_runs(params, cfg, device=device, logits=True,
                     jobs={name: (c, k, 2, links[name], prompts[name])
                           for name, c, k, *_r in FLEET_TENANTS})
    # each tenant's rows in the solo run of its fleet batch shape
    pos14 = {name: i for i, name in enumerate(
        n for n, c, *_r in FLEET_TENANTS if c == 14)}
    want = {}
    for name, c, k, *_r in FLEET_TENANTS:
        if c == 14:
            rows = solo[f"group14_k{k}"]["outs"]
            want[name] = rows[FLEET_REQS * pos14[name]:
                              FLEET_REQS * (pos14[name] + 1)]
        else:
            want[name] = solo[name]["outs"]
    own_div = {n: _fleet_divergence(n, run, solo[n])
               for n, *_r in FLEET_TENANTS}
    checks = dict(
        full_budgets=all(len(o) == FLEET_NEW for v in outs.values()
                         for o in v),
        pages_back=run["pages_back"], caches_finite=run["finite"],
        streams_equal_solo_at_fleet_shape={
            n: outs[n] == want[n] for n, *_r in FLEET_TENANTS},
        own_requests_solo_near_ties={
            n: all(r.get("recorded", True) and r.get("near_tie", True)
                   for r in own_div[n]["requests"])
            for n, *_r in FLEET_TENANTS},
        calm_fault_free=all(sum(run["faults"][n].values()) == 0
                            for n, *_r in FLEET_TENANTS
                            if n != FLEET_STORM),
        calm_clocks_below_storm=all(
            run["clocks"][n] < run["clocks"][FLEET_STORM]
            for n, *_r in FLEET_TENANTS if n != FLEET_STORM),
        storm_faulted=sum(run["faults"][FLEET_STORM].values()) > 0,
        **(_fleet_launch_checks(run, n_layers)
           if torch.device(device).type == "cuda" else {}))
    counts = _fleet_counts(run)
    checks["counts_equal_rehearsal"] = counts == FLEET_REHEARSAL
    pre = _preempt_run(params, cfg, device=device, cuts={})
    pst = pre["stats"]
    pcounts = _preempt_counts(pre)
    pchecks = dict(
        hog_preempted=pst["hog"].preemptions >= 1,
        meek_never=pst["meek"].preemptions == 0,
        full_budgets=all(len(o) == FLEET_NEW for v in pre["outs"].values()
                         for o in v),
        pages_back=pre["pages_back"], caches_finite=pre["finite"],
        **(_fleet_launch_checks(pre, n_layers)
           if torch.device(device).type == "cuda" else {}))
    pchecks["counts_equal_rehearsal"] = pcounts == FLEET_PREEMPT_REHEARSAL
    own_wall = sum(solo[n]["wall"] for n, *_r in FLEET_TENANTS)
    own_tokens = sum(len(o) for n, *_r in FLEET_TENANTS
                     for o in solo[n]["outs"])
    split = run["by_row"]["paged_flash_mq"] - run["by_row"][
        "paged_flash_mq_tc"]
    res = dict(
        arch=cfg.name, layers=n_layers, slots=FLEET_SLOTS,
        prompt_len=FLEET_PLEN, max_new=FLEET_NEW, page=FLEET_PAGE,
        max_len=FLEET_MAX_LEN, num_pages=run["num_pages"],
        tenants=[list(t) for t in FLEET_TENANTS], storm=FLEET_STORM,
        drop_p=FLEET_DROP_P, outages=[list(w) for w in FLEET_OUTAGES],
        reduced=None, wall_s=run["wall"], tokens=run["tokens"],
        tokens_per_s=run["tokens"] / run["wall"],
        solo_sequential=dict(wall_s=own_wall, tokens=own_tokens,
                             tokens_per_s=own_tokens / own_wall,
                             rounds=sum(solo[n]["stats"].decode_steps
                                        for n, *_r in FLEET_TENANTS)),
        round_calls=run["round_calls"], peak_gb=run["peak_gb"],
        split_launches=split,
        tc_launches=run["by_row"]["paged_flash_mq_tc"],
        phase_calls={c: rt["calls"] for c, rt in run["runtimes"].items()},
        per_tenant={n: dict(
            decode_steps=run["stats"][n].decode_steps,
            spec_rounds=run["stats"][n].spec_rounds,
            acceptance=run["stats"][n].acceptance_rate(),
            transmitted_bytes=run["stats"][n].transmitted_bytes,
            clock_s=run["clocks"][n], faults=run["faults"][n],
            attempts=run["attempts"][n])
            for n, *_r in FLEET_TENANTS},
        own_requests_solo=own_div, int8_noise_tol=INT8_NOISE_TOL,
        max_batch2={n: _fleet_divergence(n, run, mb2[n])
                    for n, *_r in FLEET_TENANTS},
        counts=counts, checks=checks,
        preemption=dict(
            slots=4, num_pages=FLEET_PREEMPT_PAGES, wall_s=pre["wall"],
            tokens=pre["tokens"], tokens_per_s=pre["tokens"] / pre["wall"],
            preemptions={n: st.preemptions for n, st in pst.items()},
            split_launches=pre["by_row"]["paged_flash_mq"]
            - pre["by_row"]["paged_flash_mq_tc"],
            tc_launches=pre["by_row"]["paged_flash_mq_tc"],
            counts=pcounts, checks=pchecks),
        launches=_sum_rows(run["by_row"], pre["by_row"]))
    emit("fleet_path", **res)
    bad = {t: {c: v for c, v in ch.items()
               if v is not True and not (isinstance(v, dict)
                                         and all(v.values()))}
           for t, ch in (("fleet", checks), ("preemption", pchecks))}
    if any(bad.values()):
        raise AssertionError(f"fleet path: failed checks {bad}")
    return res


# ---------------------------------------------------------------------------
# Phase 10d: the dense KV caches, the seed recompute path, the LM's segments
# ---------------------------------------------------------------------------


# timed runs of each engine of (a) and (c), in turns: one each since the
# MoE path came in (the script's time limit), three before
DENSE_REPEATS = 1
SEGMENT_REPEATS = 3        # (e)'s timed infers a batch
SEED_PROMPTS, SEED_NEW = 4, 8
# the seed path's first token against the incremental engine's (a 16-bit
# lattice on both, fp dense caches): their prefill logits may differ by
# the rounding of GEMMs of other shapes, the bound ``_index0`` puts on
# two engines' rows
SEED_FIRST_TOL = 0.25


def _add_launches(acc: dict, counts: dict) -> None:
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v


def _dense_edge_bytes(cfg, eng) -> int:
    """A dense INT8 edge cache's bytes by formula: ``k`` and ``v``, one
    byte an element over [n_edge, slots, max_len, n_kv, hd], and their
    f32 scales [n_edge, n_kv]."""
    elems = eng.n_edge * eng.max_batch * eng.max_len * cfg.n_kv * cfg.hd
    return 2 * elems + 2 * eng.n_edge * cfg.n_kv * 4


def _seed_bytes(n: int, plen: int, new: int, d_model: int,
                itemsize: int) -> int:
    """The seed path's raw-total wire bytes: at step i the whole
    [n, plen + i, d_model] blob, one Eq.(1) frame and one header."""
    from repro_torch.serve.transport import _MSG_BYTES, _QP_BYTES
    return sum(n * (plen + i) * d_model * itemsize + _QP_BYTES + _MSG_BYTES
               for i in range(new))


def _runs_summary(rs) -> dict:
    walls = [r["wall"] for r in rs]
    n_tok = sum(len(o) for o in rs[0]["out"])
    return dict(tokens=n_tok, wall_s_reps=walls,
                tokens_per_s_reps=[n_tok / w for w in walls],
                tokens_per_s=n_tok / statistics.median(walls),
                streams_repeat_identical=all(r["out"] == rs[0]["out"]
                                             for r in rs))


def _agreement(a, b) -> dict:
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    return dict(first_token_equal=[p[0] == q[0] for p, q in zip(a, b)],
                token_agreement=same / sum(len(p) for p in a))


def phase_dense_path(params, cfg, *, device="cuda", parity=True) -> dict:
    """The dense KV caches at deepseek-7b's full width and depth (bf16,
    the main path's weights), cut 14, the main path's traffic (8
    requests x 32 new tokens after 128-token prompts, 4 slots, 250 KB/s
    at 20 ms):

    (a) ``CollaborativeServingEngine(edge_paged=False,
        cloud_paged=False)`` — the INT8 dense edge (fixed scales), the
        fp dense cloud — timed in turns with the paged main-path engine:
        wire bytes, prefill calls and decode steps equal to the paged
        engine's (asserted), ``edge_cache_bytes()`` equal to the dense
        layout's formula (asserted), peak memory;
    (b) the dense engine at ``spec_k=4``: rounds, acceptance;
    (c) the cloud-only ``ServingEngine`` dense (the reference's default)
        in turns with ``paged=True``;
    (d) the seed path, ``generate_recompute`` on 4 prompts x 8 new
        tokens at ``a_bits`` 8 and 16: wall time, tokens/s, wire bytes
        equal to the raw-total formula (asserted); at 16 bits each first
        token held to the dense incremental engine's (fp dense caches)
        by prefill logits within ``SEED_FIRST_TOL`` (``_index0``'s
        rule);
    (e) the paper's ``CollaborativeEngine`` on ``make_segments(seq=128)``
        cut at ``blk14/ffn``, batch 1 and 4: edge and cloud ms, blob
        bytes (asserted), relative error against ``full_apply``
        (reported);
    (f) card against CPU at 3 layers (``_dense_parity``).

    Every kernel's launches over the dense runs (a)-(e) are read from
    the counters, set to 0 just before each: all must be 0 (no dense
    path reaches a paged kernel).  ``device="cpu"`` with
    ``parity=False`` rehearses (a)-(e) on a small model on the CPU."""
    from repro_torch.core.collab import CollaborativeEngine
    from repro_torch.core.costmodel import QP_BYTES, Channel
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import (CollaborativeServingEngine,
                                          ServingEngine)

    t_phase = time.perf_counter()
    n_req, plen, max_new, cut = 8, 128, 32, 14
    max_len = plen + max_new + 24
    channel = Channel.from_kbps(250.0, rtt_ms=20.0)
    prompts = _prompts(n_req, plen, cfg.vocab, seed=0)
    dense_kw = dict(edge_paged=False, cloud_paged=False)
    launches = {}

    def engine(**kw):
        return CollaborativeServingEngine(params, cfg, cut_layer=cut,
                                          channel=channel, max_len=max_len,
                                          device=device, **kw)
    on_card = torch.device(device).type == "cuda"

    def counted(e, fn, dense=True):
        r = _counted(e, fn)
        if dense:
            _add_launches(launches, r["by_row"])
        return r

    def well_formed(outs, n_new, what):
        if not all(len(o) == n_new and all(0 <= t < cfg.vocab for t in o)
                   for o in outs):
            raise AssertionError(f"dense path {what}: malformed streams")

    # (a) dense against paged, in turns
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    paged, dense = engine(), engine(**dense_kw)
    for e in (paged, dense):
        e.generate(prompts[:1], max_new_tokens=2)      # warm-up
    runs = {"paged": [], "dense": []}
    for _ in range(DENSE_REPEATS):
        for tag, e in (("paged", paged), ("dense", dense)):
            runs[tag].append(counted(
                e, lambda e=e: e.generate(prompts, max_new_tokens=max_new),
                dense=tag == "dense"))
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    pst, dst = runs["paged"][0]["stats"], runs["dense"][0]["stats"]
    for r in runs["dense"] + runs["paged"]:
        well_formed(r["out"], max_new, "(a)")
    for k in ("transmitted_bytes", "prefill_bytes", "prefill_calls",
              "decode_steps"):
        if getattr(pst, k) != getattr(dst, k):
            raise AssertionError(f"dense path (a): {k} {getattr(dst, k)} "
                                 f"!= the paged engine's {getattr(pst, k)}")
    want_b1 = cfg.n_layers * (pst.prefill_calls + pst.decode_steps)
    if on_card and runs["paged"][0]["launches"] != want_b1:
        raise AssertionError(f"dense path (a): the paged engine launched "
                             f"B1 {runs['paged'][0]['launches']} times, "
                             f"expected {want_b1}")
    edge_bytes = dense.edge_cache_bytes()
    if edge_bytes != _dense_edge_bytes(cfg, dense):
        raise AssertionError(f"dense path (a): edge_cache_bytes "
                             f"{edge_bytes} != {_dense_edge_bytes(cfg, dense)}")
    res = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=str(cfg.dtype), cut=cut, requests=n_req, slots=4,
               prompt_len=plen, max_new=max_new, max_len=max_len,
               reps=DENSE_REPEATS,
               dense=dict(**_runs_summary(runs["dense"]),
                          prefill_calls=dst.prefill_calls,
                          decode_steps=dst.decode_steps,
                          transmitted_bytes=dst.transmitted_bytes,
                          prefill_bytes=dst.prefill_bytes,
                          edge_cache_bytes=edge_bytes,
                          edge_cache_dtype=str(dense._edge_cache["k"].dtype),
                          cloud_cache_dtype=str(
                              dense._cloud_cache["k"].dtype)),
               paged=dict(**_runs_summary(runs["paged"]),
                          transmitted_bytes=pst.transmitted_bytes,
                          edge_cache_bytes=paged.edge_cache_bytes(),
                          b1_launches=runs["paged"][0]["launches"]),
               dense_vs_paged=_agreement(runs["dense"][0]["out"],
                                         runs["paged"][0]["out"]),
               peak_mem_gb=peak)
    del paged, dense, runs
    _free(device)

    # (b) the dense engine's speculative rounds
    spec = engine(spec_k=4, **dense_kw)
    spec.generate(prompts[:1], max_new_tokens=2)
    r = counted(spec, lambda: spec.generate(prompts, max_new_tokens=max_new))
    well_formed(r["out"], max_new, "(b)")
    st = r["stats"]
    n_tok = sum(len(o) for o in r["out"])
    res["spec_k4"] = dict(tokens=n_tok, wall_s=r["wall"],
                          tokens_per_s=n_tok / r["wall"],
                          rounds=st.spec_rounds,
                          acceptance=st.acceptance_rate(),
                          drafted_tokens=st.drafted_tokens,
                          draft_hits=st.draft_hits,
                          transmitted_bytes=st.transmitted_bytes)
    del spec, r
    _free(device)

    # (c) cloud-only: dense (the reference's default) and paged, in turns
    clouds = {"dense": ServingEngine(params, cfg, max_len=max_len,
                                     device=device),
              "paged": ServingEngine(params, cfg, max_len=max_len,
                                     paged=True, device=device)}
    for e in clouds.values():
        e.generate(prompts[:1], max_new_tokens=2)
    cruns = {"dense": [], "paged": []}
    for _ in range(DENSE_REPEATS):
        for tag, e in clouds.items():
            cruns[tag].append(counted(
                e, lambda e=e: e.generate(prompts, max_new_tokens=max_new),
                dense=tag == "dense"))
    for tag in cruns:
        well_formed(cruns[tag][0]["out"], max_new, "(c)")
    if (cruns["dense"][0]["stats"].decode_steps
            != cruns["paged"][0]["stats"].decode_steps):
        raise AssertionError("dense path (c): decode steps differ")
    res["cloud_only"] = dict(
        dense=dict(**_runs_summary(cruns["dense"]),
                   cache_bytes=clouds["dense"].cache_bytes()),
        paged=_runs_summary(cruns["paged"]),
        dense_vs_paged=_agreement(cruns["dense"][0]["out"],
                                  cruns["paged"][0]["out"]))
    del clouds, cruns
    _free(device)

    # (d) the seed recompute path
    sp = prompts[:SEED_PROMPTS]
    seed = {}
    for bits, item in ((8, 1), (16, 2)):
        e = engine(a_bits=bits, **dense_kw)
        first = None
        if bits == 16:      # the first step's logits, outside the count
            first = e.forward(np.stack(sp))[:, -1].float()
        r = counted(e, lambda e=e: e.generate_recompute(
            sp, max_new_tokens=SEED_NEW))
        well_formed(r["out"], SEED_NEW, "(d)")
        want = _seed_bytes(len(sp), plen, SEED_NEW, cfg.d_model, item)
        if r["stats"].transmitted_bytes != want or \
                r["stats"].decode_steps != SEED_NEW:
            raise AssertionError(
                f"dense path (d) at a_bits={bits}: "
                f"{r['stats'].transmitted_bytes} wire bytes over "
                f"{r['stats'].decode_steps} steps, expected {want} over "
                f"{SEED_NEW}")
        n_tok = len(sp) * SEED_NEW
        seed[bits] = dict(tokens=n_tok, wall_s=r["wall"],
                          tokens_per_s=n_tok / r["wall"],
                          transmitted_bytes=r["stats"].transmitted_bytes,
                          channel_s=r["stats"].channel_latency_s,
                          out=r["out"], first=first)
        del e, r
        _free(device)
    inc = engine(a_bits=16, edge_int8=False, cloud_int8=False, **dense_kw)
    with _PrefillGroups(inc) as pg:
        r = counted(inc, lambda: inc.generate(sp, max_new_tokens=SEED_NEW))
    rows = []
    for u, (a, b) in enumerate(zip(seed[16]["out"], r["out"])):
        la, lb = seed[16]["first"][u].double().cpu(), pg.logits[u].double()\
            .cpu()
        ta, tb = a[0], b[0]
        if ta != int(torch.argmax(la)):
            raise AssertionError(f"dense path (d): request {u}'s first "
                                 f"recompute token {ta} is not the argmax "
                                 f"of the first step's logits")
        diff = max(abs(float(la[t] - lb[t])) for t in (ta, tb))
        diff = max(diff, abs(float(la.max() - lb.max())))
        row = dict(request=u, tokens=[ta, tb], logit_diff=diff,
                   row_max_diff=float((la - lb).abs().max()))
        if diff > SEED_FIRST_TOL:
            raise AssertionError(f"dense path (d): request {u}'s first "
                                 f"token differs beyond a near-tie: {row}")
        rows.append(row)
    res["seed_path"] = dict(
        prompts=len(sp), prompt_len=plen, max_new=SEED_NEW,
        **{f"a_bits{b}": {k: v for k, v in d.items()
                          if k not in ("out", "first")}
           for b, d in seed.items()},
        recompute_vs_incremental=_agreement(seed[16]["out"], r["out"]),
        first_token_rows=rows, first_token_tol=SEED_FIRST_TOL)
    del inc, r, seed, pg
    _free(device)

    # (e) the paper's engine on the LM's block segments
    model = TF.make_segments(params, cfg, seq=plen)
    model.verify_alignment()
    ceng = CollaborativeEngine(model, f"blk{cut}/ffn", channel=channel,
                               device=device)
    res["collab_engine"] = {"cut": f"blk{cut}/ffn",
                            "edge_download_bytes": ceng.edge_download_bytes}
    for b in (1, 4):
        x = torch.tensor(np.stack(prompts[:b]), device=device)
        ceng.infer(x)                                   # warm-up
        _reset_launch_counts()
        recs = [ceng.infer(x) for _ in range(SEGMENT_REPEATS)]
        _sync(device)
        _add_launches(launches, _launch_counts())
        y, rec = recs[-1]
        truth = model.full_apply(x)
        want = b * plen * cfg.d_model + int(QP_BYTES)
        if rec.blob_bytes != want or tuple(y.shape) != (b, plen, cfg.vocab) \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"dense path (e) at batch {b}: blob "
                                 f"{rec.blob_bytes} B (expected {want}), "
                                 f"output {tuple(y.shape)}")
        rel = float(torch.linalg.norm((y - truth).float())
                    / torch.linalg.norm(truth.float()))
        res["collab_engine"][f"batch{b}"] = dict(
            edge_ms=statistics.median(r.edge_wall_s for _, r in recs) * 1e3,
            cloud_ms=statistics.median(r.cloud_wall_s for _, r in recs)
            * 1e3,
            blob_bytes=rec.blob_bytes,
            simulated_s=rec.simulated_latency_s, rel_err_vs_full=rel)
        del y, truth, recs
    del ceng, model
    _free(device)

    if any(launches.values()):
        raise AssertionError(f"dense path: a dense run launched a paged or "
                             f"INT8 kernel: {launches}")
    res["launches"] = launches
    res["phase_s_before_parity"] = time.perf_counter() - t_phase
    emit("dense_path", **res)
    res["parity"] = _dense_parity() if parity else None
    res["phase_s"] = time.perf_counter() - t_phase
    emit("dense_path_done", phase_s=res["phase_s"])
    return res


def _teacher_forced_dense(params, cfg, tokens, device):
    """Last-position logits of ``tokens`` through the cacheless
    ``forward`` (no paged kernel)."""
    from repro_torch.models import transformer as TF
    toks = torch.tensor(np.asarray(tokens, np.int32)[None], device=device)
    return TF.forward(params, toks, cfg)[0][0, -1].double().cpu()


def _dense_parity(cfg=None, *, card="cuda") -> dict:
    """The dense caches and the seed path on the card against the CPU, f32
    (the CPU port is held to the JAX engines by
    ``tests/test_torch_dense_model.py``, ``test_torch_dense_serve.py``
    and ``test_torch_seedpath.py``); ``cfg`` defaults to deepseek-7b at
    full width and 3 layers (the ``gpu`` tests pass a smaller one):

    * one attention layer over a dense INT8 cache at a scalar index (a
      16-token prefill) and a per-row one (4 tokens, one row partly and
      one wholly past the cache's end): outputs within ``PARITY_TOL`` of
      the CPU's (relative to their largest), the written lattices at most
      one step apart and equal in 99.9 % of elements, untouched
      positions unchanged; ``_sdpa`` with ``q_chunk`` equal to the whole
      block's within 1e-5;
    * the dense lossless engine (``a_bits=None``, fp dense caches on both
      sides) and ``generate_recompute`` lossless: each card stream equal
      to the CPU's, or a near-tie at the first divergence
      (``_near_ties`` with the cacheless forward's logits); the seed
      path's wire bytes equal;
    * the dense INT8 default (INT8 dense edge, fp dense cloud): the
      card's decisions held to the CPU's up to the first tie
      (``_int8_divergence``).

    ``card="cpu"`` rehearses the checks with the CPU in the card's
    place."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as ML
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import CollaborativeServingEngine

    t0 = time.perf_counter()
    if cfg is None:
        cfg = dataclasses.replace(get_arch("deepseek-7b").full, n_layers=3,
                                  dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p_gpu = init_lm(cfg, torch.Generator(device=card).manual_seed(3),
                        device=card)
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        attn = {d: tree_map(lambda t: t[0], p["blocks"]["attn"])
                for d, p in (("card", p_gpu), ("cpu", p_cpu))}
        g = torch.Generator().manual_seed(4)
        t_len = 24
        rope = ML.rope_table(t_len, cfg.hd)
        scales = (0.04 + 0.02 * torch.rand(cfg.n_kv, generator=g),
                  0.04 + 0.02 * torch.rand(cfg.n_kv, generator=g))
        cache0 = {k: torch.randint(-127, 128, (3, t_len, cfg.n_kv, cfg.hd),
                                   generator=g, dtype=torch.int8)
                  for k in ("k", "v")}
        attn_rows = {}
        # each case: its new tokens, index, and the positions it writes
        for tag, s, idx, written in (
                ("scalar", 16, torch.tensor(4), [(r, 4, 20) for r in
                                                  range(3)]),
                ("vector", 4, torch.tensor([3, t_len - 2, t_len + 1]),
                 [(0, 3, 7), (1, t_len - 2, t_len)])):
            x = torch.randn(3, s, cfg.d_model, generator=g)
            out, caches = {}, {}
            for tag_d, dev in (("card", card), ("cpu", "cpu")):
                c = {k: v.to(dev) for k, v in cache0.items()}
                out[tag_d], _ = ML.attention(
                    attn[tag_d], x.to(dev), n_heads=cfg.n_heads,
                    n_kv=cfg.n_kv, rope=tuple(t.to(dev) for t in rope),
                    kv_cache=c, cache_index=idx.to(dev),
                    kv_scales=tuple(t.to(dev) for t in scales))
                caches[tag_d] = {k: v.cpu() for k, v in c.items()}
            err = float((out["card"].cpu() - out["cpu"]).abs().max())
            top = float(out["cpu"].abs().max())
            steps = [torch.cat([(caches["card"][k][r, a:b].int()
                                 - caches["cpu"][k][r, a:b].int()).abs()
                                .flatten() for r, a, b in written])
                     for k in ("k", "v")]
            same = min(float((d == 0).float().mean()) for d in steps)
            if err > PARITY_TOL * max(top, 1.0) or \
                    max(int(d.max()) for d in steps) > 1 or same < 0.999:
                raise AssertionError(f"dense INT8 attention ({tag}) card "
                                     f"vs CPU: err {err}, lattice {same}")
            if tag == "vector":     # untouched positions keep their bytes
                for k in ("k", "v"):
                    c = caches["card"][k]
                    if not (torch.equal(c[0, :3], cache0[k][0, :3])
                            and torch.equal(c[0, 7:], cache0[k][0, 7:])
                            and torch.equal(c[1, :t_len - 2],
                                            cache0[k][1, :t_len - 2])
                            and torch.equal(c[2], cache0[k][2])):
                        raise AssertionError("dense INT8 write past the "
                                             "cache's end changed a "
                                             "position")
            attn_rows[tag] = dict(max_abs_err=err, max_abs=top,
                                  lattice_equal_share=same)
        q = torch.randn(2, 64, cfg.n_heads, cfg.hd, generator=g)
        k = torch.randn(2, 80, cfg.n_heads, cfg.hd, generator=g)
        v = torch.randn(2, 80, cfg.n_heads, cfg.hd, generator=g)
        qd, kd, vd = (t.to(card) for t in (q, k, v))
        whole = ML._sdpa(qd, kd, vd, causal=True, q_offset=16)
        chunked = ML._sdpa(qd, kd, vd, causal=True, q_offset=16, q_chunk=16)
        cpu = ML._sdpa(q, k, v, causal=True, q_offset=16, q_chunk=16)
        qerr = max(float((chunked - whole).abs().max()),
                   float((chunked.cpu() - cpu).abs().max()))
        if qerr > 1e-5:
            raise AssertionError(f"_sdpa q_chunk on the card: {qerr}")

        prompts = [np.random.RandomState(60 + i).randint(0, cfg.vocab, n)
                   .astype(np.int32) for i, n in enumerate((20, 17, 9))]
        seed_prompts = [p[:9] for p in prompts]
        base = dict(cut_layer=0, max_len=48, max_batch=2,
                    edge_paged=False, cloud_paged=False)
        lossless = dict(a_bits=None, edge_int8=False, cloud_int8=False)
        runs, logs, wire = {}, {}, {}
        p_dev = {"card": card, "cpu": "cpu"}
        for dev, p in (("card", p_gpu), ("cpu", p_cpu)):
            eng = CollaborativeServingEngine(p, cfg, device=p_dev[dev],
                                             **base, **lossless)
            runs["lossless", dev] = eng.generate(prompts, max_new_tokens=6)
            eng.stats = type(eng.stats)()
            runs["seed", dev] = eng.generate_recompute(seed_prompts,
                                                       max_new_tokens=4)
            wire[dev] = eng.stats.transmitted_bytes
            del eng
            eng = CollaborativeServingEngine(p, cfg, device=p_dev[dev],
                                             **base)
            with _Decisions() as d:
                runs["int8", dev] = eng.generate(prompts, max_new_tokens=6)
            logs[dev] = d.log
            del eng
        if wire["card"] != wire["cpu"]:
            raise AssertionError(f"seed path wire bytes card {wire['card']}"
                                 f" vs CPU {wire['cpu']}")
        checked = {
            "lossless": _near_ties(runs["lossless", "card"],
                                   runs["lossless", "cpu"], prompts, p_gpu,
                                   p_cpu, cfg, forced=_teacher_forced_dense),
            "seed": _near_ties(runs["seed", "card"], runs["seed", "cpu"],
                               seed_prompts, p_gpu, p_cpu, cfg,
                               forced=_teacher_forced_dense)}
        div = _int8_divergence(logs["card"], logs["cpu"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    res = dict(attention=attn_rows, q_chunk_err=qerr, near_ties=checked,
               int8_divergence=div, seed_wire_bytes=wire["cpu"],
               card_equals_cpu={t: runs[t, "card"] == runs[t, "cpu"]
                                for t in ("lossless", "seed", "int8")})
    emit("path_parity_dense", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype="float32", tol=PARITY_TOL,
         int8_noise_tol=INT8_NOISE_TOL, seconds=time.perf_counter() - t0,
         **res)
    return res


# ---------------------------------------------------------------------------
# Phase 10f: training (ROADMAP A17)
# ---------------------------------------------------------------------------

TRAIN_SHAPE = "train_4k"
TRAIN_BATCH = 4            # train_4k's global batch 256, reduced: 4 x 4096
TRAIN_TIMED_STEPS = 2      # after one warm step
QAT_LAYERS = 2             # (b): deepseek-7b's widths at 2 of 30 layers
QAT_SEQ, QAT_BATCH, QAT_ACCUM, QAT_STEPS = 1024, 4, 2, 4
QAT_LR = 3e-4
CKPT_DISK_MARGIN = 1.25    # free disk wanted over the checkpoint's bytes
# (c): a 3-layer f32 model, card against CPU
TRAIN_PARITY_CFG = dict(name="deepseek-7b-train-parity", n_layers=3,
                        d_model=512, n_heads=4, n_kv=4, d_ff=1376,
                        vocab=4096, dtype=torch.float32)
TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH = 64, 4
TRAIN_LOSS_RTOL = 1e-4     # f32 loss and grad norm, card vs CPU
# after a step a parameter moves by about lr · sign(m): an element whose
# near-zero gradient (or 8-bit moment) lands on the other side moves up
# to 2 lr away; all others within 1e-6
TRAIN_MOVE_ATOL = 1e-6
TRAIN_FLIP_SHARE = 1e-2
# QAT, card vs CPU: a GEMM's one-ulp difference flips an activation's
# Eq.(1) rounding now and then (INT8_NOISE_TOL's cause in serving), and
# the gradient's INT8 compression a lattice step; each flip moves the
# loss and, through Adam, an element's update by up to lr.  At 3 layers,
# d 512 the card and the CPU measured 2.8e-4 apart in loss, 1.46 % of
# the elements off (PERF.md §6)
QAT_LOSS_RTOL = 1e-3
QAT_FLIP_SHARE = 5e-2
SUPERVISOR_STEPS, SUPERVISOR_FAILS = 5, (2, 4)


def _all_fields(cfg) -> dict:
    """Every field of ``cfg``: a ``cfg_override`` that sets the config
    whole."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _train_pipe(cell, vocab: int, seed: int):
    from repro_torch.data.pipeline import TokenPipeline
    b, s = cell.batch_specs["tokens"].shape
    return TokenPipeline(vocab=vocab, seq_len=s, batch=b, seed=seed)


def _train_batches(cell, vocab: int, steps: int, seed: int = 0) -> list:
    """``steps`` TokenPipeline batches at the cell's shape, on its device."""
    from repro_torch.launch.train import batch_for
    pipe = _train_pipe(cell, vocab, seed)
    return [batch_for(cell, pipe, i) for i in range(steps)]


def _lm_train_cell(cfg, *, device, seq=None, batch=None):
    from repro_torch.launch.steps import build_cell
    shape = {k: v for k, v in (("seq_len", seq), ("global_batch", batch))
             if v is not None}
    return build_cell("deepseek-7b", TRAIN_SHAPE,
                      cfg_override=_all_fields(cfg),
                      shape_override=shape or None, device=device)


def _leaf_sample(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    return flat[::max(1, flat.numel() // 65536)].clone()


def _tree_bytes(*trees) -> int:
    from repro_torch.bridge import tree_leaves
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree))


def _peak_gb(device):
    return (torch.cuda.max_memory_allocated() / 1e9
            if torch.device(device).type == "cuda" else None)


def _train_cell_full(params, cfg, *, device, expect_8bit) -> dict:
    """(a) the reference's train cell on ``params``: 8-bit AdamW where
    the rule picks it, accumulation by the rule, constant lr; one warm
    step, then ``TRAIN_TIMED_STEPS`` timed ones."""
    from repro_torch.bridge import tree_flatten
    from repro_torch.launch.steps import use_8bit_moments
    from repro_torch.train.optim import AdamW8bitState
    cell = _lm_train_cell(cfg, device=device, batch=TRAIN_BATCH)
    n_params = sum(t.numel() for _, t in tree_flatten(params))
    want_8bit = use_8bit_moments(n_params)
    if expect_8bit is not None and want_8bit != expect_8bit:
        raise AssertionError(f"train cell: the 8-bit rule says {want_8bit} "
                             f"for {n_params} parameters")
    opt = cell.init_opt(params)
    if isinstance(opt, AdamW8bitState) != want_8bit:
        raise AssertionError("train cell: the optimizer is not the rule's")
    if want_8bit:             # the reference's state shapes and dtypes
        for (path, p), mq, ms, vq, vs in zip(
                tree_flatten(params), *[[t for _, t in tree_flatten(x)]
                                        for x in opt[1:]]):
            blk = (tuple(p.shape[:-1]) + (p.shape[-1] // 128,)
                   if p.shape[-1] % 128 == 0 else ())
            if (tuple(mq.shape), tuple(vq.shape)) != (tuple(p.shape),) * 2 \
                    or (tuple(ms.shape), tuple(vs.shape)) != (blk, blk) \
                    or {mq.dtype, vq.dtype} != {torch.int8} \
                    or {ms.dtype, vs.dtype} != {torch.float32}:
                raise AssertionError(f"8-bit state of {path}")
    batches = _train_batches(cell, cfg.vocab, 1 + TRAIN_TIMED_STEPS)
    before = {path: _leaf_sample(t) for path, t in tree_flatten(params)}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, opt, m = cell.step_fn(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        _sync(device)
        steps.append(dict(step=i + 1, loss=loss, grad_norm=gnorm,
                          seconds=time.perf_counter() - t0))
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train cell step {i + 1}: loss {loss}, "
                                 f"grad norm {gnorm}")
    moved = {path: not torch.equal(before[path], _leaf_sample(t))
             for path, t in tree_flatten(params)}
    moments = [bool((t != 0).any()) for _, t in tree_flatten(
        opt.m_q if want_8bit else opt.m)]
    # a norm scale (1.0) moves by lr·|update|, ~3e-4 a step where the
    # update is Adam's ±1, under half a bf16 spacing at 1.0 (2^-9): it
    # need not move in bf16 (it does where an 8-bit ``v`` rounds to 0 and
    # the update is m / eps); every weight matrix must move, every
    # leaf's moment be non-zero
    stuck = [p for (p, t) in tree_flatten(params)
             if not p.endswith("['scale']") and not moved[p]]
    if stuck or not all(moments):
        raise AssertionError(f"train cell: unmoved weights {stuck}, "
                             f"zero moments {moments}")
    timed = [s["seconds"] for s in steps[1:]]
    step_s = statistics.median(timed)
    tokens = TRAIN_BATCH * cell.batch_specs["tokens"].shape[1]
    profile = None
    if torch.device(device).type == "cuda":
        # one more step under the profiler: device busy and idle share
        # against the timed steps' median wall
        profile = profile_window(
            lambda: cell.step_fn(params, opt, batches[-1]), step_s, top=10)
    return dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=str(cfg.dtype), n_params=n_params, shape=TRAIN_SHAPE,
        global_batch=TRAIN_BATCH, seq_len=cell.batch_specs["tokens"].shape[1],
        reduced={"global_batch": [256, TRAIN_BATCH]},
        grad_accum=cell.grad_accum, remat=cfg.remat, use_8bit=want_8bit,
        lr=3e-4, steps=steps, step_s=step_s, step_s_all=timed,
        tokens_per_s=tokens / step_s, model_flops=cell.model_flops,
        model_flops_per_s=cell.model_flops / step_s,
        share_of_bf16_peak=cell.model_flops / step_s / BF16_FLOPS,
        peak_mem_gb=_peak_gb(device),
        checkpoint_bytes=_tree_bytes(params, opt),
        leaves_moved=sum(moved.values()), leaves=len(moved),
        unmoved_leaves=[p for p, v in moved.items() if not v],
        profile=profile)


def _qat_trainer_full(params, cfg, *, device) -> dict:
    """(b) QAT through the ``Trainer`` at deepseek-7b's widths and
    ``QAT_LAYERS`` layers: f32 AdamW, the cosine schedule, INT8 gradient
    compression, accumulation, one async checkpoint restored bit for bit
    by a fresh ``Trainer``."""
    import shutil
    import tempfile
    from repro_torch.bridge import tree_leaves, tree_map
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as TF
    from repro_torch.train.grads import zeros_like_tree
    from repro_torch.train.loop import Trainer, TrainerConfig, to_device
    from repro_torch.train.qat import make_qat_loss
    cfg2 = dataclasses.replace(cfg, n_layers=QAT_LAYERS)
    p2 = {k: tree_map((lambda v: v[:QAT_LAYERS].clone()) if k == "blocks"
                      else torch.clone, v) for k, v in params.items()}
    n = sum(t.numel() for t in tree_leaves(p2))
    need = _tree_bytes(p2) + 8 * n          # params + f32 m and v
    ckdir = tempfile.mkdtemp(prefix="train_path_ckpt_")
    try:
        free = shutil.disk_usage(ckdir).free
        if free < need * CKPT_DISK_MARGIN:
            raise AssertionError(f"train path (b): {free} B free under "
                                 f"{ckdir}, the checkpoint needs {need}")
        qat = make_qat_loss(lambda p, b, q: TF.lm_loss(p, b, cfg2, qctx=q))
        tcfg = TrainerConfig(n_steps=QAT_STEPS, lr=QAT_LR, warmup=1,
                             grad_accum=QAT_ACCUM, grad_compress=True,
                             ckpt_dir=ckdir, ckpt_every=QAT_STEPS,
                             log_every=0)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=QAT_SEQ,
                             batch=QAT_BATCH, seed=1)
        data = [{k: v.reshape(QAT_ACCUM, QAT_BATCH // QAT_ACCUM, -1)
                 for k, v in pipe.batch_at(i).items()}
                for i in range(QAT_STEPS)]
        tr = Trainer(qat, p2, tcfg)
        t0 = time.perf_counter()
        hist = tr.fit(iter(data))
        fit_s = time.perf_counter() - t0
        for h in hist:
            if not (math.isfinite(h["loss"]) and math.isfinite(
                    h["grad_norm"])):
                raise AssertionError(f"train path (b): step {h}")
        step_dir = Path(ckdir) / f"step_{QAT_STEPS:09d}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        fresh = Trainer(qat, zeros_like_tree(p2), tcfg)
        t0 = time.perf_counter()
        restored_at = fresh.maybe_restore()
        _sync(device)
        restore_s = time.perf_counter() - t0
        saved = tree_leaves((tr.params, tr.opt))
        got = tree_leaves((fresh.params, fresh.opt))
        exact = restored_at == QAT_STEPS and len(saved) == len(got) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(saved, got))
        if not exact:
            raise AssertionError("train path (b): the restored state is not "
                                 "the saved one bit for bit")
        eval_batch = to_device(pipe.batch_at(10_000), torch.device(device))
        with torch.no_grad():
            fp = float(TF.lm_loss(tr.params, eval_batch, cfg2))
            q8 = float(qat(tr.params, eval_batch))
        del fresh, saved, got
        return dict(
            n_layers=QAT_LAYERS, reduced={"n_layers": [cfg.n_layers,
                                                       QAT_LAYERS]},
            seq_len=QAT_SEQ, batch=QAT_BATCH, grad_accum=QAT_ACCUM,
            n_params=n, history=hist,
            step_s=statistics.median(h["step_time_s"] for h in hist[1:]),
            fit_s=fit_s,
            save_s=fit_s - sum(h["step_time_s"] for h in hist),
            checkpoint_bytes=ckpt_bytes, restore_s=restore_s,
            restored_bit_exact=exact, eval_loss_fp=fp,
            eval_loss_int8_lattice=q8, peak_mem_gb=_peak_gb(device))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


@contextlib.contextmanager
def _deterministic(on: bool):
    """``torch.use_deterministic_algorithms(on, warn_only=True)`` inside
    the block, the caller's setting restored after.  With it on, the
    embedding's backward (an accumulating ``index_put_``: atomics on
    CUDA) takes its sort-based deterministic kernel; ops with no
    deterministic kernel warn (recorded) instead of raising."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _stepped(a_tree, b_tree, lr, share=TRAIN_FLIP_SHARE) -> dict:
    """Card against CPU after optimizer steps: the largest difference and
    the share of elements more than ``TRAIN_MOVE_ATOL`` apart (at most
    ``share`` of them, none more than ``2 lr``)."""
    from repro_torch.bridge import tree_leaves
    worst = off = n = 0
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        d = (a.detach().cpu().double() - b.detach().cpu().double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        off += int((d > TRAIN_MOVE_ATOL).sum())
        n += d.numel()
    return dict(max_abs_diff=worst, share_off=off / n,
                ok=worst <= 2 * lr + TRAIN_MOVE_ATOL and off <= share * n)


def _lattice_share(a_tree, b_tree) -> float:
    from repro_torch.bridge import tree_leaves
    off = n = 0
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        off += int((a.cpu() != b.cpu()).sum())
        n += a.numel()
    return off / n


def _supervised(cell, params, vocab, *, fail_at, ckdir) -> tuple:
    """A ``TrainSupervisor`` run of the train cell from ``params`` (a
    copy; the 8-bit state fresh), ``WorkerFailure`` raised once at each
    step in ``fail_at`` → (final state, history)."""
    from repro_torch.bridge import tree_map
    from repro_torch.distributed.ft import TrainSupervisor, WorkerFailure
    from repro_torch.launch.train import batch_for
    from repro_torch.train.optim import adamw8bit_init
    pipe = _train_pipe(cell, vocab, seed=2)
    fired = set()

    def step_fn(state, step):
        if step in fail_at and step not in fired:
            fired.add(step)
            raise WorkerFailure(f"worker lost at step {step}")
        p, o, m = cell.step_fn(state["params"], state["opt"],
                               batch_for(cell, pipe, step))
        return {"params": p, "opt": o}, {"loss": float(m["loss"])}

    p = tree_map(torch.clone, params)
    return TrainSupervisor(ckdir, ckpt_every=1).run(
        {"params": p, "opt": adamw8bit_init(p)}, step_fn, SUPERVISOR_STEPS)


def _equal_trees(a, b) -> bool:
    from repro_torch.bridge import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _train_parity(cfg=None, *, card="cuda") -> dict:
    """(c) card against CPU on a 3-layer f32 model with the same seeded
    weights: the STE's forward and gradient mask, one train-cell step
    (8-bit AdamW, accumulation 4), one QAT ``Trainer`` step (f32 AdamW,
    compression, accumulation 2), and on the card a supervised run with
    two worker failures against an uninterrupted one (after reporting
    whether two uninterrupted runs agree with determinism off)."""
    import shutil
    import tempfile
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.core.quant import QuantParams, compute_qparams, \
        fake_quant
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import batch_for
    from repro_torch.models import transformer as TF
    from repro_torch.train.loop import Trainer, TrainerConfig, to_device
    from repro_torch.train.optim import adamw8bit_init
    from repro_torch.train.qat import make_qat_loss
    cfg = cfg or dataclasses.replace(get_arch("deepseek-7b").full,
                                     **TRAIN_PARITY_CFG)
    t_phase = time.perf_counter()
    p_cpu = TF.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_card = tree_map(lambda t: t.to(card, copy=True), p_cpu)
    res = {"cfg": dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                       vocab=cfg.vocab, dtype=str(cfg.dtype))}

    # the STE: forward bit for bit, gradient mask equal
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, cfg.d_model, generator=g) * 3
    ct = torch.randn(64, cfg.d_model, generator=g)
    ste = {}
    for axis in (None, 1):
        qp = compute_qparams(x * 0.7, axis=axis)    # x saturates in places
        outs = []
        for dev in ("cpu", card):
            xd = x.to(dev, copy=True).requires_grad_()
            qd = QuantParams(scale=qp.scale.to(dev),
                             zero_point=qp.zero_point.to(dev), axis=axis)
            y = fake_quant(xd, qd)
            y.backward(ct.to(dev))
            outs.append((y.detach().cpu(), xd.grad.cpu()))
        (y0, g0), (y1, g1) = outs
        ste[f"axis_{axis}"] = dict(
            forward_equal=torch.equal(y0, y1),
            mask_equal=torch.equal(g0 != 0, g1 != 0),
            grad_equal=torch.equal(g0, g1), passed=int((g0 != 0).sum()),
            of=g0.numel())
        if not (torch.equal(y0, y1) and torch.equal(g0, g1)):
            raise AssertionError(f"STE card vs CPU: {ste}")
    res["ste"] = ste

    # one train-cell step, 8-bit AdamW
    cells = {d: _lm_train_cell(cfg, device=d, seq=TRAIN_PARITY_SEQ,
                               batch=TRAIN_PARITY_BATCH)
             for d in ("cpu", card)}
    runs = {}
    for d, pp in (("cpu", p_cpu), (card, p_card)):
        p = tree_map(torch.clone, pp)
        o = adamw8bit_init(p)
        (batch,) = _train_batches(cells[d], cfg.vocab, 1, seed=3)
        p, o, m = cells[d].step_fn(p, o, batch)
        runs[d] = (p, o, float(m["loss"]), float(m["grad_norm"]))
    (pc, oc, lc, nc), (pg, og, lg, ng) = runs["cpu"], runs[card]
    cell_res = dict(loss_cpu=lc, loss_card=lg, grad_norm_cpu=nc,
                    grad_norm_card=ng, grad_accum=cells[card].grad_accum,
                    **_stepped(pg, pc, 3e-4),
                    m_q_share_off=_lattice_share(og.m_q, oc.m_q),
                    v_q_share_off=_lattice_share(og.v_q, oc.v_q))
    res["train_cell"] = cell_res
    if not (abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc)
            and abs(ng - nc) <= TRAIN_LOSS_RTOL * abs(nc)
            and cell_res["ok"]
            and cell_res["m_q_share_off"] <= TRAIN_FLIP_SHARE):
        raise AssertionError(f"train cell, card vs CPU: {cell_res}")
    del runs, pc, oc, pg, og

    # one QAT Trainer step: f32 AdamW, compression, accumulation 2
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_PARITY_SEQ,
                         batch=TRAIN_PARITY_BATCH, seed=4)
    raw = {k: v.reshape(2, TRAIN_PARITY_BATCH // 2, -1)
           for k, v in pipe.batch_at(0).items()}
    qat = make_qat_loss(lambda p, b, q: TF.lm_loss(p, b, cfg, qctx=q))
    trs = {}
    for d, pp in (("cpu", p_cpu), (card, p_card)):
        tr = Trainer(qat, tree_map(torch.clone, pp), TrainerConfig(
            n_steps=1, lr=QAT_LR, warmup=0, grad_accum=2,
            grad_compress=True, log_every=0))
        trs[d] = (tr, tr.fit(iter([raw]))[0])
    (tc, hc), (tg, hg) = trs["cpu"], trs[card]
    qat_res = dict(loss_cpu=hc["loss"], loss_card=hg["loss"], lr=hg["lr"],
                   **_stepped(tg.params, tc.params, QAT_LR,
                              share=QAT_FLIP_SHARE))
    res["qat_trainer"] = qat_res
    if not (abs(hg["loss"] - hc["loss"]) <= QAT_LOSS_RTOL * abs(hc["loss"])
            and qat_res["ok"]):
        raise AssertionError(f"QAT Trainer, card vs CPU: {qat_res}")
    del trs, tc, tg

    # supervised restarts on the card
    ckroot = tempfile.mkdtemp(prefix="train_path_sup_")
    try:
        def run(tag, fail_at=()):
            return _supervised(cells[card], p_card, cfg.vocab,
                               fail_at=fail_at, ckdir=f"{ckroot}/{tag}")
        sup = {}
        with _deterministic(False):
            a, _ = run("n1")
            b, _ = run("n2")
            sup["repeat_equal_nondeterministic"] = _equal_trees(a, b)
        del a, b
        with _deterministic(True):
            a, _ = run("d1")
            b, _ = run("d2")
            f, hist = run("f", SUPERVISOR_FAILS)
            sup["repeat_equal_deterministic"] = _equal_trees(a, b)
            sup["restart_equal_uninterrupted"] = _equal_trees(a, f)
        sup.update(steps=SUPERVISOR_STEPS, failures_at=list(SUPERVISOR_FAILS),
                   history_steps=[h["step"] for h in hist])
        res["supervisor"] = sup
        if not (sup["restart_equal_uninterrupted"]
                and sup["history_steps"] == list(
                    range(1, SUPERVISOR_STEPS + 1))):
            raise AssertionError(f"supervised restarts: {sup}")
        del a, b, f
    finally:
        shutil.rmtree(ckroot, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    _free(card)
    return res


def phase_train_path(params, cfg, *, device="cuda", parity=True,
                     expect_8bit=True) -> dict:
    """Training on the card (ROADMAP A17), last of the phases on the
    deepseek-7b weights (it updates them):

    (a) the reference's train cell at ``cfg``'s full width and depth on
        ``params``: ``train_4k`` at seq 4096 with the global batch cut
        256 → ``TRAIN_BATCH`` (the rule's accumulation 4: microbatches
        of 1 x 4096), remat on, 8-bit AdamW (asserted the rule's pick
        and the reference's state shapes), lr 3e-4; one warm step and
        ``TRAIN_TIMED_STEPS`` timed: loss and grad norm finite, every
        weight matrix moved and every leaf's moment non-zero (asserted);
        one more step in a profile window (device busy, idle share); step
        s,
        tokens/s, model flops/s against the bf16 peak, peak memory, the
        bytes a checkpoint of this state would take;
    (b) QAT through the ``Trainer`` at ``QAT_LAYERS`` layers of ``cfg``
        (``_qat_trainer_full``): one async checkpoint restored bit for bit
        (asserted), its bytes and seconds, the fp and INT8-lattice eval
        losses;
    (c) card against CPU at 3 layers, f32 (``_train_parity``).

    Every kernel's launches over (a)-(c) are read and must be 0 (the
    training forward reads K/V outside the paged kernel, and QAT's GEMMs
    are fake-quant products): ``train_path_launches``.  Runs inside
    ``_deterministic(True)``; (c) turns it off for its repeat check."""
    t_phase = time.perf_counter()
    _reset_launch_counts()
    with _deterministic(True), warnings.catch_warnings(record=True) as wrn:
        warnings.simplefilter("always")
        res = {"train_cell": _train_cell_full(params, cfg, device=device,
                                              expect_8bit=expect_8bit)}
        _free(device)
        emit("train_path_cell", **res["train_cell"])
        res["qat_trainer"] = _qat_trainer_full(params, cfg, device=device)
        _free(device)
        emit("train_path_qat", **res["qat_trainer"])
        if parity:
            res["parity"] = _train_parity(card=device)
            emit("train_path_parity", **res["parity"])
    res["launches"] = _launch_counts()
    res["warnings"] = sorted({str(w.message)[:160] for w in wrn})
    if any(res["launches"].values()):
        raise AssertionError(f"train path launched a kernel: "
                             f"{res['launches']}")
    res["phase_s"] = time.perf_counter() - t_phase
    emit("train_path_done", launches=res["launches"],
         warnings=res["warnings"], phase_s=res["phase_s"])
    return res


# ---------------------------------------------------------------------------
# Phase 10e: a mixture-of-experts LM (qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------


MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_CUT = 2
MOE_REPEATS = 1             # timed runs of the serial engine
# spec_k=4 runs 12 of the 48 layers: its draft suffix holds the whole
# stack on the edge's f32 lattice (120 GB at 48 layers, 29.9 GB at 12)
MOE_SPEC_LAYERS = 12
MOE_PARITY_LAYERS = 3
# card vs CPU, f32: moe's output within this share of its largest |value|
# (GEMMs summed in another order); two experts' CPU gates closer than
# GATE_TIE are a near-tie, where the card may route the other way
MOE_TOL = 1e-4
GATE_TIE = 1e-5
# device memory the phase may leave allocated beyond what it found
MOE_LEFT_GB = 1.0


def _serial_wire_bytes(st, *, n_req, plen, max_new, d_model) -> int:
    """The wire bytes a serial collaborative run owes, by the reference's
    framing: each request's prompt blob (one byte an element, a scale
    and zero point a row) and its first token, each decode step's live
    rows' deltas and tokens, and a header each way per prefill call and
    per step."""
    from repro_torch.serve.transport import _MSG_BYTES, _QP_BYTES, _TOK_BYTES
    return (n_req * (plen * d_model + _QP_BYTES + _TOK_BYTES)
            + n_req * (max_new - 1) * (d_model + _QP_BYTES + _TOK_BYTES)
            + 2 * _MSG_BYTES * (st.prefill_calls + st.decode_steps))


_INT8_ROWS = ("int8_matmul", "int8_matmul_wgmma", "int8_pack_weight",
              "int8_matmul_splitk")


def _moe_run(e, prompts, max_new, vocab, what, *, want_split, want_tc,
             on_card, launches) -> dict:
    """One counted run of ``prompts`` through engine ``e``: streams
    well formed, B1's split and tensor-core launches each equal to what
    the schedule implies (``want_split(stats)``, ``want_tc(stats)``) and
    above 0, no B4 kernel launched; the counts added to ``launches``."""
    r = _counted(e, lambda: e.generate(prompts, max_new_tokens=max_new))
    st = r["stats"]
    if not all(len(o) == max_new and all(0 <= t < vocab for t in o)
               for o in r["out"]):
        raise AssertionError(f"moe path {what}: malformed streams")
    split = r["launches"] - r["tc_launches"]
    if on_card and not (split == want_split(st) > 0
                        and r["tc_launches"] == want_tc(st) > 0):
        raise AssertionError(
            f"moe path {what}: B1 split / tensor-core launches {split} / "
            f"{r['tc_launches']}, expected {want_split(st)} / "
            f"{want_tc(st)}")
    if any(r["by_row"][n] for n in _INT8_ROWS):
        raise AssertionError(f"moe path {what}: a B4 kernel was launched: "
                             f"{r['by_row']}")
    _add_launches(launches, r["by_row"])
    r["split_launches"] = split
    return r


def phase_moe_path(cfg=None, *, device="cuda", parity=True) -> dict:
    """qwen3-moe-30b-a3b ``FULL`` at its published width (bf16, seeded
    random weights drawn on the card one layer at a time), the main
    path's traffic: 8 requests x 32 new tokens after 128-token prompts,
    4 slots, INT8 paged KV (page 16), 250 KB/s at 20 ms.

    (a) ``CollaborativeServingEngine`` at cut 2, all 48 layers, timed
        ``MOE_REPEATS`` times: 256 tokens, wire bytes equal to the
        serial framing at d_model 2048, B1's split launches (every layer
        once a decode step: 8 query rows a kv head) and tensor-core
        launches (every layer once a prefill call) as the schedule
        implies, no B4 launch (asserted); tokens/s (median), peak
        memory, and one profile window (the device's idle share);
    (b) the cloud-only ``ServingEngine`` over bf16 pages, 48 layers, one
        timed run: tokens/s and launches (asserted as in (a));
    (c) ``spec_k=4`` at cut 2 on the first ``MOE_SPEC_LAYERS`` layers
        (the full stack freed first): acceptance, rounds, tokens/s, and
        the verify's launches — 4 rows x 8 heads a kv head go to the
        tensor-core kernel, once per cloud layer a round (asserted, with
        every other launch the rounds imply);
    (d) ``path_parity_moe`` (``_moe_parity``), after every weight of
        (a)-(c) is released (device memory within ``MOE_LEFT_GB`` of
        what the phase found, asserted).

    ``cfg`` (a smaller LM with ``moe``) and ``device="cpu"`` with
    ``parity=False`` rehearse (a)-(c) on the CPU."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.core.costmodel import Channel
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import (CollaborativeServingEngine,
                                          ServingEngine)

    t_phase = time.perf_counter()
    cfg = cfg or get_arch(MOE_ARCH).full
    on_card = torch.device(device).type == "cuda"
    n_req, plen, max_new, cut, k = 8, 128, 32, MOE_CUT, 4
    max_len = plen + max_new + 24
    channel = Channel.from_kbps(250.0, rtt_ms=20.0)
    prompts = _prompts(n_req, plen, cfg.vocab, seed=0)
    launches = {}
    found = torch.cuda.memory_allocated() / 1e9 if on_card else None
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    _sync(device)
    res = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
               dtype=str(cfg.dtype), cut=cut, requests=n_req, slots=4,
               prompt_len=plen, max_new=max_new,
               param_count=cfg.param_count(),
               init_s=time.perf_counter() - t0,
               weights_gb=(torch.cuda.memory_allocated() / 1e9 - found
                           if on_card else None))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    n_layers = cfg.n_layers

    def run(e, what, **kw):
        return _moe_run(e, prompts, max_new, cfg.vocab, what,
                        on_card=on_card, launches=launches, **kw)

    def per_step(st):
        return n_layers * st.decode_steps

    def per_prefill(st):
        return n_layers * st.prefill_calls

    # (a) the serial collaborative engine at full depth
    t0 = time.perf_counter()
    eng = CollaborativeServingEngine(params, cfg, cut_layer=cut,
                                     channel=channel, max_len=max_len,
                                     device=device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    eng.generate(prompts[:1], max_new_tokens=2)            # warm-up
    runs = [run(eng, "(a)", want_split=per_step, want_tc=per_prefill)
            for _ in range(MOE_REPEATS)]
    st = runs[0]["stats"]
    want = _serial_wire_bytes(st, n_req=n_req, plen=plen, max_new=max_new,
                              d_model=cfg.d_model)
    for r in runs:
        if r["stats"].transmitted_bytes != want:
            raise AssertionError(f"moe path (a): wire bytes "
                                 f"{r['stats'].transmitted_bytes} != "
                                 f"{want} by formula")
    res["serial"] = dict(
        **_runs_summary(runs), setup_s=setup_s,
        edge_blocks=eng.n_edge, cloud_blocks=eng.n_cloud,
        prefill_calls=st.prefill_calls, decode_steps=st.decode_steps,
        split_launches=runs[0]["split_launches"],
        tc_launches=runs[0]["tc_launches"],
        transmitted_bytes=st.transmitted_bytes, wire_formula=want,
        channel_s=st.channel_latency_s,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None),
        first_output=runs[0]["out"][0])
    if on_card:
        prof = profile_window(
            lambda: eng.generate(prompts, max_new_tokens=max_new),
            statistics.median(r["wall"] for r in runs))
        res["serial"]["profile"] = prof
        res["serial"]["device_idle_share"] = prof["device_idle_share"]
    serial_outs = runs[0]["out"]
    del eng, runs
    _free(device)

    # (b) cloud-only over bf16 pages
    cloud = ServingEngine(params, cfg, max_len=max_len, paged=True,
                          device=device)
    cloud.generate(prompts[:1], max_new_tokens=2)
    r = run(cloud, "(b)", want_split=per_step, want_tc=per_prefill)
    res["cloud_only"] = dict(
        **_runs_summary([r]), pages=str(cfg.dtype),
        prefill_calls=r["stats"].prefill_calls,
        decode_steps=r["stats"].decode_steps,
        split_launches=r["split_launches"], tc_launches=r["tc_launches"],
        first_output=r["out"][0],
        **_agreement(r["out"], serial_outs))
    del cloud, r
    _free(device)

    # (c) spec_k=4 on the first MOE_SPEC_LAYERS layers; the full stack
    # goes first (the draft suffix's f32 lattice would not fit beside it)
    scfg = dataclasses.replace(cfg, n_layers=min(MOE_SPEC_LAYERS,
                                                 cfg.n_layers))
    sparams = dict(params, blocks=tree_map(
        lambda v: v[:scfg.n_layers].clone(), params["blocks"]))
    del params
    _free(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spec = CollaborativeServingEngine(sparams, scfg, cut_layer=cut,
                                      channel=channel, max_len=max_len,
                                      spec_k=k, device=device)
    spec.generate(prompts[:1], max_new_tokens=2)
    n_s, n_cloud = scfg.n_layers, spec.n_cloud
    with _PhaseLaunches(spec, ("_verify_impl",)) as pl:
        r = run(spec, "(c)",
                want_split=lambda st: st.spec_rounds * k * n_s,
                want_tc=lambda st: (st.prefill_calls * (n_s + n_cloud)
                                    + st.spec_rounds * n_cloud))
    st = r["stats"]
    if on_card and not (pl.tc["_verify_impl"] == st.spec_rounds * n_cloud
                        > 0 and pl.split["_verify_impl"] == 0):
        raise AssertionError(f"moe path (c): the verify launched the "
                             f"tensor-core kernel {pl.tc['_verify_impl']} "
                             f"times and the split kernel "
                             f"{pl.split['_verify_impl']}, expected "
                             f"{st.spec_rounds * n_cloud} and 0")
    res["spec_k4"] = dict(
        **_runs_summary([r]), layers=n_s, reduced=dict(
            n_layers=[cfg.n_layers, n_s]),
        prefill_calls=st.prefill_calls, spec_rounds=st.spec_rounds,
        acceptance=st.acceptance_rate(),
        draft_hits=st.draft_hits, drafted_tokens=st.drafted_tokens,
        tokens_per_round=st.decode_tokens / max(st.spec_rounds, 1),
        split_launches=r["split_launches"], tc_launches=r["tc_launches"],
        verify_calls=pl.calls["_verify_impl"],
        verify_tc_launches=pl.tc["_verify_impl"],
        transmitted_bytes=st.transmitted_bytes,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None))
    del spec, sparams, r, pl
    gc.collect()
    _free(device)
    left = torch.cuda.memory_allocated() / 1e9 if on_card else None
    if on_card and left - found >= MOE_LEFT_GB:
        raise AssertionError(f"moe path: {left} GB still allocated after "
                             f"the phase, {found} GB before it")
    res["mem_found_gb"], res["mem_left_gb"] = found, left
    res["launches"] = launches
    res["phase_s_before_parity"] = time.perf_counter() - t_phase
    emit("moe_path", **res)
    res["parity"] = _moe_parity() if parity else None
    res["phase_s"] = time.perf_counter() - t_phase
    emit("moe_path_done", phase_s=res["phase_s"])
    return res


def _moe_layer_check(p_card, p_cpu, cfg, rows, card, seed) -> dict:
    """Layer 0's ``moe`` on ``rows`` = (B, S) random unit-RMS inputs, on
    the card (twice) and on the CPU: the two card runs bit-identical;
    the expert indices equal except where the CPU's gates of the two
    choices lie within ``GATE_TIE`` (raises on any other difference);
    without such a tie the dropped (token, k) pairs equal and the
    outputs within ``MOE_TOL`` of the CPU's largest |value| (with one,
    over the rows whose routing and drops agree)."""
    from repro_torch.bridge import tree_map
    from repro_torch.models import layers as ML
    mp_card = tree_map(lambda v: v[0], p_card["blocks"]["moe"])
    mp_cpu = tree_map(lambda v: v[0], p_cpu["blocks"]["moe"])
    n_e, top_k = cfg.moe.n_experts, cfg.moe.top_k
    kw = dict(top_k=top_k, capacity_factor=cfg.moe.capacity_factor)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(tuple(rows) + (cfg.d_model,), generator=g,
                    dtype=torch.float32)
    y_cpu, aux_cpu = ML.moe(mp_cpu, x, **kw)
    y1, aux1 = ML.moe(mp_card, x.to(card), **kw)
    y2, _ = ML.moe(mp_card, x.to(card), **kw)
    if not torch.equal(y1, y2):
        raise AssertionError(f"moe at {rows}: two card runs differ")
    xt = x.reshape(-1, cfg.d_model)
    t = xt.shape[0]
    gates = torch.softmax(torch.matmul(xt, mp_cpu["router"]["w"]), -1)
    _, i_cpu, _ = ML._route(mp_cpu["router"], xt, n_e, top_k)
    _, i_card, _ = ML._route(mp_card["router"], xt.to(card), n_e, top_k)
    i_card = i_card.cpu()
    cap = ML.moe_capacity(t, top_k, n_e, cfg.moe.capacity_factor)
    drop_cpu = ML.moe_dispatch(i_cpu, n_e, cap)["pair_slot"] < 0
    drop_card = ML.moe_dispatch(i_card, n_e, cap)["pair_slot"].cpu() < 0
    differ = (i_cpu != i_card).any(-1)
    worst = 0.0
    for row in differ.nonzero().flatten().tolist():
        at = (i_cpu[row] != i_card[row]).nonzero().flatten()
        gap = float((gates[row, i_cpu[row, at]]
                     - gates[row, i_card[row, at]]).abs().max())
        worst = max(worst, gap)
        if gap > GATE_TIE:
            raise AssertionError(f"moe at {rows}: token {row} routed to "
                                 f"{i_card[row].tolist()} on the card, "
                                 f"{i_cpu[row].tolist()} on the CPU, gates "
                                 f"{gap} apart")
    keep = ~differ & (drop_cpu == drop_card).all(-1)
    if not differ.any() and not keep.all():
        raise AssertionError(f"moe at {rows}: dropped pairs differ with "
                             f"equal routing")
    y_c, y_g = y_cpu.reshape(t, -1), y1.cpu().reshape(t, -1)
    err = float((y_g[keep] - y_c[keep]).abs().max()) if keep.any() else 0.0
    scale = float(y_c.abs().max())
    tol = MOE_TOL * max(scale, 1.0)
    if not err <= tol:
        raise AssertionError(f"moe at {rows}: card vs CPU max abs err "
                             f"{err} > {tol}")
    return dict(rows=t, capacity=cap, dropped_pairs=int(drop_cpu.sum()),
                tokens_all_dropped=int(drop_cpu.all(-1).sum()),
                max_abs_err=err, max_abs=scale, tol=tol,
                aux_diff=abs(float(aux1) - float(aux_cpu)),
                gate_near_ties=int(differ.sum()), worst_tie_gap=worst,
                rows_compared=int(keep.sum()), repeat_identical=True)


def _moe_parity(cfg=None, *, card="cuda") -> dict:
    """``path_parity_moe``: qwen3-moe-30b-a3b at full width (d 2048, 128
    experts, top 8) and ``MOE_PARITY_LAYERS`` layers, in f32, the same
    weights on the card and on the CPU (the CPU port is held to the JAX
    package by ``tests/test_torch_moe_*.py``):

    * ``moe`` at a 4-row decode and a 512-row prefill (capacity 40 over
      a mean load of 32: pairs drop, asserted at full width) by
      ``_moe_layer_check``: card runs bit-identical, routing and drops
      equal up to gate near-ties, outputs within ``MOE_TOL``;
    * the collaborative engine at cut 0, lossless: the card's stream
      against the CPU's, up to near-ties of the teacher-forced logits
      (``_near_ties``);
    * the INT8 default: the card's decisions against the CPU's up to the
      first tie within the devices' noise (``_int8_divergence``,
      ``INT8_NOISE_TOL``).

    ``cfg`` (a smaller MoE LM) and ``card="cpu"`` rehearse the checks."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import CollaborativeServingEngine

    t0 = time.perf_counter()
    if torch.device(card).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    full = cfg is None
    cfg = cfg or dataclasses.replace(get_arch(MOE_ARCH).full,
                                     n_layers=MOE_PARITY_LAYERS,
                                     dtype=torch.float32)
    p_card = init_lm(cfg, torch.Generator(device=card).manual_seed(2),
                     device=card)
    p_cpu = tree_map(lambda v: v.cpu(), p_card)
    layer = {name: _moe_layer_check(p_card, p_cpu, cfg, rows, card, seed)
             for name, rows, seed in (("decode", (4, 1), 0),
                                      ("prefill", (4, 128), 1))}
    if full and not layer["prefill"]["dropped_pairs"]:
        raise AssertionError("moe parity: the 512-row prefill dropped no "
                             "pair")
    prompts = [np.random.RandomState(7 + i).randint(0, cfg.vocab, n)
               .astype(np.int32) for i, n in enumerate((20, 17, 33, 9))]
    lossless = dict(a_bits=None, edge_int8=False, cloud_int8=False)
    runs, logs = {}, {}
    for tag, kw in (("lossless", lossless), ("int8", {})):
        for dev, p in ((card, p_card), ("cpu", p_cpu)):
            eng = CollaborativeServingEngine(p, cfg, device=dev,
                                             cut_layer=0, max_len=64, **kw)
            with _Decisions() as d:
                runs[tag, dev] = eng.generate(prompts, max_new_tokens=6)
            logs[tag, dev] = d.log
            del eng
    ties = _near_ties(runs["lossless", card], runs["lossless", "cpu"],
                      prompts, p_card, p_cpu, cfg)
    div = _int8_divergence(logs["int8", card], logs["int8", "cpu"])
    res = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
               dtype="float32", moe=layer, moe_tol=MOE_TOL,
               gate_tie=GATE_TIE, requests=len(prompts),
               lossless_identical=runs["lossless", card]
               == runs["lossless", "cpu"],
               lossless_near_ties=ties, parity_tol=PARITY_TOL,
               int8_identical=runs["int8", card] == runs["int8", "cpu"],
               int8_first_token_equal=[
                   a[0] == b[0] for a, b in zip(runs["int8", card],
                                                runs["int8", "cpu"])],
               int8_divergence=div, int8_noise_tol=INT8_NOISE_TOL,
               seconds=time.perf_counter() - t0)
    emit("path_parity_moe", **res)
    del p_card, p_cpu
    _free(card)
    return res


def _rehearsal_model(n_layers: int):
    """deepseek-7b's width (d_model 4096: the same wire bytes) at
    ``n_layers``, with a small vocabulary and FFN the schedule does not
    see, f32, seed 0, on the CPU: ``(cfg, params)``."""
    import dataclasses
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_lm
    cfg = dataclasses.replace(get_arch("deepseek-7b").full,
                              n_layers=n_layers, vocab=512, d_ff=256,
                              dtype=torch.float32)
    return cfg, init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")


def rehearse_fleet() -> tuple:
    """The fleet path's byte-driven schedule on this host's CPU, on
    ``_rehearsal_model`` at 3 layers (the fleet's cuts 14 and 28 map to
    0 and 1): prints and returns ``_fleet_counts`` of the
    four-tenant run (``FLEET_REHEARSAL``) and ``_preempt_counts`` of the
    preemption run (``FLEET_PREEMPT_REHEARSAL``), with the storm's
    per-message log for placing ``FLEET_OUTAGES``.  Run with
    ``python3 -c "import chip_smoke as c; c.rehearse_fleet()"``."""
    cfg, params = _rehearsal_model(3)
    cuts = {14: 0, 28: 1}
    specs = _fleet_specs(FLEET_TENANTS, cuts, FLEET_OUTAGES)
    storm = next(s for s in specs if s.name == FLEET_STORM).channel
    log, orig = [], storm.attempt

    def attempt(nbytes):
        out = orig(nbytes)
        log.append((round(storm.clock_s, 3), int(nbytes), out.kind))
        return out

    storm.attempt = attempt
    run = _fleet_run(params, cfg, device="cpu", specs=specs,
                     prompts=_fleet_prompts(FLEET_TENANTS, cfg.vocab),
                     max_new=FLEET_NEW)
    counts = _fleet_counts(run)
    pcounts = _preempt_counts(_preempt_run(params, cfg, device="cpu",
                                           cuts=cuts))
    print("storm messages", log, flush=True)
    print("FLEET_REHEARSAL =", repr(counts), flush=True)
    print("FLEET_PREEMPT_REHEARSAL =", repr(pcounts), flush=True)
    return counts, pcounts


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10g: the diffusion families and the LM serving cells
# ---------------------------------------------------------------------------


DIFF_SEED = 0
UNET_TRAIN_BATCH = 8        # train_256's global batch 256, reduced
FLUX_TRAIN_BLOCKS = {"n_double": 2, "n_single": 2}   # of 19 + 38
FLUX_TRAIN_BATCH = 2
LM_PREFILL_BATCH = 1        # prefill_32k's global batch 32, reduced
LM_DECODE_BATCH = 2         # decode_32k's global batch 128, reduced
LM_DECODE_INDEX = 16384     # the decode cell's cache_index (a 0-dim tensor)
DIFF_TOL = 2e-4             # f32, card vs CPU, × max |CPU|
# (e)'s cut models (full widths, f32) and resolutions
UNET_PARITY = ({"n_res_blocks": 1}, 128)
FLUX_PARITY = ({"n_double": 1, "n_single": 1}, 256)


def _diff_inputs(cell, seed: int, *, t_value=None) -> dict:
    """A cell's inputs drawn on its device from a seeded generator: the
    latents, text and context normal; U-Net ``t`` uniform in
    [0, 1000) (or ``t_value``), MMDiT ``t`` uniform in [0, 1)."""
    dev = cell.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, spec in cell.batch_specs.items():
        if k == "t" and not spec.dtype.is_floating_point:
            out[k] = (torch.full(spec.shape, t_value, dtype=spec.dtype,
                                 device=dev) if t_value is not None else
                      torch.randint(0, 1000, spec.shape, generator=gen,
                                    device=dev, dtype=spec.dtype))
        elif k == "t":
            out[k] = (torch.full(spec.shape, t_value, dtype=spec.dtype,
                                 device=dev) if t_value is not None else
                      torch.rand(spec.shape, generator=gen, device=dev,
                                 dtype=spec.dtype))
        else:
            out[k] = torch.randn(spec.shape, generator=gen, device=dev,
                                 dtype=spec.dtype)
    return out


def _finite(what: str, t: torch.Tensor, shape=None) -> None:
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise AssertionError(f"{what}: shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{what}: non-finite values")


def _diff_cell(arch, shape, *, device, smoke, batch=None, cfg=None,
               img_res=None):
    from repro_torch.launch.steps import build_cell
    sh = {k: v for k, v in (("global_batch", batch), ("img_res", img_res))
          if v is not None}
    return build_cell(arch, shape, smoke=smoke, device=device,
                      cfg_override=cfg, shape_override=sh or None)


def _sampler(cell, params, x, inputs, total: int, run: int,
             device) -> tuple:
    """The first ``run`` of a ``total``-step sampler's denoise steps of
    ``cell`` from ``x``: DDIM at t = 1000 - stride · (i + 1) (the last to
    the clean sample), or Euler from t = 1 down by 1 / total → (the
    sample, each step's seconds)."""
    secs = []
    for i in range(run):
        if "ctx" in inputs:
            t = torch.full_like(inputs["t"], 1000 - (1000 // total) * (i + 1))
        else:
            t = torch.full_like(inputs["t"], 1.0 - i / total)
        t0 = time.perf_counter()
        x = cell.run(params, None, {**inputs, "latent": x, "t": t})
        _sync(device)
        secs.append(time.perf_counter() - t0)
        _finite(f"{cell.arch_id} {cell.shape_name} step {i + 1}", x,
                inputs["latent"].shape)
    return x, secs


def _denoise_row(cell, params, *, device, profile: bool,
                 sampler: bool) -> dict:
    """``sampler``: the cell's whole sampler (its shape's ``steps``, each
    timed, the first warm); else its first two steps, one warm and one
    timed."""
    from repro_torch.configs import get_arch
    steps = get_arch(cell.arch_id).shapes[cell.shape_name].steps
    inputs = _diff_inputs(cell, DIFF_SEED)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        x, secs = _sampler(cell, params, inputs["latent"], inputs, steps,
                           steps if sampler else 2, device)
        step_s = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
        prof = None
        if profile and device.type == "cuda":
            prof = profile_window(lambda: cell.run(params, None, inputs),
                                  step_s, top=8)
    b = inputs["latent"].shape[0]
    return dict(shape=cell.shape_name, kind=cell.kind, batch=b,
                latent=list(inputs["latent"].shape), sampler_steps=steps,
                steps_run=len(secs), step_s=step_s, step_s_all=secs,
                sampler_s=sum(secs) if sampler else None,
                images_per_s=(b / sum(secs) if sampler else b / steps
                              / step_s),
                model_flops=cell.model_flops,
                model_flops_per_s=cell.model_flops / step_s,
                share_of_bf16_peak=cell.model_flops / step_s / BF16_FLOPS,
                out_std=float(x.float().std()),
                peak_mem_gb=_peak_gb(device), profile=prof)


def _diff_train_row(cell, *, device, steps: int = 2) -> dict:
    """One warm and ``steps - 1`` timed train steps on fresh seeded
    weights: the moment rule's pick, losses finite, every weight matrix
    moved."""
    from repro_torch.bridge import tree_flatten
    from repro_torch.launch.steps import use_8bit_moments
    from repro_torch.train.optim import AdamW8bitState
    params = cell.init_params()
    n_params = sum(t.numel() for _, t in tree_flatten(params))
    opt = cell.init_opt(params)
    want_8bit = use_8bit_moments(n_params)
    if isinstance(opt, AdamW8bitState) != want_8bit:
        raise AssertionError(f"{cell.arch_id} train: the optimizer is not "
                             "the rule's")
    before = {p: _leaf_sample(t) for p, t in tree_flatten(params)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(steps):
        batch = _diff_inputs(cell, DIFF_SEED + 1 + i)
        t0 = time.perf_counter()
        params, opt, m = cell.step_fn(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        rows.append(dict(step=i + 1, loss=loss, grad_norm=gnorm,
                         seconds=time.perf_counter() - t0))
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{cell.arch_id} train step {i + 1}: "
                                 f"loss {loss}, grad norm {gnorm}")
    stuck = [p for p, t in tree_flatten(params)
             if p.endswith("['w']") and torch.equal(before[p],
                                                     _leaf_sample(t))]
    if stuck:
        raise AssertionError(f"{cell.arch_id} train: unmoved weights "
                             f"{stuck}")
    step_s = statistics.median(r["seconds"] for r in rows[1:])
    out = dict(shape=cell.shape_name, n_params=n_params, use_8bit=want_8bit,
               batch=cell.batch_specs["latent"].shape[0], steps=rows,
               step_s=step_s, images_per_s=cell.batch_specs["latent"].shape[0]
               / step_s, model_flops=cell.model_flops,
               model_flops_per_s=cell.model_flops / step_s,
               share_of_bf16_peak=cell.model_flops / step_s / BF16_FLOPS,
               peak_mem_gb=_peak_gb(device),
               weights_moved=sum(p.endswith("['w']") for p in before))
    del params, opt
    return out


def phase_diffusion_path(*, device="cuda", smoke=False) -> dict:
    """The diffusion families on the card (ROADMAP A18), seeded bf16
    weights at the published widths (``smoke``: the SMOKE configs and
    shapes, a CPU rehearsal):

    (a) unet-sd15 (0.81 B parameters): ``gen_fast``'s whole 4-step DDIM
        sampler at batch 16, 512², through the denoise cell; ``gen_1024``
        at batch 4 (16,384 latent cells: the ``q_chunk`` path), one warm
        and one timed step; one profiled step;
    (b) flux-dev, all 19 + 38 blocks (11.88 B parameters, drawn a layer
        at a time): ``gen_fast``'s 4 Euler steps at batch 16;
        ``gen_1024`` at batch 4 (4,608 tokens), one warm and one timed
        step; one profiled step;
    (c) the train cells: unet-sd15 ``train_256`` with the batch cut 256 →
        ``UNET_TRAIN_BATCH`` (the moment rule's pick asserted: f32
        AdamW), flux-dev ``train_256`` at ``FLUX_TRAIN_BLOCKS`` of its
        blocks, full width, batch ``FLUX_TRAIN_BATCH``; one warm and one
        timed step each, losses finite, every weight matrix moved.

    Each step is finite and of the input's shape (asserted).  Every
    kernel's launches over (a)-(c) are read and must be 0: the diffusion
    attention is the reference's eager ``einsum`` / softmax, outside any
    Pallas kernel.  (d), the LM cells, runs on the deepseek-7b weights
    (``phase_lm_cells``) and (e), card against CPU, in the parity worker
    (``_diffusion_parity``)."""
    t_phase = time.perf_counter()
    device = torch.device(device)
    _reset_launch_counts()
    res = {"reduced": {
        "unet-sd15 train_256": {"global_batch": [256, UNET_TRAIN_BATCH]},
        "flux-dev train_256": {"global_batch": [256, FLUX_TRAIN_BATCH],
                               "blocks": ["19 + 38", "{n_double} + "
                                          "{n_single}".format(
                                              **FLUX_TRAIN_BLOCKS)]}}}
    for arch in ("unet-sd15", "flux-dev"):
        t0 = time.perf_counter()
        fast = _diff_cell(arch, "gen_fast", device=device, smoke=smoke)
        params = fast.init_params()
        _sync(device)
        from repro_torch.bridge import tree_flatten
        row = dict(arch=arch, init_s=time.perf_counter() - t0,
                   n_params=sum(t.numel() for _, t in tree_flatten(params)),
                   weights_gb=_tree_bytes(params) / 1e9)
        row["gen_fast"] = _denoise_row(fast, params, device=device,
                                       profile=True, sampler=True)
        big = _diff_cell(arch, "gen_1024", device=device, smoke=smoke)
        row["gen_1024"] = _denoise_row(big, params, device=device,
                                       profile=False, sampler=False)
        del params, fast, big
        _free(device)
        row["phase_s"] = time.perf_counter() - t0
        res[arch] = row
        emit("diffusion_path_" + arch.split("-")[0], **row)
    t0 = time.perf_counter()
    res["train"] = {
        "unet-sd15": _diff_train_row(_diff_cell(
            "unet-sd15", "train_256", device=device, smoke=smoke,
            batch=None if smoke else UNET_TRAIN_BATCH), device=device),
        "flux-dev": _diff_train_row(_diff_cell(
            "flux-dev", "train_256", device=device, smoke=smoke,
            batch=None if smoke else FLUX_TRAIN_BATCH,
            cfg=FLUX_TRAIN_BLOCKS), device=device)}
    if res["train"]["unet-sd15"]["use_8bit"]:
        raise AssertionError("unet-sd15 train: 0.81 B parameters take f32 "
                             "moments by the rule")
    _free(device)
    res["train_s"] = time.perf_counter() - t0
    emit("diffusion_path_train", **res["train"], seconds=res["train_s"])
    res["launches"] = _launch_counts()
    if any(res["launches"].values()):
        raise AssertionError(f"diffusion path launched a kernel: "
                             f"{res['launches']}")
    res["phase_s"] = time.perf_counter() - t_phase
    emit("diffusion_path_done", launches=res["launches"],
         reduced=res["reduced"], phase_s=res["phase_s"])
    return res


def phase_lm_cells(params, cfg, *, device="cuda", seq=None) -> dict:
    """(d) of the diffusion path: the LM's serving cells on ``params``
    (deepseek-7b at full width and depth): ``prefill_32k`` at batch
    ``LM_PREFILL_BATCH`` (``q_chunk=2048``, a dense cache made in the
    step) and ``decode_32k`` at batch ``LM_DECODE_BATCH`` on a dense
    32,768-position cache at a 0-dim ``cache_index``; one warm and one
    timed call each, logits finite and of the reference's shape, every
    kernel's launches 0.  ``seq`` cuts both cells' sequence (a CPU
    rehearsal)."""
    t_phase = time.perf_counter()
    device = torch.device(device)
    _reset_launch_counts()
    res = {"reduced": {"prefill_32k": {"global_batch": [32,
                                                         LM_PREFILL_BATCH]},
                       "decode_32k": {"global_batch": [128,
                                                       LM_DECODE_BATCH]}}}
    gen = torch.Generator(device=device).manual_seed(DIFF_SEED)
    for shape, batch in (("prefill_32k", LM_PREFILL_BATCH),
                         ("decode_32k", LM_DECODE_BATCH)):
        from repro_torch.launch.steps import build_cell
        sh = {"global_batch": batch}
        if seq is not None:
            sh["seq_len"] = seq
        cell = build_cell("deepseek-7b", shape, cfg_override=_all_fields(cfg),
                          shape_override=sh, device=device)
        spec = cell.batch_specs
        if shape == "prefill_32k":
            inputs = {"tokens": torch.randint(0, cfg.vocab,
                                              spec["tokens"].shape,
                                              generator=gen, device=device,
                                              dtype=torch.int32)}
            tokens = batch * spec["tokens"].shape[1]
        else:
            inputs = {"token": torch.randint(0, cfg.vocab, (batch,),
                                             generator=gen, device=device,
                                             dtype=torch.int32),
                      "cache_index": torch.tensor(
                          min(LM_DECODE_INDEX, (seq or LM_DECODE_INDEX) - 1),
                          dtype=torch.int32,
                                                  device=device)}
            tokens = batch
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = cell.init_state(params)
        secs = []
        with torch.no_grad():
            for _ in range(2):
                t0 = time.perf_counter()
                logits, cache = cell.run(params, state, inputs)
                _sync(device)
                secs.append(time.perf_counter() - t0)
                _finite(f"{shape} logits", logits, (batch, cfg.vocab))
        cache_gb = _tree_bytes(cache) / 1e9
        cache_len = cache["k"].shape[2]
        del state, cache, logits
        _free(device)
        res[shape] = dict(batch=batch, seq_len=cache_len,
                          warm_s=secs[0], call_s=secs[1],
                          tokens_per_s=tokens / secs[1],
                          model_flops=cell.model_flops,
                          model_flops_per_s=cell.model_flops / secs[1],
                          share_of_bf16_peak=cell.model_flops / secs[1]
                          / BF16_FLOPS, cache_gb=cache_gb,
                          peak_mem_gb=_peak_gb(device))
    res["launches"] = _launch_counts()
    if any(res["launches"].values()):
        raise AssertionError(f"LM cells launched a kernel: "
                             f"{res['launches']}")
    res["phase_s"] = time.perf_counter() - t_phase
    emit("diffusion_path_lm_cells", **res)
    return res


def _diffusion_parity(*, card="cuda", smoke=False) -> dict:
    """(e) of the diffusion path: card against CPU in f32 on the same
    seeded weights and inputs — unet-sd15 at full widths with
    ``UNET_PARITY`` (one res block a stage, 128²: 16 × 16 latents) and
    flux-dev at full width with ``FLUX_PARITY`` (1 double and 1 single
    block, 256²: 256 image and 512 text tokens), or both ``SMOKE``
    configs at their smoke shapes with ``smoke``; each through the
    denoise cell's step (``ddim_step`` at gen_fast's stride, ``rf_step``
    at its dt) within ``DIFF_TOL`` × max |CPU|."""
    t_phase = time.perf_counter()
    res = {}
    for arch, (cut, res_px) in (("unet-sd15", UNET_PARITY),
                                ("flux-dev", FLUX_PARITY)):
        if smoke:
            cut, res_px = {}, None
        res[arch] = _diff_step_parity(arch, card, smoke=smoke, img_res=res_px,
                                      cfg={**cut, "dtype": torch.float32})
        res[arch].update(cut=cut, img_res=res_px)
    res["phase_s"] = time.perf_counter() - t_phase
    emit("diffusion_path_parity", **res)
    return res


def _diff_step_parity(arch, card, *, smoke, img_res, cfg) -> dict:
    """One gen_fast denoise step of ``arch`` at batch 1 on the card and on
    the CPU from the same seeded f32 weights and inputs → its error,
    asserted within ``DIFF_TOL`` × max |CPU|."""
    from repro_torch.bridge import tree_map
    cells = {dev: _diff_cell(arch, "gen_fast", device=dev, smoke=smoke,
                             batch=1, img_res=img_res, cfg=cfg)
             for dev in ("cpu", card)}
    cpu_params = cells["cpu"].init_params()
    card_params = tree_map(lambda t: t.to(card), cpu_params)
    inputs = _diff_inputs(cells["cpu"], DIFF_SEED + 7,
                          t_value=750 if arch == "unet-sd15" else 0.75)
    with torch.no_grad():
        want = cells["cpu"].run(cpu_params, None, inputs)
        got = cells[card].run(card_params, None,
                              {k: v.to(card) for k, v in inputs.items()})
    err = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    del cpu_params, card_params
    _free(card)
    if not err <= DIFF_TOL * scale:
        raise AssertionError(f"{arch}: card vs CPU {err} > {DIFF_TOL} x "
                             f"{scale}")
    return dict(latent=list(inputs["latent"].shape), max_abs_err=err,
                max_abs_cpu=scale, rel_err=err / scale, tol=DIFF_TOL)


# ---------------------------------------------------------------------------
# Phase 11: the same engine on the card and on the CPU
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


def _near_ties(card, cpu, prompts, p_gpu, p_cpu, cfg, *,
               forced=None) -> list:
    """Hold the card's greedy streams to the CPU's: equal, or else at the
    first divergence both devices' teacher-forced f32 logits (by
    ``forced``, default ``_teacher_forced``) agree within ``PARITY_TOL``
    and the CPU's top two lie within twice it."""
    forced = forced or _teacher_forced
    checked = []
    for pr, a, b in zip(prompts, card, cpu):
        if a == b:
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        ctx = list(pr) + b[:i]
        lg = forced(p_gpu, cfg, ctx, "cuda")
        lc = forced(p_cpu, cfg, ctx, "cpu")
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
      ``spec_k=4`` stream equal to the serial one on each device;
    * sampled (check 6 of the sampled path): a lossless serial stream at
      ``temperature=0.8, top_p=0.9``, seed = the prompt's index, on the
      card identical to the CPU's;
    * then ``_control_parity``: the control loop and overload serving at
      3 layers."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import CollaborativeServingEngine
    from repro_torch.serve.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("deepseek-7b").full, n_layers=2,
                              dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p_gpu = init_lm(cfg, gen, device="cuda")
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    prompts = [np.random.RandomState(5 + i).randint(0, cfg.vocab, n)
               .astype(np.int32) for i, n in enumerate((20, 17, 33, 9, 16))]
    lossless = dict(a_bits=None, edge_int8=False, cloud_int8=False)
    samps = [SamplingParams(temperature=SAMPLE_T, top_p=SAMPLE_P, seed=i)
             for i in range(len(prompts))]
    runs, logs = {}, {}
    for tag, dev, p, kw in (
            ("lossless", "cuda", p_gpu, lossless),
            ("lossless", "cpu", p_cpu, lossless),
            ("lossless_sampled", "cuda", p_gpu, lossless),
            ("lossless_sampled", "cpu", p_cpu, lossless),
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
            runs[tag, dev] = (eng.generate(
                prompts, max_new_tokens=8,
                sampling=samps if tag.endswith("_sampled") else None),
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
    if runs["lossless_sampled", "cuda"][0] != runs["lossless_sampled",
                                                    "cpu"][0]:
        raise AssertionError(
            f"lossless sampled streams differ card vs CPU: "
            f"{runs['lossless_sampled', 'cuda'][0]} vs "
            f"{runs['lossless_sampled', 'cpu'][0]}")
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
         sampled_identical=True,
         sampled_first_output=runs["lossless_sampled", "cpu"][0][0],
         int8_tp2_equals_tp1={dev: runs["int8_tp2", dev][0]
                              == runs["int8", dev][0]
                              for dev in ("cuda", "cpu")})
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    _control_parity()
    _resilient_parity()
    _fleet_parity()


class ParityWorker:
    """The card-vs-CPU checks of phase 11 (``phase_path_parity``) and of
    the dense and MoE paths (``_dense_parity``, ``_moe_parity``) in a
    process of its own, started after the kernel phases and joined
    before the training path: most of their time goes to CPU runs of
    full-width models, on host cores that the host-bound serving phases
    leave idle, and their card runs are small (their device memory
    beside the serving phases' stays under the card's).  It runs
    ``chip_smoke.py --only parity`` with ``cpu_threads`` torch threads
    into files of a temporary directory; its launch counters are its
    own.  ``join`` waits, prints its lines and raises if it
    failed; ``stop`` ends it if it is still running."""

    def __init__(self, cpu_threads: int):
        import tempfile
        self._dir = tempfile.mkdtemp(prefix="chip_smoke_parity_")
        self._out = open(os.path.join(self._dir, "out.log"), "w+")
        self._err = open(os.path.join(self._dir, "err.log"), "w+")
        self.started = time.perf_counter() - _START
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--only", "parity",
             "--cpu-threads", str(cpu_threads)],
            stdout=self._out, stderr=self._err, cwd=str(ROOT))
        emit("parity_worker", pid=self.proc.pid, cpu_threads=cpu_threads)

    def join(self) -> None:
        t0 = time.perf_counter()
        rc = self.proc.wait()
        waited = time.perf_counter() - t0
        self._out.seek(0)
        self._err.seek(0)
        lines, err = self._out.read().splitlines(), self._err.read()
        self.stop()
        for ln in lines:
            # each phase line on the script's clock, its own beside it
            try:
                d = json.loads(ln)
                d["worker_elapsed_s"] = d.pop("elapsed_s")
                d["elapsed_s"] = self.started + d["worker_elapsed_s"]
                ln = json.dumps(d)
            except (ValueError, KeyError, TypeError):
                pass
            print(ln, flush=True)
        if rc != 0:
            raise RuntimeError(f"the parity worker exited with {rc}:\n"
                               f"{err[-6000:]}")
        emit("parity_joined", started_at_s=self.started, waited_s=waited)

    def stop(self) -> None:
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self._out.closed:
            self._out.close()
            self._err.close()
            shutil.rmtree(self._dir, ignore_errors=True)


def _control_parity(cfg=None) -> dict:
    """The control loop and overload serving, lossless (``a_bits=None``,
    fp pages), f32, 2 slots, on the card and on the CPU (the CPU port is
    held to the JAX engines by ``tests/test_torch_adaptive.py`` and
    ``test_torch_overload.py``); ``cfg`` defaults to deepseek-7b at full
    width and 3 layers (the ``gpu`` tests pass a smaller one):

    * ``_ScriptedPolicy(0, 1, 4)``: a warm raise out of k 1 (draft
      rebuild), a drained switch to cut 1, a drop to k 1 and a warm
      raise back — one cut switch, three k switches, two rebuilds
      asserted — against the fixed cut-0 serial stream, equal on each
      device;
    * a demand-paged engine on a 5-page pool (4 usable: the worst case
      holds one request at a time) squeezed to 0 free pages from the
      first turn on (``PressureSchedule``), with at least one preemption
      and every page back after it, against the worst-case engine on
      the same pool, equal on each device;
    * every card stream against the CPU's: equal, or at the first
      divergence a near-tie (``_near_ties``: the two devices sum a GEMM
      in other orders).

    Returns the streams' equalities and each run's counters."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.core.costmodel import Channel
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import FaultyChannel, PressureSchedule
    from repro_torch.serve.engine import CollaborativeServingEngine

    if cfg is None:
        cfg = dataclasses.replace(get_arch("deepseek-7b").full, n_layers=3,
                                  dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p_gpu = init_lm(cfg, torch.Generator(device="cuda").manual_seed(2),
                        device="cuda")
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        prompts = [np.random.RandomState(40 + i).randint(0, cfg.vocab, n)
                   .astype(np.int32)
                   for i, n in enumerate((20, 17, 33, 9, 16))]
        max_new = 16
        base = dict(a_bits=None, edge_int8=False, cloud_int8=False,
                    max_len=64, max_batch=2, cut_layer=0)
        runs, stats = {}, {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            for tag, kw in (
                    ("fixed", {}),
                    ("scripted", dict(policy=_ScriptedPolicy(0, 1, 4, 2))),
                    ("worst_case", dict(num_pages=5)),
                    ("demand", dict(num_pages=5, demand_paged=True,
                                    pressure=PressureSchedule(
                                        [(1e-6, 1000.0, 0)])))):
                eng = CollaborativeServingEngine(
                    p, cfg, device=dev, channel=FaultyChannel(
                        Channel.from_kbps(250.0, rtt_ms=20.0), seed=0),
                    **base, **kw)
                runs[tag, dev] = eng.generate(prompts,
                                              max_new_tokens=max_new)
                if eng.pressure is not None:
                    eng.pressure.apply(eng._pool.allocator, float("inf"))
                a = eng._pool.allocator
                st = eng.stats
                stats[tag, dev] = dict(
                    cut_switches=st.cut_switches,
                    spec_k_switches=st.spec_k_switches,
                    draft_rebuilds=st.draft_rebuilds,
                    policy_holds=st.policy_holds,
                    preemptions=st.preemptions,
                    stall_wait_s=st.stall_wait_s,
                    spec_rounds=st.spec_rounds, draft_hits=st.draft_hits,
                    transmitted_bytes=st.transmitted_bytes,
                    channel_latency_s=st.channel_latency_s,
                    pages_back=a.num_free == a.num_pages - 1
                    and not a.live)
                del eng
        for dev in ("cuda", "cpu"):
            s_, d_ = stats["scripted", dev], stats["demand", dev]
            got = (s_["cut_switches"], s_["spec_k_switches"],
                   s_["draft_rebuilds"], d_["preemptions"] >= 1,
                   d_["pages_back"])
            if got != (1, 3, 2, True, True):
                raise AssertionError(f"control parity on {dev}: scripted "
                                     f"{s_}, demand {d_}")
            # one device's arithmetic throughout: a cut switch, a k
            # switch or a replay must not move a lossless stream
            for tag, twin in (("scripted", "fixed"),
                              ("demand", "worst_case")):
                if runs[tag, dev] != runs[twin, dev]:
                    raise AssertionError(f"control parity on {dev}: the "
                                         f"{tag} stream differs from the "
                                         f"{twin} one")
        checked = {f"{tag}_card_vs_cpu": _near_ties(
            runs[tag, "cuda"], runs[tag, "cpu"], prompts, p_gpu, p_cpu, cfg)
            for tag in ("fixed", "scripted", "worst_case", "demand")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    res = dict(card_equals_cpu={t: runs[t, "cuda"] == runs[t, "cpu"]
                                for t, d in runs if d == "cuda"},
               stats={f"{t}_{d}": v for (t, d), v in stats.items()})
    emit("path_parity_control", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype="float32", requests=len(prompts),
         max_new=max_new, tol=PARITY_TOL, scripted_equals_fixed=True,
         demand_equals_worst_case=True, near_ties=checked, **res)
    return res


# the 3-layer resilient parity's faults: drops and two outage windows on
# the simulated clock (lossless f32 rows: 16 KB a row at d_model 4096)
PARITY_DROP_P = 0.05
PARITY_OUTAGES = ((6.0, 7.5), (14.0, 15.5))
# the same for the ``gpu`` test's 3-layer SMOKE model (d_model 64), whose
# first 10 s pass in a fallback deadline (an early drop)
PARITY_OUTAGES_SMOKE = ((10.6, 11.2), (11.6, 12.2))
PARITY_MAX_NEW = 16


# ``_resilient_parity``'s runs: tag -> (spec_k, sampled, faulted)
PARITY_RUNS = {"fault_free": (1, False, False),
               "fault_free_sampled": (1, True, False),
               "k1": (1, False, True), "k4": (4, False, True),
               "k1_sampled": (1, True, True)}


def _resilient_parity_runs(p, cfg, dev, prompts, outages, tags) -> tuple:
    """``_resilient_parity``'s runs ``tags`` on one device: the
    fault-free plain engine (greedy and sampled) and the resilient
    engine through drops and ``outages`` (k = 1 and 4 greedy, k = 1
    sampled), each on a fresh engine.  Returns ``(streams, counters)``
    by run."""
    from repro_torch.core.costmodel import Channel
    from repro_torch.serve import (CollaborativeServingEngine, FaultyChannel,
                                   ReliableTransport,
                                   ResilientCollaborativeEngine,
                                   SamplingParams)
    samp = [SamplingParams(temperature=SAMPLE_T, top_p=SAMPLE_P,
                           seed=30 + i) for i in range(len(prompts))]
    base = dict(a_bits=None, edge_int8=False, cloud_int8=False,
                max_len=64, max_batch=2, cut_layer=0)
    link = Channel.from_kbps(250.0, rtt_ms=20.0)
    runs, stats = {}, {}
    for tag in tags:
        k, sampled, faulted = PARITY_RUNS[tag]
        if faulted:
            fch = FaultyChannel(link, seed=0, drop_p=PARITY_DROP_P,
                                outages=[list(w) for w in outages])
            eng = ResilientCollaborativeEngine(
                p, cfg, device=dev, spec_k=k, channel=fch,
                transport=ReliableTransport(
                    fch, fallback_deadline_s=RESILIENT_FALLBACK_DEADLINE_S),
                **base)
        else:
            eng = CollaborativeServingEngine(p, cfg, device=dev, spec_k=k,
                                             channel=link, **base)
        runs[tag] = eng.generate(prompts, max_new_tokens=PARITY_MAX_NEW,
                                 sampling=samp if sampled else None)
        st = eng.stats
        a = eng._pool.allocator
        stats[tag] = dict(
            edge_only_tokens=st.edge_only_tokens, resyncs=st.resyncs,
            outage_s=st.outage_s, retries=st.retries, timeouts=st.timeouts,
            spec_rounds=st.spec_rounds, draft_hits=st.draft_hits,
            decode_steps=st.decode_steps,
            transmitted_bytes=st.transmitted_bytes,
            channel_latency_s=st.channel_latency_s,
            phase_calls=dict(eng.phase_calls),
            round_log=list(getattr(eng, "round_log", [])),
            cloud_down=bool(getattr(eng, "cloud_down", False)),
            pages_back=a.num_free == a.num_pages - 1 and not a.live)
        del eng
    return runs, stats


def _resilient_parity(cfg=None, outages=None) -> dict:
    """The resilient engine, lossless (``a_bits=None``, fp pages), f32,
    2 slots, on the card and on the CPU (the CPU port is held to the JAX
    engines by ``tests/test_torch_chaos.py`` and
    ``test_torch_resilience.py``); ``cfg`` defaults to deepseek-7b at
    full width and 3 layers, ``outages`` to ``PARITY_OUTAGES`` (the
    ``gpu`` tests pass a smaller model and its windows).  On each
    device, over ``FaultyChannel(250 KB/s, 20 ms, seed 0)`` with
    ``PARITY_DROP_P`` (``_resilient_parity_runs``):

    * the resilient stream at spec_k = 1 and 4 equal to the fault-free
      serial stream (the plain engine on a plain channel), with at
      least one resync and edge-only tokens in each;
    * on the card, a sampled stream (temperature 0.8, top-p 0.9) at
      spec_k = 1 through the outages equal to the fault-free sampled
      stream (the sampled path's parity holds sampled streams card =
      CPU; the CPU runs only the greedy cases, for time);
    * the card's streams against the CPU's: equal, or a near-tie at the
      first divergence (``_near_ties``); at spec_k = 1 the counters,
      phase calls and ``round_log`` equal the CPU's (the schedule
      depends only on wire bytes), and at spec_k = 4 wherever the
      streams are equal.

    Returns the streams' equalities and each run's counters."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_lm

    if cfg is None:
        cfg = dataclasses.replace(get_arch("deepseek-7b").full, n_layers=3,
                                  dtype=torch.float32)
    outages = PARITY_OUTAGES if outages is None else outages
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p_gpu = init_lm(cfg, torch.Generator(device="cuda").manual_seed(3),
                        device="cuda")
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        prompts = _parity_prompts(cfg)
        runs, stats = {}, {}
        for dev, p, tags in (("cuda", p_gpu, tuple(PARITY_RUNS)),
                             ("cpu", p_cpu, ("fault_free", "k1", "k4"))):
            r, s_ = _resilient_parity_runs(p, cfg, dev, prompts, outages,
                                           tags)
            runs.update({(t, dev): v for t, v in r.items()})
            stats.update({(t, dev): v for t, v in s_.items()})
        for tag, twin, dev in (
                ("k1", "fault_free", "cuda"), ("k1", "fault_free", "cpu"),
                ("k4", "fault_free", "cuda"), ("k4", "fault_free", "cpu"),
                ("k1_sampled", "fault_free_sampled", "cuda")):
            s_ = stats[tag, dev]
            if not (s_["resyncs"] >= 1 and s_["edge_only_tokens"] > 0
                    and not s_["cloud_down"] and s_["pages_back"]):
                raise AssertionError(f"resilient parity on {dev}: {tag} "
                                     f"{s_}")
            # one device's arithmetic: the faults, the edge-only tokens
            # and the replay must not move a lossless stream
            if runs[tag, dev] != runs[twin, dev]:
                raise AssertionError(f"resilient parity on {dev}: the "
                                     f"{tag} stream differs from the "
                                     f"{twin} one")
        checked = {f"{tag}_card_vs_cpu": _near_ties(
            runs[tag, "cuda"], runs[tag, "cpu"], prompts, p_gpu, p_cpu, cfg)
            for tag in ("fault_free", "k1", "k4")}
        for tag in ("k1", "k4"):
            if (tag == "k1" or runs[tag, "cuda"] == runs[tag, "cpu"]) and \
                    stats[tag, "cuda"] != stats[tag, "cpu"]:
                raise AssertionError(f"resilient parity: {tag} counters on "
                                     f"the card differ from the CPU's")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    res = dict(card_equals_cpu={t: runs[t, "cuda"] == runs[t, "cpu"]
                                for t, d in runs if d == "cpu"},
               counters_card_equal_cpu={
                   t: stats[t, "cuda"] == stats[t, "cpu"]
                   for t, d in stats if d == "cpu"},
               sampled_equals_fault_free=True,
               stats={f"{t}_{d}": {k: v for k, v in s.items()
                                   if k != "round_log"}
                      for (t, d), s in stats.items()})
    emit("path_parity_resilient", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype="float32", requests=len(prompts),
         max_new=PARITY_MAX_NEW, drop_p=PARITY_DROP_P,
         outages=[list(w) for w in outages], tol=PARITY_TOL,
         resilient_equals_fault_free=True, near_ties=checked, **res)
    return res


# the fleet's 3-layer parity: the four tenants with cuts 14 and 28 at 0
# and 1, each tenant's two prompts in a prefill bucket of its own, so
# every admission group is one tenant's requests and its solo engine
# prefills the same rows (``fleet_path`` holds tenants that share a
# prefill group, at full size); the storm's outage, mid-stream at d_model
# 4096 (f32 rows: 16 KB), and the same for the ``gpu`` test's 3-layer
# SMOKE model (d_model 64), each picked on a CPU run of this traffic
FLEET_PARITY_LENS = {"edge0": [5, 7], "edge1": [12, 15], "edge2": [20, 30],
                     "edge3": [33, 40]}
FLEET_PARITY_NEW = 8
FLEET_PARITY_OUTAGES = ((6.0, 7.0),)
FLEET_PARITY_OUTAGES_SMOKE = ((1.0, 1.5),)
LOSSLESS_FP = dict(a_bits=None, edge_int8=False, cloud_int8=False)


def _fleet_parity_runs(p, cfg, dev, prompts, outages,
                       conf=LOSSLESS_FP) -> tuple:
    """The fleet (lossless unless ``conf`` says otherwise) and each
    tenant's solo engine at the fleet's batch shape, on one device:
    ``(fleet run, solo streams)``."""
    cuts = {14: 0, 28: 1}
    run = _fleet_run(p, cfg, device=dev,
                     specs=_fleet_specs(FLEET_TENANTS, cuts, outages),
                     prompts=prompts, max_new=FLEET_PARITY_NEW, max_len=64,
                     **conf)
    solo = _solo_runs(
        p, cfg, device=dev, num_pages=run["num_pages"], max_len=64,
        max_new=FLEET_PARITY_NEW,
        jobs={name: (cuts[c], k, FLEET_SLOTS, None, prompts[name])
              for name, c, k, *_r in FLEET_TENANTS}, **conf)
    return run, {n: v["outs"] for n, v in solo.items()}


def _fleet_parity(cfg=None, outages=None) -> dict:
    """The fleet, lossless (``a_bits=None``, fp pages), f32, on the card
    and on the CPU (the CPU port is held to the JAX fleet by
    ``tests/test_torch_fleet_*.py``); ``cfg`` defaults to deepseek-7b at
    full width and 3 layers, ``outages`` to ``FLEET_PARITY_OUTAGES``
    (the ``gpu`` tests pass a smaller model and its window).  The four
    ``FLEET_TENANTS`` at cuts 0 and 1 with the storm's drops and outage,
    prompts of ``FLEET_PARITY_LENS``.

    Asserted on each device: every tenant's fleet stream equal to its
    solo engine's at the fleet's batch shape; every budget filled,
    every page back, every cache finite.  Card against CPU: each
    tenant's streams equal, or a near-tie at the first divergence
    (``_near_ties``: the devices sum a GEMM in other orders); the k = 1
    tenants' counters and the storm's faults, attempts and clock equal
    (byte-driven), and a k = 4 tenant's counters wherever its streams
    are equal."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_lm

    if cfg is None:
        cfg = dataclasses.replace(get_arch("deepseek-7b").full, n_layers=3,
                                  dtype=torch.float32)
    outages = FLEET_PARITY_OUTAGES if outages is None else outages
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p_gpu = init_lm(cfg, torch.Generator(device="cuda").manual_seed(4),
                        device="cuda")
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        prompts = _fleet_prompts(FLEET_TENANTS, cfg.vocab,
                                 lens=FLEET_PARITY_LENS)
        runs, solos, checks = {}, {}, {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            runs[dev], solos[dev] = _fleet_parity_runs(p, cfg, dev, prompts,
                                                       outages)
            run = runs[dev]
            checks[dev] = dict(
                streams_equal_solo={n: run["outs"][n] == solos[dev][n]
                                    for n, *_r in FLEET_TENANTS},
                full_budgets=all(len(o) == FLEET_PARITY_NEW
                                 for v in run["outs"].values() for o in v),
                pages_back=run["pages_back"], caches_finite=run["finite"],
                storm_faulted=sum(run["faults"][FLEET_STORM].values()) > 0)
        near = {n: _near_ties(runs["cuda"]["outs"][n],
                              runs["cpu"]["outs"][n], prompts[n], p_gpu,
                              p_cpu, cfg)
                for n, *_r in FLEET_TENANTS}
        counts = {dev: _fleet_counts(runs[dev]) for dev in runs}
        checks["card_vs_cpu"] = dict(
            counts_k1_and_storm=counts["cuda"] == counts["cpu"],
            counters_where_streams_equal={
                n: dataclasses.asdict(runs["cuda"]["stats"][n])
                == dataclasses.asdict(runs["cpu"]["stats"][n])
                for n, *_r in FLEET_TENANTS
                if runs["cuda"]["outs"][n] == runs["cpu"]["outs"][n]})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    res = dict(card_equals_cpu={n: runs["cuda"]["outs"][n]
                                == runs["cpu"]["outs"][n]
                                for n, *_r in FLEET_TENANTS},
               round_calls={d: r["round_calls"] for d, r in runs.items()},
               counts=counts["cuda"], checks=checks, near_ties=near)
    emit("path_parity_fleet", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype="float32", lens=FLEET_PARITY_LENS,
         max_new=FLEET_PARITY_NEW, drop_p=FLEET_DROP_P,
         outages=[list(w) for w in outages], tol=PARITY_TOL, **res)
    bad = {t: {c: v for c, v in ch.items()
               if v is not True and not (isinstance(v, dict)
                                         and all(v.values()))}
           for t, ch in checks.items()}
    if any(bad.values()):
        raise AssertionError(f"fleet parity: failed checks {bad}")
    return res


def _parity_prompts(cfg) -> list:
    return [np.random.RandomState(60 + i).randint(0, cfg.vocab, n)
            .astype(np.int32) for i, n in enumerate((20, 17, 33, 9, 16))]


# the cnn_path's card-against-CPU check (cuDNN and oneDNN sum a conv in
# other orders): fp32 outputs within CNN_F32_TOL of max |CPU| (TF32 would
# be ~1e-3 off); the boundary lattice of the same float tensor under the
# same (scale, zero point) equal, and each device's scale and zero point
# for it equal (both divide the span by a tensor Range_LP); in the last
# edge segment, each lattice of the CPU going on from the card's
# lattices (teacher-forced lattice by lattice) at most one step apart on
# at most CNN_LATTICE_SHARE of its elements; the segment's float output
# and the INT8 outputs within relative L2 CNN_INT8_TOL; the calibrated
# scales within CNN_SCALE_RTOL.  Reported, not bounded: the boundary
# lattice with only the segment's input forced and end to end, where
# each static lattice passes a flipped step on to the next (AlexNet
# conv5: two steps apart end to end; a ViT block holds six)
CNN_F32_TOL = 1e-4
CNN_LATTICE_SHARE = 0.05
CNN_INT8_TOL = 0.05
CNN_SCALE_RTOL = 1e-4
# net, card-vs-CPU cut.  The ResNets and ViTs run at their published
# widths and depths in f32 (their configs say bf16 for all but
# resnet-18; the reference's collaborative engine fails in bf16)
CNN_NETS = (("alexnet", "conv5"), ("vgg16", None), ("googlenet", "conv2"),
            ("resnet-18", "s1b0/body"), ("resnet-152", None),
            ("vit-s16", "blk0/ffn"), ("deit-b", None), ("vit-h14", None))
LEGACY_CNNS = ("alexnet", "vgg16", "googlenet")
# nets run at fewer blocks than published, to keep the script inside
# its time (every cut still timed): ViT-H/14 at 8 of its 32 blocks, and
# ResNet-152's third stage at 12 of its 36 identical bottleneck blocks
# (26 of 50 blocks; every stage and block shape kept)
CNN_DEPTH = {"vit-h14": {"n_layers": 8},
             "resnet-152": {"depths": (3, 8, 12, 3)}}
CNN_REPEATS = 3


def _cnn_images(batch, res, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((batch, res, res, 3), generator=g, device=device)


def _cnn_model(net: str, device="cuda"):
    """One net of ``CNN_NETS`` at full width (and depth, but for
    ``CNN_DEPTH``), seeded random weights from the port's ``init_*`` on
    ``device``, f32 → (segmented model, input resolution)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import legacy, resnet, vit
    gen = torch.Generator(device=device).manual_seed(0)
    cfg = get_arch(net).full
    if net in LEGACY_CNNS:
        params = getattr(legacy, f"init_{net}")(gen, device=device)
        return getattr(legacy, f"{net}_segments")(params), cfg.img_res
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cfg = dataclasses.replace(cfg, **CNN_DEPTH.get(net, {}))
    if net.startswith("resnet"):
        return resnet.make_segments(
            resnet.init_resnet(gen, cfg, device=device), cfg), cfg.img_res
    return vit.make_segments(vit.init_vit(gen, cfg, device=device),
                             cfg), cfg.img_res


def _cnn_cut_row(eng, cand, x1, x32, truth) -> dict:
    """One engine at one cut: median edge / cloud wall and images/s over
    ``CNN_REPEATS`` runs at batch 1 and 32 (after one warm run each), the
    blob bytes checked against the graph's boundary, the fp32 error."""
    row = {"cut": eng.cut, "edge_download_bytes": eng.edge_download_bytes,
           "storage_reduction": eng.storage_reduction}
    elems = cand.blobs[0].elems                  # the graph's, at batch 1
    for x in (x1, x32):
        b = x.shape[0]
        eng.infer(x)
        recs = []
        for _ in range(CNN_REPEATS):
            y, rec = eng.infer(x)
            recs.append(rec)
        want = (b * elems * 4 if eng.cut == "input"
                else b * elems + 8)              # Eq.(1) frame: 8 B
        if rec.blob_bytes != want:
            raise AssertionError(f"{eng.model.name} {eng.cut} batch {b}: "
                                 f"{rec.blob_bytes} blob bytes, expected "
                                 f"{want}")
        edge = statistics.median(r.edge_wall_s for r in recs)
        cloud = statistics.median(r.cloud_wall_s for r in recs)
        total = statistics.median(r.edge_wall_s + r.cloud_wall_s
                                  for r in recs)
        row[f"b{b}"] = {"edge_ms": edge * 1e3, "cloud_ms": cloud * 1e3,
                        "images_per_s": b / total,
                        "blob_bytes": rec.blob_bytes,
                        "precision": rec.precision}
        if b == 1:
            rel = float(torch.linalg.norm(y - truth)
                        / torch.linalg.norm(truth))
            if not math.isfinite(rel) or (eng.cut == "input"
                                          and rel >= 1e-6):
                raise AssertionError(f"{eng.model.name} {eng.cut}: fp32 "
                                     f"relative error {rel}")
            row["rel_err_vs_fp32"] = rel
    return row


def _steps(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.cpu().to(torch.int32) - b.cpu().to(torch.int32)).abs()
    return {"max_step": int(d.max()), "share": float((d > 0).float().mean()),
            "elems": d.numel()}


def _cnn_card_vs_cpu(model, cut, calib, x) -> dict:
    """The same weights, calibration batches and images (all on the card;
    on the CPU, a test's own check) through the port on their device and
    on the CPU at ``cut``, each device calibrating its own engine.
    Checked: blob bytes (the boundary's elements + 8), download bytes,
    the ``act_scales`` names and zero points equal; the scales within
    ``CNN_SCALE_RTOL``; the fp32 model's output within ``CNN_F32_TOL`` of
    max |CPU|.  At the last edge segment, fed the card's own input to it
    (``h``): the boundary of the card's float output, its lattice under
    the card's (scale, zero point) equal on both devices, and the CPU's
    own zero point and scale equal to the card's (``core.quant``
    divides the span by a tensor Range_LP on both devices); each static
    lattice of the segment and the boundary, the CPU going on from the
    card's lattices under the card's scales
    (``last_edge_trace(force=)``), at most one step apart on at most
    ``CNN_LATTICE_SHARE`` of its elements; the segment's float output,
    each device on its own lattices, within relative L2
    ``CNN_INT8_TOL``; the INT8 outputs within relative L2
    ``CNN_INT8_TOL``.  Reported besides: the boundary lattice with only
    ``h`` forced, and end to end.  Used by ``phase_cnn_path`` and by the
    ``gpu`` tests of ``tests/test_torch_cuda.py``."""
    import dataclasses
    from repro_torch.bridge import tree_map
    from repro_torch.core.collab import (CollaborativeEngine, Segment,
                                         SegmentedModel)
    from repro_torch.core.quant import quantize
    cpu_model = SegmentedModel(model.name, model.graph, [
        Segment(s.name, s.apply, tree_map(lambda t: t.cpu(), s.params))
        for s in model.segments])
    with torch.no_grad():
        y_gpu = model.full_apply(x).cpu()
        y_cpu = cpu_model.full_apply(x.cpu())
        f32_err = float((y_gpu - y_cpu).abs().max() / y_cpu.abs().max())
        g, c = (CollaborativeEngine(m, cut, device=dev, calib_batches=[
            b.to(dev) for b in calib])
            for m, dev in ((model, x.device), (cpu_model, "cpu")))
        end_to_end = _steps(g.boundary(g.edge_forward(x))[0],
                            c.boundary(c.edge_forward(x.cpu()))[0])
        h = g.last_edge_input(x)
        z_g, lats_g = g.last_edge_trace(h)
        z_c, _ = c.last_edge_trace(h)
        z_f, lats_f = c.last_edge_trace(h, force=lats_g,
                                        scales=g.act_scales)
        blob_g, qp_g = g.boundary(z_g)
        qp_c = c.boundary(z_g.cpu())[1]
        on_cpu = dataclasses.replace(qp_g, scale=qp_g.scale.cpu(),
                                     zero_point=qp_g.zero_point.cpu())
        ulp = torch.nextafter(qp_c.scale, qp_c.scale + 1) - qp_c.scale
        same_float = {
            "lattice_equal": torch.equal(blob_g.cpu(),
                                         quantize(z_g.cpu(), on_cpu)),
            "zero_point_equal": torch.equal(on_cpu.zero_point,
                                            qp_c.zero_point),
            "scale_ulps": float((on_cpu.scale - qp_c.scale).abs() / ulp)}
        input_forced = _steps(blob_g, c.boundary(z_c)[0])
        lattices = [_steps(a, b) for a, b in zip(
            lats_g + [blob_g], lats_f + [c.boundary(z_f)[0]])]
        (y_g, rec_g), (y_c, rec_c) = g.infer(x), c.infer(x.cpu())
    z_g, y_g = z_g.cpu(), y_g.cpu()
    edge_rel = float(torch.linalg.norm(z_g - z_c) / torch.linalg.norm(z_c))
    int8_rel = float(torch.linalg.norm(y_g - y_c) / torch.linalg.norm(y_c))
    same_names = sorted(g.act_scales) == sorted(c.act_scales)
    scale_rel = max((float(abs(g.act_scales[k].scale.cpu() - qp.scale)
                           / qp.scale) for k, qp in c.act_scales.items()
                     if k in g.act_scales), default=0.0)
    same_zero_points = same_names and all(
        torch.equal(g.act_scales[k].zero_point.cpu(), qp.zero_point)
        for k, qp in c.act_scales.items())
    forced = {"lattices": len(lattices),
              "max_step": max(r["max_step"] for r in lattices),
              "max_share": max(r["share"] for r in lattices),
              "shares": [r["share"] for r in lattices]}
    res = {"cut": cut, "f32_max_err": f32_err, "f32_tol": CNN_F32_TOL,
           "same_float_boundary": same_float,
           "teacher_forced_lattices": forced,
           "lattice_share_tol": CNN_LATTICE_SHARE,
           "input_forced_lattice": input_forced,
           "end_to_end_lattice": end_to_end,
           "last_edge_rel_l2": edge_rel,
           "int8_rel_l2": int8_rel, "int8_tol": CNN_INT8_TOL,
           "act_scale_names": len(c.act_scales),
           "act_scale_max_rel_diff": scale_rel,
           "act_scale_rtol": CNN_SCALE_RTOL,
           "blob_bytes": rec_g.blob_bytes}
    if not (rec_g.blob_bytes == rec_c.blob_bytes == blob_g.numel() + 8
            and g.edge_download_bytes == c.edge_download_bytes
            and same_names and same_zero_points
            and scale_rel <= CNN_SCALE_RTOL
            and f32_err <= CNN_F32_TOL and same_float["lattice_equal"]
            and same_float["zero_point_equal"]
            and same_float["scale_ulps"] == 0
            and len(lats_f) == len(lats_g) and forced["max_step"] <= 1
            and forced["max_share"] <= CNN_LATTICE_SHARE
            and math.isfinite(edge_rel) and edge_rel <= CNN_INT8_TOL
            and math.isfinite(int8_rel) and int8_rel <= CNN_INT8_TOL):
        raise AssertionError(f"{model.name} card vs CPU: {res}")
    return res


def phase_cnn_path() -> dict:
    """The paper's own CNN split inference (``core.collab``) on the card:
    AlexNet (227²), VGG16, GoogLeNet, ResNet-18/152, ViT-S/16, DeiT-B and
    ViT-H/14 (224²), full width and depth, f32, seeded random weights
    built on the card by the port's ``init_*`` (``_cnn_model``).  At
    every engine cut (``input`` and each segment; ViT's ``blk{i}/attn``
    candidates end no segment) a ``CollaborativeEngine`` calibrated on 4
    seeded batches of 8: edge / cloud ms and images/s at batch 1 and 32
    (median of ``CNN_REPEATS``), blob bytes (asserted at every cut: the
    graph's boundary elements + 8, or 4 B an element at ``input``), the
    int8 download and storage reduction, the fp32 relative error against
    ``full_apply`` (finite; < 1e-6 at ``input``); a ``torch.profiler``
    window at batch 32 at ``input`` and at the last cut (all on the
    edge): device busy time and idle share.  Algorithm 1 on the port's
    graphs at the Table 3 bandwidths must pick ``TABLE3_PICKS``.  At
    each net's card-vs-CPU cut of ``CNN_NETS``, ``_cnn_card_vs_cpu`` on 8
    seeded images.  TF32 is switched on for the whole phase and must be
    on again after it: the path's products keep true f32 within their
    own calls.  Kernel launch counts are set to 0 before and returned
    after, by summary row (no kernel is on this path)."""
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.core.collab import CollaborativeEngine
    from repro_torch.core.costmodel import (CLOUD_TITANXP_CLASS, Channel,
                                            EDGE_TX2_CLASS)
    from repro_torch.core.partition import candidate_partition_points

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _reset_launch_counts()
    try:
        for net, parity_cut in CNN_NETS:
            t0 = time.perf_counter()
            model, res = _cnn_model(net)
            model.verify_alignment()
            cands = {c.name: c for c in candidate_partition_points(
                model.graph)}
            calib = [_cnn_images(8, res, 100 + i) for i in range(4)]
            x1, x32 = _cnn_images(1, res, 1), _cnn_images(32, res, 2)
            with torch.no_grad():
                truth = model.full_apply(x1)
            rows, profiles = [], {}
            names = ["input"] + [s.name for s in model.segments]
            for cut in names:
                eng = CollaborativeEngine(model, cut, calib_batches=calib,
                                          device="cuda")
                rows.append(_cnn_cut_row(eng, cands[cut], x1, x32, truth))
                if cut in ("input", names[-1]):
                    # cloud-only, and everything on the INT8 edge
                    prof = profile_window(
                        lambda: eng.infer(x32),
                        32 / rows[-1]["b32"]["images_per_s"], top=5)
                    profiles[cut] = {k: prof[k] for k in (
                        "device_busy_s", "device_idle_share",
                        "device_events", "unprofiled_wall_s",
                        "profiled_wall_s", "top")}
                del eng
            algorithm1 = None
            if net in TABLE3_PICKS:
                kbps, pick = TABLE3_PICKS[net]
                best, _ = AutoTuner(model.graph, EDGE_TX2_CLASS,
                                    CLOUD_TITANXP_CLASS).tune(
                    Channel.from_kbps(kbps))
                if best.point != pick:
                    raise AssertionError(f"{net}: Algorithm 1 picks "
                                         f"{best.point} at {kbps} KB/s, "
                                         f"the JAX package {pick}")
                algorithm1 = {"kbps": kbps, "pick": best.point,
                              "jax_pick": pick}
            parity = (_cnn_card_vs_cpu(model, parity_cut, calib,
                                       _cnn_images(8, res, 3))
                      if parity_cut else None)
            torch.cuda.synchronize()
            emit("cnn_path", net=net, img_res=res, dtype="float32",
                 params=model.graph.total_param_elems(),
                 gflops_b1=model.graph.total_flops() / 1e9,
                 n_cuts=len(rows), n_candidates=len(cands),
                 reduced=CNN_DEPTH.get(net),
                 repeats=CNN_REPEATS, algorithm1=algorithm1,
                 card_vs_cpu=parity, cuts=rows, profiles_b32=profiles,
                 seconds=time.perf_counter() - t0)
            del model
            torch.cuda.empty_cache()
        if (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) != (True, True):
            raise AssertionError("the CNN path left TF32 switched off")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return _launch_counts()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels", "cnn_path", "control",
                                       "dense", "moe", "train",
                                       "diffusion", "parity"),
                    help="run only the kernel phases (a quick check of a "
                         "kernel change), only the CNN path, only the "
                         "build, the control loop, overload, resilient "
                         "and fleet phases and their 3-layer card-vs-CPU "
                         "cases, only the build and the dense path, "
                         "only the build, the attention kernel cases and "
                         "the MoE path with its parity, or only the "
                         "build, fresh weights and the train path, or "
                         "only the card-vs-CPU checks of phase 11 and of "
                         "the dense and MoE paths (the whole script runs "
                         "them in a process of its own); prints no "
                         "result line")
    ap.add_argument("--cpu-threads", type=int, default=None,
                    help="torch's CPU threads (default: torch's own)")
    args = ap.parse_args(argv)
    if args.cpu_threads:
        torch.set_num_threads(args.cpu_threads)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.only == "parity":
        phase_path_parity()
        _dense_parity()
        _moe_parity()
        _diffusion_parity()
        emit("parity_done", cpu_threads=torch.get_num_threads(),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        return 0
    smi = phase_device()
    if args.only == "cnn_path":
        phase_cnn_path()
        return 0
    if args.only == "diffusion":
        phase_diffusion_path()
        from repro_torch.configs import get_arch
        from repro_torch.models.transformer import init_lm
        cfg = get_arch("deepseek-7b").full
        params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        phase_lm_cells(params, cfg)
        del params
        torch.cuda.empty_cache()
        _diffusion_parity()
        return 0
    build = start_build()
    # the CNN and diffusion paths launch no kernel of the port: they run
    # on the card while nvcc compiles (their counts are still set to 0
    # and read)
    cnn_launches = phase_cnn_path() if args.only is None else None
    diff_res = phase_diffusion_path() if args.only is None else None
    phase_build(build)
    if args.only in ("dense", "train"):
        from repro_torch.configs import get_arch
        from repro_torch.models.transformer import init_lm
        cfg = get_arch("deepseek-7b").full
        params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        (phase_dense_path if args.only == "dense" else phase_train_path)(
            params, cfg)
        return 0
    if args.only == "control":
        from repro_torch.configs import get_arch
        from repro_torch.models.transformer import init_lm
        cfg = get_arch("deepseek-7b").full
        params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        phase_adaptive_path(params, cfg, {"outs": []})
        phase_overload_path(params, cfg)
        phase_resilient_path(params, cfg)
        phase_fleet_path(params, cfg)
        del params
        torch.cuda.empty_cache()
        _control_parity()
        _resilient_parity()
        _fleet_parity()
        return 0
    if args.only == "moe":
        phase_kernels()
        phase_moe_path()
        return 0
    kres = phase_kernels()
    sres = phase_sharded_kernels()
    ires, pres = phase_int8_kernels()
    phase_int8_threshold()
    phase_int8_epilogues()
    if args.only == "kernels":
        return 0
    worker = ParityWorker(max(1, len(os.sched_getaffinity(0)) // 2))
    try:
        res = _serving_phases(worker)
    finally:
        worker.stop()
    _summary(smi, kres, sres, ires, pres, cnn_launches, diff_res, *res)
    return 0


def _serving_phases(worker: ParityWorker) -> tuple:
    """Phases 4-10 on one seeded set of deepseek-7b weights, ``worker``
    joined before the training path, then the MoE path; the results the
    summary line reads."""
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
    samp_res = phase_sampled_path(params, cfg, main_res, spec_res)
    tp_res = phase_tp_path(params, cfg, main_res, spec_res)
    adapt_res = phase_adaptive_path(params, cfg, main_res)
    over_res = phase_overload_path(params, cfg)
    res_res = phase_resilient_path(
        params, cfg, fault_free={1: main_res["outs"], 4: spec_res["outs"]})
    fleet_res = phase_fleet_path(params, cfg)
    # the dense and MoE paths' card-vs-CPU checks run in the worker
    dense_res = phase_dense_path(params, cfg, parity=False)
    # the LM cells, training and MoE paths take most of the card's memory
    worker.join()
    lm_res = phase_lm_cells(params, cfg)
    train_res = phase_train_path(params, cfg)   # it updates the weights
    del params
    torch.cuda.empty_cache()
    moe_res = phase_moe_path(parity=False)
    return (main_res, spec_res, samp_res, tp_res, adapt_res, over_res,
            res_res, fleet_res, dense_res, lm_res, train_res, moe_res)


def _summary(smi, kres, sres, ires, pres, cnn_launches, diff_res, main_res,
             spec_res, samp_res, tp_res, adapt_res, over_res, res_res,
             fleet_res, dense_res, lm_res, train_res, moe_res) -> None:
    """The ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and the
    result line."""
    # each summary row is the kernel's main-path shape: the decode step
    # of 4 slots (int8_matmul_splitk: gate/up at M = 4; int8_matmul, the
    # front door, and int8_matmul_wgmma, its kernel above 32 rows:
    # gate/up at a 4 x 128 prefill on a packed weight; int8_pack_weight:
    # that weight's pack; the serving path calls none of them, so their
    # main-path counts are 0 — read, not assumed)
    dec = next(r for r in kres if r["shape"] == "deepseek7b_decode_int8")
    pre = next(r for r in kres if r["shape"] == "deepseek7b_prefill_int8")
    sdec = next(r for r in sres
                if r["shape"] == "deepseek7b_decode_int8_tp2")
    mm = next(r for r in ires if r["shape"] == "int8mm_m512_4096x11008")
    sk = next(r for r in ires if r["shape"] == "int8mm_m4_4096x11008")
    pk = next(r for r in pres if r["shape"] == "pack_4096x11008")
    rows = [{
        "name": "paged_flash_mq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:213",
        "launches": main_res["launches"],
        "spec_path_launches": spec_res["launches"],
        "sampled_serial_launches": samp_res["serial"]["launches"],
        "sampled_spec_launches": samp_res["spec"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kres),
        "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None, "prev_ms": dec["prev_ms"],
        "n_splits": dec["n_splits"], "shape": dec["shape"]}, {
        # B1 at prefill (S * group > 16): the tensor-core kernel, launched
        # through paged_flash_mq; its launches are counted apart too
        "name": "paged_flash_mq_tc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:213",
        "launches": main_res["tc_launches"],
        "spec_path_launches": spec_res["tc_launches"],
        "sampled_serial_launches": samp_res["serial"]["tc_launches"],
        "sampled_spec_launches": samp_res["spec"]["tc_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kres
                           if r["kernel_design"] == "tensor_core"),
        "ms": pre["kernel_ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None, "prev_ms": pre["prev_ms"],
        "shape": pre["shape"]}, {
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
        "bound_by": sdec["bound_by"], "library_ms": None,
        "prev_ms": sdec["prev_ms"], "n_splits": sdec["n_splits"], "tp": 2,
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
        "int_mm_tn_ms": mm["int_mm_tn_ms"],
        "kernel_design": mm["kernel_design"], "prev_ms": mm["prev_ms"],
        "unpacked_call_ms": mm["unpacked_call_ms"],
        "shape": mm["shape"]}, {
        # B4 at M > 32: the wgmma kernel, launched through int8_matmul on
        # a packed weight; its launches are counted apart too.  prev_ms:
        # the tiled kernel, same arguments, same run
        "name": "int8_matmul_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul_sm90.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:139",
        "launches": main_res["int8_matmul_wgmma_launches"],
        "spec_path_launches": spec_res["int8_matmul_wgmma_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in ires
                           if r["out_dtype"] == "torch.float32"
                           and r["kernel_design"] == "wgmma"),
        "ms": mm["kernel_ms"], "plain_ms": mm["plain_ms"],
        "bound_ms": mm["bound_ms"], "bound_by": mm["bound_by"],
        "library_ms": None, "prev_ms": mm["prev_ms"],
        "int_mm_ms": mm["int_mm_ms"], "int_mm_tn_ms": mm["int_mm_tn_ms"],
        "bn": mm["bn"], "grid": mm["grid"], "shape": mm["shape"]}, {
        # the wgmma kernel's layout step: [K, N] -> [N, K] and colsum once
        # per weight (or per call on an unpacked weight)
        "name": "int8_pack_weight", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul_sm90.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:139",
        "launches": main_res["int8_pack_launches"],
        "spec_path_launches": spec_res["int8_pack_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in pres),
        "ms": pk["kernel_ms"], "plain_ms": pk["plain_ms"],
        "bound_ms": pk["bound_ms"], "bound_by": pk["bound_by"],
        "library_ms": None, "shape": pk["shape"]}, {
        # B4 at M <= 32: the split-K cluster kernel, launched through
        # int8_matmul; its launches are counted apart too.  prev_ms: the
        # tiled kernel, same arguments, same run
        "name": "int8_matmul_splitk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:139",
        "launches": main_res["int8_matmul_splitk_launches"],
        "spec_path_launches": spec_res["int8_matmul_splitk_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in ires
                           if r["out_dtype"] == "torch.float32"
                           and r["kernel_design"] == "splitk"),
        "ms": sk["kernel_ms"], "plain_ms": sk["plain_ms"],
        "bound_ms": sk["bound_ms"], "bound_by": sk["bound_by"],
        "library_ms": None, "prev_ms": sk["prev_ms"],
        "int_mm_ms": sk["int_mm_ms"], "int_mm_tn_ms": sk["int_mm_tn_ms"],
        "cluster": sk["cluster"], "slice_k": sk["slice_k"],
        "shape": sk["shape"]}]
    for r in rows:        # the CNN path runs no kernel: its counts, read
        r["cnn_path_launches"] = cnn_launches[r["name"]]
        r["adaptive_path_launches"] = adapt_res["launches"][r["name"]]
        r["overload_path_launches"] = over_res["launches"][r["name"]]
        r["resilient_path_launches"] = res_res["launches"][r["name"]]
        r["fleet_path_launches"] = fleet_res["launches"][r["name"]]
        # read from the counters; phase_dense_path failed if any was not 0
        r["dense_path_launches"] = dense_res["launches"][r["name"]]
        # phase_train_path failed if any was not 0
        r["train_path_launches"] = train_res["launches"][r["name"]]
        # the MoE path's (a)-(c) runs together; B4's rows must read 0
        r["moe_path_launches"] = moe_res["launches"][r["name"]]
        # the diffusion path's (a)-(c) and (d), the LM cells; both failed
        # if any was not 0
        r["diffusion_path_launches"] = (diff_res["launches"][r["name"]]
                                        + lm_res["launches"][r["name"]])
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
