"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --collaborative --cut auto --bandwidth 250 --spec-k auto --adaptive

Cloud-only mode runs the batched engine over a dense fp KV cache, as
the reference's launcher does; ``--collaborative`` splits the stack at the
(auto-tuned or given) block and runs the paper's INT8-edge / fp-cloud
pipeline over a simulated wireless channel; ``--spec-k`` turns its
decode into speculative draft/verify rounds (an int, or ``auto`` for
the cost model's pick, which keeps self-correcting from the measured
acceptance between requests); ``--adaptive`` closes the whole tuning
loop online — link telemetry re-tunes the draft length between rounds
and the cut layer at admission boundaries.  ``--temperature``/``--top-p``/``--sample-seed``
sample instead of greedy decode (collaborative mode only): the verify
becomes exact rejection sampling against the cloud distribution, and
request i samples with seed ``sample-seed + i``, so every stream replays
bit for bit.  Runs on the CUDA card unless ``--device cpu`` is given.
Weights are random, from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.autotune import AutoTuner
from repro_torch.core.costmodel import (CLOUD_TITANXP_CLASS, Channel,
                                        EDGE_TX2_CLASS)
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LMConfig, init_lm, make_graph
from repro_torch.serve.engine import CollaborativeServingEngine, ServingEngine
from repro_torch.serve.sampling import SamplingParams


def auto_cut(cfg: LMConfig, channel: Channel, prompt_len: int):
    """Algorithm 1 over the LM's block-boundary candidates → (point, cut
    layer), exactly as the reference launcher derives it."""
    graph = make_graph(cfg, batch=1, seq=prompt_len)
    best, _ = AutoTuner(graph, EDGE_TX2_CLASS, CLOUD_TITANXP_CLASS).tune(
        channel)
    cut = (int(best.point.split("/")[0][3:])
           if best.point.startswith("blk") else 0)
    return best.point, cut


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--collaborative", action="store_true")
    ap.add_argument("--cut", default="auto")
    ap.add_argument("--bandwidth", type=float, default=250.0,
                    help="wireless KB/s for the collaborative channel")
    ap.add_argument("--rtt", type=float, default=20.0,
                    help="wireless round-trip time in ms")
    ap.add_argument("--spec-k", default="1",
                    help="speculative draft length: an int, or 'auto' to "
                         "pick it from the channel with the cost model and "
                         "keep self-correcting from measured acceptance")
    ap.add_argument("--adaptive", action="store_true",
                    help="online control loop: telemetry re-tunes spec_k "
                         "between rounds and the cut layer at admission "
                         "boundaries")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="decode temperature; 0 keeps the greedy path, >0 "
                         "turns verify into exact rejection sampling "
                         "against the cloud distribution")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus cutoff applied to the cloud "
                         "distribution before sampling (1.0 = off)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base seed of the draws; request i samples with "
                         "seed+i so outputs replay bit for bit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    spec_k = args.spec_k if args.spec_k == "auto" else int(args.spec_k)
    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"{args.arch} is a {spec.family} arch; the serving "
                         f"launcher targets the LM family")
    cfg = spec.smoke if args.smoke else spec.full
    print(f"serving {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} on {dev}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_lm(cfg, gen, device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    max_len = args.prompt_len + args.max_new + 24
    # temperature 0 stays on the greedy path (sampling=None)
    sampling = None
    if args.temperature > 0:
        sampling = [SamplingParams(temperature=args.temperature,
                                   top_p=args.top_p,
                                   seed=args.sample_seed + i)
                    for i in range(args.requests)]

    if not args.collaborative:
        if sampling is not None:
            raise SystemExit("--temperature>0 needs --collaborative: the "
                             "rejection-sampling verify lives in the "
                             "collaborative engine")
        # the reference CLI's engine: one dense fp KV cache
        eng = ServingEngine(params, cfg, max_batch=4, max_len=max_len,
                            device=dev)
        t0 = time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=args.max_new)
        dt = time.perf_counter() - t0
        print(f"cloud-only (dense fp KV): {args.requests} reqs x "
              f"{args.max_new} tokens in {dt:.2f}s "
              f"({eng.stats.decode_steps} decode steps)")
        print("first output:", outs[0])
        return

    channel = Channel.from_kbps(args.bandwidth, rtt_ms=args.rtt)
    if args.cut == "auto":
        point, cut_layer = auto_cut(cfg, channel, args.prompt_len)
        print(f"auto-tuned cut (Algorithm 1): {point} "
              f"-> edge blocks 0..{cut_layer}")
    else:
        cut_layer = int(args.cut)
    if args.adaptive and cut_layer > cfg.n_layers - 2:
        cut_layer = cfg.n_layers - 2
        print(f"adaptive mode: clamping cut to {cut_layer} so every "
              f"candidate partition keeps a cloud block")
    eng = CollaborativeServingEngine(
        params, cfg, cut_layer=cut_layer, channel=channel, max_len=max_len,
        spec_k=spec_k, policy="auto" if args.adaptive else None, device=dev)
    if sampling is not None:
        print(f"sampling: temperature={args.temperature} "
              f"top_p={args.top_p} seeds {args.sample_seed}.."
              f"{args.sample_seed + args.requests - 1} "
              f"(exact cloud distribution via rejection-sampled verify)")
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=args.max_new,
                        sampling=sampling)
    dt = time.perf_counter() - t0
    print(f"collaborative: {dt:.2f}s, int8 wire bytes "
          f"{eng.stats.transmitted_bytes / 1e3:.1f}KB "
          f"({eng.stats.prefill_bytes / 1e3:.1f}KB prefill + "
          f"{eng.stats.bytes_per_decode_token():.0f} B/token incremental "
          f"decode), simulated channel "
          f"time {eng.stats.channel_latency_s:.2f}s")
    if eng.spec_k > 1:
        print(f"speculative rounds: spec_k={eng.spec_k}, "
              f"{eng.stats.spec_rounds} rounds, draft acceptance "
              f"{eng.stats.acceptance_rate():.0%}")
    if eng.policy is not None:
        print(f"control loop: spec_k={eng.spec_k} cut={eng.cut} "
              f"(switches: k={eng.stats.spec_k_switches}, "
              f"cut={eng.stats.cut_switches}; draft acceptance "
              f"{eng.stats.acceptance_rate():.0%})")
    print("first output:", outs[0])


if __name__ == "__main__":
    main()
