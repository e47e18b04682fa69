"""Quickstart of the port: the paper's pipeline on AlexNet's graph and a
small CNN.

  1. AlexNet's layer graph and its candidate partition points (§2.2)
  2. Algorithm 1's best cut per wireless bandwidth
  3. collaborative inference at every cut of a small CNN: INT8 edge →
     simulated channel → fp32 cloud, against the fp32 model

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Twin of ``examples/quickstart.py``; runs on the CUDA card unless
``--device cpu`` is given.  The small CNN's weights are random, from a
seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.autotune import AutoTuner
from repro_torch.core.collab import (CollaborativeEngine, Segment,
                                     SegmentedModel)
from repro_torch.core.costmodel import (CLOUD_TITANXP_CLASS, Channel,
                                        EDGE_TX2_CLASS)
from repro_torch.core.graph import LayerGraph
from repro_torch.core.partition import partition_report
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import legacy

BANDWIDTHS_KBPS = (50, 100, 250, 500, 1000, 10000)
TINY_CUTS = ("input", "conv1", "conv2", "head")


def tiny_cnn(gen: torch.Generator, *, device: DeviceLike = None, c: int = 8,
             d: int = 16, n_cls: int = 10, img: int = 16) -> SegmentedModel:
    """conv → conv (stride 2) → global mean + dense, segmented at each
    layer boundary; the same network as the JAX suite's ``tiny_cnn``."""
    dev = resolve_device(device)
    p1 = L.conv2d_init(gen, 3, 3, c, device=dev)
    p2 = L.conv2d_init(gen, 3, c, d, device=dev)
    p3 = L.dense_init(gen, d, n_cls, bias=True, dtype=torch.float32,
                      device=dev)

    def s1(p, x, *, qctx=None):
        return L.conv2d(p, x, qctx=qctx, name="conv1", act="relu")

    def s2(p, x, *, qctx=None):
        return L.conv2d(p, x, stride=2, qctx=qctx, name="conv2", act="relu")

    def s3(p, x, *, qctx=None):
        return L.cnn_dense(p, torch.mean(x, dim=(1, 2)), qctx=qctx,
                           name="head")

    g = LayerGraph("tiny-cnn")
    g.add("input", "input", [], (1, img, img, 3))
    g.add("conv1", "conv", ["input"], (1, img, img, c),
          flops=2 * 9 * 3 * c * img * img, param_elems=9 * 3 * c + c)
    g.add("conv2", "conv", ["conv1"], (1, img // 2, img // 2, d),
          flops=2 * 9 * c * d * (img // 2) ** 2, param_elems=9 * c * d + d)
    g.add("head", "dense", ["conv2"], (1, n_cls), flops=2 * d * n_cls,
          param_elems=d * n_cls + n_cls)
    return SegmentedModel(
        name="tiny-cnn", graph=g,
        segments=[Segment("conv1", s1, p1), Segment("conv2", s2, p2),
                  Segment("head", s3, p3)])


def images(batch: int, img: int, seed: int, device: torch.device
           ) -> torch.Tensor:
    """Uniform [0, 1) NHWC images from a numpy seed."""
    x = np.random.RandomState(seed).rand(batch, img, img, 3)
    return torch.tensor(x.astype(np.float32), device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the small CNN runs (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the small CNN's random weights")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== AlexNet (paper Table 3 subject), ImageNet-sized input ==\n")
    graph = legacy.alexnet_graph()
    print(partition_report(graph))

    print("\n== Algorithm 1: best cut per wireless bandwidth ==")
    tuner = AutoTuner(graph, EDGE_TX2_CLASS, CLOUD_TITANXP_CLASS)
    print(f"{'bandwidth':>12} {'best cut':>10} {'total (s)':>10} "
          f"{'upload (KB)':>12} {'edge model (KB)':>16} {'storage red.':>12}")
    for kbps in BANDWIDTHS_KBPS:
        best, _ = tuner.tune(Channel.from_kbps(kbps))
        print(f"{kbps:>10} KB/s {best.point:>10} {best.total_s:>10.3f} "
              f"{best.transmit_bytes / 1e3:>12.1f} "
              f"{best.edge_model_bytes / 1e3:>16.1f} "
              f"{best.storage_reduction:>11.1%}")
    sp = tuner.speedup_vs_cloud_only(Channel.from_kbps(250))
    print(f"\nspeed-up vs cloud-only @250KB/s: {sp:.2f}x "
          f"(paper reports 1.7x for AlexNet)")

    print(f"\n== collaborative inference on {dev} (small CNN, real "
          f"compute) ==")
    model = tiny_cnn(torch.Generator(device=dev).manual_seed(args.seed),
                     device=dev)
    x = images(1, 16, 0, dev)
    truth = model.full_apply(x)
    for cut in TINY_CUTS:
        eng = CollaborativeEngine(model, cut, channel=Channel.from_kbps(250),
                                  calib_batches=[images(2, 16, 9, dev)],
                                  device=dev)
        y, rec = eng.infer(x)
        rel = float(torch.linalg.norm(y - truth) / torch.linalg.norm(truth))
        print(f"  cut={cut:6s} blob={rec.blob_bytes:6d}B ({rec.precision}) "
              f"sim-latency={rec.simulated_latency_s * 1e3:7.2f}ms "
              f"rel-err vs fp32={rel:.4f}")
    print("\nDone. The INT8 edge keeps the output within quantization noise.")


if __name__ == "__main__":
    main()
