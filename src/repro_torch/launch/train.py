"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-7b --smoke --steps 4 --ckpt DIR [--device cpu]

Builds the (arch × train shape) cell (``launch.steps``), feeds the
deterministic synthetic pipeline (``TokenPipeline`` for an LM,
``ImagePipeline`` for a vision net, ``LatentPipeline`` for a diffusion
model, its ``noise``, ``t``, ``txt`` and ``vec`` drawn from one
``RandomState(0)`` as the reference's launcher draws them), takes
optimizer steps with periodic
checkpointing, and restarts from the latest checkpoint under ``--ckpt``
when one is there, as the reference's launcher does.  Runs on the CUDA
card unless ``--device cpu`` is given.  Weights are random, from a
``torch.Generator`` seeded with 0 (not JAX's key 0: other numbers).
The optimizer state is the cell's own (8-bit moments where the rule
picks them); the reference's launcher always builds f32 AdamW.

The latent pipeline is the reference's: ``cfg.img_res // 8`` cells a
side with ``in_ch`` channels.  That fits the U-Net's smoke cell and not
flux-dev's, whose cell wants ``(img_res // 16)²`` patch tokens; the
launcher fails on it as the reference's does, naming the mismatch
(ROADMAP C).  The flux-dev train cell itself runs through
``build_cell``.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import (ImagePipeline, LatentPipeline,
                                       TokenPipeline)
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                latest_step,
                                                restore_checkpoint)
from repro_torch.launch.steps import Cell, build_cell


def pipeline(family: str, cfg, cell: Cell):
    """The synthetic pipeline that fills ``cell``'s batch."""
    specs = cell.batch_specs
    if family == "lm":
        b, s = specs["tokens"].shape
        return TokenPipeline(vocab=cfg.vocab, seq_len=s, batch=b)
    if family == "diffusion":
        return LatentPipeline(latent_res=cfg.img_res // 8,
                              channels=getattr(cfg, "in_ch", 4),
                              batch=specs["latent"].shape[0],
                              ctx_len=getattr(cfg, "ctx_len", 4),
                              ctx_dim=getattr(cfg, "ctx_dim", 16))
    return ImagePipeline(img_res=specs["image"].shape[1],
                         batch=specs["image"].shape[0],
                         n_classes=getattr(cfg, "n_classes", 10))


def _synthetic(k: str, spec, rng: np.random.RandomState) -> np.ndarray:
    """The reference launcher's draw for a batch key its pipeline lacks."""
    if k == "noise":
        return rng.randn(*spec.shape)
    if k == "t":
        if spec.dtype.is_floating_point:
            return rng.rand(*spec.shape)
        return rng.randint(0, 1000, spec.shape)
    if k in ("txt", "vec", "ctx", "latent"):
        return rng.randn(*spec.shape) * 0.5
    raise KeyError(f"no synthetic source for batch key {k}")


def batch_for(cell: Cell, pipe, step: int,
              rng: Optional[np.random.RandomState] = None) -> dict:
    """The pipeline's batch at ``step`` as tensors on the cell's device,
    in the cell's dtypes and shapes; keys the pipeline lacks (a
    diffusion cell's ``noise``, ``t``, ``txt``, ``vec``) are drawn from
    ``rng`` in the cell's key order."""
    raw = pipe.batch_at(step)
    out = {}
    for k, spec in cell.batch_specs.items():
        arr = np.asarray(raw[k]) if k in raw else _synthetic(k, spec, rng)
        if arr.size != math.prod(spec.shape):
            raise ValueError(
                f"{cell.arch_id}: the pipeline's {k!r} is "
                f"{list(arr.shape)} ({arr.size} values) and the cell "
                f"wants {list(spec.shape)}")
        arr = arr.reshape(spec.shape)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            cell.device, spec.dtype)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    shape = args.shape or next(iter(spec.shapes))
    if spec.shapes[shape].kind != "train":
        raise SystemExit(f"{shape} is not a train shape")
    cell = build_cell(args.arch, shape, smoke=args.smoke, device=args.device)
    cfg = spec.smoke if args.smoke else spec.full
    print(f"arch={args.arch} shape={shape} device={cell.device} "
          f"smoke={args.smoke} grad_accum={cell.grad_accum}")
    pipe = pipeline(spec.family, cfg, cell)
    rng = np.random.RandomState(0)
    params = cell.init_params()
    opt = cell.init_opt(params)

    start = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt, every=args.ckpt_every,
                                async_save=False)
        if latest_step(args.ckpt) is not None:
            state, start, _ = restore_checkpoint(args.ckpt,
                                                 {"p": params, "o": opt})
            params, opt = state["p"], state["o"]
            print(f"restored checkpoint @ step {start}")

    for step in range(start, args.steps):
        batch = batch_for(cell, pipe, step, rng)
        t0 = time.perf_counter()
        params, opt, metrics = cell.step_fn(params, opt, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        dt = time.perf_counter() - t0
        print(f"step {step + 1:4d} loss={loss:.4f} gnorm={gnorm:.3f} "
              f"{dt * 1e3:.0f}ms", flush=True)
        if mgr:
            mgr.maybe_save(step + 1, {"p": params, "o": opt})
    if mgr:
        mgr.wait()
    return params, opt


if __name__ == "__main__":
    main()
