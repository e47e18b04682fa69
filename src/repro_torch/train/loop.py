"""Trainer: the generic training loop of the examples and tests.

Counterpart of ``repro.train.loop``: AdamW with the cosine schedule and
clipping, gradient accumulation over microbatches (the batch's leading
axis when ``grad_accum > 1``), optional QAT (fake-quant in the loss),
optional INT8 error-feedback gradient compression, periodic
checkpointing and a metric history.  Kept from the reference:
microbatch gradients accumulate in **f32** buffers (a single batch's
gradients stay in the parameter dtype), and the schedule is read at the
optimizer's step *before* the update, so the first warm-up step has
``lr = 0``.  The step runs eagerly on the parameters' device and updates
them in place (``train.optim``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.bridge import tree_leaves
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                latest_step,
                                                restore_checkpoint)
from repro_torch.train.grad_compress import (compress_with_feedback,
                                             init_error_feedback)
from repro_torch.train.grads import value_and_grad_into, zeros_like_tree
from repro_torch.train.optim import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule)

Params = Any


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    grad_accum: int = 1
    grad_compress: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, loss_fn: Callable[[Params, Dict], torch.Tensor],
                 params: Params, cfg: TrainerConfig):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.opt = adamw_init(params)
        self.error = init_error_feedback(params) if cfg.grad_compress \
            else None
        self.schedule = cosine_schedule(cfg.lr, cfg.warmup, cfg.n_steps)
        self.history: List[Dict] = []
        self._mgr = (CheckpointManager(cfg.ckpt_dir, every=cfg.ckpt_every)
                     if cfg.ckpt_dir else None)

    def _grads(self, params, batch):
        cfg = self.cfg
        if cfg.grad_accum > 1:
            acc = zeros_like_tree(params, torch.float32)
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(cfg.grad_accum):
                mb = {k: v[i] for k, v in batch.items()}
                loss = loss + value_and_grad_into(self.loss_fn, params, mb,
                                                  acc)
            inv = 1.0 / cfg.grad_accum
            for g in tree_leaves(acc):
                g.mul_(inv)
            return loss * inv, acc
        acc = zeros_like_tree(params)
        return value_and_grad_into(self.loss_fn, params, batch, acc), acc

    def _step(self, params, opt, error, batch):
        loss, grads = self._grads(params, batch)
        if error is not None:
            grads, error = compress_with_feedback(grads, error)
        lr = self.schedule(opt.step)
        params, opt, gnorm = adamw_update(grads, opt, params, self.cfg.adamw,
                                          lr=lr)
        return params, opt, error, {"loss": loss, "grad_norm": gnorm,
                                    "lr": lr}

    def maybe_restore(self) -> int:
        if self._mgr is None or latest_step(self.cfg.ckpt_dir) is None:
            return 0
        state = {"params": self.params, "opt": self.opt}
        state, step, _ = restore_checkpoint(self.cfg.ckpt_dir, state)
        self.params, self.opt = state["params"], state["opt"]
        return step

    def fit(self, data: Iterator[Dict], *, start_step: int = 0
            ) -> List[Dict]:
        cfg = self.cfg
        step = start_step
        for batch in data:
            if step >= cfg.n_steps:
                break
            batch = to_device(batch, self.device)
            t0 = time.perf_counter()
            self.params, self.opt, self.error, metrics = self._step(
                self.params, self.opt, self.error, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = time.perf_counter() - t0
            step += 1
            metrics["step"] = step
            self.history.append(metrics)
            if self._mgr is not None:
                self._mgr.maybe_save(step, {"params": self.params,
                                            "opt": self.opt})
            if cfg.log_every and step % cfg.log_every == 0:
                print(f"step {step:5d}  loss {metrics['loss']:.4f}  "
                      f"gnorm {metrics['grad_norm']:.3f}  "
                      f"lr {metrics['lr']:.2e}  "
                      f"{metrics['step_time_s'] * 1e3:.0f} ms", flush=True)
        if self._mgr is not None:
            self._mgr.wait()
        return self.history
