"""Train cells: one step function per (architecture × train shape).

Counterpart of the train kinds of ``repro.launch.steps``: a ``Cell``
holds an eager PyTorch step ``step_fn(params, opt, batch) -> (params,
opt, {"loss", "grad_norm"})`` (no jit, lowering or shardings), a seeded
parameter init, the optimizer init and the batch's ``TensorSpec``.
Kept from the reference's ``_train_cell`` and its LM and vision cells:

* 8-bit AdamW moments when ``n_params * 12 / devices > 14e9`` (f32
  parameters, gradients and moments would not fit), else f32 AdamW;
  one device here.  deepseek-7b at full size takes the 8-bit state;
* microbatch accumulation in the **parameter dtype** (bf16 for the big
  configs), the LM cell taking ``want = 8 if params > 1e11 else 4``
  microbatches, or the largest of ``want``, ``want // 2``, 2 that
  divides the batch;
* a constant ``cfg.lr`` (no schedule);
* ``model_flops = 6 · active params · tokens`` for an LM, three times
  the forward graph's flops for a vision net;
* the smoke shapes (``_smoke_shape``).

An MoE arch's train cell raises: the reference trains it through
``moe_sharded`` (the F-split MoE under ``shard_map``), which the port
does not have (ROADMAP A16 leftovers).  Prefill, decode and infer cells
come with the dry run (ROADMAP A18).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.bridge import tree_leaves
from repro_torch.configs import ShapeSpec, TensorSpec, get_arch, shape_inputs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import resnet as RN
from repro_torch.models import transformer as TF
from repro_torch.models import vit as VT
from repro_torch.train.grads import value_and_grad_into, zeros_like_tree
from repro_torch.train.optim import (AdamW8bitState, AdamWConfig,
                                     adamw8bit_init, adamw8bit_update,
                                     adamw_init, adamw_update)

__all__ = ["Cell", "build_cell", "use_8bit_moments"]

Params = Any
MOMENT_BUDGET_BYTES = 14e9     # the reference's per-device budget


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    step_fn: Callable
    init_params: Callable[[], Params]       # seeded, on ``device``
    init_opt: Callable[[Params], Any]
    batch_specs: Dict[str, TensorSpec]
    device: torch.device
    grad_accum: int = 1
    model_flops: float = 0.0      # 6·N·D (LM) / 3 · graph flops (vision)


def use_8bit_moments(n_params: int, devices: int = 1) -> bool:
    """The reference's rule: f32 moments cost 8 B a parameter; when
    parameters, gradients and moments (12 B) would pass the 14 GB a
    device budget, the moments go 8-bit."""
    return n_params * 12.0 / devices > MOMENT_BUDGET_BYTES


def _train_cell(arch_id: str, sh: ShapeSpec, *, device: torch.device,
                init_fn, loss_fn, batch_specs: Dict[str, TensorSpec],
                model_flops: float, opt_cfg: AdamWConfig = AdamWConfig(),
                grad_accum: int = 1) -> Cell:
    def init_opt(params):
        n = sum(p.numel() for p in tree_leaves(params))
        return (adamw8bit_init if use_8bit_moments(n) else adamw_init)(
            params)

    def step(params, opt, batch):
        acc = zeros_like_tree(params)        # the parameter dtype
        if grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(grad_accum):
                mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss = loss + value_and_grad_into(loss_fn, params, mb, acc)
            inv = 1.0 / grad_accum
            loss = loss * inv
            for g in tree_leaves(acc):
                # the reference's weak-typed ``g * inv``: inv in g's dtype
                g.mul_(torch.tensor(inv, dtype=g.dtype).item())
        else:
            loss = value_and_grad_into(loss_fn, params, batch, acc)
        update = (adamw8bit_update if isinstance(opt, AdamW8bitState)
                  else adamw_update)
        params, opt, gnorm = update(acc, opt, params, opt_cfg)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    return Cell(arch_id=arch_id, shape_name=sh.name, kind="train",
                step_fn=step, init_params=init_fn, init_opt=init_opt,
                batch_specs=batch_specs, device=device,
                grad_accum=grad_accum, model_flops=model_flops)


def _generator(device: torch.device) -> torch.Generator:
    """Seed 0, where the reference's cells take ``PRNGKey(0)``."""
    return torch.Generator(device=device).manual_seed(0)


def _lm_cell(arch_id: str, sh: ShapeSpec, cfg: TF.LMConfig, specs, *,
             device: torch.device) -> Cell:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{arch_id}: the reference trains an MoE arch through "
            "moe_sharded (the F-split MoE under shard_map), which the "
            "port does not have yet (ROADMAP A16 leftovers)")
    b, s = sh.global_batch, sh.seq_len
    want = 8 if cfg.param_count() > 1e11 else 4
    accum = next((c for c in (want, want // 2, 2) if c >= 2 and b % c == 0),
                 1)
    return _train_cell(
        arch_id, sh, device=device,
        init_fn=lambda: TF.init_lm(cfg, _generator(device), device),
        loss_fn=lambda p, batch: TF.lm_loss(p, batch, cfg),
        batch_specs=specs, grad_accum=accum,
        model_flops=6.0 * cfg.active_param_count() * b * s)


def _vision_cell(arch_id: str, sh: ShapeSpec, cfg, specs, *,
                 device: torch.device) -> Cell:
    run_cfg = dataclasses.replace(cfg, img_res=sh.img_res)
    if isinstance(cfg, VT.ViTConfig):
        init = lambda: VT.init_vit(_generator(device), run_cfg,
                                   device=device)
        fwd, graph = VT.forward, VT.make_graph
    elif isinstance(cfg, RN.ResNetConfig):
        init = lambda: RN.init_resnet(_generator(device), run_cfg,
                                      device=device)
        fwd, graph = RN.forward, RN.make_graph
    else:
        raise NotImplementedError(f"{arch_id}: no train cell for "
                                  f"{type(cfg).__name__}")

    def loss(params, batch):
        return TF.token_nll(fwd(params, batch["image"], run_cfg),
                            batch["label"])

    return _train_cell(
        arch_id, sh, device=device, init_fn=init, loss_fn=loss,
        batch_specs=specs,
        model_flops=3.0 * graph(run_cfg, batch=sh.global_batch
                                ).total_flops())


def build_cell(arch_id: str, shape_name: str, *, smoke: bool = False,
               cfg_override: Optional[Dict[str, Any]] = None,
               shape_override: Optional[Dict[str, Any]] = None,
               device: DeviceLike = None) -> Cell:
    """The (arch, shape) train cell on ``device`` (default the card).
    ``cfg_override`` replaces config fields, ``shape_override`` shape
    fields (a cut batch, say)."""
    spec = get_arch(arch_id)
    cfg = spec.smoke if smoke else spec.full
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    sh = spec.shapes[shape_name]
    if smoke:
        sh = _smoke_shape(spec.family, sh, cfg)
    if shape_override:
        sh = dataclasses.replace(sh, **shape_override)
    if sh.kind != "train":
        raise NotImplementedError(
            f"{shape_name}: {sh.kind} cells come with the dry run "
            "(ROADMAP A18)")
    dev = resolve_device(device)
    specs = shape_inputs(spec.family, sh)
    if spec.family == "lm":
        return _lm_cell(arch_id, sh, cfg, specs, device=dev)
    return _vision_cell(arch_id, sh, cfg, specs, device=dev)


def _smoke_shape(family: str, sh: ShapeSpec, cfg) -> ShapeSpec:
    if family == "lm":
        return dataclasses.replace(sh, seq_len=min(sh.seq_len, 64),
                                   global_batch=min(sh.global_batch, 2))
    return dataclasses.replace(sh, img_res=min(sh.img_res, cfg.img_res),
                               global_batch=min(sh.global_batch, 2))
