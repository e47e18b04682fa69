"""Cells: one step function per (architecture × input shape).

Counterpart of ``repro.launch.steps``: a ``Cell`` holds an eager
PyTorch step (no jit, lowering or shardings), a seeded parameter init,
its state's init (the optimizer's for a train cell, the KV cache's for
a decode cell) and its inputs' ``TensorSpec``.  The kinds, per family:

* lm: ``train`` (causal LM + AdamW) ``step(params, opt, batch)``;
  ``prefill`` ``step(params, tokens) -> (logits, cache)`` with
  ``q_chunk=2048``, no remat and a dense cache made in the step;
  ``decode`` ``step(params, cache, token, cache_index) -> (logits,
  cache)`` on a dense cache (INT8 with ``variant="int8kv"``);
* diffusion: ``train`` (eps / rectified-flow matching + AdamW, ``noise``
  and ``t`` from the batch) and ``denoise``, one sampler step:
  ``ddim_step`` with stride ``1000 // steps`` (U-Net,
  ``step(params, latent, t, ctx)``) or ``rf_step`` with ``dt =
  1 / steps`` (MMDiT, ``step(params, latent, t, txt, vec)``);
* vision: ``train`` (CE + AdamW) and ``infer`` ``step(params, image)``.

``Cell.run(params, state, inputs)`` calls any kind's step.  Kept from
the reference's ``_train_cell`` and cells:

* 8-bit AdamW moments when ``n_params * 12 / devices > 14e9`` (f32
  parameters, gradients and moments would not fit), else f32 AdamW;
  one device here.  deepseek-7b at full size takes the 8-bit state;
* microbatch accumulation in the **parameter dtype** (bf16 for the big
  configs), the LM cell taking ``want = 8 if params > 1e11 else 4``
  microbatches, or the largest of ``want``, ``want // 2``, 2 that
  divides the batch;
* a constant ``cfg.lr`` (no schedule);
* ``model_flops``: ``6 · active params · tokens`` for an LM train cell
  and ``2 ·`` for prefill and decode; a diffusion or vision net's
  forward graph flops, three times that to train;
* U-Net ``q_chunk = 2048`` once the latent has more than 4,096 cells;
* the smoke shapes (``_smoke_shape``).

An MoE arch's train cell raises: the reference trains it through
``moe_sharded`` (the F-split MoE under ``shard_map``), which the port
does not have (ROADMAP A16 leftovers).  Its prefill and decode cells
run ``moe``, which ``moe_sharded`` equals on one device.  The
``zero1`` and ``sseq`` decode variants are shardings only and raise
(A16).  ``device="meta"`` builds a cell with no storage (the dry run):
its init draws from a CPU generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.bridge import tree_leaves
from repro_torch.configs import ShapeSpec, TensorSpec, get_arch, shape_inputs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mmdit as MM
from repro_torch.models import resnet as RN
from repro_torch.models import transformer as TF
from repro_torch.models import unet as UN
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
    init_opt: Optional[Callable[[Params], Any]]   # train cells
    batch_specs: Dict[str, TensorSpec]      # the step's inputs
    device: torch.device
    grad_accum: int = 1
    model_flops: float = 0.0      # the reference's rule (module docstring)
    arg_names: Tuple[str, ...] = ()         # a serving step's inputs
    init_cache: Optional[Callable[[], Any]] = None   # decode cells

    def init_state(self, params: Params) -> Any:
        """The step's state: the optimizer's (train), the KV cache
        (decode), else None."""
        if self.kind == "train":
            return self.init_opt(params)
        return self.init_cache() if self.init_cache is not None else None

    def run(self, params: Params, state: Any,
            inputs: Dict[str, torch.Tensor]) -> Any:
        """One step of any kind on ``inputs`` (named as ``batch_specs``)
        and ``state`` (``init_state``'s)."""
        if self.kind == "train":
            return self.step_fn(params, state, inputs)
        args = [inputs[k] for k in self.arg_names]
        if self.kind == "decode":
            return self.step_fn(params, state, *args)
        return self.step_fn(params, *args)


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
    """Seed 0, where the reference's cells take ``PRNGKey(0)``; a CPU
    generator for the meta device (which has none of its own)."""
    gen_dev = "cpu" if device.type == "meta" else device
    return torch.Generator(device=gen_dev).manual_seed(0)


def _serving_cell(arch_id: str, sh: ShapeSpec, kind: str, step,
                  init_fn, specs, arg_names, *, device: torch.device,
                  model_flops: float, init_cache=None) -> Cell:
    return Cell(arch_id=arch_id, shape_name=sh.name, kind=kind,
                step_fn=step, init_params=init_fn, init_opt=None,
                batch_specs=specs, device=device, model_flops=model_flops,
                arg_names=tuple(arg_names), init_cache=init_cache)


def _lm_cell(arch_id: str, sh: ShapeSpec, cfg: TF.LMConfig, specs, *,
             device: torch.device, variant: Optional[str] = None) -> Cell:
    b, s = sh.global_batch, sh.seq_len
    init = lambda c: (lambda: TF.init_lm(c, _generator(device), device))
    if sh.kind == "prefill":
        pf_cfg = dataclasses.replace(cfg, q_chunk=2048, remat=False)

        def prefill_step(params, tokens):
            cache = TF.init_cache(pf_cfg, b, max_len=s, device=device)
            return TF.prefill(params, tokens, pf_cfg, cache=cache)

        return _serving_cell(
            arch_id, sh, "prefill", prefill_step, init(pf_cfg), specs,
            ("tokens",), device=device,
            model_flops=2.0 * cfg.active_param_count() * b * s)
    if sh.kind == "decode":
        if variant is not None and ("zero1" in variant or "sseq" in variant):
            raise NotImplementedError(
                f"variant {variant!r}: zero1 and sseq are shardings over "
                "several devices (ROADMAP A16 leftovers)")
        int8kv = variant is not None and "int8kv" in variant
        dec_cfg = dataclasses.replace(cfg, remat=False)

        def decode_step(params, cache, token, cache_index):
            return TF.decode_step(params, token, cache, cache_index,
                                  dec_cfg)

        return _serving_cell(
            arch_id, sh, "decode", decode_step, init(dec_cfg), specs,
            ("token", "cache_index"), device=device,
            model_flops=2.0 * dec_cfg.active_param_count() * b,
            init_cache=lambda: TF.init_cache(dec_cfg, b, max_len=s,
                                             quantized=int8kv,
                                             device=device))
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{arch_id}: the reference trains an MoE arch through "
            "moe_sharded (the F-split MoE under shard_map), which the "
            "port does not have yet (ROADMAP A16 leftovers)")
    want = 8 if cfg.param_count() > 1e11 else 4
    accum = next((c for c in (want, want // 2, 2) if c >= 2 and b % c == 0),
                 1)
    return _train_cell(
        arch_id, sh, device=device, init_fn=init(cfg),
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

    graph_flops = graph(run_cfg, batch=sh.global_batch).total_flops()
    if sh.kind == "infer":
        return _serving_cell(
            arch_id, sh, "infer", lambda p, image: fwd(p, image, run_cfg),
            init, specs, ("image",), device=device, model_flops=graph_flops)

    def loss(params, batch):
        return TF.token_nll(fwd(params, batch["image"], run_cfg),
                            batch["label"])

    return _train_cell(
        arch_id, sh, device=device, init_fn=init, loss_fn=loss,
        batch_specs=specs, model_flops=3.0 * graph_flops)


def _mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.to(torch.float32)
                                   - target.to(torch.float32)))


def _unet_cell(arch_id: str, sh: ShapeSpec, cfg: UN.UNetConfig, specs, *,
               device: torch.device) -> Cell:
    b = sh.global_batch
    lat = sh.img_res // 8
    # q-tile the full-resolution self-attention once the tokens explode
    qc = 2048 if lat * lat > 4096 else None
    run_cfg = dataclasses.replace(cfg, img_res=sh.img_res, q_chunk=qc)
    graph_flops = UN.make_graph(run_cfg, batch=b, latent_res=lat
                                ).total_flops()
    init = lambda: UN.init_unet(_generator(device), run_cfg, device=device)
    if sh.kind == "train":
        def loss(params, batch):
            _, alphas = UN.ddpm_schedule(device=batch["latent"].device)
            a = alphas[batch["t"].long()][:, None, None, None]
            x_t = (torch.sqrt(a) * batch["latent"]
                   + torch.sqrt(1 - a) * batch["noise"])
            pred = UN.unet_forward(params, x_t, batch["t"], batch["ctx"],
                                   run_cfg)
            return _mse(pred, batch["noise"])

        return _train_cell(arch_id, sh, device=device, init_fn=init,
                           loss_fn=loss, batch_specs=specs,
                           model_flops=3.0 * graph_flops)
    stride = max(1000 // max(sh.steps, 1), 1)

    def step(params, latent, t, ctx):
        return UN.ddim_step(params, latent, t, t - stride, ctx, run_cfg)

    return _serving_cell(arch_id, sh, "denoise", step, init, specs,
                         ("latent", "t", "ctx"), device=device,
                         model_flops=graph_flops)


def _mmdit_cell(arch_id: str, sh: ShapeSpec, cfg: MM.MMDiTConfig, specs,
                *, device: torch.device) -> Cell:
    b = sh.global_batch
    run_cfg = dataclasses.replace(cfg, img_res=sh.img_res)
    graph_flops = MM.make_graph(run_cfg, batch=b).total_flops()
    init = lambda: MM.init_mmdit(_generator(device), run_cfg, device=device)
    if sh.kind == "train":
        def loss(params, batch):
            t = batch["t"][:, None, None]
            x_t = (1 - t) * batch["latent"] + t * batch["noise"]
            v = MM.mmdit_forward(params, x_t, batch["t"] * 1000,
                                 batch["txt"], batch["vec"], run_cfg)
            return _mse(v, batch["noise"] - batch["latent"])

        return _train_cell(arch_id, sh, device=device, init_fn=init,
                           loss_fn=loss, batch_specs=specs,
                           model_flops=3.0 * graph_flops)
    dt = 1.0 / max(sh.steps, 1)

    def step(params, latent, t, txt, vec):
        return MM.rf_step(params, latent, t, torch.full_like(t, dt), txt,
                          vec, run_cfg)

    return _serving_cell(arch_id, sh, "denoise", step, init, specs,
                         ("latent", "t", "txt", "vec"), device=device,
                         model_flops=graph_flops)


def build_cell(arch_id: str, shape_name: str, *, smoke: bool = False,
               cfg_override: Optional[Dict[str, Any]] = None,
               shape_override: Optional[Dict[str, Any]] = None,
               variant: Optional[str] = None,
               device: DeviceLike = None) -> Cell:
    """The (arch, shape) cell on ``device`` (default the card; ``"meta"``
    builds it without storage).  ``cfg_override`` replaces config
    fields, ``shape_override`` shape fields (a cut batch, say);
    ``variant="int8kv"`` gives a decode cell the INT8 dense cache."""
    spec = get_arch(arch_id)
    cfg = spec.smoke if smoke else spec.full
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    sh = spec.shapes[shape_name]
    if smoke:
        sh = _smoke_shape(spec.family, sh, cfg)
    if shape_override:
        sh = dataclasses.replace(sh, **shape_override)
    dev = resolve_device(device)
    specs = shape_inputs(spec.family, sh, cfg)
    if spec.family == "lm":
        return _lm_cell(arch_id, sh, cfg, specs, device=dev, variant=variant)
    if spec.family == "diffusion":
        if isinstance(cfg, MM.MMDiTConfig):
            return _mmdit_cell(arch_id, sh, cfg, specs, device=dev)
        return _unet_cell(arch_id, sh, cfg, specs, device=dev)
    return _vision_cell(arch_id, sh, cfg, specs, device=dev)


def _smoke_shape(family: str, sh: ShapeSpec, cfg) -> ShapeSpec:
    if family == "lm":
        return dataclasses.replace(sh, seq_len=min(sh.seq_len, 64),
                                   global_batch=min(sh.global_batch, 2))
    if family == "diffusion":
        return dataclasses.replace(sh, img_res=min(sh.img_res, 64),
                                   global_batch=min(sh.global_batch, 2))
    return dataclasses.replace(sh, img_res=min(sh.img_res, cfg.img_res),
                               global_batch=min(sh.global_batch, 2))
