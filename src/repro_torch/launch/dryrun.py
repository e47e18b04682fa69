"""Dry run of every (architecture × input shape) cell on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells 'flux.*' \\
        --smoke --out /tmp/dry --force

The port's analog of ``repro.launch.dryrun``: each of ``list_cells()``'s
40 cells is built on ``device="meta"`` (shapes and dtypes, no storage:
a full-size cell costs no memory) and its step runs once, eagerly,
under ``torch.utils.flop_counter.FlopCounterMode`` and under a dispatch
mode that sums each operation's input and output bytes (views move
none): the traffic an eager, unfused run moves.  Eager code runs every
layer, so nothing is extrapolated (the reference compiles 1- and
2-layer probes because XLA counts a scan's body once).

One JSON record per cell, ``<out>/<arch>__<shape>.json``: the kind, the
outputs' shapes and dtypes, the counted flops (matmuls and
convolutions, forward and backward), ``model_flops`` and their ratio,
parameter, state (optimizer moments, or the decode cell's KV cache),
gradient-buffer and input bytes and their resident total, whether that
fits one 80 GB card, the eager traffic, and the bounds at the H100
constants: counted flops over the dense bf16 peak, traffic over the
memory rate.  One device is counted, so no collective.  The two MoE
train cells are recorded as ``not_ported`` (the reference trains them
through ``moe_sharded``, ROADMAP A16); any other failure makes the run
exit non-zero.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pytree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.bridge import tree_flatten
from repro_torch.configs import list_cells
from repro_torch.launch.steps import Cell, build_cell

# the bounds' card: H100 SXM, 700 W (the constants chip_smoke.py uses)
CARD = "NVIDIA H100 80GB HBM3, 700 W (SXM constants)"
PEAK_BF16 = 989e12            # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12              # B/s
CARD_BYTES = 80e9


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    return sum(_nbytes(v) for _, v in tree_flatten(tree)
               if torch.is_tensor(v))


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor each operation reads and writes
    (a view reads and writes none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        if not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in rets):
            ins, _ = _pytree_flatten((args, kwargs or {}))
            outs, _ = _pytree_flatten(out)
            self.bytes += sum(_nbytes(t) for t in ins + outs
                              if isinstance(t, torch.Tensor))
            self.ops += 1
        return out


def meta_inputs(cell: Cell) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=cell.device)
            for k, s in cell.batch_specs.items()}


def _leaves(tree: Any) -> List[dict]:
    return [{"path": p, "shape": list(v.shape),
             "dtype": str(v.dtype).replace("torch.", "")}
            for p, v in tree_flatten(tree) if torch.is_tensor(v)]


def run_cell(arch: str, shape: str, *, smoke: bool = False) -> dict:
    """Build the cell on the meta device, run its step once under the
    counters → the cell's record."""
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, smoke=smoke, device="meta")
    except NotImplementedError as e:
        if "moe_sharded" not in str(e):
            raise
        return {"arch": arch, "shape": shape, "smoke": smoke,
                "status": "not_ported", "reason": str(e)}
    params = cell.init_params()
    state = cell.init_state(params)
    inputs = meta_inputs(cell)
    p_bytes, s_bytes = tree_bytes(params), tree_bytes(state)
    in_bytes = tree_bytes(inputs)
    flops_mode = FlopCounterMode(display=False)
    counter = ByteCounter()
    with flops_mode, counter:
        out = cell.run(params, state, inputs)
    flops = float(flops_mode.get_total_flops())
    grad_bytes = p_bytes if cell.kind == "train" else 0
    resident = p_bytes + s_bytes + grad_bytes + in_bytes
    compute_s = flops / PEAK_BF16
    memory_s = counter.bytes / HBM_BW
    outputs = (_leaves(out[2]) if cell.kind == "train" else _leaves(out))
    return {
        "arch": arch, "shape": shape, "smoke": smoke, "status": "ok",
        "kind": cell.kind, "device": str(cell.device),
        "outputs": outputs,
        "counted_flops": flops,
        "model_flops": cell.model_flops,
        "useful_flop_ratio": cell.model_flops / flops if flops else 0.0,
        "param_bytes": p_bytes, "state_bytes": s_bytes,
        "grad_buffer_bytes": grad_bytes, "input_bytes": in_bytes,
        "resident_bytes": resident,
        "fits_one_card": resident <= CARD_BYTES,
        "eager_traffic_bytes": counter.bytes, "dispatched_ops": counter.ops,
        "bounds": {"card": CARD, "peak_bf16_flops": PEAK_BF16,
                   "hbm_bytes_per_s": HBM_BW, "compute_s": compute_s,
                   "memory_s": memory_s,
                   "bound_s": max(compute_s, memory_s),
                   "bound_by": ("operations" if compute_s >= memory_s
                                else "bytes")},
        "collectives": {"wire_bytes": 0, "reason": "one device"},
        "grad_accum": cell.grad_accum,
        "seconds": time.time() - t0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=".*",
                    help="regex over '<arch> <shape>'")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs and shapes")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true",
                    help="rerun cells whose record exists")
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    pat = re.compile(args.cells)
    cells = [(a, s) for a, s in list_cells() if pat.search(f"{a} {s}")]
    failures, records = [], []
    for i, (arch, shape) in enumerate(cells, 1):
        path = outdir / f"{arch}__{shape}.json"
        if path.exists() and not args.force:
            rec = json.loads(path.read_text())
            print(f"[{i}/{len(cells)}] skip {arch} {shape} (exists)",
                  flush=True)
        else:
            try:
                rec = run_cell(arch, shape, smoke=args.smoke)
            except Exception:
                failures.append((arch, shape))
                traceback.print_exc()
                continue
            path.write_text(json.dumps(rec, indent=1))
        records.append(rec)
        if rec["status"] == "ok":
            print(f"[{i}/{len(cells)}] {arch} {shape}: {rec['kind']} "
                  f"flops={rec['counted_flops']:.4g} "
                  f"model={rec['model_flops']:.4g} "
                  f"ratio={rec['useful_flop_ratio']:.3f} "
                  f"resident={rec['resident_bytes'] / 1e9:.2f}GB "
                  f"fits={rec['fits_one_card']} "
                  f"bound={rec['bounds']['bound_s']:.4g}s "
                  f"({rec['bounds']['bound_by']})", flush=True)
        else:
            print(f"[{i}/{len(cells)}] {arch} {shape}: {rec['status']}",
                  flush=True)
    ok = sum(r["status"] == "ok" for r in records)
    (outdir / "summary.json").write_text(json.dumps(
        {"cells": len(cells), "ok": ok, "smoke": args.smoke,
         "not_ported": [(r["arch"], r["shape"]) for r in records
                        if r["status"] == "not_ported"],
         "failed": failures}, indent=1))
    if failures:
        print(f"\nFAILED cells: {failures}", flush=True)
        return 1
    print(f"\n{ok} of {len(cells)} dry-run cells recorded, "
          f"{len(records) - ok} not ported.", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
