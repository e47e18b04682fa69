"""Checkpointing of parameter and optimizer trees, in the reference's
layout (one directory a step, committed by an atomic rename):

    <dir>/step_000000042/
        manifest.json        # tree structure, per-leaf dtype/shape, metadata
        leaf_00000.npy ...   # one .npy per leaf

Counterpart of ``repro.distributed.checkpoint``.  Leaves are written in
JAX's flatten order under JAX's ``keystr`` paths (``bridge.tree_flatten``),
so the same tree gives the same manifest records and the same leaf
files, byte for byte: a bf16 leaf is written as ``np.save`` writes JAX's
bf16 (descr ``'<V2'``, dtype ``"bfloat16"`` in the manifest) and read back
through an int16 view, with no ``ml_dtypes``.  ``restore_checkpoint``
puts each leaf on ``device`` (or the target leaf's device), where the
reference takes ``shardings``.  ``keep`` bounds disk usage; a save goes
to ``.tmp-<step>`` first, so a crash mid-save never corrupts the latest
checkpoint.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_flatten, tree_unflatten
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

_BF16 = "bfloat16"


def _treedef(tree: Any) -> str:
    """The tree's structure in the form of JAX's ``PyTreeDef`` string."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            kids = ", ".join(node(getattr(t, f)) for f in t._fields)
            return f"CustomNode(namedtuple[{type(t).__name__}], [{kids}])"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(node(v) for v in t) \
                + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _host(leaf: Any) -> Any:
    """A leaf copied to host memory now (tensors stay tensors)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _save_leaf(path: Path, leaf: Any) -> Tuple[list, str]:
    """Write one leaf as ``np.save`` writes the reference's → (shape,
    dtype name)."""
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        bits = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": bits.shape})
            f.write(bits.tobytes())
        return list(bits.shape), _BF16
    arr = (leaf.detach().cpu().contiguous().numpy() if torch.is_tensor(leaf)
           else np.asarray(leaf))
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str | Path, step: int, tree: Any, *,
                    metadata: Optional[Dict] = None, keep: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp-{step:09d}"
    final = directory / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "metadata": metadata or {},
                "treedef": _treedef(tree), "leaves": []}
    for i, (path, leaf) in enumerate(tree_flatten(tree)):
        fname = f"leaf_{i:05d}.npy"
        shape, dtype = _save_leaf(tmp / fname, leaf)
        manifest["leaves"].append({"index": i, "file": fname, "path": path,
                                   "shape": shape, "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    steps = sorted(p for p in directory.iterdir()
                   if p.name.startswith("step_"))
    for old in steps[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                   if p.name.startswith("step_"))
    return steps[-1] if steps else None


def restore_checkpoint(directory: str | Path, tree_like: Any, *,
                       step: Optional[int] = None,
                       device: DeviceLike = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` → (tree, step,
    metadata).  Each leaf takes the target leaf's dtype and goes to
    ``device``, or without one to the target tensor's device (the card
    for a non-tensor target)."""
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    targets = [leaf for _, leaf in tree_flatten(tree_like)]
    if len(targets) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"target tree has {len(targets)}")
    dev = None if device is None else resolve_device(device)
    leaves = []
    for rec, target in zip(manifest["leaves"], targets):
        t = _load_leaf(d / rec["file"], rec["dtype"])
        if torch.is_tensor(target):
            t = t.to(device=dev or target.device, dtype=target.dtype)
        else:
            t = t.to(dev or resolve_device(None))
        leaves.append(t)
    return tree_unflatten(tree_like, leaves), step, manifest["metadata"]


class CheckpointManager:
    """Checkpoint every ``every`` steps, optionally in a background
    thread.  The tree is copied to host memory before ``maybe_save``
    returns, so training may update its tensors in place right after."""

    def __init__(self, directory: str | Path, *, every: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.directory = Path(directory)
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def maybe_save(self, step: int, tree: Any, *,
                   metadata: Optional[Dict] = None) -> bool:
        if step % self.every != 0:
            return False
        self.wait()
        host = tree_unflatten(tree, [_host(leaf) for _, leaf in
                                     tree_flatten(tree)])
        if self.async_save:
            self._pending = threading.Thread(
                target=self._save, args=(step, host, metadata), daemon=True)
            self._pending.start()
        else:
            save_checkpoint(self.directory, step, host, metadata=metadata,
                            keep=self.keep)
        return True

    def _save(self, step: int, host: Any, metadata: Optional[Dict]) -> None:
        try:
            save_checkpoint(self.directory, step, host, metadata=metadata,
                            keep=self.keep)
        except Exception as e:           # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Join a pending save; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
