"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
at the repository root (listed in ``.gitignore``), keyed by a hash of the
source, then loaded with ``ctypes``.  Nothing is built when a module is
imported: the first call that launches a kernel builds it, and a second
process finds the library already there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns nvcc's output (with ptxas' register report), or "" when the
    library was there."""
    out = _lib_path(name)
    if out.exists():
        return ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
         str(_CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)        # atomic: a concurrent loader sees all or none
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use; the
    caller sets its entry points' ``argtypes``."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
