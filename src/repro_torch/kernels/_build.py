"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
at the repository root (listed in ``.gitignore``), keyed by a hash of the
source and of the shared ``csrc/*.cuh`` headers, then loaded with
``ctypes``.  Nothing is built when a module is imported: the first call
that launches a kernel builds it, and a second process finds the library
already there.
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
    """The library's path, named by a hash of its source, of every shared
    header in ``csrc/`` (so a header edit rebuilds each library that may
    include it) and of the flags."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(_CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


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


def sources() -> list:
    """The names of every ``csrc/<name>.cu``."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Build every library not built yet, one ``nvcc`` per source, all
    started together; returns each source's nvcc output (see ``build``)."""
    from concurrent.futures import ThreadPoolExecutor
    names = sources()
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``; the first use builds
    every library not built yet, in parallel.  The caller sets its entry
    points' ``argtypes``."""
    lib = _LOADED.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
