"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface.  :func:`build`
compiles it with ``nvcc`` for ``sm_90a`` into a shared library in
``_build/`` next to this file (listed in ``.gitignore``), named by a hash
of the source content, so a source change rebuilds under a new name and an
unchanged source is compiled once.  :func:`load` opens the library with
``ctypes`` once per process and lets the kernel's module declare its
functions' argument types.  :func:`build_all` starts one ``nvcc`` per
source at the same time.

Nothing here runs at import: the kernels are built at first use, on a
machine with the CUDA toolkit.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

_LIBS: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> str:
    """Path of ``csrc/<name>.cu``."""
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` for sm_90a into a shared library (once
    per source content) and return its path."""
    src = source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu ({res.returncode}):"
                               f"\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic: a half-written library never loads
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Build every named source, one ``nvcc`` each, all started together;
    returns each build's seconds (a source already built takes ~0)."""

    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if need be and opened once;
    ``bind`` sets its functions' ``argtypes``/``restype`` on first open."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        bind(lib)
        _LIBS[name] = lib
    return lib
