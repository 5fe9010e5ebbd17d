"""Build and load the port's CUDA kernels (nvcc + ctypes).

On first use a kernel source under ``pydcop_tpu_torch/csrc/`` is compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, and loaded with :mod:`ctypes`.  The library lands in
``pydcop_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no multiply-add contraction: the kernels must round exactly as
    # their plain PyTorch versions do
    "--fmad=false",
    # per-kernel registers / spills in the build log
    "-Xptxas", "-v",
)


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's output (ptxas resource usage), "" when reused


_LOADED: Dict[str, Built] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "toolkit is needed to build the port's kernels"
    )


def load(source: str) -> Built:
    """Compile ``csrc/<source>`` if needed and load it (once per
    process; the shard threads of a mesh run share one build)."""
    if source in _LOADED:
        return _LOADED[source]
    with _LOAD_LOCK:
        if source not in _LOADED:
            _LOADED[source] = _load(source)
    return _LOADED[source]


def _load(source: str) -> Built:
    src = CSRC / source
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
