"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/torch_kernels/``
at the repository root, at first use, and loaded with ``ctypes``. The
library's file name carries a hash of its source, the headers beside it
and its flags, so an edited kernel rebuilds and a stale one is never
loaded. Nothing here runs at import: the CPU tests import every module on
a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-kernel extra flags; binkeys compares floats against a threshold and
# adam gives its plain version's bits, so both must round like their op-by-op
# PyTorch versions: no FMA contraction (the tile kernels' shared eligibility
# test fixes its rounding with intrinsics, csrc/tile_eligibility.cuh)
EXTRA_FLAGS = {
    "binkeys": ("--fmad=false",),
    "tile_forward": (),
    "tile_backward": (),
    "segsum_band": (),
    "segsum_compact": (),
    "monotone_expand": (),
    "group_reduce": (),
    "sh_color": (),
    "adam": ("--fmad=false",),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# `nvcc -Xptxas -v` output of the builds made by this process, by kernel
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    flags = ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS[name]
    sources = [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]  # headers too
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in sources) + " ".join(flags).encode())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, *BASE_FLAGS, *EXTRA_FLAGS[name],
        "-o", str(tmp), str(SRC_DIR / f"{name}.cu"),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    ptxas_reports[name] = proc.stderr.strip()
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, float]:
    """Build every kernel, one ``nvcc`` per source, all started together.
    Returns the wall seconds of each build."""

    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(EXTRA_FLAGS)) as pool:
        futures = {name: pool.submit(timed, name) for name in EXTRA_FLAGS}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
