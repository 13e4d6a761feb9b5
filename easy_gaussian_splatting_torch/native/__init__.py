"""Native (C++) host-side helpers, loaded through ctypes; counterpart of
``easy_gaussian_splatting_tpu/native/__init__.py``.

``egs_native.cpp`` beside this file is the port's own copy. It is compiled
with the host C++ compiler at first use into ``build/native/`` at the
repository root (git-ignored; the library's name carries a hash of its
source). Every caller has a pure-Python fallback, used when the library is
missing or cannot be built: these helpers parse files on the host, they
are no device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "egs_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib: Optional[ctypes.CDLL] = None
_lib_attempted = False


def _build_library() -> Optional[Path]:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"egs_native_{tag}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_so = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp_so)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as exc:
        logger.warning(f"native library build failed ({exc}); using pure-Python fallbacks")
        tmp_so.unlink(missing_ok=True)
        return None
    os.replace(tmp_so, so_path)
    return so_path


def get_library() -> Optional[ctypes.CDLL]:
    """The compiled native library, or None (fallbacks in force)."""
    global _lib, _lib_attempted
    if _lib_attempted:
        return _lib
    _lib_attempted = True
    so_path = _build_library()
    if so_path is None:
        return None
    lib = ctypes.CDLL(str(so_path))
    lib.parse_points3d.restype = ctypes.c_longlong
    lib.parse_points3d.argtypes = [
        ctypes.c_char_p, ctypes.c_ulonglong,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_ulonglong,
    ]
    lib.parse_images.restype = ctypes.c_longlong
    lib.parse_images.argtypes = [
        ctypes.c_char_p, ctypes.c_ulonglong,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_ulonglong,
        ctypes.c_ulonglong,
    ]
    lib.dilate_mask.restype = None
    lib.dilate_mask.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    _lib = lib
    logger.debug(f"native library loaded from {so_path}")
    return _lib


def parse_points3d(buf: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse points3D.bin via the native library. Returns (xyz f32 [n,3],
    rgb u8 [n,3]) or None if unavailable/failed."""
    lib = get_library()
    if lib is None or len(buf) < 8:
        return None
    n = int(np.frombuffer(buf, "<u8", 1)[0])
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.uint8)
    got = lib.parse_points3d(
        buf, len(buf),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
    )
    if got != n:
        logger.warning("native points3D parse failed; falling back")
        return None
    return xyz, rgb


def parse_images(buf: bytes):
    """Parse images.bin via the native library. Returns
    (ids, camera_ids, quats [n,4], trans [n,3], names) or None."""
    lib = get_library()
    if lib is None or len(buf) < 8:
        return None
    n = int(np.frombuffer(buf, "<u8", 1)[0])
    ids = np.empty((n,), np.int32)
    cam_ids = np.empty((n,), np.int32)
    quats = np.empty((n, 4), np.float64)
    trans = np.empty((n, 3), np.float64)
    name_buf = np.zeros((len(buf),), np.uint8)
    got = lib.parse_images(
        buf, len(buf),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cam_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        quats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        trans.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        name_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        name_buf.size, n,
    )
    if got != n:
        logger.warning("native images parse failed; falling back")
        return None
    names = bytes(name_buf.tobytes()).split(b"\x00")[:n]
    return ids, cam_ids, quats, trans, [s.decode("utf-8") for s in names]


def dilate_mask(mask: np.ndarray, expand_pixels: int) -> Optional[np.ndarray]:
    """Native mask dilation; returns None if unavailable."""
    lib = get_library()
    if lib is None:
        return None
    h, w = mask.shape
    src = np.ascontiguousarray((mask > 0).astype(np.uint8))
    out = np.empty((h, w), np.uint8)
    tmp = np.empty((h, w), np.uint8)
    lib.dilate_mask(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tmp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, expand_pixels,
    )
    return out
