"""Sorted-segment reductions of gradient rows: the CUDA kernels
``csrc/segsum_band.cu``, ``csrc/segsum_compact.cu`` and
``csrc/monotone_expand.cu``, each beside its plain PyTorch version.

Counterparts of ``easy_gaussian_splatting_tpu/ops/pallas/segments.py``.
Rows are the tiled backward's f32 gradient rows [n, 16] gathered into
ascending flat-id order; ``g`` [n] i32 are their non-decreasing group ids
(the Gaussian index).

- ``segsum_band``: ``out[i]`` is the sum of ``rows[j]`` over ``j`` in
  ``[i, i + LOOK)`` while ``g[j] == g[i]``, so each group's total lands on
  its first row.
- ``segsum_compact``: row ``k`` of the output is the sum of the ``k``-th
  group's rows, groups in ascending id order, for ``k < max_groups``; rows
  past the number of groups are unspecified.
- ``monotone_expand``: ``out[c] = present[c] ? compact[rank[c]] : 0`` for a
  monotone rank of stride at most 1.

Unlike the TPU kernels (which compare ids and ranks as f32, exact only
below 2^24, and pad rows to their 512-row blocks), ids and ranks are
integers and any row count is taken.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LOOK = 128  # longest group summed in full (max_tiles^2 <= LOOK)
NUM_COLS = 16

# kernel launches made by each wrapper (the plain versions never count):
# `segsum_band`, `segsum_compact`, `monotone_expand`
launches = 0
compact_launches = 0
expand_launches = 0


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check_rows(name: str, rows: torch.Tensor, n: int) -> None:
    """The kernels' common contract on a row matrix: CUDA, f32 [n, 16],
    contiguous, 16-byte aligned (float4 loads)."""
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: rows must be on a CUDA device")
    if rows.dtype != torch.float32:
        raise ValueError(f"{name}: rows must be f32, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape != (n, NUM_COLS):
        raise ValueError(f"{name}: rows must be [{n}, {NUM_COLS}], got {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def _check_index(name: str, what: str, t: torch.Tensor, n: int, dev, dtype=torch.int32) -> None:
    if t.device != dev or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be a contiguous {dtype} [{n}] on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


# ------------------------------------------------------------ segsum_band
def segsum_band_plain(rows: torch.Tensor, g: torch.Tensor, look: int = LOOK) -> torch.Tensor:
    """Log-step segmented suffix scan: after the shift-k step each row holds
    the sum over its group's rows in ``[i, i + 2k)``; shifts 1, 2, ... below
    ``look`` cover ``look`` rows (``LOOK`` for ``segsum_band``; the ``scan``
    backward reduction sets it from the window size). Every step adds
    neighbours of similar size, so millions of rows do not cancel as a
    global cumulative sum would."""
    n = rows.shape[0]
    out = rows
    k = 1
    while k < look:
        if k >= n:
            break
        same = torch.zeros(n, dtype=torch.bool, device=rows.device)
        same[: n - k] = g[k:] == g[: n - k]
        ahead = torch.zeros_like(out)
        ahead[: n - k] = out[k:]
        out = out + torch.where(same[:, None], ahead, torch.zeros_like(ahead))
        k *= 2
    return out


def segsum_band(rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Segmented suffix sums [n, 16] f32 of group-sorted rows. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if rows.device.type == "cpu":
        return segsum_band_plain(rows, g)
    n = rows.shape[0]
    _check_rows("segsum_band", rows, n)
    _check_index("segsum_band", "g", g, n, rows.device)
    dev = rows.device
    out = torch.empty_like(rows)
    if n == 0:
        return out
    fn = _build.load("segsum_band").egs_segsum_band
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    err = fn(
        rows.data_ptr(), g.data_ptr(), n, LOOK, out.data_ptr(),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segsum_band kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


# --------------------------------------------------------- segsum_compact
def group_slots(g: torch.Tensor) -> torch.Tensor:
    """[n] i32 index of each row's group among the groups of ``g`` (ids
    non-decreasing): the inclusive cumulative sum of the group-start flags,
    less one."""
    start = torch.ones_like(g, dtype=torch.int32)
    start[1:] = (g[1:] != g[:-1]).to(torch.int32)
    return torch.cumsum(start, 0, dtype=torch.int32) - 1


def segsum_compact_plain(rows: torch.Tensor, g: torch.Tensor, max_groups: int) -> torch.Tensor:
    """``index_add_`` of each row into its group's slot (on the CPU it adds
    in row order); rows of groups at or past ``max_groups`` are dropped.
    Output rows past the number of groups are zero."""
    slot = group_slots(g).to(torch.int64)
    keep = slot < max_groups
    out = torch.zeros((max_groups, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, slot[keep], rows[keep])


def segsum_compact(rows: torch.Tensor, g: torch.Tensor, max_groups: int) -> torch.Tensor:
    """Per-group sums [max_groups, 16] f32 of group-sorted rows, one row per
    group in ascending id order. ``max_groups`` bounds the output (the
    caller knows how many groups it reads). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if max_groups < 1:
        raise ValueError(f"segsum_compact: max_groups must be positive, got {max_groups}")
    if rows.device.type == "cpu":
        return segsum_compact_plain(rows, g, max_groups)
    n = rows.shape[0]
    _check_rows("segsum_compact", rows, n)
    _check_index("segsum_compact", "g", g, n, rows.device)
    if n >= 2**31:
        raise ValueError(f"segsum_compact: at most 2^31 - 1 rows, got {n}")
    dev = rows.device
    out = torch.empty((max_groups, NUM_COLS), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.load("segsum_compact")
    lib.egs_segsum_compact_span.restype = ctypes.c_longlong
    span = lib.egs_segsum_compact_span()
    # one status word per block of the kernel's decoupled look-back and the
    # blocks' ticket counter, zeroed by the launch itself (one memset)
    status = torch.empty(((n + span - 1) // span + 1,), dtype=torch.int64, device=dev)
    fn = lib.egs_segsum_compact
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    err = fn(
        rows.data_ptr(), g.data_ptr(), n, max_groups, status.data_ptr(), out.data_ptr(),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segsum_compact kernel launch failed: CUDA error {err}")
    global compact_launches
    compact_launches += 1
    return out


# -------------------------------------------------------- monotone_expand
def monotone_expand_plain(
    compact: torch.Tensor, rank: torch.Tensor, present: torch.Tensor
) -> torch.Tensor:
    """A clamped row gather, masked by ``present``."""
    n_in = compact.shape[0]
    if n_in == 0:
        return torch.zeros((rank.shape[0], compact.shape[1]), dtype=compact.dtype,
                           device=compact.device)
    rows = compact[torch.clamp(rank, max=n_in - 1).to(torch.int64)]
    return torch.where(present[:, None], rows, torch.zeros_like(rows))


def monotone_expand(
    compact: torch.Tensor, rank: torch.Tensor, present: torch.Tensor
) -> torch.Tensor:
    """``out[c] = present[c] ? compact[rank[c]] : 0`` [C, 16] f32 for a
    monotone ``rank`` [C] i32 (stride <= 1) and ``present`` [C] bool. A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if compact.device.type == "cpu":
        return monotone_expand_plain(compact, rank, present)
    n_in, c = compact.shape[0], rank.shape[0]
    _check_rows("monotone_expand", compact, n_in)
    dev = compact.device
    _check_index("monotone_expand", "rank", rank, c, dev)
    _check_index("monotone_expand", "present", present, c, dev, torch.bool)
    if n_in == 0 or c == 0:  # nothing to read: no present row can have a rank
        return torch.zeros((c, NUM_COLS), dtype=torch.float32, device=dev)
    out = torch.empty((c, NUM_COLS), dtype=torch.float32, device=dev)
    fn = _build.load("monotone_expand").egs_monotone_expand
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    err = fn(
        compact.data_ptr(), rank.data_ptr(), present.data_ptr(), c, n_in, out.data_ptr(),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"monotone_expand kernel launch failed: CUDA error {err}")
    global expand_launches
    expand_launches += 1
    return out
