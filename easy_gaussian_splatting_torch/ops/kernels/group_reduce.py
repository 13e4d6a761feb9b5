"""Fixed-stride group sums of gradient rows: the CUDA kernel
``csrc/group_reduce.cu`` and its plain PyTorch version.

Counterpart of ``easy_gaussian_splatting_tpu/ops/pallas/group_reduce.py``.
``x`` [G*b, 16] f32 are gradient rows in the dense duplicate grid, where
each Gaussian's rows sit at a fixed stride ``b``; ``out[g]`` is the sum of
rows ``g*b .. g*b + b - 1``, added in row order. A second population of
another group size (the grid's overflow slots) can follow in the same
rows and the same launch, where the JAX package makes a call for each.
The TPU kernel took bf16 hi/lo rows of 128 lanes in VMEM blocks; the
port's rows are the decoded f32 values.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .segments import NUM_COLS, _check_rows, _device_index

# kernel launches made by `group_reduce` (the plain version never counts)
launches = 0


def group_reduce_plain(x: torch.Tensor, b: int, tail=None) -> torch.Tensor:
    """A loop over ``k < b`` adding ``x.view(G, b, 16)[:, k]`` in the
    kernel's order, so the two agree bit for bit; a ``tail`` population the
    same way, its sums after the others."""
    if tail is not None:
        tail_b, tail_groups = tail
        split = x.shape[0] - tail_b * tail_groups
        return torch.cat([group_reduce_plain(x[:split], b), group_reduce_plain(x[split:], tail_b)])
    xs = x.view(x.shape[0] // b, b, x.shape[1])
    out = xs[:, 0].clone()
    for k in range(1, b):
        out += xs[:, k]
    return out


def group_reduce(x: torch.Tensor, b: int, tail=None) -> torch.Tensor:
    """Sums [G, 16] f32 of each run of ``b`` consecutive rows of ``x``
    [G*b, 16] f32. With ``tail = (tail_b, tail_groups)`` the last
    ``tail_b * tail_groups`` rows are groups of ``tail_b`` rows instead, and
    their sums the last ``tail_groups`` rows of the output: both
    populations in one launch. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    tail_b, tail_groups = tail if tail is not None else (1, 0)
    rest = x.shape[0] - tail_b * tail_groups
    if b < 1 or tail_b < 1 or tail_groups < 0 or rest < 0 or rest % b:
        raise ValueError(
            f"group_reduce: {x.shape[0]} rows are not groups of {b} followed by "
            f"{tail_groups} groups of {tail_b}"
        )
    if x.device.type == "cpu":
        return group_reduce_plain(x, b, tail)
    _check_rows("group_reduce", x, x.shape[0])
    groups = rest // b
    dev = x.device
    out = torch.empty((groups + tail_groups, NUM_COLS), dtype=torch.float32, device=dev)
    if groups + tail_groups == 0:
        return out
    fn = _build.load("group_reduce").egs_group_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    err = fn(
        x.data_ptr(), groups, b, tail_groups, tail_b, out.data_ptr(), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group_reduce kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
