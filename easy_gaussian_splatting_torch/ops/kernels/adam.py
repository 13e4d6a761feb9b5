"""One grouped Adam step over the six parameter groups: the CUDA kernel
``csrc/adam.cu`` (one launch for all six groups) and its plain PyTorch
version.

No Pallas kernel stands behind it: the JAX package leaves Adam to XLA,
which fuses each group's update into one pass on the TPU. As eager
PyTorch ops (:func:`adam_plain`) the update is some 20 full-width passes
a group, three of them ``torch.where``s on the skip flag that write every
output a second time, about 168 B moved a parameter value. The kernel
reads p, g, mu and nu once and writes p, mu and nu once, 28 B a value,
and is designed as a stream: nothing is reused, so each block takes 4,096
consecutive values of one group with 16-byte loads and stores.

The kernel rounds op by op as the plain version does, so on the card the
two give the same bits. The step counts advance after the launch, with
:func:`select` as the plain version does.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .segments import _device_index
from ...models.gaussians import PARAM_NAMES, GaussianParams
from ...models.optimizer import BETA1, BETA2, EPS, AdamState, select

# kernel launches made by `adam_step` (the plain version never counts):
# one a step on the card, for all six groups
launches = 0

BLOCK_VALUES = 4096  # values a block updates (csrc/adam.cu: 256 threads x 4 float4s)


def adam_plain(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    lrs: Dict[str, float | torch.Tensor],
    skips: Dict[str, bool | torch.Tensor] | None = None,
    in_place: bool = False,
) -> tuple[GaussianParams, AdamState]:
    """``models/optimizer.py::adam_update`` as PyTorch ops, one group at a
    time (its contract; the kernel's plain version)."""
    new_params, new_mu, new_nu, new_steps = {}, {}, {}, {}
    for name in PARAM_NAMES:
        p = getattr(params, name)
        mu = getattr(state.mu, name)
        nu = getattr(state.nu, name)
        step = state.steps[name]
        g = getattr(grads, name)
        step1 = step + 1
        mu1 = BETA1 * mu + (1.0 - BETA1) * g
        nu1 = BETA2 * nu + (1.0 - BETA2) * g * g
        t = step1.to(torch.float32)
        mu_hat = mu1 / (1.0 - torch.pow(BETA1, t))
        nu_hat = nu1 / (1.0 - torch.pow(BETA2, t))
        lr = lrs[name]
        lr = lr if isinstance(lr, torch.Tensor) else float(lr)
        upd = lr * mu_hat / (torch.sqrt(nu_hat) + EPS)
        p1 = p - upd
        skip = False if skips is None else skips.get(name, False)
        new_params[name] = select(skip, p, p1, p if in_place else None)
        new_mu[name] = select(skip, mu, mu1, mu if in_place else None)
        new_nu[name] = select(skip, nu, nu1, nu if in_place else None)
        new_steps[name] = select(skip, step, step1, step if in_place else None)
    return (
        GaussianParams(**new_params),
        AdamState(mu=GaussianParams(**new_mu), nu=GaussianParams(**new_nu), steps=new_steps),
    )


_P, _LL = ctypes.c_void_p, ctypes.c_longlong


class _Group(ctypes.Structure):
    """``csrc/adam.cu``'s ``EgsAdamGroup``, field by field."""

    _fields_ = [("p", _P), ("g", _P), ("mu", _P), ("nu", _P), ("p_out", _P), ("mu_out", _P),
                ("nu_out", _P), ("lr", _P), ("skip", _P), ("step", _P), ("n", _LL),
                ("block0", _LL), ("lr_value", ctypes.c_float), ("pad", ctypes.c_int)]


def block_table(lengths) -> tuple[list, int]:
    """Each group's first block, and the launch's blocks: ceil(n / 4096)
    a group of n values, in order."""
    starts, total = [], 0
    for n in lengths:
        starts.append(total)
        total += -(-n // BLOCK_VALUES)
    return starts, total


def _check(name: str, device, p, g, mu, nu, step, lr, skip) -> None:
    for what, x in (("param", p), ("grad", g), ("mu", mu), ("nu", nu)):
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(f"adam: {name}'s {what} must be f32 on {device}, got {x.dtype} on "
                             f"{x.device}")
        if x.shape != p.shape:
            raise ValueError(f"adam: {name}'s {what} must be {list(p.shape)}, got "
                             f"{list(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"adam: {name}'s {what} must be contiguous")
    if step.device != device or step.dtype != torch.int32 or step.dim() != 0:
        raise ValueError(f"adam: {name}'s step count must be a 0-d int32 tensor on {device}")
    if isinstance(lr, torch.Tensor) and (lr.device != device or lr.dtype != torch.float32
                                         or lr.numel() != 1):
        raise ValueError(f"adam: {name}'s learning rate must be a number or one f32 on {device}")
    if isinstance(skip, torch.Tensor) and (skip.device != device or skip.dtype != torch.bool
                                           or skip.numel() != 1):
        raise ValueError(f"adam: {name}'s skip must be a bool or one bool on {device}")


def _launch(rows, device) -> None:
    """One launch over ``rows``: (name, (p, g, mu, nu, p_out, mu_out,
    nu_out), lr, skip, step) a group."""
    starts, blocks = block_table(bufs[0].numel() for _, bufs, *_ in rows)
    if not blocks:
        return
    table = (_Group * len(rows))()
    for row, (_, bufs, lr, skip, step), block0 in zip(table, rows, starts):
        (row.p, row.g, row.mu, row.nu, row.p_out, row.mu_out,
         row.nu_out) = (x.data_ptr() for x in bufs)
        tensor_lr = isinstance(lr, torch.Tensor)
        row.lr = lr.data_ptr() if tensor_lr else None
        row.lr_value = 0.0 if tensor_lr else float(lr)
        row.skip = skip.data_ptr() if isinstance(skip, torch.Tensor) else None
        row.step, row.n, row.block0 = step.data_ptr(), bufs[0].numel(), block0
    fn = _build.load("adam").egs_adam_step
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Group), ctypes.c_int, _LL, ctypes.c_int, _P]
    err = fn(table, len(rows), blocks, _device_index(device),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
    global launches
    launches += 1


def adam_step(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    lrs: Dict[str, float | torch.Tensor],
    skips: Dict[str, bool | torch.Tensor] | None = None,
    in_place: bool = False,
) -> tuple[GaussianParams, AdamState]:
    """:func:`adam_plain`'s step: CPU tensors take it; CUDA tensors launch
    the kernel once for the groups not skipped by a host bool (a group so
    skipped returns its own tensors, as :func:`select` does), then advance
    their step counts."""
    device = params.means.device
    if device.type == "cpu":
        return adam_plain(params, grads, state, lrs, skips, in_place)
    new_params, new_mu, new_nu, new_steps = {}, {}, {}, {}
    rows = []
    for name in PARAM_NAMES:
        p, g = getattr(params, name), getattr(grads, name)
        mu, nu = getattr(state.mu, name), getattr(state.nu, name)
        step = state.steps[name]
        lr = lrs[name]
        skip = False if skips is None else skips.get(name, False)
        _check(name, device, p, g, mu, nu, step, lr, skip)
        if isinstance(skip, torch.Tensor) or not skip:
            outs = (p, mu, nu) if in_place else tuple(map(torch.empty_like, (p, mu, nu)))
            rows.append((name, (p, g, mu, nu, *outs), lr, skip, step))
            new_params[name], new_mu[name], new_nu[name] = outs
        else:
            new_params[name], new_mu[name], new_nu[name] = p, mu, nu
            new_steps[name] = step
    _launch(rows, device)
    for name, _, _, skip, step in rows:
        new_steps[name] = select(skip, step, step + 1, step if in_place else None)
    return (
        GaussianParams(**{n: new_params[n] for n in PARAM_NAMES}),
        AdamState(mu=GaussianParams(**new_mu), nu=GaussianParams(**new_nu),
                  steps={n: new_steps[n] for n in PARAM_NAMES}),
    )

