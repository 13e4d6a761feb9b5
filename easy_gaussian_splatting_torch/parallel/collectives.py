"""The collectives of the multi-device path, over ``torch.distributed``
process groups: the port's counterparts of ``jax.lax.all_gather``,
``psum``/``pmax``/``pmean`` and ``psum_scatter`` inside ``shard_map``.

Each returns a new tensor and leaves its input as it was. A failed or
timed-out collective raises (the group's timeout, set at
``init_process_group``); nothing falls back to another backend. Gloo
takes every one of them on CUDA tensors too (``all_reduce`` sum and max,
``all_gather_into_tensor``, ``reduce_scatter_tensor``; checked on an H100
with torch 2.11), which is how one card hosts a world of several ranks.
NCCL's collectives can be recorded into a CUDA graph (``training/
graphs.py``'s sharded step) once the communicator is up; gloo's wait on
the host and cannot, so a gloo world's step runs eagerly.

**The stripe gather and its gradient.** ``gather_rows`` is an
``autograd.Function``: forward, ``all_gather`` of every rank's rows in
group-rank order; backward, this rank's rows of the cotangent. Every rank
computes the same loss from the same gathered image, so the cotangents of
the gathered image agree, and rank r's parameter gradient is exactly the
contribution of its own stripe, g_r. One sum over the ranks then gives the
full gradient, Σ_r g_r. JAX's transpose of ``all_gather`` reduce-scatters
the n identical cotangents instead, so each chip holds n·g_r, and its
``psum(...) / n`` (``shard.py:258-270``) gives the same Σ_r g_r. The Gaussian-
sharded path sums over its tiles group and reduce-scatters over its gauss
group without the division, where JAX divides by the mesh size
(``gauss_shard.py:208-214``). ``tests/test_torch_parallel.py`` holds the
port's sums to JAX's.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# (collective, backend) -> calls in this process, the smoke run's report of
# which collectives ran on which backend (a replayed graph adds the calls
# its capture recorded, as it adds its kernel launches)
CALLS: collections.Counter = collections.Counter()


def _note(name: str, group) -> None:
    CALLS[(name, str(dist.get_backend(group)))] += 1


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``psum`` (``op="sum"``) or ``pmax`` (``"max"``) over ``group``."""
    out = x.contiguous().clone()
    _note(f"all_reduce_{op}", group)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def mean(x: torch.Tensor, group) -> torch.Tensor:
    """``pmean``: the sum over ``group`` divided by its size."""
    return all_reduce(x, group) / float(group_size(group))


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in group-rank order (JAX's
    ``all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    out = x.new_empty((group_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _note("all_gather_into_tensor", group)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x`` [n·k, ...], this rank's k rows
    (``psum_scatter(..., tiled=True)``)."""
    n = group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _note("reduce_scatter_tensor", group)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, dist.get_rank(ctx.group) * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_rows`` with the stripe gather's gradient (see the module
    docstring): the cotangent's rows of this rank."""
    return _GatherRows.apply(x, group)


def pack_rows(tensors) -> torch.Tensor:
    """Per-row tensors (same leading size) as one f32 [C, D] buffer, so one
    collective moves them all; booleans travel as 0/1."""
    c = tensors[0].shape[0]
    return torch.cat([t.reshape(c, -1).to(torch.float32) for t in tensors], dim=1)


def unpack_rows(buf: torch.Tensor, like) -> list:
    """The inverse of ``pack_rows``, row count from ``buf``: each tensor's
    trailing shape and dtype from ``like``."""
    out, col = [], 0
    for t in like:
        width = math.prod(t.shape[1:])
        part = buf[:, col:col + width].reshape((buf.shape[0],) + tuple(t.shape[1:]))
        out.append(part > 0.5 if t.dtype == torch.bool else part.to(t.dtype))
        col += width
    return out
