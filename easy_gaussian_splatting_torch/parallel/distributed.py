"""Process-group initialisation; counterpart of
``easy_gaussian_splatting_tpu/parallel/distributed.py``.

The JAX package joins one process per host into one runtime; the port runs
one process per device (``torchrun``'s idiom), each a rank of one
``torch.distributed`` world. Two ways in, the ``EGS_TPU_*`` meanings under
``EGS_TORCH_*`` names:

    # one command per rank; tcp:// rendezvous at rank 0's host
    EGS_TORCH_COORDINATOR=<host0>:29500 EGS_TORCH_NUM_PROCESSES=<n> \\
    EGS_TORCH_PROCESS_ID=<rank> python -m easy_gaussian_splatting_torch.train ...

    # torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT: env://
    EGS_TORCH_DISTRIBUTED=1 torchrun --nproc-per-node 4 \\
        -m easy_gaussian_splatting_torch.train -c <config with mesh_shape> ...

A rank on the card uses ``cuda:LOCAL_RANK`` (or its rank modulo the host's
device count), made current before anything touches the device. The
backend is named by the caller; by default NCCL for a CUDA rank and gloo
for a CPU one. NCCL refuses two ranks on one device; gloo takes CUDA
tensors, which is how one card hosts a whole test world.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device

logger = logging.getLogger(__name__)

# a collective that waits longer than this raises (a rank that diverged or
# died must fail its peers, not hang them)
DEFAULT_TIMEOUT_S = 600.0


def default_backend(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """The device a rank drives: for CUDA, ``cuda:LOCAL_RANK`` where the
    launcher sets it, else the rank modulo the host's device count."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(init_method: str, world_size: int, rank: int,
               device: str | torch.device = "cuda", backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world as ``rank`` of ``world_size``; returns the rank's
    device (made current on CUDA)."""
    dev = rank_device(device, rank)
    backend = backend or default_backend(dev)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=timeout_s), **kw,
    )
    logger.info(f"process group up: rank {rank}/{world_size}, {backend} on {dev}")
    return dev


def maybe_initialize_from_env(device: str | torch.device = "cuda", backend: str | None = None,
                              timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the world the environment describes (``EGS_TORCH_COORDINATOR``
    with ``EGS_TORCH_NUM_PROCESSES`` and ``EGS_TORCH_PROCESS_ID``, or
    ``EGS_TORCH_DISTRIBUTED=1`` under ``torchrun``). Call it before anything
    touches the device. Returns True when a process group is up."""
    if dist.is_initialized():
        return True
    coordinator = os.environ.get("EGS_TORCH_COORDINATOR", "")
    if coordinator:
        init = f"tcp://{coordinator}"
        world = int(os.environ["EGS_TORCH_NUM_PROCESSES"])
        rank = int(os.environ["EGS_TORCH_PROCESS_ID"])
    elif os.environ.get("EGS_TORCH_DISTRIBUTED", "") == "1":
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    initialize(init, world, rank, device, backend, timeout_s)
    return True
