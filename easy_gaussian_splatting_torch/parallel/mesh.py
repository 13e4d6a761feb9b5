"""Device meshes over an initialised ``torch.distributed`` process group;
counterpart of ``easy_gaussian_splatting_tpu/parallel/mesh.py``.

One rank drives one device, and the mesh's devices are the world's ranks
in gauss-major order: ``rank = gauss_idx * n_tiles + tile_idx``, which is
also the rank's image-stripe index. Each axis has a process group: the
ranks that share every other coordinate (a rank's tiles group is the ranks
of its ``gauss_idx``, its gauss group the ranks of its ``tile_idx``). A
1-D mesh's one axis is the whole world.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from .. import resolve_device

TILE_AXIS = "tiles"
GAUSS_AXIS = "gauss"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axes, their sizes, its index on
    each, its device and each axis's process group (the one holding it)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device
    groups: tuple  # one process group per axis

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def world(self):
        """The group of every rank of the mesh (stripe gathers, means)."""
        return dist.group.WORLD

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.world))

    @property
    def stripe_index(self) -> int:
        """Row-major index over the whole grid: the rank's stripe."""
        idx = 0
        for coord, size in zip(self.coords, self.shape):
            idx = idx * size + coord
        return idx

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]


def _world(n: int) -> tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n} devices needs an initialised process group of {n} ranks "
            "(torchrun with EGS_TORCH_DISTRIBUTED=1, or EGS_TORCH_COORDINATOR, "
            "EGS_TORCH_NUM_PROCESSES and EGS_TORCH_PROCESS_ID; see parallel/distributed.py)"
        )
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, have {world}")
    return world, dist.get_rank()


def make_mesh(n_devices: int | None = None, axis: str = TILE_AXIS,
              device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh over every rank of the world (``n_devices``, when given,
    must equal the world size): ``tiles`` shards image stripes, ``gauss``
    the Gaussian storage."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    _, rank = _world(n_devices)
    n = n_devices
    return Mesh((axis,), (n,), (rank,), resolve_device(device), (dist.group.WORLD,))


def make_mesh2d(n_gauss: int, n_tiles: int, device: str | torch.device = "cuda") -> Mesh:
    """2-D ``(gauss, tiles)`` mesh over ``n_gauss * n_tiles`` ranks: storage
    sharded over ``gauss``, stripes over the whole grid. Every rank creates
    every group, in the same order, as ``dist.new_group`` requires."""
    _, rank = _world(n_gauss * n_tiles)
    g_idx, t_idx = divmod(rank, n_tiles)
    tiles_group = gauss_group = None
    for g in range(n_gauss):
        grp = dist.new_group([g * n_tiles + t for t in range(n_tiles)])
        if g == g_idx:
            tiles_group = grp
    for t in range(n_tiles):
        grp = dist.new_group([g * n_tiles + t for g in range(n_gauss)])
        if t == t_idx:
            gauss_group = grp
    return Mesh(
        (GAUSS_AXIS, TILE_AXIS), (n_gauss, n_tiles), (g_idx, t_idx),
        resolve_device(device), (gauss_group, tiles_group),
    )


def parse_mesh_shape(shape: str) -> dict:
    """``"tiles:N"``, ``"gauss:N"`` or ``"gauss:G,tiles:T"`` as {axis: size};
    anything else raises ``ValueError``, as the JAX trainer does."""
    try:
        sizes = {k: int(v) for k, v in (p.split(":") for p in shape.split(","))}
    except ValueError as e:
        raise ValueError(f"invalid mesh_shape: {shape}") from e
    if set(sizes) not in ({TILE_AXIS}, {GAUSS_AXIS}, {GAUSS_AXIS, TILE_AXIS}) or min(
            sizes.values()) < 1:
        raise ValueError(f"invalid mesh_shape: {shape}")
    return sizes


def mesh_from_shape(shape: str, device: str | torch.device = "cuda") -> Mesh:
    """The mesh a config's ``mesh_shape`` names, over the initialised world
    (whose size must be the shape's device count)."""
    sizes = parse_mesh_shape(shape)
    if len(sizes) == 2:
        return make_mesh2d(sizes[GAUSS_AXIS], sizes[TILE_AXIS], device)
    ((axis, n),) = sizes.items()
    return make_mesh(n, axis, device)
