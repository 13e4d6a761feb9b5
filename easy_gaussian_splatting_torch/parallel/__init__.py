"""Multi-device training on ``torch.distributed``; counterpart of
``easy_gaussian_splatting_tpu/parallel/``.

How a JAX mesh maps onto ``torch.distributed``: the JAX package drives n
devices from one controller through ``shard_map``; the port runs one
process per device, each a rank of one world, and every rank runs the
same program (``train()`` included) on its own device. A mesh
(``mesh.Mesh``) is this rank's view: the axis names and sizes
(``("tiles",)``, ``("gauss",)`` or ``("gauss", "tiles")``), its index on
each axis, the world size, its device and one process group per axis.
Ranks are gauss-major, ``rank = gauss_idx * n_tiles + tile_idx``, which is
also the rank's image-stripe index. The backend is named when the world
is joined (``distributed.initialize``): NCCL for one rank a card, gloo for
CPU ranks or for several ranks sharing one card (NCCL refuses that).

Every rank must take the same decisions on the host, or the ranks diverge
and wait in different collectives: each value the host reads from the
device to decide something is reduced over the world first (the
intersection count a step reports, the densify overflow and info, the
binning autotune's counts).
"""

from .distributed import maybe_initialize_from_env
from .mesh import make_mesh, make_mesh2d
from .shard import make_sharded_train_step

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "make_sharded_train_step",
    "maybe_initialize_from_env",
]
