"""Scene/data layer: the COLMAP and Blender loaders, frames, point clouds,
the host-side prefetcher and the device-resident frame cache."""

from .scene import Scene
from .types import Frame, Pointcloud

__all__ = ["Frame", "Pointcloud", "Scene"]
