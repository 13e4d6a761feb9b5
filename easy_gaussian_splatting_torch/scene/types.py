"""Core data types: point clouds and frames; counterpart of
``easy_gaussian_splatting_tpu/scene/types.py``.

A ``Pointcloud`` carries the xyz/rgb init data; a ``Frame`` is a lazily
loaded camera view: declared intrinsics and a world-to-camera pose (OpenCV
convention: X right, Y down, Z forward) with image and mask paths.
``load()`` gives the per-step frame dict (numpy f32, intrinsics rescaled to
the on-disk image size); ``to_json`` exports the camera for the viewer
(``cameras.json``). The JAX module's matplotlib debug helpers are not
ported.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from .image_io import get_downscale_factor, load_image, load_mask


@dataclasses.dataclass
class Pointcloud:
    xyzs: np.ndarray  # [N, 3] float32
    rgbs: np.ndarray  # [N, 3] uint8

    @property
    def nbr_points(self) -> int:
        return int(self.xyzs.shape[0])


@dataclasses.dataclass
class Frame:
    image_path: Path
    mask_path: Optional[Path]
    mask_expand_pixels: int
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    w2c: np.ndarray  # [4, 4] float32, OpenCV convention
    white_background: bool

    def load(self) -> Dict[str, Any]:
        """Decode the image (and mask), rescale the intrinsics to the
        on-disk size and return the frame dict (all numpy, float32)."""
        image = load_image(self.image_path, self.white_background)
        image = image.astype(np.float32) / 255.0
        height, width = image.shape[:2]

        if self.mask_path is not None:
            mask = load_mask(self.mask_path, self.mask_expand_pixels).astype(np.float32)
            if mask.shape != image.shape[:2]:
                raise ValueError(f"mask size {mask.shape} != image size {image.shape[:2]}")
        else:
            mask = np.zeros((height, width), np.float32)

        factor = get_downscale_factor(self.height, self.width, height, width)
        K = np.array(
            [
                [self.fx * factor, 0.0, self.cx * factor],
                [0.0, self.fy * factor, self.cy * factor],
                [0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        return {
            "K": K,
            "height": height,
            "width": width,
            "w2c": self.w2c.astype(np.float32),
            "image": image,
            "mask": mask,
        }

    def to_json(self, id: int) -> Dict[str, Any]:
        c2w = np.linalg.inv(self.w2c)
        return {
            "id": id,
            "img_name": self.image_path.stem,
            "width": self.width,
            "height": self.height,
            "position": c2w[:3, 3].tolist(),
            "rotation": c2w[:3, :3].tolist(),
            "fx": self.fx,
            "fy": self.fy,
        }


def quat_to_rotmat_np(quat: np.ndarray) -> np.ndarray:
    """Numpy wxyz quaternion -> rotation matrix (normalizing)."""
    q = np.asarray(quat, np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
