"""Blender / nerf_synthetic dataset loader; counterpart of
``easy_gaussian_splatting_tpu/scene/blender.py``.

Parses ``transforms_{train,val,test}.json``: focal from ``camera_angle_x``
(fx = fy = W / (2 tan(fov / 2)), principal point at the image centre), the
OpenGL/Blender camera convention (X right, Y up, Z back) turned into
OpenCV's (X right, Y down, Z forward), masks in a sibling
``<split>_masks`` directory. With no SfM point cloud, one is drawn:
uniform gray points inside the cameras' bounding box shrunk to a third
around its centre.

The frame list is ``val-eval + test-eval + train`` with the eval indexes
first, and the cloud takes exactly one ``np.random.rand(n, 3)`` draw from
the globally seeded numpy generator, as the JAX module does: one seed gives
both packages the same split and the same initial points.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Tuple

import numpy as np
from PIL import Image

from .types import Frame, Pointcloud

logger = logging.getLogger(__name__)

# Right-multiplying c2w by this flips its Y/Z basis columns: OpenGL/Blender
# -> OpenCV; homogeneous, so the translation column is untouched.
_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def _mask_for(image_path: Path) -> Path:
    """Mask convention: ``<split>_masks/<name>`` next to ``<split>/``."""
    masks_dir = image_path.parent.with_name(image_path.parent.name + "_masks")
    return masks_dir / image_path.name


def _image_size(path: Path) -> Tuple[int, int]:
    with Image.open(path) as im:
        return im.size  # (width, height)


def load_frames(
    transforms_path: Path,
    use_masks: bool,
    mask_expand_pixels: int,
    white_background: bool,
    suffix: str = ".png",
) -> List[Frame]:
    """Frames for one ``transforms_*.json`` file, in file order."""
    if not transforms_path.exists():
        raise FileNotFoundError(f"{transforms_path} does not exist")
    meta = json.loads(transforms_path.read_text())
    half_tan = np.tan(0.5 * meta["camera_angle_x"])

    frames: List[Frame] = []
    for entry in meta["frames"]:
        image_path = transforms_path.parent / (entry["file_path"] + suffix)
        width, height = _image_size(image_path)
        focal = 0.5 * width / half_tan
        c2w_cv = np.asarray(entry["transform_matrix"], np.float64) @ _GL_TO_CV
        mask_path = _mask_for(image_path)
        frames.append(
            Frame(
                image_path=image_path,
                mask_path=mask_path if use_masks and mask_path.exists() else None,
                mask_expand_pixels=mask_expand_pixels,
                width=width,
                height=height,
                fx=focal,
                fy=focal,
                cx=width / 2.0,
                cy=height / 2.0,
                w2c=np.linalg.inv(c2w_cv).astype(np.float32),
                white_background=white_background,
            )
        )
    return frames


def generate_pointcloud(frames: List[Frame], num_points: int = 100000) -> Pointcloud:
    """Uniform gray points in the 1/3-shrunk camera bounding box: one
    global min/max over every camera-centre coordinate (all axes pooled),
    so the sample region is a cube. Takes one ``np.random.rand`` draw from
    the global generator."""
    centers = np.stack([np.linalg.inv(f.w2c)[:3, 3] for f in frames])
    lo, hi = float(centers.min()), float(centers.max())
    mid, third = 0.5 * (hi + lo), (hi - lo) / 6.0
    lo, hi = mid - third, mid + third
    xyzs = (lo + np.random.rand(num_points, 3) * (hi - lo)).astype(np.float32)
    gray = np.full((num_points, 3), 127, np.uint8)
    return Pointcloud(xyzs=xyzs, rgbs=gray)


def load_blender_data(
    path: str,
    use_masks: bool,
    mask_expand_pixels: int,
    eval: bool,
    eval_in_val: bool,
    eval_in_test: bool,
    white_background: bool,
    init_points: int = 100000,
) -> Tuple[List[Frame], Pointcloud, List[int], List[int]]:
    root = Path(path)

    def split(name: str) -> List[Frame]:
        return load_frames(root / f"transforms_{name}.json", use_masks, mask_expand_pixels,
                           white_background)

    eval_frames: List[Frame] = []
    for name, wanted in (("val", eval_in_val), ("test", eval_in_test)):
        if wanted:
            eval_frames += split(name)
    n_eval = len(eval_frames)
    frames = eval_frames + split("train")

    eval_indexes = list(range(n_eval))
    train_indexes = list(range(n_eval if eval else 0, len(frames)))
    if not eval_indexes:
        logger.warning("evaluation split is empty")

    pc_frames = frames[n_eval:] if eval else frames
    pc = generate_pointcloud(pc_frames, num_points=init_points)
    return frames, pc, train_indexes, eval_indexes
