"""COLMAP sparse-reconstruction binary loaders; counterpart of
``easy_gaussian_splatting_tpu/scene/colmap.py``.

Parses ``sparse/0/{cameras,images,points3D}.bin`` (SIMPLE_PINHOLE and
PINHOLE camera models only), builds w2c poses from (wxyz quaternion,
translation), looks up per-image masks at ``masks/<name>.png``, sorts the
frames by image path and makes a shuffled ratio eval split. Binary layouts
follow the public COLMAP format: little-endian; the variable-length 2D
track records are skipped. ``images.bin`` and ``points3D.bin`` go through
the native parser when it is built (``native/``), else through the
Python record walk below.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native as _native
from .types import Frame, Pointcloud, quat_to_rotmat_np

logger = logging.getLogger(__name__)

# {model_id: (model_name, num_params)}; pinhole models only
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model_name: str
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


@dataclasses.dataclass
class ColmapImage:
    id: int
    file_name: str
    camera_id: int
    quat: Tuple[float, float, float, float]  # wxyz, w2c
    trans: Tuple[float, float, float]


def _intrinsics_from_params(model_name: str, params: Sequence[float]) -> Tuple[float, float, float, float]:
    if model_name == "SIMPLE_PINHOLE":
        return params[0], params[0], params[1], params[2]
    if model_name == "PINHOLE":
        return params[0], params[1], params[2], params[3]
    raise ValueError(f"unsupported camera model: {model_name}")


def load_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    buf = path.read_bytes()
    (num_cameras,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    cameras: Dict[int, ColmapCamera] = {}
    for _ in range(num_cameras):
        camera_id, model_id, width, height = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        if model_id not in CAMERA_MODELS:
            raise ValueError(f"unsupported camera model id: {model_id}")
        model_name, num_params = CAMERA_MODELS[model_id]
        params = struct.unpack_from(f"<{num_params}d", buf, off)
        off += 8 * num_params
        fx, fy, cx, cy = _intrinsics_from_params(model_name, params)
        cameras[camera_id] = ColmapCamera(camera_id, model_name, int(width), int(height), fx, fy, cx, cy)
    if len({c.model_name for c in cameras.values()}) > 1:
        raise ValueError("scenes mixing camera models are not supported")
    return cameras


def load_images_binary(path: Path) -> Dict[int, ColmapImage]:
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    buf = path.read_bytes()
    native = _native.parse_images(buf)
    if native is not None:
        ids, cam_ids, quats, trans, names = native
        return {
            int(ids[i]): ColmapImage(
                int(ids[i]), names[i], int(cam_ids[i]), tuple(quats[i]), tuple(trans[i]),
            )
            for i in range(len(ids))
        }
    (num_images,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    images: Dict[int, ColmapImage] = {}
    for _ in range(num_images):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        image_id = vals[0]
        quat = vals[1:5]  # wxyz
        trans = vals[5:8]
        camera_id = vals[8]
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (num_points2d,) = struct.unpack_from("<Q", buf, off)
        off += 8 + 24 * num_points2d  # skip the 2D-3D track (x, y, point3D_id)
        images[image_id] = ColmapImage(image_id, name, camera_id, quat, trans)
    return images


def load_points3d_binary(path: Path) -> Pointcloud:
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    buf = path.read_bytes()
    native = _native.parse_points3d(buf)
    if native is not None:
        xyz, rgb = native
        return Pointcloud(xyzs=xyz, rgbs=rgb)
    (num_points,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    xyzs = np.empty((num_points, 3), np.float32)
    rgbs = np.empty((num_points, 3), np.uint8)
    # fixed prefix: uint64 id, 3x f64 xyz, 3x u8 rgb, f64 error = 43 bytes,
    # then uint64 track_len + 8 bytes per track element
    for i in range(num_points):
        xyzs[i] = np.frombuffer(buf, "<f8", 3, off + 8)
        rgbs[i] = np.frombuffer(buf, "u1", 3, off + 32)
        (track_len,) = struct.unpack_from("<Q", buf, off + 43)
        off += 51 + 8 * track_len
    return Pointcloud(xyzs=xyzs, rgbs=rgbs)


def load_colmap_data(
    path: str,
    use_masks: bool,
    mask_expand_pixels: int,
    eval: bool,
    eval_split_ratio: float,
    white_background: bool,
) -> Tuple[List[Frame], Pointcloud, List[int], List[int]]:
    """Load a COLMAP scene. Returns (frames, pointcloud, train_indexes,
    eval_indexes). The split shuffle draws from the module-global
    ``random`` in the JAX module's call order, so under one ``random.seed``
    both packages pick the same eval frames."""
    root = Path(path)
    sparse = root / "sparse" / "0"
    cameras = load_cameras_binary(sparse / "cameras.bin")
    images = load_images_binary(sparse / "images.bin")
    pc = load_points3d_binary(sparse / "points3D.bin")

    def build_frame(im) -> Frame:
        cam = cameras[im.camera_id]
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = quat_to_rotmat_np(np.asarray(im.quat))
        w2c[:3, 3] = np.asarray(im.trans, np.float32)
        mask_path = (root / "masks" / im.file_name).with_suffix(".png")
        return Frame(
            image_path=root / "images" / im.file_name,
            mask_path=mask_path if use_masks and mask_path.exists() else None,
            mask_expand_pixels=mask_expand_pixels,
            width=cam.width,
            height=cam.height,
            fx=cam.fx,
            fy=cam.fy,
            cx=cam.cx,
            cy=cam.cy,
            w2c=w2c,
            white_background=white_background,
        )

    frames = sorted((build_frame(im) for im in images.values()), key=lambda f: f.image_path)
    mask_count = sum(f.mask_path is not None for f in frames)
    logger.info(
        "loaded COLMAP scene: %d registered images / %d camera models / %d sparse points%s",
        len(images), len(cameras), pc.nbr_points,
        f" / {mask_count} masks" if use_masks else "",
    )

    indexes = list(range(len(frames)))
    random.shuffle(indexes)
    split_point = int(len(frames) * eval_split_ratio)
    eval_indexes = indexes[:split_point]
    train_indexes = indexes[split_point:] if eval else indexes
    if not eval_indexes:
        logger.warning("evaluation split is empty")
    return frames, pc, train_indexes, eval_indexes
