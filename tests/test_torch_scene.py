"""Scene parity: the port's COLMAP and Blender loaders, image IO, native
parser and ``Scene`` against the JAX package's on the same files (written
here from a numpy seed). Frames, point clouds and splits must be equal:
both packages decode the same PNGs with PIL and draw the splits from the
same global generators."""

import json
import random
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from easy_gaussian_splatting_tpu.scene import blender as jblender
from easy_gaussian_splatting_tpu.scene import colmap as jcolmap
from easy_gaussian_splatting_tpu.scene import image_io as jio
from easy_gaussian_splatting_tpu.scene.scene import Scene as JScene
from easy_gaussian_splatting_torch import native as tnative
from easy_gaussian_splatting_torch.scene import blender as tblender
from easy_gaussian_splatting_torch.scene import colmap as tcolmap
from easy_gaussian_splatting_torch.scene import image_io as tio
from easy_gaussian_splatting_torch.scene.scene import Scene as TScene


def write_colmap(root: Path, n_images=6, width=24, height=16, n_points=40, seed=0):
    """A COLMAP scene with variable-length 2D and 3D tracks, RGBA/RGB
    images and masks for every other image."""
    rng = np.random.default_rng(seed)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    (root / "masks").mkdir()
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 0, width, height))  # SIMPLE_PINHOLE
        f.write(struct.pack("<ddd", 20.0, width / 2, height / 2))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in rng.permutation(n_images):  # out of name order
            q = rng.normal(size=4)
            t = rng.normal(size=3)
            f.write(struct.pack("<idddddddi", int(i) + 1, *q, *t, 1))
            f.write(f"img_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", int(i)))
            for _ in range(int(i)):
                f.write(struct.pack("<ddq", 1.0, 2.0, -1))
            mode = "RGBA" if i % 2 else "RGB"
            arr = rng.integers(0, 256, size=(height, width, len(mode)), dtype=np.uint8)
            Image.fromarray(arr, mode).save(root / "images" / f"img_{i:03d}.png")
            if i % 2 == 0:
                mask = (rng.uniform(size=(height, width)) < 0.05).astype(np.uint8) * 255
                Image.fromarray(mask).save(root / "masks" / f"img_{i:03d}.png")
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for i in range(n_points):
            f.write(struct.pack("<Qddd", i, *rng.normal(size=3)))
            f.write(struct.pack("<BBB", *rng.integers(0, 256, size=3)))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", i % 3))
            for j in range(i % 3):
                f.write(struct.pack("<ii", 1, j))
    return root


def write_blender(root: Path, sizes=((16, 16), (16, 16), (24, 20)), seed=1):
    """A Blender scene: train frames of two sizes, test and val splits, RGBA
    images and a train mask directory."""
    rng = np.random.default_rng(seed)
    for name, n in (("train", len(sizes)), ("test", 2), ("val", 1)):
        (root / name).mkdir(parents=True)
        (root / f"{name}_masks").mkdir()
        frames = []
        for i in range(n):
            w, h = sizes[i] if name == "train" else (16, 16)
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.normal(size=3) * 3
            frames.append({"file_path": f"./{name}/r_{i}", "transform_matrix": c2w.tolist()})
            arr = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
            Image.fromarray(arr, "RGBA").save(root / name / f"r_{i}.png")
            mask = (rng.uniform(size=(h, w)) < 0.05).astype(np.uint8)
            Image.fromarray(mask).save(root / f"{name}_masks" / f"r_{i}.png")
        with open(root / f"transforms_{name}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


def assert_frames_equal(tframes, jframes):
    assert len(tframes) == len(jframes)
    for t, j in zip(tframes, jframes):
        assert t.image_path == j.image_path and t.mask_path == j.mask_path
        assert (t.width, t.height, t.fx, t.fy, t.cx, t.cy) == (j.width, j.height, j.fx, j.fy, j.cx, j.cy)
        np.testing.assert_array_equal(t.w2c, j.w2c)
        td, jd = t.load(), j.load()
        assert set(td) == set(jd)
        for k in td:
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
        assert t.to_json(3) == j.to_json(3)


@pytest.mark.parametrize("use_masks,expand", [(False, 0), (True, 0), (True, 2)])
def test_colmap_loads_like_jax(tmp_path, use_masks, expand):
    """Frames (K, w2c, image, mask, sizes), the point cloud and the split:
    equal under one ``random.seed`` (the split shuffle's call order)."""
    root = write_colmap(tmp_path / "colmap")
    out = {}
    for name, mod in (("jax", jcolmap), ("torch", tcolmap)):
        random.seed(11)
        out[name] = mod.load_colmap_data(str(root), use_masks, expand, True, 0.34, False)
    (tf, tpc, ttr, tev), (jf, jpc, jtr, jev) = out["torch"], out["jax"]
    assert_frames_equal(tf, jf)
    assert sum(f.mask_path is not None for f in tf) == (3 if use_masks else 0)
    np.testing.assert_array_equal(tpc.xyzs, jpc.xyzs)
    np.testing.assert_array_equal(tpc.rgbs, jpc.rgbs)
    assert (ttr, tev) == (jtr, jev) and len(tev) == 2 and len(ttr) == 4


@pytest.mark.parametrize("eval_split", [True, False])
def test_blender_loads_like_jax(tmp_path, eval_split):
    """Frames of two sizes, RGBA on white, masks, the val + test eval split
    and the point cloud drawn from the global numpy generator."""
    root = write_blender(tmp_path / "blender")
    out = {}
    for name, mod in (("jax", jblender), ("torch", tblender)):
        np.random.seed(5)
        out[name] = mod.load_blender_data(str(root), True, 1, eval_split, True, True, True,
                                          init_points=500)
    (tf, tpc, ttr, tev), (jf, jpc, jtr, jev) = out["torch"], out["jax"]
    assert_frames_equal(tf, jf)
    np.testing.assert_array_equal(tpc.xyzs, jpc.xyzs)
    np.testing.assert_array_equal(tpc.rgbs, jpc.rgbs)
    assert (ttr, tev) == (jtr, jev) and tev == [0, 1, 2]


@pytest.mark.parametrize("e", [0, 1, 3])
def test_image_io_matches_jax(tmp_path, e):
    rng = np.random.default_rng(e)
    mask = (rng.uniform(size=(20, 30)) < 0.03).astype(np.uint8)
    np.testing.assert_array_equal(tio.expand_mask(mask, e), jio.expand_mask(mask, e))
    Image.fromarray(mask * 200).save(tmp_path / "m.png")
    np.testing.assert_array_equal(tio.load_mask(tmp_path / "m.png", e), jio.load_mask(tmp_path / "m.png", e))
    rgba = rng.integers(0, 256, size=(10, 12, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "i.png")
    for white in (False, True):
        np.testing.assert_array_equal(tio.load_image(tmp_path / "i.png", white),
                                      jio.load_image(tmp_path / "i.png", white))
    assert tio.get_downscale_factor(800, 600, 400, 300) == jio.get_downscale_factor(800, 600, 400, 300)
    with pytest.raises(ValueError):
        tio.get_downscale_factor(800, 600, 400, 200)


def test_native_parser_matches_its_fallback(tmp_path, monkeypatch):
    """The port's own native library (built from its own copy of the
    source, into the repository's build directory) against the Python
    record walks and the Python dilation."""
    root = write_colmap(tmp_path / "colmap", n_points=300)
    sparse = root / "sparse" / "0"
    assert tnative.get_library() is not None
    assert tnative._SRC.parent == Path(tnative.__file__).parent
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    nat_pc = tcolmap.load_points3d_binary(sparse / "points3D.bin")
    nat_im = tcolmap.load_images_binary(sparse / "images.bin")
    mask = (np.random.default_rng(0).uniform(size=(40, 50)) < 0.02).astype(np.uint8)
    nat_mask = tio.expand_mask(mask, 3)
    monkeypatch.setattr(tnative, "get_library", lambda: None)
    py_pc = tcolmap.load_points3d_binary(sparse / "points3D.bin")
    py_im = tcolmap.load_images_binary(sparse / "images.bin")
    np.testing.assert_array_equal(nat_pc.xyzs, py_pc.xyzs)
    np.testing.assert_array_equal(nat_pc.rgbs, py_pc.rgbs)
    assert nat_im.keys() == py_im.keys()
    for k in nat_im:
        a, b = nat_im[k], py_im[k]
        assert (a.id, a.file_name, a.camera_id) == (b.id, b.file_name, b.camera_id)
        np.testing.assert_array_equal(a.quat, b.quat)
        np.testing.assert_array_equal(a.trans, b.trans)
    np.testing.assert_array_equal(nat_mask, tio.expand_mask(mask, 3))


@pytest.mark.parametrize("fmt", ["colmap", "blender"])
def test_scene_matches_jax(tmp_path, fmt):
    """``Scene``: the tiled train indexes, the eval indexes, each frame
    dict and ``cameras.json``."""
    root = (write_colmap(tmp_path / "data") if fmt == "colmap" else write_blender(tmp_path / "data"))
    args = (str(root), fmt)
    rest = (15, True, 0.34, False, True, True, 1, False)
    scenes = {}
    for name, cls in (("jax", JScene), ("torch", TScene)):
        random.seed(2)
        np.random.seed(2)
        scenes[name] = cls(*args, str(tmp_path / name), *rest, blender_init_points=50)
    t, j = scenes["torch"], scenes["jax"]
    assert t.train_indexes == j.train_indexes and len(t.train_indexes) == 15
    assert t.eval_indexes == j.eval_indexes
    for split in ("train", "eval"):
        assert t.nbr_data(split) == j.nbr_data(split)
        for i in (0, t.nbr_data(split) - 1):
            td, jd = t.get_data(split, i), j.get_data(split, i)
            for k in td:
                np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    tj = json.loads((tmp_path / "torch" / "cameras.json").read_text())
    jj = json.loads((tmp_path / "jax" / "cameras.json").read_text())
    assert tj == jj and len(tj) == len(t.frames)
    with pytest.raises(ValueError):
        TScene(*args, None, 2, *rest[1:])
