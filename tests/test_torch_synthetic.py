"""Procedural datasets: the port's generator against the JAX package's. The
ground truth and cameras are drawn with numpy from the same seeds, so they
and every file that holds no render (``transforms_*.json``, the COLMAP
``*.bin`` files) must be equal; the PNGs come from two renderers that round
differently, so each must agree within 1/255 on at least 99.9% of its
pixels."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from easy_gaussian_splatting_tpu.utils import synthetic as jsyn
from easy_gaussian_splatting_torch.utils import synthetic as tsyn


@pytest.mark.parametrize("kw", [
    dict(n=300), dict(n=1000, seed=3, sh_degree=3), dict(n=500, layout="unbounded", aniso=4.0),
])
def test_make_gt_gaussians_matches_jax(kw):
    for t, j in zip(tsyn.make_gt_gaussians(**kw), jsyn.make_gt_gaussians(**kw)):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_ring_cameras_match_jax():
    np.testing.assert_array_equal(tsyn.ring_cameras(7, seed=2), jsyn.ring_cameras(7, seed=2))
    q = tsyn._rotmat_to_quat(tsyn.ring_cameras(1, seed=5)[0][:3, :3])
    assert q == jsyn._rotmat_to_quat(jsyn.ring_cameras(1, seed=5)[0][:3, :3])


def _assert_pngs_close(t_dir: Path, j_dir: Path, pattern: str, count: int):
    t_files, j_files = sorted(t_dir.glob(pattern)), sorted(j_dir.glob(pattern))
    assert [p.name for p in t_files] == [p.name for p in j_files] and len(t_files) == count
    for a, b in zip(t_files, j_files):
        x = np.asarray(Image.open(a)).astype(np.int32)
        y = np.asarray(Image.open(b)).astype(np.int32)
        assert x.shape == y.shape
        close = (np.abs(x - y) <= 1).all(axis=-1) if x.ndim == 3 else np.abs(x - y) <= 1
        assert close.mean() >= 0.999, (a.name, close.mean())
        assert x.std() > 5  # something was rendered


def test_blender_scene_matches_jax(tmp_path):
    kw = dict(n_train=3, n_test=2, image_size=24, n_gaussians=40, with_masks=True, sh_degree=1)
    tsyn.generate_blender_scene(tmp_path / "t", device="cpu", **kw)
    jsyn.generate_blender_scene(tmp_path / "j", **kw)
    for split, n in (("train", 3), ("test", 2)):
        name = f"transforms_{split}.json"
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
        _assert_pngs_close(tmp_path / "t" / split, tmp_path / "j" / split, "*.png", n)
        _assert_pngs_close(tmp_path / "t" / f"{split}_masks", tmp_path / "j" / f"{split}_masks",
                           "*.png", n)


@pytest.mark.parametrize("gt_renderer", ["oracle", "tiled"])
def test_colmap_scene_matches_jax(tmp_path, gt_renderer):
    kw = dict(n_images=3, image_size=32, n_gaussians=50, n_points=257, sh_degree=3,
              gt_renderer=gt_renderer)
    tsyn.generate_colmap_scene(tmp_path / "t", device="cpu", **kw)
    jsyn.generate_colmap_scene(tmp_path / "j", **kw)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        t = (tmp_path / "t" / "sparse" / "0" / name).read_bytes()
        assert t == (tmp_path / "j" / "sparse" / "0" / name).read_bytes(), name
    assert len((tmp_path / "t" / "sparse" / "0" / "points3D.bin").read_bytes()) == 8 + 51 * 257
    _assert_pngs_close(tmp_path / "t" / "images", tmp_path / "j" / "images", "*.png", 3)
