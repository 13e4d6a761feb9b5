"""The device-resident frame cache on the CPU: each split index gives the
frame ``Scene.get_data`` gives (exactly: the same decoded arrays, stacked
and indexed), padding rows hold 0 in the image and 1 in the mask, a split
over the byte budget gives no cache, and the trainer feeds the frames in
streaming's order."""

import random

import numpy as np
import pytest
import torch

from easy_gaussian_splatting_torch.scene.device_cache import build_cache
from easy_gaussian_splatting_torch.scene.scene import Scene
from easy_gaussian_splatting_torch.training import config as tconfig
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from test_torch_scene import write_blender


def _scene(tmp_path, total=9):
    root = write_blender(tmp_path / "data")  # train frames of two sizes
    np.random.seed(0)
    return Scene(str(root), "blender", None, total, True, 0.125, True, True, True, 1, True,
                 blender_init_points=40)


@pytest.mark.parametrize("split", ["train", "eval"])
def test_get_equals_get_data(tmp_path, split):
    scene = _scene(tmp_path)
    cache = build_cache(scene, split, budget_mb=64, num_workers=2, device="cpu")
    assert cache is not None and cache.num_frames == len(set(
        scene.train_indexes if split == "train" else scene.eval_indexes))
    for i in range(scene.nbr_data(split)):
        got, want = cache.get(i), scene.get_data(split, i)
        assert set(got) == set(want)
        assert (got["height"], got["width"]) == (want["height"], want["width"])
        for k in ("image", "mask", "w2c", "K"):
            assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_padding_rows(tmp_path):
    """Rows padded up to a multiple of 7: image rows 0, mask rows 1 (the
    mask-compositing loss ignores them)."""
    scene = _scene(tmp_path)
    cache = build_cache(scene, "train", budget_mb=64, pad_rows_to=7, device="cpu")
    for i in range(scene.nbr_data("train")):
        got, want = cache.get(i), scene.get_data("train", i)
        h = want["height"]
        hp = -(-h // 7) * 7
        assert got["image"].shape == (hp, want["width"], 3) and hp > h
        np.testing.assert_array_equal(got["image"][:h].numpy(), want["image"])
        np.testing.assert_array_equal(got["mask"][:h].numpy(), want["mask"])
        assert (got["image"][h:] == 0).all() and (got["mask"][h:] == 1).all()


def test_over_budget_gives_none(tmp_path):
    scene = _scene(tmp_path)
    assert build_cache(scene, "train", budget_mb=0, device="cpu") is None


def test_trainer_feeds_streaming_order(tmp_path, monkeypatch):
    """train() with the cache and without it hands the step the same frames
    in the same order (one ``random.shuffle`` of the split's indexes)."""
    root = write_blender(tmp_path / "data")
    fed = {True: [], False: []}
    orig = ttrainer.make_train_step

    def make(cfg, render_fn):
        step = orig(cfg, render_fn)

        def run(model, adam, w2c, K, image, mask, *a, **k):
            fed[cfg.data_device_cache].append((image.clone(), mask.clone(), w2c.clone()))
            return step(model, adam, w2c, K, image, mask, *a, **k)

        return run

    monkeypatch.setattr(ttrainer, "make_train_step", make)
    for cached in (True, False):
        cfg = tconfig.config_from_dict(dict(
            data=str(root), data_format="blender", white_background=True, eval=False,
            total_iterations=7, blender_init_points=30, sh_degree=0, sh_degree_interval=0,
            tile_size=16, refine_start=1000, data_device_cache=cached, dataloader_workers=0,
            initial_capacity=64))
        random.seed(4)
        np.random.seed(4)
        ttrainer.train(cfg, device="cpu")
    assert len(fed[True]) == len(fed[False]) == 7
    sizes = {tuple(img.shape) for img, _, _ in fed[True]}
    assert len(sizes) == 2  # both size groups were fed
    for (a, am, aw), (b, bm, bw) in zip(fed[True], fed[False]):
        assert torch.equal(a, b) and torch.equal(am, bm) and torch.equal(aw, bw)
