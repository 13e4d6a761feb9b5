"""The port's offline viewer on the CPU: a run directory built by the JAX
package's writers is served through ``launch_viewer.build_viewer``; camera
loading, config reading and the per-resolution capacity agree with the
JAX package."""

import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.training import config as jconfig
from easy_gaussian_splatting_tpu.viewer import integration as jint
from easy_gaussian_splatting_torch.launch_viewer import build_viewer, load_run
from easy_gaussian_splatting_torch.models.gaussians import init_gaussian_state
from easy_gaussian_splatting_torch.models.render import CameraView
from easy_gaussian_splatting_torch.training import config as tconfig
from easy_gaussian_splatting_torch.training.trainer import get_render_fn
from easy_gaussian_splatting_torch.utils.checkpoint import save_checkpoint
from easy_gaussian_splatting_torch.viewer import integration as tint
from easy_gaussian_splatting_torch.viewer.camera import CameraState

W, H = 64, 48


def _ring(k, n=3, radius=4.0):
    th = 2 * np.pi * k / n
    pos = np.array([radius * np.sin(th), 0.3, -radius * np.cos(th)])
    z = -pos / np.linalg.norm(pos)
    x = np.cross([0.0, -1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return dict(rotation=np.stack([x, np.cross(z, x), z], 1).tolist(),
                position=pos.tolist(), fx=60.0, fy=62.0, width=W, height=H)


@pytest.fixture
def run_dir(tmp_path, rng):
    """A tiny run directory: config dumped by the JAX package, cameras, and
    a 400-Gaussian SH-3 checkpoint with dead capacity slots."""
    n = 400
    xyz = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    state = init_gaussian_state(xyz, rgb, 3, capacity=1536, device="cpu")
    state.params.sh_rest[:n] = torch.as_tensor(rng.normal(0, 0.1, (n, 15, 3)).astype(np.float32))
    save_checkpoint(tmp_path / "checkpoints" / "iterations_100.npz", state, 3, 100)
    cfg = jconfig.config_from_dict(dict(tile_size=16, white_background=True))
    jconfig.dump_config(cfg, tmp_path / "config.yaml")
    (tmp_path / "cameras.json").write_text(json.dumps([_ring(k) for k in range(3)]))
    return tmp_path


def _get(port, path):
    return urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=30).read()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://localhost:{port}{path}", data=json.dumps(payload).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def test_viewer_serves_cameras_and_renders(run_dir):
    from PIL import Image

    viewer = build_viewer(run_dir, port=0, device="cpu")
    try:
        assert viewer.port > 0
        assert b"viewer" in _get(viewer.port, "/")
        cams = json.loads(_get(viewer.port, "/cameras"))
        assert len(cams) == 3
        np.testing.assert_allclose(cams[0]["position"], _ring(0)["position"], atol=1e-9)
        orbit = dict(yaw=0.4, pitch=0.2, radius=4.0, target=[0, 0, 0], width=80, height=56)
        body, ctype = _post(viewer.port, "/render", orbit)
        assert ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
        im = np.asarray(Image.open(io.BytesIO(body)))
        assert im.shape == (56, 80, 3)
        assert im.min() < 200  # content on the white background
        stats = viewer.base_render_func.stats
        assert 0 < stats["num_isects"] <= stats["isect_cap"]
        body, _ = _post(viewer.port, "/render", {**orbit, "sh_cap": 1, "pad_aspect": 2.0})
        assert Image.open(io.BytesIO(body)).size == (112, 56)
        status = json.loads(_post(viewer.port, "/record/add", orbit)[0])["status"]
        assert status == "1 keyframes"
        assert json.loads(_post(viewer.port, "/record/clear", {})[0])["status"] == "cleared"
    finally:
        viewer.stop()


def test_load_camera_states_matches_jax(run_dir):
    tc, jc = tint.load_camera_states(run_dir), jint.load_camera_states(run_dir)
    assert len(tc) == len(jc) == 3
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.w2c, b.w2c)
        np.testing.assert_array_equal(a.K, b.K)
        assert (a.width, a.height) == (b.width, b.height)


def test_load_run_compacts_and_tunes(run_dir):
    cfg, state, sh, cams = load_run(run_dir, device="cpu")
    assert state.capacity == 1024 and state.num_alive() == 400 and sh == 3
    assert cfg.isect_mult != 3.0 and cfg.white_background


@pytest.mark.parametrize("pixels", [180 * 320, 480 * 640, 800 * 800])
def test_capacity_scale_matches_jax_up_to_probe(pixels):
    """At or below the probe size the port's scale is the JAX viewer's
    ``min(1, r * 1.5 + 0.05)``; above it the scale keeps growing."""
    base = 800 * 800
    assert tint.capacity_scale(pixels, base) == min(1.0, pixels / base * 1.5 + 0.05)
    assert tint.capacity_scale(1280 * 1024, base) == 1280 * 1024 / base > 1.0


def test_truncated_frame_renders_again(run_dir):
    """A frame size whose first capacity estimate truncates is rendered
    again with the capacity grown to 1.5x its count, and keeps it."""
    cfg, state, sh, cams = load_run(run_dir, device="cpu")
    cfg.isect_mult = 0.25
    bg = torch.ones(3)
    rf = tint.make_gs_render_func(
        lambda: state, lambda: sh, bg, get_render_fn(cfg), cfg=cfg, base_pixels=W * H * 400,
    )
    cam = CameraState(cams[0].w2c, cams[0].K, W, H)
    img = rf(cam)
    st = rf.stats
    assert st["rerenders"] == 1 and st["num_isects"] <= st["isect_cap"]
    ref = get_render_fn(tconfig.config_from_dict({**cfg.to_dict(), "isect_mult": 8.0}))(
        state.params, state.alive,
        CameraView(torch.as_tensor(cam.w2c, dtype=torch.float32),
                   torch.as_tensor(cam.K, dtype=torch.float32), W, H),
        sh, bg,
    )
    np.testing.assert_allclose(img, ref.image.numpy(), atol=1e-6)
    rf(cam)
    assert rf.stats["rerenders"] == 0


@pytest.mark.parametrize("name", ["nerf_synthetic.yaml", "tandt_db.yaml"])
def test_config_reads_repo_configs_like_jax(name):
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "configs" / name
    t, j = tconfig.load_config(path), jconfig.load_config(path)
    assert {k: v for k, v in t.to_dict().items() if k != "device"} == {
        k: v for k, v in j.to_dict().items() if k != "device"
    }


def test_config_dumps_read_across_packages(tmp_path):
    cfg = tconfig.config_from_dict(dict(isect_mult=2.125, save_model_iterations=[5, 9]))
    tconfig.dump_config(cfg, tmp_path / "t.yaml")
    back = jconfig.load_config(tmp_path / "t.yaml")
    assert back.isect_mult == 2.125 and back.save_model_iterations == [5, 9]
    jconfig.dump_config(back, tmp_path / "j.yaml")
    assert tconfig.load_config(tmp_path / "j.yaml") == cfg
