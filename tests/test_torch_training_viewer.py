"""The port's training viewer on the CPU: ``train()`` with ``view_online``
and an output directory serves ``/render`` over HTTP through the
``DelayRender`` mailbox, the loop renders the newest request between steps,
and training is unchanged; the mailbox and the fov helpers against the JAX
package's."""

import dataclasses
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.viewer import camera as jcam
from easy_gaussian_splatting_torch.models.render import CameraView
from easy_gaussian_splatting_torch.training import config as tconfig
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.viewer import camera as tcam
from easy_gaussian_splatting_torch.viewer import integration as tint
from easy_gaussian_splatting_torch.viewer.server import _orbit_to_camera

STEPS = 4
ORBITS = [dict(yaw=0.3 * k, pitch=0.2, radius=3.5, target=[0, 0, 0], fov=0.9,
               width=48, height=32) for k in range(STEPS)]


def _post(port, payload) -> np.ndarray:
    from PIL import Image

    req = urllib.request.Request(f"http://localhost:{port}/render",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(Image.open(io.BytesIO(r.read())))


def _jpeg_round_trip(img: np.ndarray) -> np.ndarray:
    """The image as the server encodes it, decoded."""
    from PIL import Image

    buf = io.BytesIO()
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(buf, "JPEG", quality=85)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())))


@pytest.fixture(scope="module")
def scene_cfg(tmp_path_factory):
    from easy_gaussian_splatting_torch.utils.synthetic import generate_blender_scene

    data = tmp_path_factory.mktemp("tv") / "scene"
    generate_blender_scene(data, n_train=3, n_test=1, image_size=32, n_gaussians=30, device="cpu")
    return dict(data=str(data), data_format="blender", white_background=True, eval=False,
                blender_init_points=200, renderer="tiled", tile_size=16,
                total_iterations=STEPS, refine_start=1, refine_every=2, refine_stop=100,
                reset_opacities_every=100, sh_degree_interval=0, sh_degree=1,
                save_model_iterations=[], data_device_cache=False, dataloader_workers=0,
                log_every=1)


def _train(cfg_dict, output, monkeypatch, hook=None, view_online=True):
    """``train()`` with its viewer bound to a free port; ``hook(loop, cfg,
    viewer, update)`` stands in for each loop iteration's
    ``update_render_image``."""
    built = []
    construct = tint.construct_training_viewer

    def build(loop, cfg, output_dir):
        viewer = construct(loop, cfg, output_dir, port=0)
        built.append(viewer)
        if hook is not None:
            update = viewer.update_render_image
            viewer.update_render_image = lambda: hook(loop, cfg, viewer, update)
        return viewer

    monkeypatch.setattr(tint, "construct_training_viewer", build)
    np.random.seed(0)
    torch.manual_seed(0)
    import random

    random.seed(0)
    cfg = tconfig.config_from_dict(dict(cfg_dict, output=str(output), view_online=view_online))
    return ttrainer.train(cfg, device="cpu"), built


def test_training_viewer_serves_loop_rendered_frames(scene_cfg, tmp_path, monkeypatch):
    """Each iteration the test posts a camera: the response is the mailbox's
    frame (the white placeholder first, then the previous iteration's
    request rendered on the loop's state), never a render on the HTTP
    thread; after ``update_render_image`` the loop has rendered the posted
    camera exactly as a direct render of its state gives it. The step count
    and the trained parameters equal a run without the viewer's requests."""
    responses, expected, threads = [], [], []

    def hook(loop, cfg, viewer, update):
        k = loop.step - 1
        responses.append(_post(viewer.port, ORBITS[k]))
        render = viewer.delay_render._render
        viewer.delay_render._render = lambda cam: (threads.append(threading.current_thread()),
                                                   render(cam))[1]
        update()
        viewer.delay_render._render = render
        cam = _orbit_to_camera(ORBITS[k])
        rf = ttrainer.get_render_fn(dataclasses.replace(cfg, isect_mult=4.0))
        with torch.no_grad():
            img = rf(loop.model.params, loop.model.alive,
                     CameraView(torch.as_tensor(cam.w2c, dtype=torch.float32),
                                torch.as_tensor(cam.K, dtype=torch.float32), 48, 32),
                     loop.active_sh_degree, torch.ones(3)).image
        expected.append(img.numpy())
        np.testing.assert_array_equal(viewer.delay_render._last_frame, expected[-1])

    loop, built = _train(scene_cfg, tmp_path / "with", monkeypatch, hook)
    assert len(built) == 1 and built[0].in_training_mode
    assert loop.step == STEPS and len(responses) == STEPS
    assert threads == [threading.main_thread()] * STEPS  # rendered on the loop's thread
    assert responses[0].shape == (720, 1280, 3) and (responses[0] == 255).all()
    for got, want in zip(responses[1:], expected[:-1]):
        np.testing.assert_array_equal(got, _jpeg_round_trip(want))
    with pytest.raises(OSError):  # train() stopped the server
        _post(built[0].port, ORBITS[0])

    plain, none_built = _train(scene_cfg, tmp_path / "without", monkeypatch, view_online=False)
    assert plain.step == loop.step and not none_built
    for k in ("means", "sh_0", "logit_opacities"):
        torch.testing.assert_close(getattr(loop.model.params, k), getattr(plain.model.params, k),
                                   rtol=0, atol=0)


def test_delay_render_matches_jax():
    """The same sequence of requests and loop updates through both
    packages' mailboxes: the newest request wins, an update with no request
    renders nothing, a request returns the last frame at once."""
    log = {"jax": [], "torch": []}

    def make(mod, name):
        def render(cam):
            log[name].append(cam.width)
            return np.full((cam.height, cam.width, 3), cam.width / 100.0, np.float32)

        return mod.DelayRender(render)

    boxes = {"jax": make(jcam, "jax"), "torch": make(tcam, "torch")}
    outs = {"jax": [], "torch": []}
    for op in ("get 10", "get 20", "update", "update", "get 30", "update", "get 40"):
        for name, mod in (("jax", jcam), ("torch", tcam)):
            if op == "update":
                boxes[name].update_render_image()
            else:
                w = int(op.split()[1])
                cam = mod.CameraState(np.eye(4), np.eye(3), w, 2)
                outs[name].append(boxes[name].get_render_image(cam).copy())
    assert log["torch"] == log["jax"] == [20, 30]
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("focal,pixels", [(45.0, 48), (1111.0, 800), (60.0, 64.0)])
def test_fov_helpers_match_jax(focal, pixels):
    assert tcam.focal2fov(focal, pixels) == jcam.focal2fov(focal, pixels)
    K = np.array([[focal, 0, 0], [0, focal * 1.1, 0], [0, 0, 1]])
    got = tcam.CameraState(np.eye(4), K, pixels, pixels // 2).fov()
    want = jcam.CameraState(np.eye(4), K, pixels, pixels // 2).fov()
    assert got == want
    assert tcam.fov2focal(got[0], pixels) == pytest.approx(focal)
