"""The port's command lines on the CPU, in process through their ``main(argv)``
with ``--device cpu``: train then eval on a tiny generated Blender scene
(the run directory of ``tests/test_cli.py``), the port's eval against the
repository's ``eval.py`` on the same run directory, the e2e script at a few
steps, and the eval's capacity check."""

import dataclasses
import importlib.util
import logging
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from easy_gaussian_splatting_tpu.utils import logging as jlog
from easy_gaussian_splatting_torch import eval as teval
from easy_gaussian_splatting_torch import train as ttrain
from easy_gaussian_splatting_torch import validate_e2e
from easy_gaussian_splatting_torch.utils import logging as tlog

REPO = Path(__file__).resolve().parent.parent
# tests/test_cli.py's schedule: 30 steps of the reference renderer, one
# densify window, a checkpoint at the end
CLI_CFG = {
    "data_format": "blender", "white_background": True, "eval": True, "eval_in_test": True,
    "eval_every": 20, "eval_render_num": 1, "total_iterations": 30,
    "save_model_iterations": [30], "sh_degree": 1, "sh_degree_interval": 10,
    "refine_start": 5, "refine_stop": 20, "refine_every": 10, "reset_opacities_every": 100,
    "log_every": 10, "renderer": "ref", "raster_chunk": 64, "blender_init_points": 50,
    "dataloader_workers": 0,
}


@pytest.fixture(scope="module", autouse=True)
def _no_console_handler():
    """Both packages' ``set_global_state`` add a stdout handler to the root
    logger once per process; the test process keeps pytest's own."""
    saved = tlog._configured, jlog._configured
    tlog._configured = jlog._configured = True
    yield
    tlog._configured, jlog._configured = saved


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's train CLI on a 48-pixel Blender scene (4 train and 2 test
    frames): returns the run directory."""
    from easy_gaussian_splatting_torch.utils.synthetic import generate_blender_scene

    root = tmp_path_factory.mktemp("torch_cli")
    data = root / "data"
    generate_blender_scene(data, n_train=4, n_test=2, image_size=48, n_gaussians=60, device="cpu")
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.dump(CLI_CFG))
    run_dir = ttrain.main(["-c", str(cfg_path), "-d", str(data), "-o", str(root / "out"),
                           "--device", "cpu"])
    return root, run_dir


def test_train_cli_run_directory_then_eval(trained):
    root, run_dir = trained
    runs = list((root / "out" / "data").iterdir())
    assert runs == [run_dir]
    assert re.fullmatch(r"\d\d-\d\d_\d\d-\d\d-\d\d", run_dir.name)
    for name in ("config.yaml", "cameras.json", "tensorboard", "checkpoints/iterations_30.npz"):
        assert (run_dir / name).exists(), name
    dumped = yaml.safe_load((run_dir / "config.yaml").read_text())
    assert dumped["data"] == str(root / "data") and dumped["output"] == str(run_dir)
    assert dumped["save_model_iterations"] == [30]
    results = teval.main(["-p", str(run_dir), "--device", "cpu"])
    assert set(results) == {"train", "eval"}
    for m in results.values():
        for k in ("psnr", "ssim", "lpips_proxy", "fps", "latency_ms", "latency_device_ms"):
            assert np.isfinite(m[k]), k
        assert m["psnr"] > 10.0


def test_train_cli_appends_the_last_iteration(tmp_path, monkeypatch):
    """``total_iterations`` joins ``save_model_iterations`` when missing, and
    every saved iteration is evaluated after training; ``--profile`` sets
    ``profile_steps``."""
    from easy_gaussian_splatting_torch.utils.synthetic import generate_blender_scene

    data = tmp_path / "scene"
    generate_blender_scene(data, n_train=3, n_test=2, image_size=32, n_gaussians=20, device="cpu")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.dump(dict(CLI_CFG, total_iterations=6, save_model_iterations=[3],
                                       refine_start=100, eval_every=100)))
    seen = {}
    monkeypatch.setattr(teval, "eval", lambda path, it, device: seen.setdefault(it, path))
    from easy_gaussian_splatting_torch.training import trainer

    profiles = []
    real_train = trainer.train

    def train(cfg, **kw):
        profiles.append(cfg.profile_steps)
        return real_train(cfg, **kw)

    monkeypatch.setattr(trainer, "train", train)
    run_dir = ttrain.main(["-c", str(cfg_path), "-d", str(data), "-o", str(tmp_path / "out"),
                           "--device", "cpu", "--profile", "2"])
    assert sorted(seen) == [3, 6] and set(seen.values()) == {str(run_dir)}
    assert profiles == [2]
    assert (run_dir / "checkpoints" / "iterations_3.npz").exists()
    assert (run_dir / "checkpoints" / "iterations_6.npz").exists()
    assert yaml.safe_load((run_dir / "config.yaml").read_text())["save_model_iterations"] == [3, 6]


def _root_eval():
    spec = importlib.util.spec_from_file_location("root_eval_cli", REPO / "eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _colmap_run(root: Path) -> Path:
    """A run directory written by the JAX package's writers over a generated
    COLMAP scene (its eval split drawn from the global generator), streamed
    by prefetch threads (``data_device_cache: false``), with an untrained
    300-Gaussian checkpoint."""
    from easy_gaussian_splatting_tpu.models.gaussians import init_gaussian_state
    from easy_gaussian_splatting_tpu.training.config import config_from_dict, dump_config
    from easy_gaussian_splatting_tpu.utils.checkpoint import save_checkpoint
    from easy_gaussian_splatting_torch.utils.synthetic import generate_colmap_scene

    data = generate_colmap_scene(root / "colmap", n_images=8, image_size=32, n_gaussians=40,
                                 n_points=300, device="cpu")
    run_dir = root / "run"
    cfg = config_from_dict(dict(data=str(data), data_format="colmap", eval_split_ratio=0.25,
                                renderer="ref", raster_chunk=64, total_iterations=8,
                                data_device_cache=False, dataloader_workers=2, sh_degree=1))
    run_dir.mkdir()
    dump_config(cfg, run_dir / "config.yaml")
    rng = np.random.default_rng(0)
    state = init_gaussian_state(rng.uniform(-1, 1, size=(300, 3)).astype(np.float32),
                                rng.integers(0, 256, size=(300, 3)).astype(np.uint8), 1)
    save_checkpoint(run_dir / "checkpoints" / "iterations_8.npz", state, 1, 8)
    return run_dir


@pytest.mark.parametrize("run", ["blender-trained", "colmap-streamed-jax-written"])
def test_port_eval_matches_root_eval(run, trained, tmp_path, caplog):
    """The repository's ``eval.py`` (JAX) and the port's eval on the same run
    directory: psnr and ssim per split within 1e-3 (the JAX values read from
    its log line, printed to 3 decimals), on a run directory each package
    wrote. On COLMAP data the eval split is drawn from the re-seeded global
    generator, so equal metrics per split show the same split; those frames
    stream through prefetch threads."""
    run_dir = trained[1] if run == "blender-trained" else _colmap_run(tmp_path)
    caplog.set_level(logging.INFO)
    _root_eval().eval(str(run_dir))
    pattern = re.compile(r"evaluation in\s+(train|eval) set: psnr=\s*([\d.]+), ssim=\s*([\d.]+)")
    jax_m = {m.group(1): (float(m.group(2)), float(m.group(3)))
             for m in map(pattern.search, caplog.messages) if m}
    assert set(jax_m) == {"train", "eval"}
    caplog.clear()
    port = teval.eval(run_dir, device="cpu")
    assert len([m for m in caplog.messages if "evaluation in" in m]) == 2
    for split, (psnr, ssim) in jax_m.items():
        assert abs(port[split]["psnr"] - psnr) <= 1e-3, (split, port[split]["psnr"], psnr)
        assert abs(port[split]["ssim"] - ssim) <= 1e-3, (split, port[split]["ssim"], ssim)


def test_validate_e2e_at_a_few_steps(tmp_path):
    """The e2e script end to end at 20 steps: the run directory it leaves
    holds the config and the checkpoint, and the port's eval reads it."""
    out = validate_e2e.main([
        "--iters", "20", "--size", "32", "--cameras", "4", "--gt-gaussians", "20",
        "--init-points", "60", "--renderer", "ref", "--min-psnr", "5", "--out", str(tmp_path),
        "--device", "cpu",
    ])
    assert out["passed"] and np.isfinite(out["psnr"]) and out["gaussians"] > 0
    run_dir = tmp_path / "run"
    assert out["run_dir"] == run_dir
    assert (run_dir / "config.yaml").exists() and (run_dir / "cameras.json").exists()
    assert (run_dir / "checkpoints" / "iterations_20.npz").exists()
    assert len(list((tmp_path / "data" / "test").glob("r_*.png"))) == 2
    results = teval.eval(run_dir, device="cpu")
    np.testing.assert_allclose(results["eval"]["psnr"], out["psnr"], rtol=1e-5)
    failed = validate_e2e.main([
        "--iters", "4", "--size", "32", "--cameras", "4", "--gt-gaussians", "20",
        "--init-points", "60", "--renderer", "ref", "--min-psnr", "99", "--out",
        str(tmp_path / "gate"), "--device", "cpu",
    ])
    assert not failed["passed"]


def test_eval_renders_a_split_again_on_overflow(tmp_path, caplog):
    """A capacity below a frame's intersection count truncates that frame;
    the eval then renders the split again with the capacity grown, logs it,
    and its images equal the untruncated renders bit for bit."""
    from easy_gaussian_splatting_torch.models.gaussians import (
        compact_for_inference,
        init_gaussian_state,
    )
    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.scene.scene import Scene
    from easy_gaussian_splatting_torch.training.config import config_from_dict
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn
    from easy_gaussian_splatting_torch.utils.synthetic import generate_blender_scene

    data = generate_blender_scene(tmp_path / "scene", n_train=2, n_test=2, image_size=48,
                                  n_gaussians=20, device="cpu")
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.0, 1.0, size=(400, 3)).astype(np.float32)
    state = compact_for_inference(init_gaussian_state(
        xyz, rng.integers(0, 256, size=(400, 3)).astype(np.uint8), 0, device="cpu"))
    cfg = config_from_dict(dict(data=str(data), data_format="blender", white_background=True,
                                eval_in_test=True, blender_init_points=50, total_iterations=2,
                                tile_size=16, eval_render_num=10, data_device_cache=False,
                                dataloader_workers=0))
    scene = Scene.from_config(cfg)
    bg = torch.ones(3)
    roomy = teval.evaluate_split(dataclasses.replace(cfg), scene, "eval", state, 0, bg)
    assert roomy["rerenders"] == 0 and roomy["max_isects"] <= roomy["isect_cap"]
    small = dataclasses.replace(cfg, isect_mult=0.5 * roomy["max_isects"] / state.capacity)
    tight = dataclasses.replace(small)
    caplog.set_level(logging.WARNING)
    again = teval.evaluate_split(tight, scene, "eval", state, 0, bg)
    assert again["rerenders"] == 1 and again["max_isects"] <= again["isect_cap"]
    assert tight.isect_mult > small.isect_mult  # the grown capacity is kept
    assert "rendering the split again" in caplog.text
    renders = sorted(k for k in roomy if k.startswith("render_"))
    assert renders == ["render_1", "render_2"]
    for k in renders:
        np.testing.assert_array_equal(again[k], roomy[k])
    for k in ("psnr", "ssim", "lpips_proxy"):
        assert again[k] == roomy[k], k
    # the first pass was truncated: a frame at the small capacity differs
    differs = []
    for i in range(scene.nbr_data("eval")):
        d = scene.get_data("eval", i)
        cam = CameraView(torch.as_tensor(d["w2c"]), torch.as_tensor(d["K"]), d["width"],
                         d["height"])
        cut = get_render_fn(small)(state.params, state.alive, cam, 0, bg).image
        full = get_render_fn(tight)(state.params, state.alive, cam, 0, bg).image
        differs.append(not torch.equal(cut, full))
    assert any(differs)
