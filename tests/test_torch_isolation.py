"""The port stands alone: it imports nothing of JAX, Flax or the JAX package,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import easy_gaussian_splatting_torch as egt

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "easy_gaussian_splatting_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import easy_gaussian_splatting_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "easy_gaussian_splatting_tpu") and sys.modules[m] is not None]
print(len(names), bad)
print(" ".join(names))
"""

# the training path's modules, each of which must be among those imported
TRAINING_MODULES = (
    "ops.clip", "ops.ssim", "ops.lr_schedule", "ops.kernels.segments",
    "ops.kernels.group_reduce", "models.loss", "models.optimizer",
    "models.density", "scene.scene", "utils.tb", "training.trainer",
    "scene.image_io", "scene.types", "scene.colmap", "scene.blender",
    "scene.device_cache", "native", "utils.synthetic", "utils.profiling",
    "training.graphs", "evaluation.metrics", "evaluation.lpips", "evaluation.evaluator",
    "train", "eval", "validate_e2e", "viewer.integration", "utils.logging",
    "parallel", "parallel.mesh", "parallel.distributed", "parallel.collectives",
    "parallel.shard", "parallel.gauss_shard", "bench",
)
# the one string of the port that names the JAX package: the checkpoint
# format tag both packages write and read
SHARED_TAGS = {"easy_gaussian_splatting_tpu/v1"}


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.strip().split("\n")
    n, bad = counts.split(maxsplit=1)
    assert int(n) >= 30 and bad.strip() == "[]"
    imported = set(names.split())
    for mod in TRAINING_MODULES:
        assert f"easy_gaussian_splatting_torch.{mod}" in imported, mod


def _code_strings(path: Path):
    """The string constants of a Python file that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {
        id(node.body[0].value) for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
        and node.body and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
    }
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs]


def test_port_names_no_path_inside_the_jax_package():
    """No code of the port (outside its comments and docstrings, which cite
    each function's counterpart) names anything inside
    ``easy_gaussian_splatting_tpu``: the native library builds from the
    port's own copy of its source, and no kernel reads the JAX package's
    files."""
    pkg = REPO / "easy_gaussian_splatting_torch"
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        bad += [(path.name, line, v) for line, v in _code_strings(path)
                if "easy_gaussian_splatting_tpu" in v and v not in SHARED_TAGS]
    for path in sorted([*pkg.rglob("*.cu"), *pkg.rglob("*.cuh"), *pkg.rglob("*.cpp")]):
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
        if "easy_gaussian_splatting_tpu" in code:
            bad.append((path.name, 0, "code"))
    assert not bad
    from easy_gaussian_splatting_torch import native

    assert native._SRC == pkg / "native" / "egs_native.cpp" and native._SRC.exists()
    assert native.BUILD_DIR == REPO / "build" / "native"


def test_entry_points_refuse_cpu_unless_asked(monkeypatch, tmp_path):
    from easy_gaussian_splatting_torch.launch_viewer import build_viewer
    from easy_gaussian_splatting_torch.models.gaussians import (
        init_gaussian_state,
        params_from_numpy,
    )
    from easy_gaussian_splatting_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xyz = np.random.default_rng(0).uniform(size=(10, 3)).astype(np.float32)
    rgb = np.zeros((10, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        egt.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gaussian_state(xyz, rgb, 0)
    state = init_gaussian_state(xyz, rgb, 0, device="cpu")
    path = tmp_path / "checkpoints" / "iterations_1.npz"
    save_checkpoint(path, state, 0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({k: np.zeros((1, 3)) for k in ("means",)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_viewer(tmp_path)
    from easy_gaussian_splatting_torch.training.config import config_from_dict
    from easy_gaussian_splatting_torch.training.trainer import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(config_from_dict(dict(data_device_cache=False)), scene=object())
    # the command lines: each refuses before it writes anything
    from easy_gaussian_splatting_torch import eval as teval
    from easy_gaussian_splatting_torch import train as ttrain
    from easy_gaussian_splatting_torch import validate_e2e

    (tmp_path / "config.yaml").write_text("{}")
    for main, argv in (
        (ttrain.main, ["-c", str(REPO / "configs" / "nerf_synthetic.yaml"), "-d", str(tmp_path),
                       "-o", str(tmp_path / "out")]),
        (teval.main, ["-p", str(tmp_path)]),
        (validate_e2e.main, ["--iters", "2", "--out", str(tmp_path / "e2e")]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not (tmp_path / "out").exists() and not (tmp_path / "e2e").exists()
    assert egt.resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds only the script, it exits non-zero and
    prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
