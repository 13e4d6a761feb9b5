"""The port's benchmark (``easy_gaussian_splatting_torch/bench.py``) on the
CPU, held to the repository's ``bench.py`` on the same seeded scene at a
tiny size (2,000 Gaussians, 64x64, tile 32): the intersection count, the
tuned binning, the capacity and the byte model are equal exactly. The
root script's point runs its jitted step once; its tuned fields and bytes
are restated here over the JAX package's functions, as it computes them.
Then the port's points (B = 1 and 2) and its ``main``: one JSON line with
the root's keys, the matrix, and a failing or truncated point that raises."""

import importlib.util
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_gaussian_splatting_torch import bench as tbench

REPO = Path(__file__).resolve().parent.parent
N, H, W, TILE, MARGIN = 2000, 64, 64, 32, 1.2
ROOT_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"step_ms", "gaussians", "image", "mpix_per_s", "backend", "scale_probe"}


def _root_bench():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root_point():
    """The root script's point (its one step call in this file), and its
    tuned fields and per-view bytes restated from ``bench.py:55-105`` and
    ``:164-175`` over the JAX package's functions."""
    from easy_gaussian_splatting_tpu.models.gaussians import init_gaussian_state
    from easy_gaussian_splatting_tpu.ops.rasterize_tiled import (
        BUDGET_CANDIDATES,
        _ov_capacity,
        make_isect_counter,
        max_isect_cap,
    )
    from easy_gaussian_splatting_tpu.training.config import config_from_dict

    out = _root_bench().bench_point(N, H, W, TILE, MARGIN, iters=1)

    rng = np.random.default_rng(0)
    xyzs = rng.uniform(-1.5, 1.5, size=(N, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(N, 3)).astype(np.uint8)
    model = init_gaussian_state(xyzs, rgbs, sh_degree=3, capacity=None)
    cfg = config_from_dict(dict(renderer="tiled", white_background=True, tile_size=TILE))
    K = jnp.array([[1111.0, 0, W / 2], [0, 1111.0, H / 2], [0, 0, 1.0]], jnp.float32)
    w2c = jnp.eye(4, dtype=jnp.float32).at[2, 3].set(4.0)
    counter = make_isect_counter(cfg.tile_size, cfg.max_tiles, cfg.max_tiles)
    vals = np.asarray(counter(model.params, model.alive, w2c, K, height=H, width=W))
    n_isect = int(vals[0])
    cap_lim = max_isect_cap(cfg.isect_hbm_budget_mb)
    cfg.isect_mult = math.floor(
        min(max(0.25, n_isect * MARGIN / model.capacity), cap_lim / model.capacity) * 1e3) / 1e3
    m_cells = cfg.max_tiles * cfg.max_tiles
    best_dom = None
    for bb, need in zip(BUDGET_CANDIDATES, vals[2:]):
        if bb >= m_cells:
            continue
        ovf = round(max(0.01, min(1.0, int(need) * 2.0 / model.capacity)), 3)
        dom = model.capacity * bb + m_cells * _ov_capacity(model.capacity, ovf)
        if best_dom is None or dom < best_dom:
            cfg.small_budget, cfg.ov_frac, best_dom = bb, ovf, dom
    cap = model.capacity
    domain = cap * cfg.small_budget + m_cells * _ov_capacity(cap, cfg.ov_frac)
    icap = int(cap * cfg.isect_mult)
    per_view = (cap * (236 * 2 + 236 * 2 + 472 * 2) + icap * (64 * 3 + 48 * 3)
                + domain * 16 + H * W * 3 * 4 * 6)
    assert n_isect == out["isects"]
    assert round(per_view / 819e9 * 1e3, 2) == out["sol_ms"]  # the root's own roofline
    return dict(out=out, isects=out["isects"], isect_mult=cfg.isect_mult,
                small_budget=cfg.small_budget, ov_frac=cfg.ov_frac, capacity=cap,
                sol_bytes=per_view)


@pytest.fixture(scope="module")
def port_point():
    p = tbench.prepare_point(N, H, W, TILE, MARGIN, device="cpu")
    return dict(isects=p.n_isect, isect_mult=p.cfg.isect_mult, small_budget=p.cfg.small_budget,
                ov_frac=p.cfg.ov_frac, capacity=p.model.capacity,
                sol_bytes=tbench.sol_bytes(p.cfg, p.model.capacity, H, W))


@pytest.mark.parametrize("field", ["isects", "isect_mult", "small_budget", "ov_frac",
                                   "capacity", "sol_bytes"])
def test_point_equals_root_bench(root_point, port_point, field):
    assert port_point[field] == root_point[field]
    assert type(port_point[field]) is type(root_point[field])


@pytest.mark.parametrize("batch", [1, 2])
def test_bench_point_on_cpu(root_point, batch):
    out = tbench.bench_point(N, H, W, TILE, MARGIN, iters=1, batch=batch, device="cpu")
    want = set(root_point["out"]) | ({"camera_batch"} if batch > 1 else set())
    assert set(out) == want
    assert out["isects"] == root_point["isects"] and out["gaussians"] == N
    assert out.get("camera_batch", 1) == batch
    assert out["bw_util"] is None  # the card's bound is no share of a CPU step
    sol_ms = batch * root_point["sol_bytes"] / tbench.HBM_BYTES_PER_S * 1e3
    assert out["sol_ms"] == sol_ms
    assert math.isfinite(out["step_ms"]) and out["step_ms"] > 0
    assert out["it_per_s"] == pytest.approx(batch * 1e3 / out["step_ms"])


def test_a_truncated_step_raises(monkeypatch):
    """A last step with more intersections than rows fails the point."""
    monkeypatch.setattr(tbench, "isect_capacity", lambda capacity, mult: 1)
    with pytest.raises(RuntimeError, match="it was truncated"):
        tbench.bench_point(N, H, W, TILE, MARGIN, iters=1, device="cpu")


def _json_lines(text: str):
    found = []
    for line in text.splitlines():
        try:
            found.append(json.loads(line))
        except ValueError:
            pass
    return found


def test_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "ITERS_SMALL", 1)
    result = tbench.main([str(N), str(H), str(W), "--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert _json_lines(out) == [result] and json.loads(lines[-1]) == result
    assert set(result) == ROOT_KEYS and set(result["detail"]) == DETAIL_KEYS
    assert result["metric"] == "train_iters_per_sec" and result["unit"] == "it/s"
    assert result["vs_baseline"] == result["value"] / tbench.BASELINE_ITERS_PER_SEC
    detail = result["detail"]
    assert detail["backend"] == "cpu" and detail["image"] == f"{W}x{H}"
    (probe,) = detail["scale_probe"]
    assert probe["gaussians"] == N and "error" not in probe
    assert result["value"] == probe["it_per_s"] and detail["step_ms"] == probe["step_ms"]
    assert lines[0].startswith(f"bench: {N} gaussians, B 1, {W}x{H} on cpu")


def _fake_points(monkeypatch, fail_at=None):
    calls = []

    def fake(n, h, w, tile_size, margin, iters, batch, device):
        calls.append((n, h, w, tile_size, margin, iters, batch))
        if len(calls) == fail_at:
            raise RuntimeError("the card faulted")
        out = dict(gaussians=n, step_ms=10.0 * batch, it_per_s=100.0, isects=1,
                   mpix_per_s=1.0, sol_ms=0.1, bw_util=0.01)
        return dict(out, camera_batch=batch) if batch > 1 else out

    monkeypatch.setattr(tbench, "bench_point", fake)
    return calls


def test_main_runs_the_matrix(monkeypatch, capsys):
    calls = _fake_points(monkeypatch)
    result = tbench.main(["--device", "cpu"])
    assert calls == [(100_000, 800, 800, 32, 1.2, 30, 1), (1_000_000, 800, 800, 32, 1.2, 15, 1),
                     (3_000_000, 800, 800, 32, 1.2, 15, 1), (100_000, 800, 800, 32, 1.2, 15, 4)]
    assert [p["gaussians"] for p in result["detail"]["scale_probe"]] == [
        100_000, 1_000_000, 3_000_000, 100_000]
    assert result["detail"]["scale_probe"][-1]["camera_batch"] == 4
    assert _json_lines(capsys.readouterr().out) == [result]
    calls.clear()
    tbench.main(["500000", "600", "400", "16", "1.5", "--batch=2", "--device", "cpu"])
    assert calls == [(500_000, 600, 400, 16, 1.5, 15, 2)]


@pytest.mark.parametrize("argv,fail_at", [(["--device", "cpu"], 2),
                                          ([str(N), "--device", "cpu"], 1)])
def test_a_failing_point_raises(monkeypatch, capsys, argv, fail_at):
    """No retry and no ``error`` entry: the failure propagates and nothing
    is printed as a result."""
    calls = _fake_points(monkeypatch, fail_at=fail_at)
    with pytest.raises(RuntimeError, match="the card faulted"):
        tbench.main(argv)
    assert len(calls) == fail_at
    assert _json_lines(capsys.readouterr().out) == []


def test_main_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = _fake_points(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([str(N)])
    assert calls == []
