"""CPU tests of the benchmark's harness: ``BENCHMARK.json`` against its
contract, the lookups by name, the arithmetic of the metrics and the
yardstick, the import rules, and a run of each kind of cell at a small
size on the CPU (the kernels' plain versions, the step and the render
eager).

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, run, trace, yardstick
from benchmark.reference import render as ref_render

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a small size of each configuration for the CPU: a few thousand Gaussians
# at their capacity rule's rung, frames of tens of pixels
SMALL = {
    "tandt_db": {"gaussians": 3000, "capacity": 4096, "width": 96, "height": 64, "views": 6,
                 "fx": 58.0, "fy": 58.0},
    "nerf_synthetic": {"gaussians": 2000, "capacity": 3072, "width": 64, "height": 64,
                       "views": 6, "fx": 88.9, "fy": 88.9},
}


def small(cell: str, **traffic) -> dict:
    """The override of ``cell`` at its small size; a serve cell's frames at
    the configuration's own size, where the viewer's tuning holds."""
    scene = SMALL[cell.split(".")[0]]
    mix = dict(traffic)
    if cell.endswith(".serve"):
        mix.update(width=scene["width"], height=scene["height"])
    return {"scene": scene, "traffic": mix}


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists()
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"train_views_per_s", "frame_ms_p95", "peak_mem_gib", "setup_s"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_every_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        cell, config, mix, limits = run.cell_files(SPEC, w["name"])
        assert config["name"] == w["config"] and callable(cells.kind(mix["kind"]))
        assert limits and all("limit" in v for v in limits.values())
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = [m for m in SPEC["per_layer"] if run.reports(m, w["name"], e2e)]
        assert per_layer, w["name"]
        for m in per_layer:
            assert m["moves"] in e2e
            assert callable(run.metric_reader(m["name"]))


def test_config_capacity_is_the_programs_rule():
    from easy_gaussian_splatting_torch.models.gaussians import _round_up_capacity

    for c in SPEC["configs"]:
        scene = json.loads((ROOT / c["file"]).read_text())["scene"]
        assert scene["capacity"] == _round_up_capacity(int(scene["gaussians"] * 1.3))


def test_p95_and_rate_take_every_sample():
    values = list(range(1, 101))  # 1..100 ms
    assert cells.p95(values) == pytest.approx(95.05)
    assert cells.p95([5.0] * 19 + [100.0]) == pytest.approx(5.0 + 0.05 * 95.0)
    # the rate is all the window's views over all its time
    assert 330 / 20.5 == pytest.approx(16.097560975609756)


def test_yardstick_counts_by_hand():
    # 4 tiles of 1024 pixels, 100 live rows, 50 walked, 3000 composited pairs
    c = dict(tiles=4, tile_pixels=1024, pixels=4000, live_rows=100, walk_rows=50,
             composited=3000)
    fwd_bytes = 50 * 64 + 5 * 4 + 1024 * 32 + 4000 * 20
    bwd_bytes = 100 * 128 + 5 * 4 + 1024 * 32 + 4000 * 24
    assert yardstick.forward_bound_s(c) == pytest.approx(
        max(fwd_bytes / 3.35e12, 30 * 3000 / 67e12))
    assert yardstick.backward_bound_s(c) == pytest.approx(
        max(bwd_bytes / 3.35e12, 70 * 3000 / 67e12))
    # the step's byte model: 1000 alive Gaussians, 2000 live rows (features,
    # gradient rows and one sort pass), a 20x30 image
    assert yardstick.step_bytes(1000, 2000, 20, 30) == (
        1000 * 1888 + 2000 * (336 + 16) + 20 * 30 * 72)
    # the loss on a 20x30 image: L1 and the SSIM's 11-tap blur of 5 maps x 3 channels
    px, blur = 20 * 30 * 3, 5 * 3 * 2 * 11 * (20 * 20 + 10 * 20)
    formula = 20 * 10 * 20 * 3
    assert yardstick.loss_ops(20, 30) == 6 * px + blur + formula + 2 * px + 2 * (blur + formula)
    assert yardstick.step_ops(10, 20, 30, 7) == (3 * 400 * 10 + 100 * 7
                                                 + yardstick.loss_ops(20, 30) + 14 * 59 * 10)


def test_kernel_names_sort_into_layers():
    assert yardstick.port_kernel("void tile_forward_kernel<32>(float const*)") == "tiled_forward"
    assert yardstick.port_kernel("tile_backward_kernel") == "tiled_backward"
    assert yardstick.port_kernel("elementwise_kernel") is None
    assert yardstick.GEMM_PATTERN.search("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n")
    assert yardstick.SORT_PATTERN.search("void cub::DeviceRadixSortOnesweepKernel<>")


def test_trace_window_busy_and_gaps():
    dev = [("k1", 1.0, 0.5, "kernel"), ("k2", 1.25, 0.5, "kernel"), ("copy", 2.5, 0.25,
                                                                     "gpu_memcpy")]
    spans = [("bench.window", 0.5, 3.0), ("train.dispatch", 0.5, 0.4),
             ("train.readback", 1.7, 1.0)]
    w = trace.Window(dev, spans, 0.5, 3.5, 2, True)
    assert w.busy_s == pytest.approx(1.0) and w.window_s == pytest.approx(3.0)
    assert w.kernel_s(lambda n: n == "k1") == pytest.approx(0.5)
    b = w.breakdown()
    assert b["device_ops"][0] == ["k1", 0.5] or b["device_ops"][0] == ["k2", 0.5]
    assert b["idle_gaps"][0] == ["train.readback", pytest.approx(0.75)]
    assert sum(g for _, g in b["idle_gaps"]) == pytest.approx(2.0)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("easy_gaussian_splatting_torch",
                                             "easy_gaussian_splatting_tpu", "jax", "jaxlib",
                                             "flax"), (path, mod)


def test_nothing_the_benchmark_runs_imports_jax():
    cells_run = [("nerf_synthetic.train", small("nerf_synthetic.train")),
                 ("tandt_db.serve_native", small("tandt_db.serve_native"))]
    code = (
        "import json\n"
        "from benchmark import run\n"
        "import benchmark.calibrate, easy_gaussian_splatting_torch.training.graphs\n"
        "spec = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        f"for name, ov in {cells_run!r}:\n"
        "    run.run_cell(spec, name, 5, 0.2, False, 'cpu', ov)\n"
        "for m in spec['per_layer']:\n"
        "    run.metric_reader(m['name'])\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    # whole top-level names: the port's name begins with the JAX package's
    assert run.forbidden_modules(["easy_gaussian_splatting_torch.ops", "jaxtyping"]) == []
    assert run.forbidden_modules(["jax.numpy", "easy_gaussian_splatting_tpu", "flax"]) == [
        "easy_gaussian_splatting_tpu", "flax", "jax"]


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "nerf_synthetic.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct_on_the_cpu(cell):
    """The harness end to end at a small size, traced: the program agrees
    with the reference under the cell's limits; the result has the keys the
    contract names, ``checks`` last."""
    res, checks = run.run_cell(SPEC, cell, 2**31 + 12345, 0.5, True, "cpu",
                               small(cell, trace_units=2))
    assert res["correct"], checks
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 3 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                  "window_s"}


def test_same_seed_same_inputs():
    scene = dict(SMALL["tandt_db"], layout="unbounded", camera={"radius": 3.2,
                                                                "height": [-0.8, 0.8]})
    a = cells.inputs.gaussians(scene, 7, "cpu")
    b = cells.inputs.gaussians(scene, 7, "cpu")
    c = cells.inputs.gaussians(scene, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["means"], c["means"])
    assert np.array_equal(cells.inputs.view_order(6, 7, 20), cells.inputs.view_order(6, 7, 20))
    assert np.array_equal(cells.inputs.train_views(scene, 7)[0],
                          cells.inputs.train_views(scene, 7)[0])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000001])
    y = ref_render.tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0  # a tie rounds to even
    assert y[2] == 1.0 + 2**-10 and y[3] == -3.0
    assert math.isclose(float(ref_render.tf32_round(torch.tensor([0.1]))), 0.0999755859375)
