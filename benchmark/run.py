"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``) and metrics; the cell's correctness limits
are ``limits/<cell>.json``. A run makes its inputs from the seed, sets up
(the program's imports, the CUDA context, the inputs, the binning's
tuning, the first steps or frames, which capture the program's CUDA
graphs), measures for ``--seconds``, with ``--trace 1`` then profiles a few
more steps or frames, frees the program's state and decides ``correct``
against the plain reference. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, then ``checks``); the numbers compared, each
beside its limit, are also the last lines of standard error.

Exits 2 without a result when no CUDA device is there or fewer than the
cell asks for, and 3 when ``jax``, ``jaxlib``, ``flax`` or the JAX package
was imported. The kernels' builds stay in the checkout
(``build/torch_kernels/``, the port's own path) and so would Triton's cache
(``build/triton_cache/``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "easy_gaussian_splatting_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, name: str, override: dict | None = None):
    """The cell ``name`` of ``spec``, its configuration, traffic mix and
    limits, found by name. ``override`` (tests only) updates groups of the
    configuration, or the mix under ``"traffic"``: ``{"scene":
    {"gaussians": 2000}, "traffic": {"width": 64}}``."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {', '.join(cells)}")
    cell = cells[name]
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    mix = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    for group, values in (override or {}).items():
        if group == "traffic":
            mix.update(values)
        else:
            config[group] = {**config.get(group, {}), **values}
    return cell, config, mix, limits


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports the per-layer ``metric``: it is listed, or
    the metric lists no cells and moves an end-to-end metric the cell
    reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules(names=None) -> list:
    """The forbidden top-level packages among ``names`` (default: every
    module imported), compared by whole top-level names."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader reads: the cell and its kind, the
    measured window (``measured``), the profiled window (``window``, a
    ``trace.Window``) and the work each traced step or frame needs
    (``counts``)."""

    def __init__(self, cell: str, kind: str, measured: dict, window, counts):
        self.cell, self.kind = cell, kind
        self.measured, self.window, self.counts = measured, window, counts


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool, device="cuda",
             override=None, t_start: float | None = None):
    """One run of cell ``name``: (result dict, the numbers compared with
    their limits); ``override`` as :func:`cell_files` takes it."""
    import torch

    from . import cells, trace as tracing

    t_start = T_START if t_start is None else t_start
    cell, config, mix, limits = cell_files(spec, name, override)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    runner = cells.kind(mix["kind"])(config, mix, seed, dev)
    runner.setup()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_reserved(dev)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    captures, first = runner.captures(), runner.i
    measured = runner.window(seconds)
    reserved = torch.cuda.max_memory_reserved(dev) if cuda else 0
    program_peak = max(setup_peak, reserved)  # read before any of the yardstick's work
    print(f"bench: {name} seed {seed}: set-up {setup_s:.3f} s (peak reserved "
          f"{setup_peak / 2**30:.3f} GiB), {measured['units']} {mix['kind']} units in "
          f"{measured['wall_s']:.3f} s, {runner.captures() - captures} captures inside the "
          f"window; {runner.describe()}", flush=True)
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    values = {"setup_s": setup_s, "peak_mem_gib": reserved / 2**30 if cuda else None}
    values.update({k: v for k, v in measured.items() if isinstance(v, float)})
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in e2e if values.get(m["name"]) is not None}
    extra = {}
    if trace:
        units = mix["trace_units"]
        window = tracing.profile(runner.traced_units, units, runner.launches, dev)
        if cuda:
            program_peak = max(program_peak, torch.cuda.max_memory_reserved(dev))
        counts = runner.work_counts(runner.unit_views(runner.i - units, units))
        ctx = Context(name, mix["kind"], measured, window, counts)
        metrics = {}
        for m in spec["per_layer"]:
            if reports(m, name, [x["name"] for x in e2e]):
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": window.busy_s, "window_s": window.window_s}
        breakdown = window.breakdown()
    attempted = runner.i - first  # the window's steps or frames, and the traced ones
    runner.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = runner.compare(runner.reference())
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": runner.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": cell["chips"] if cuda else 1,  # the cards the run uses
            "memory_peak_bytes": int(program_peak),
            "power_limit_w": power_limit() if cuda else None,
            **extra,
        },
    }
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = cell_files(spec, args.workload)[0]
    # the build and kernel caches of the program, at fixed paths in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"bench: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
