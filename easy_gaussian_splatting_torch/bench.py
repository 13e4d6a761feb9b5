"""Benchmark: the whole train step's throughput on the card; counterpart of
the repository's ``bench.py``.

    python -m easy_gaussian_splatting_torch.bench [N] [H W] [tile_size] [margin] [--batch B]
        [--device cuda]

The arguments and defaults of the root script, plus ``--device``. Self-
contained (no dataset): at each point a synthetic scene of N Gaussians
(uniform in [-1.5, 1.5]^3, SH degree 3, seeded), one 800x800 camera
(f = 1111, four units from the origin) and a random target image; the
binning is tuned on that frame as the trainer's autotune does; then the
complete train step (projection, binning, the tiled CUDA kernels forward
and backward, L1 + SSIM, densify statistics, grouped Adam) is timed after
its capture. With no N, the matrix: 100k, 1M and 3M Gaussians (the
nerf_synthetic mid-train point, the tandt_db mid-train point and the
densified end state), then 100k at B = 4 camera views a step.

On the card the step is ``training/graphs.py::GraphedTrainStep`` over
``make_train_step`` (or ``make_batched_train_step``), the counterpart of
the JAX step's ``jax.jit`` with donation: its first call captures, and the
timed calls replay, the state flowing from each call into the next. With
``--device cpu`` the step runs eagerly on the kernels' plain versions.

Each point logs a line (capacity, tuned binning, its capture, the step,
peak allocated and reserved device memory); the last line of stdout is
ONE JSON object with the root script's keys: ``metric``, ``value`` (the
first point's iterations a second), ``unit``, ``vs_baseline`` (over 10
it/s, the estimate derived in BASELINE.md) and ``detail`` with every
point under ``scale_probe``. ``backend`` names the card. Numbers are
unrounded. Unlike the root script, which retries a failed point and then
records its error, a failed point raises (an error, a truncated step, a
second capture): the command exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from . import resolve_device
from .models.gaussians import GaussianModelState, _round_up_capacity, init_gaussian_state
from .models.optimizer import AdamState, init_adam_state
from .ops.rasterize_tiled import _ov_capacity, isect_capacity, make_isect_counter
from .training.config import Config, config_from_dict
from .training.trainer import (
    get_render_fn,
    make_batched_train_step,
    make_train_step,
    tuned_binning,
)

BASELINE_ITERS_PER_SEC = 10.0
DEFAULT_PROBE_NS = (100_000, 1_000_000, 3_000_000)
DEFAULT_BATCHED_POINTS = ((100_000, 4),)  # (N, B), run only with no N given
# timed steps a point: fewer above ITERS_SMALL_N gaussians (the steps are
# ~10x longer) and at the batched point
ITERS_SMALL, ITERS_LARGE, ITERS_BATCHED = 30, 15, 15
ITERS_SMALL_N = 300_000
# NVIDIA H100 SXM5 (80 GB HBM3): memory bandwidth from the data sheet, B/s
HBM_BYTES_PER_S = 3.35e12
LR_MEANS = 1e-3


@dataclasses.dataclass
class Point:
    """One benchmark point, ready to step: the tuned config, the state, the
    first frame's intersection count and ``step``, one train step
    ``(model, adam) -> (model, adam, loss dict)`` (on the card a replay of
    ``graphed``, a capture at its first call)."""

    cfg: Config
    model: GaussianModelState
    adam: AdamState
    n_isect: int
    step: Callable
    graphed: Any  # the GraphedTrainStep on the card, else None


def sol_bytes(cfg: Config, capacity: int, height: int, width: int) -> int:
    """The bytes one view's step must move at the least (the root script's
    model of the algorithm's work): parameters and Adam state (forward and
    backward reads, the update's read and write), the per-intersection
    features (packed, read by both kernels) and gradient rows (written,
    read by the reduction), one pass of the binning sort over its two
    populations (key and payload, read and write), and the loss images."""
    m_cells = cfg.max_tiles * cfg.max_tiles
    domain = capacity * cfg.small_budget + m_cells * _ov_capacity(capacity, cfg.ov_frac)
    icap = int(capacity * cfg.isect_mult)
    return (capacity * (236 * 2 + 236 * 2 + 472 * 2)
            + icap * (64 * 3 + 48 * 3)
            + domain * 16
            + height * width * 3 * 4 * 6)


def prepare_point(n: int, h: int, w: int, tile_size: int = 32, margin: float = 1.2,
                  batch: int = 1, device="cuda") -> Point:
    """The point's seeded scene, state, tuned binning and step (the root
    script's draws, in its order)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    xyzs = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    # the default capacity leaves 1.3x headroom (the trainer's growth
    # target); from 2M on the per-slot memory asks for a tight ladder rung
    capacity = None if n < 2_000_000 else _round_up_capacity(int(n * 1.05))
    model = init_gaussian_state(xyzs, rgbs, sh_degree=3, capacity=capacity, device=dev)
    adam = init_adam_state(model.params)
    cfg = config_from_dict(dict(renderer="tiled", white_background=True, tile_size=tile_size))
    K = torch.tensor([[1111.0, 0, w / 2], [0, 1111.0, h / 2], [0, 0, 1.0]],
                     dtype=torch.float32, device=dev)
    w2c = torch.eye(4, dtype=torch.float32, device=dev)
    w2c[2, 3] = 4.0
    # the binning sized on this frame as the trainer's autotune sizes it
    counter = make_isect_counter(cfg.tile_size, cfg.max_tiles, cfg.max_tiles)
    vals = counter(model.params, model.alive, w2c, K, height=h, width=w).cpu().numpy()
    cfg.isect_mult, cfg.small_budget, cfg.ov_frac = tuned_binning(cfg, vals, model.capacity, margin)
    n_isect = int(vals[0])
    image = torch.as_tensor(rng.uniform(size=(h, w, 3)).astype(np.float32), device=dev)
    mask = torch.zeros((h, w), dtype=torch.float32, device=dev)
    if batch > 1:
        # B distinct views a step: x shifted by 0.05 i, the target rolled by i
        w2cs = w2c.repeat(batch, 1, 1)
        w2cs[:, 0, 3] += torch.tensor([0.05 * i for i in range(batch)], device=dev)
        frame = (w2cs, K.repeat(batch, 1, 1),
                 torch.stack([torch.roll(image, i, dims=0) for i in range(batch)]),
                 mask.repeat(batch, 1, 1))
        step_fn = make_batched_train_step(cfg, get_render_fn(cfg))
    else:
        frame = (w2c, K, image, mask)
        step_fn = make_train_step(cfg, get_render_fn(cfg))
    graphed = None
    if dev.type == "cuda":
        from .training.graphs import GraphedTrainStep

        step_fn = graphed = GraphedTrainStep(cfg, step_fn, dev)

    def step(model, adam):
        return step_fn(model, adam, *frame, LR_MEANS, True, False, False,
                       height=h, width=w, sh_degree=3)

    return Point(cfg, model, adam, n_isect, step, graphed)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _force(n: int, model: GaussianModelState, ld) -> None:
    """Read values that depend on the last step (``means[0, 0]`` and the
    loss): they must be finite."""
    last = float(model.params.means[0, 0]) + float(ld["total"])
    if not math.isfinite(last):
        raise RuntimeError(f"{n} gaussians: the last step's means[0, 0] + loss is {last}")


def bench_point(n: int, h: int, w: int, tile_size: int = 32, margin: float = 1.2,
                iters: int = ITERS_SMALL, batch: int = 1, device="cuda") -> Dict[str, Any]:
    """One point: the step called once (the capture on the card), then
    ``iters`` calls timed on the host clock between two synchronizes; logs
    the point's line and returns its ``scale_probe`` entry. Raises if the
    last step was truncated (more intersections than rows) or, on the card,
    if a timed call captured again."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    p = prepare_point(n, h, w, tile_size, margin, batch, dev)
    setup_s = time.perf_counter() - t0
    model, adam, ld = p.step(p.model, p.adam)  # on the card, the capture
    _force(n, model, ld)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        model, adam, ld = p.step(model, adam)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    _force(n, model, ld)
    cap = model.capacity
    icap = isect_capacity(cap, p.cfg.isect_mult)
    if int(ld["isects"]) > icap:
        raise RuntimeError(f"{n} gaussians: the last step binned {int(ld['isects'])} "
                           f"intersections into {icap} rows: it was truncated")
    sol_ms = batch * sol_bytes(p.cfg, cap, h, w) / HBM_BYTES_PER_S * 1e3
    line = (f"bench: {n} gaussians, B {batch}, {w}x{h} on {dev}: capacity {cap}, "
            f"{p.n_isect} intersections, isect_mult {p.cfg.isect_mult}, small_budget "
            f"{p.cfg.small_budget}, ov_frac {p.cfg.ov_frac}; set-up (scene, k-NN, autotune) "
            f"{setup_s:.1f} s; step {dt * 1e3:.3f} ms over {iters} "
            f"calls; last step's isects {int(ld['isects'])} of {icap}")
    if p.graphed is not None:
        caps = p.graphed.captures
        line += f"; {len(caps)} captures (" + "; ".join(
            f"warm-up {c['warmup_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, pool "
            f"{c['pool_bytes'] / 2**20:.1f} MiB" for c in caps) + ")"
        line += (f"; peak allocated {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB, "
                 f"reserved {torch.cuda.max_memory_reserved(dev) / 2**20:.1f} MiB")
        p.graphed.reset()  # the graphs, their pool and the state's buffers
        if len(caps) != 1:
            raise RuntimeError(f"{n} gaussians: {len(caps)} captures, not 1: a timed call "
                               "captured again")
    else:
        line += "; eager, peak memory not measured"
    print(line, flush=True)
    out = {
        "gaussians": n,
        "step_ms": dt * 1e3,
        "it_per_s": batch / dt,  # views (reference iterations) a second
        "isects": p.n_isect,
        "mpix_per_s": batch * h * w / dt / 1e6,
        "sol_ms": sol_ms,
        # the card's bound over its step: no share off the card
        "bw_util": sol_ms / (dt * 1e3) if dev.type == "cuda" else None,
    }
    if batch > 1:
        out["camera_batch"] = batch
    return out


def main(argv: List[str] | None = None) -> Dict[str, Any]:
    """Run the matrix (no N) or one point; print and return the result."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("point", nargs="*", help="[N] [H W] [tile_size] [margin]")
    parser.add_argument("--batch", type=int, default=1, help="camera views a step")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_intermixed_args(argv)
    pos, batch = args.point, args.batch
    dev = resolve_device(args.device)
    h, w = 800, 800
    tile_size, margin = 32, 1.2
    if len(pos) >= 3:
        h, w = int(pos[1]), int(pos[2])
    if len(pos) >= 4:
        tile_size = int(pos[3])
    if len(pos) >= 5:
        margin = float(pos[4])
    # (N, B, timed steps): one point, or the matrix and the batched points
    points = [(n, batch, ITERS_SMALL if n <= ITERS_SMALL_N else ITERS_LARGE)
              for n in ([int(pos[0])] if pos else DEFAULT_PROBE_NS)]
    if not pos:
        points += [(n, b, ITERS_BATCHED) for n, b in DEFAULT_BATCHED_POINTS]
    probes = []
    for n, b, iters in points:
        probes.append(bench_point(n, h, w, tile_size, margin, iters=iters, batch=b, device=dev))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    head = probes[0]
    result = {
        "metric": "train_iters_per_sec",
        "value": head["it_per_s"],
        "unit": "it/s",
        "vs_baseline": head["it_per_s"] / BASELINE_ITERS_PER_SEC,
        "detail": {
            "step_ms": head["step_ms"],
            "gaussians": head["gaussians"],
            "image": f"{w}x{h}",
            "mpix_per_s": head["mpix_per_s"],
            "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
            "scale_probe": probes,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
