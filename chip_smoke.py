#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0] [--gaussians 1000000] [--ab-parent DIR]
    python3 chip_smoke.py --replay-probe RUNS   # the profiler's lost records

Drives ``easy_gaussian_splatting_torch`` (never the JAX package) through
its offline viewer, the first main path of the port:

1. device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit; no card is a failure;
2. build: every CUDA kernel from ``easy_gaussian_splatting_torch/csrc``,
   one ``nvcc`` per source in parallel, with ``-Xptxas -v``'s report;
3. run directory, from ``--seed`` with numpy: a 1M-Gaussian SH-degree-3
   checkpoint (uniform in [-1.5, 1.5]^3, random opacities and view-
   dependent SH), ``configs/nerf_synthetic.yaml``'s config and a ring of
   800x800 cameras (f = 1111, radius 4, looking at the origin);
4. kernel checks: each kernel's wrapper on the inputs one served
   800x800 frame gives it, held against its plain PyTorch version;
5. serve: the viewer built by ``launch_viewer.build_viewer`` on cuda
   answers ``/cameras`` and three ``/render`` requests (the 800x800
   dataset camera, a 720p orbit, a 180p rung with ``sh_cap: 1``); the
   first frame is held against the same frame from the plain versions,
   every frame must fit its intersection capacity, and both kernels'
   launch counts must rise during the requests (the closure replays a
   CUDA graph captured per frame size; a replay adds the launches its
   capture recorded);
6. numbers: request latency, each kernel's and plain version's time
   (CUDA events; ``binkeys`` also on the device alone), its lower bound on
   this card, the forward's work counts (pairs reached and composited,
   (warp, row) pairs its cull keeps, rows walked per tile), launches per
   frame and peak device memory;

and then through its trainer, the second:

7. training data: the same 1M-Gaussian scene initialised for training
   (``init_gaussian_state``, SH 3) and four 800x800 ring cameras whose
   targets the port's forward renders from a "ground-truth" copy with
   other colours, opacities and view-dependent SH;
8. kernel checks at the inputs of one real train step: ``binkeys``,
   ``tiled_backward`` and ``segsum_band`` against their plain versions,
   and the whole step's parameter gradients with all four kernels against
   the same step with the four plain versions;
9. train: the port's ``train()`` for 40 steps on cuda with
   ``configs/nerf_synthetic.yaml``'s values and a compressed schedule
   (printed), so densify runs at steps 20, 30, 40 and the opacity reset at
   30; the step runs as a CUDA graph per signature (its captures printed;
   so in phases 11, 13 and 15); every kernel's launches rise every step,
   no step is truncated, the loss falls before the first event and the
   checkpoint reloads with its Adam state. A wrapper's launch counter does
   not run on a replay (the graph adds the launches its capture recorded),
   so every replayed step outside the timed ones runs under the profiler:
   the kernels it saw run must equal the counters' increments, one of each
   main-path kernel a step (so the replays of phases 11 (b) and 13 (a); and
   every ``profile_device`` profile holds its kernels to the counters);
10. numbers: step time, both backward kernels' and plain versions' times
   and bounds, the backward's work counts (pairs walked from its warps'
   horizons, composited, kept by its cull), ``tiled_forward`` checked,
   timed and counted on the step's inputs, peak device memory, a profile
   of three steps on the state after the opacity reset, and both tile
   kernels checked, timed and counted again on that step's inputs;

and then through the trainer under the other backward reductions
(``rasterize_tiled.BWD_REDUCE``), the main paths of this part of the port:

11. reductions: for ``band`` (the baseline) and each of ``scan``,
   ``pallas`` and ``dense``: (a) phase 8's step under it, with its kernels
   (``segsum_compact`` and ``monotone_expand``; ``group_reduce``) held
   against their plain versions on that step's inputs, its gradients
   against the band step's, and under ``dense`` the grid binning against
   the ``binkeys`` binning; the kernels' times, plain versions', one
   PyTorch call's (``library_ms``) and bounds; (b) ``train()`` for 12 steps
   on the first ring camera with a schedule compressed so that one densify
   event runs, at step 10 (printed): its kernels' launches rise every step,
   the other reductions' kernels (and under ``dense`` ``binkeys``) never
   run, no step truncates, the loss is finite and falls before the event;
   step time, peak device memory and a profile of three steps;
   ``group_reduce`` (one launch for both of ``dense``'s populations) timed
   back to back and on the device alone behind a device-side wait, beside
   the library's sum of each population;
12. with ``--ab-parent DIR`` (another checkout, the parent commit): its
   ``tiled_forward`` (the served frame, phase 8's and the post-reset
   inputs), ``tiled_backward``, ``group_reduce``, ``binkeys`` (the served
   frame's and phase 8's binning) and ``segsum_compact`` (phase 11's
   ``pallas`` call) beside this tree's on the same recorded inputs, outputs compared, timed parent,
   change, change, parent;

and then through ``train(cfg)`` with no scene object, the path a user of
the data loaders takes:

13. (a) a COLMAP directory written by the port's ``generate_colmap_scene``
   (24 images 800x800 of 20,000 SH-3 ground-truth Gaussians rendered by
   its tiled renderer, ``--gaussians`` sparse points) trained 60 steps with
   ``configs/tandt_db.yaml``'s values and a compressed schedule (printed):
   both frame caches resident, every main-path kernel launched every step,
   no truncation, the loss finite and falling before the one densify
   event, evals at steps 1, 30 and 60 from the eval cache with finite
   metrics (the device latency below the blocking host latency), the
   profiler trace written and the checkpoint reloaded; step medians (host
   clock and CUDA events), loop-iteration medians and peak device memory,
   then the same with each frame streamed from the host
   (``data_device_cache: false``), decoded ahead by the prefetch threads;
   (b) the convergence check of ``scripts/validate_e2e.py``'s defaults,
   through the port's e2e script (``validate_e2e.main``): a 128x128
   Blender scene of 300 SH-0 Gaussians rendered by the port's oracle, 800
   steps, the test frames' PSNR, SSIM and proxy LPIPS after re-seeding;
   below 22 dB fails;

and then through the multi-camera step and the command lines:

14. the batched step (run between phases 12 and 13, on phase 8's state
   and binning): ``make_batched_train_step`` on B = 4 ring views at
   800x800, held against its sequential reference on the card (the max
   difference and whether the two are equal bit for bit printed), run
   twice on the same inputs, ``binkeys``, ``tiled_forward``,
   ``tiled_backward`` and ``segsum_band`` each launched B times a step,
   no view truncated; the median of 10 chained steps, per view, beside
   phase 10's single-view median, and peak device memory;
15. (a) ``python -m easy_gaussian_splatting_torch.eval`` on phase 13 (a)'s
   run directory: the binning tuned again, both splits' metrics finite,
   no frame past its capacity; (b) ``train(cfg)`` on phase 13 (a)'s scene
   with ``view_online`` for 24 steps, a client posting 1280x720 ``/render``
   requests every 16 ms, first from a thread of this process, then from a
   process of its own (as a browser): every request answered from the
   mailbox, every frame rendered by the loop on its own thread and not
   truncated, the step median beside phase 13's cached median;

and then through the multi-device path (``parallel/``), with ranks spawned
from this process (a rank that fails fails the run):

16. (a) phase 8's state and first frame, rendered with 16-pixel tiles (so
   that both 400-row stripes start on a tile edge of the full frame; see
   ``MESH_TILE``), on two gloo ranks sharing the card (NCCL refuses two
   ranks on one device): ``tiles:2`` uniform and adaptive and ``gauss:2``'s
   pre-Adam gradients, absgrad and radii against the single-device render
   of the same windows and, for the uniform stripes, against the full
   frame's single-device step, within ``tests/test_parallel.py``'s bands
   (the adaptive stripes' distance from the full frame's step printed, and
   the same at the config's 32-pixel tiles), each rank's kernel launches
   and binning work (the partition's balance), then one ``gauss:2`` and one
   ``tiles:2`` train step against the single step;
   ``tiles:1`` on a world of one NCCL rank, bit for bit equal to the single
   step; (b) ``train(cfg)`` under ``tiles:2``, then ``gauss:2``, on two gloo
   ranks from phase 13 (a)'s scene (21 steps, the Scene's least; one
   densify event): both finish, the ranks' parameters end bit for bit
   equal, the capacity is the growth arithmetic's, and rank 0's checkpoint
   renders a finite frame in the single-device viewer path. Peak memory and
   the collectives each backend ran, per rank. Two processes time-share one
   card there: their step times are no scaling number;

and then through the compiled step (run after phase 16 (a), before 13, on
phase 8's state and frames and the served model of phases 3-6):

17. (a) 40 steps of phase 9's schedule from phase 8's state compacted to
   the capacity rung above its population (1,048,576): eager, eager with
   the flags and learning rate as 0-d tensors on the card, and through
   ``GraphedTrainStep``; the first densify event grows the capacity, so
   the graphed step captures again; every step's state fingerprint and
   loss scalars and the final state bit for bit equal to the eager run's,
   the captures' times and pools printed, and where each run's memory
   peak rose; then 8 steps over frames of two sizes in turn (800x800 and
   800x600): one capture a size, kept, and bit for bit the eager steps;
   (b) 3 steps eager and graphed
   under each backward reduction (``band``, ``scan``, ``pallas``,
   ``dense``) and under the ``xla`` grid binning, bit for bit equal; (c)
   step medians eager and graphed in the order p c p c p c, the host time
   inside the step call (the loop's ``dispatch`` bucket), and a profile of
   3 steps of each (device busy, idle share, and one of each main-path
   kernel a step seen by the profiler); (d) the served closure at 800x800,
   1280x720 and 320x180, graphed against eager: frames bit for bit equal,
   latency medians, re-renders, captures, and one graphed frame a size
   under the profiler (its kernels equal to the counters' increments);
   (e) peak device memory of (a) and (d);

and then through the JAX package's other jitted programs as CUDA graphs
(``training/graphs.py``), each against its eager version:

18. (a) (after phase 14, on phase 8's state) phase 14's 10 batched steps
   eager and through ``GraphedTrainStep`` over ``make_batched_train_step``
   in turn, p c p c p c, every run bit for bit the first eager run's (each step's state
   fingerprint and loss scalars, the final state); step medians, peak
   memory above each run's start, and 3 steps of each under the profiler
   (device busy, idle share, the kernels held to the launch counters);
   (b) (after phase 15 (a), whose eval replays the evaluator's frame and
   LPIPS programs) the same eval command with the evaluator eager: each
   split's psnr, ssim, proxy LPIPS, largest intersection count and passes
   again equal, FPS and latencies of both, and a replay of every program
   of the graphed evaluators under the profiler; (c) on one NCCL rank (the
   card's machine has one GPU; NCCL refuses two ranks on one device, so
   capture across ranks is not measured here): the sharded step under
   ``tiles:1``, ``gauss:1`` and ``gauss:1,tiles:1``, eager and graphed, 8
   steps from phase 8's state at the capacity rung above its population
   with a densify event that grows it (a second capture) and an opacity
   reset, bit for bit, and 3 replays under the profiler (after phase 16
   (a)); then (after phase 16 (b)) ``train(cfg)`` under ``tiles:1`` and
   ``gauss:1`` on phase 13 (a)'s scene on one NCCL rank (graphed, its
   replays profiled) against one gloo rank (eager, logged so): losses and
   final state bit for bit;

and then through the programs over the live train state (the graphed
step's buffers taken by reference: the refine event, the opacity reset,
the intersection counters, the eval's frame) and the capture ahead of need
(``training/precompile.py``):

19. (after phase 18 (c)) ``train(cfg)`` on phase 13 (a)'s scene with a
   schedule of four refine events, an opacity reset, two SH bumps and
   two evals in 45 steps, at a capacity a probe run chose so that an event
   past the first grows it: (a) the refine programs eager (the port
   before: also the evaluator's own copy of the model), graphed, and
   graphed with the capture ahead, every loss, every event's counts, every
   intersection count the trainer read and the final state's digest bit
   for bit; each event's wall time in the three runs, the growth's, and
   each program's capture and pool; (b) each eval's peak allocated memory,
   the copying evaluator against the programs that share the step's pool
   and read its buffers: lower by at least the copy, 236 B a slot; (c) the
   first step of the grown capacity and of an SH bump replays a program
   captured ahead (``ahead``), capturing nothing, beside the graphed run's
   first steps, which captured; no warm failed; (d) (in 18 (c)'s runs) the
   NCCL rank's graphed densify and striped counter against gloo's eager
   ones: every event's counts and every intersection count equal.

and then through the port's benchmark entry point:

20. (a) ``python -m easy_gaussian_splatting_torch.bench`` as a subprocess,
   the whole matrix (100k, 1M and 3M Gaussians at 800x800, then 100k at
   B = 4): exit 0, its last line the root ``bench.py``'s keys with no
   ``error`` and every point's keys, ``backend`` the card (the bench
   itself fails a point on a second capture or a truncated step); each
   point's line (capture, peak allocated and reserved memory) and its
   step, it/s, intersections, bound and share of it printed;
   (b) the 100k points (B = 1 and 4) again in process through
   ``bench_point``, their launches exactly the counter's, the warm-up
   calls' and the replays', then stepped again with replays under the
   profiler: B of each main-path kernel a replay, as the counters say,
   and one capture; (c) the four main-path kernels against their plain
   versions on the bench's own inputs: the first warm-up call of the 3M
   point (4,194,304 slots) and of the 100k point at B = 4, with the
   limits of phases 4 and 8.

Then one JSON line of the seven kernels. Each main path's counts are
zeroed just before it: ``launches`` counts the ``train()`` run of phase 9
for the first four and that of its reduction in phase 11 for the other
three, ``launches_served`` the viewer's build and requests of phase 5,
``launches_data_path`` the cached ``train(cfg)`` run of phase 13 (a),
``launches_batched`` phase 14's 10 timed batched steps,
``launches_eval_cli`` phase 15's eval (graphed), ``launches_mesh`` rank
0's sharded calls and ``train()`` runs of phase 16,
``launches_batched_graphed`` phase 18 (a)'s graphed batched runs,
``launches_mesh_graphed`` phase 18 (c)'s graphed ``train()`` runs,
``launches_refine`` phase 19's graphed run and ``launches_bench`` phase 20
(b)'s two ``bench_point`` runs.
``ms``, ``plain_ms``, ``bound_ms`` and ``max_abs_err`` come from the served
800x800 frame for binkeys and tiled_forward, and from the first train
step for the others; ``library_ms`` is null where no one PyTorch call
computes the function. ``max_abs_err_bench`` is phase 20 (c)'s largest
difference from the plain version at the bench's points (null for the
three reduction-only kernels, which the bench does not run).

The last line of stdout is ``{"ok": true, "device": {...}}``; any failed
phase exits non-zero before it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import io
import json
import math
import shutil
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "build" / "chip_smoke_run"
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per unit of work, counted from the kernels' sources:
# binkeys per tested window cell (four clamped edge minima of the
# quadratic, the inside test, the compare)
BINKEYS_OPS_PER_CELL = 75
# tiled_forward per composited (pixel, intersection) pair: the eligibility
# test (~20: the 7-term polynomial, 13, its reach test, exp, the clamp and
# the two tests), 1 - alpha and the new T, the stop test, the weight and
# three multiply-adds (two operations each)
FORWARD_OPS_PER_COMPOSITED = 30
# the older yardstick charged the eligibility test to every pair reached,
# composited or not; [6] prints it beside the bound
FORWARD_OPS_PER_PAIR = 20
# tiled_backward per composited (pixel, intersection) pair: the eligibility
# test (~20, as the forward), ~39 operations of gradient math and 11 adds
# to the per-tile sums
BACKWARD_OPS_PER_COMPOSITED = 70

TOL = 1e-4  # rgb / final-T agreement of kernel and plain forward
MIN_AGREE = 0.9999  # share of pixels that must agree within TOL
REQUEST_REPEATS = 5
SIZES = {"dataset": (800, 800), "orbit_720p": (1280, 720), "rung_180p": (320, 180)}

BWD_TOL = 1e-4  # tiled_backward vs plain, relative to each column's max
SEG_RTOL = 1e-5  # segsum_band vs plain, relative to the group's |sum|
STEP_GRAD_RTOL = 1e-3  # whole-step gradients, relative L2 per parameter
# configs/nerf_synthetic.yaml with a schedule compressed so that every
# event happens within the run
TRAIN_SCHEDULE = dict(
    total_iterations=40, sh_degree_interval=0, refine_start=10, refine_every=10,
    reset_opacities_every=20, save_model_iterations=[40], save_optimizer_state=True,
    data_device_cache=False, log_every=1, dataloader_workers=2,
)
TIMED_STEPS = range(14, 19)  # steps 15-19: the five before the first event
# the steps whose replays run under the profiler: the others
PROFILED_STEPS = set(range(1, 41)) - {i + 1 for i in TIMED_STEPS}


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 3
def _look_at(pos: np.ndarray) -> np.ndarray:
    """c2w rotation columns (x, y, z) of a camera at ``pos`` looking at the
    origin, y down (the viewer's orbit convention)."""
    z = -pos / np.linalg.norm(pos)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=1)


def write_run_dir(run_dir: Path, n: int, seed: int, device) -> None:
    import torch

    from easy_gaussian_splatting_torch.models.gaussians import init_gaussian_state
    from easy_gaussian_splatting_torch.training.config import dump_config, load_config
    from easy_gaussian_splatting_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(seed)
    xyzs = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    state = init_gaussian_state(xyzs, rgbs, sh_degree=3, device=device)
    sh_rest = rng.normal(0.0, 0.1, size=(n, 15, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, size=n)
    logits = np.log(opac / (1.0 - opac)).astype(np.float32)
    state.params.sh_rest[:n] = torch.as_tensor(sh_rest, device=device)
    state.params.logit_opacities[:n] = torch.as_tensor(logits, device=device)
    save_checkpoint(run_dir / "checkpoints" / "iterations_30000.npz", state, 3, 30000)
    dump_config(load_config(REPO / "configs" / "nerf_synthetic.yaml"), run_dir / "config.yaml")
    cams = []
    for k in range(4):
        th = 2.0 * math.pi * k / 4
        pos = 4.0 * np.array([-math.sin(th), 0.0, -math.cos(th)])
        cams.append(dict(
            rotation=_look_at(pos).tolist(), position=pos.tolist(),
            fx=1111.0, fy=1111.0, width=800, height=800,
        ))
    (run_dir / "cameras.json").write_text(json.dumps(cams))


# ------------------------------------------------------------------ phase 4
@contextlib.contextmanager
def swapped(module, name: str, fn):
    """Temporarily replace ``module.name`` (the rasterizer looks kernel
    wrappers up through their module at call time)."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def recording(module, name: str):
    """Record the arguments of every call of ``module.name``."""
    calls = []
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    with swapped(module, name, rec):
        yield calls


def near_decision(feats, offsets, basis, t: int, p: int) -> bool:
    """Replay pixel ``p`` of tile ``t`` in f64: does any eligibility or stop
    decision on its walk lie within f32 rounding of its edge? Eligibility
    compares sigma, whose f32 error is ~1e-7 of the sum of the absolute
    polynomial terms (1e-5 allows 100x); the stop compares a product of
    (1 - alpha) terms, whose relative error grows with 1 / (1 - alpha)
    (1e-3 allows alpha up to the 0.999 clamp)."""
    s, e = int(offsets[t]), int(offsets[t + 1])
    f = feats[s:e].double().cpu().numpy()
    b = basis[p].double().cpu().numpy()
    terms = f[:, :7] * b[:7]
    s2 = terms.sum(axis=1)
    nlo = f[:, 6]
    scale = np.abs(terms).sum(axis=1) + np.abs(nlo) + 1.0
    expo = np.maximum(s2, nlo)
    alpha = np.minimum(np.exp(-expo), 0.999)
    d_elig = np.minimum(np.abs(s2 - (nlo - 1e-3)), np.abs(expo - math.log(255.0))) / scale
    elig = (s2 >= nlo - 1e-3) & (alpha >= 1.0 / 255.0)
    T = 1.0
    for i in range(e - s):
        if d_elig[i] < 1e-5:
            return True
        if not elig[i]:
            continue
        t_next = T * (1.0 - alpha[i])
        if abs(math.log(t_next / 1e-4)) < 1e-3:
            return True
        if t_next < 1e-4:
            return False
        T = t_next
    return False


def check_binkeys(calls) -> float:
    """Kernel against plain version on every recorded call: keys, flats
    and counts must be equal. Returns the largest absolute difference."""
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk

    max_err = 0
    for args, kwargs in calls:
        got = bk.binkeys(*args, **kwargs)
        want = bk.binkeys_plain(*args, **kwargs)
        for name, g, w in zip(("keys", "flats", "counts"), got, want):
            diff = int((g != w).sum())
            if g.numel():
                max_err = max(max_err, int((g.long() - w.long()).abs().max()))
            check(diff == 0, (
                f"binkeys {name} differ from the plain version in {diff} of "
                f"{g.numel()} entries (n_keys={kwargs['n_keys']}): the exact "
                "tile test rounded differently"
            ))
    return float(max_err)


def describe_binkeys(call) -> str:
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk

    (fgeo, igeo), kw = call
    tail = kw.get("tail")
    return (f"{fgeo.shape[1]} rows with n_keys {kw['n_keys']}, "
            f"{int((igeo[6] == bk.POP_TAIL).sum())} of them in the tail of "
            f"{0 if tail is None else tail.shape[0]} slots with m {kw['m']}")


def compare_frames(got_rgb, got_t, want_rgb, want_t):
    """Per-pixel agreement mask of two forward outputs within TOL."""
    d_rgb = (got_rgb - want_rgb).abs().amax(dim=-1)
    d_t = (got_t - want_t).abs()
    return (d_rgb <= TOL) & (d_t <= TOL), float(d_rgb.max())


def check_forward(args, tag: str = "4", what: str = "the served 800x800 frame"):
    """Kernel against plain version on recorded forward inputs. Pixels
    outside TOL, and pixels inside it whose last contributor differs, are
    flipped decisions: each must replay an eligibility or stop decision
    within rounding of its edge. Returns (largest rgb difference, plain ms
    of the one plain call)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    feats, offsets, basis = args
    k_rgb, k_t, k_last = tr.tiled_forward(feats, offsets, basis)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    p_rgb, p_t, p_last = tr.tiled_forward_plain(feats, offsets, basis)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    agree, max_err = compare_frames(k_rgb, k_t, p_rgb, p_t)
    n_px = agree.numel()
    n_bad = int((~agree).sum())
    last_only = agree & (k_last != p_last)
    share = 1.0 - n_bad / n_px
    log(f"[{tag}] tiled_forward on {what}: {n_px - n_bad}/{n_px} pixels within {TOL} (share "
        f"{share:.6f}), max rgb |diff| {max_err:.3e}; {int(last_only.sum())} more "
        "agree in rgb but differ in last contributor")
    flipped = ((~agree) | last_only).nonzero().tolist()
    replayed = flipped[:64]
    explained = sum(1 for t, p in replayed if near_decision(feats, offsets, basis, t, p))
    log(f"[{tag}] tiled_forward: {explained} of {len(replayed)} replayed flipped pixels "
        "have a stop/eligibility decision within rounding of its edge")
    check(share >= MIN_AGREE, f"tiled_forward agrees on only {share:.6f} of pixels on {what}")
    check(explained == len(replayed), f"tiled_forward: unexplained pixel differences on {what}")
    return max_err, plain_ms


# ------------------------------------------------------------------ phase 6
def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: ``iters`` calls queued behind a
    wait on the device, so that none waits on the host's launch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~30 ms of device clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def binkeys_bound(calls):
    """(bytes, f32 ops) the binkeys calls of one frame must move and do:
    the rows and the tail's ids read once, every key, flat and count
    written once; the exact test of each cell the data needs tested (a
    row's first n_keys cells below its count, none for a row of the tail;
    a tail slot's cells below its row's count, none for an empty slot)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk

    nbytes = ops = 0
    for (fgeo, igeo), kw in calls:
        n, m, n_keys, tail = fgeo.shape[1], kw["m"], kw["n_keys"], kw.get("tail")
        n_tail = 0 if tail is None else tail.shape[0]
        nbytes += (fgeo.numel() + igeo.numel()) * 4 + n_tail * 8 \
            + (n_keys * n + m * n_tail) * 12 + n * 4
        count = igeo[3].long()
        cells = int(torch.where(igeo[6] == bk.POP_TAIL, 0, count.clamp(max=n_keys)).sum())
        if tail is not None:
            cells += int(count[tail[tail < n]].clamp(max=m).sum())
        ops += BINKEYS_OPS_PER_CELL * cells
    return nbytes, ops


def forward_counts(feats, offsets, basis) -> dict:
    """The forward's work on this data, in the kernel's layout of 64-pixel
    warps (``tile_raster.warp_pixels``): ``reached``, the (pixel,
    intersection) pairs each pixel's walk reaches (its tile's rows up to
    the one that stops it, or all of them); ``composited``, those it
    composites; ``warp_steps``, the (warp, intersection) pairs up to each
    warp's last stop (the rows its farthest pixel reaches); ``warp_kept``,
    those the per-warp cull keeps (``warp_reach_plain`` with the tile's bound
    on |px|, |py|, as the kernel tests them), the rows its warps walk; the
    rows each tile walks, up to its last pixel's stop
    (``walk_max``, ``walk_p90``, ``walk_mean``), and the rows its list holds
    (``list_mean``). Transmittance in f64, so a pixel whose T lands within
    rounding of 1e-4 may count one row more or less than the kernel's."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr
    from easy_gaussian_splatting_torch.ops.rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, T_EPS

    dev = feats.device
    offs = offsets.long()
    lengths = offs[1:] - offs[:-1]
    t, p = lengths.shape[0], basis.shape[0]
    idx = tr.warp_pixels(p).to(dev)  # [warps, 64] pixel ids, p: none

    def rect(pix):
        pix = pix[pix < p]
        return tuple(float(v) for v in (basis[pix, 3].min(), basis[pix, 3].max(),
                                        basis[pix, 4].min(), basis[pix, 4].max()))

    rects = [rect(i) for i in idx]
    # the kernel bounds every row's box by the largest |px|, |py| of the tile
    bound = (max(max(abs(r[0]), abs(r[1])) for r in rects),
             max(max(abs(r[2]), abs(r[3])) for r in rects))
    n = dict(reached=0, composited=0, warp_steps=0, warp_kept=0, tiles=t,
             list_mean=float(lengths.double().mean()))
    walk = torch.zeros(t, dtype=torch.long, device=dev)
    for t0, t1, longest in tr._tile_batches(lengths.tolist(), p, 1 << 24):
        if longest == 0:
            continue
        lane = torch.arange(longest, device=dev)
        in_range = lane[None, :] < lengths[t0:t1, None]
        gpos = offs[t0:t1, None] + lane[None, :]
        f = feats[torch.where(in_range, gpos, torch.zeros_like(gpos))]
        s2 = tr._sigma2(f, basis)  # [B, P, L]
        nlo = f[..., 6][:, None, :]
        alpha = torch.clamp(torch.exp(-torch.maximum(s2, nlo)), max=ALPHA_CLAMP)
        elig = (s2 >= nlo - tr.SIGMA_EPS) & (alpha >= ALPHA_THRESH) & in_range[:, None, :]
        del s2, nlo
        incl = torch.cumprod(torch.where(elig, 1.0 - alpha.double(), 1.0), dim=-1)
        del alpha
        stop = elig & (incl < T_EPS)  # T after the row, were it composited
        del incl
        stopped = (torch.cumsum(stop, dim=-1, dtype=torch.int32) - stop.to(torch.int32)) > 0
        reached = in_range[:, None, :] & ~stopped
        n["reached"] += int(reached.sum())
        n["composited"] += int((elig & ~stopped & ~stop).sum())
        del elig, stop, stopped
        reach_len = reached.sum(-1)  # [B, P]: each pixel's walk is a prefix
        del reached
        padded = torch.cat([reach_len, torch.zeros_like(reach_len[:, :1])], 1)
        warp_len = padded[:, idx].amax(2)  # [B, warps]
        walk[t0:t1] = reach_len.amax(1)
        n["warp_steps"] += int(warp_len.sum())
        rows = f.view(-1, f.shape[-1])
        for k, box in enumerate(rects):
            walked = lane[None, :] < warp_len[:, k, None]
            kept = tr.warp_reach_plain(rows, box, bound).view(walked.shape)
            n["warp_kept"] += int((walked & kept).sum())
    n.update(walk_max=int(walk.max()), walk_mean=float(walk.double().mean()),
             walk_p90=float(torch.quantile(walk.double(), 0.9)), walk_rows=int(walk.sum()))
    return n


def log_forward_counts(tag: str, what: str, n: dict) -> None:
    log(f"[{tag}] tiled_forward work on {what}: (pixel, intersection) pairs reached "
        f"{n['reached']}, composited {n['composited']}; (warp, intersection) pairs to the "
        f"64-pixel warps' last stops {n['warp_steps']}, kept by the cull {n['warp_kept']}; rows "
        f"walked per tile max {n['walk_max']}, p90 {n['walk_p90']:.0f}, mean {n['walk_mean']:.1f} "
        f"(listed per tile, mean {n['list_mean']:.1f}) over {n['tiles']} tiles")


def forward_numbers(args, tag: str, what: str) -> float:
    """``tiled_forward`` on recorded inputs: checked against its plain
    version, timed (CUDA events over 20 launches), its work counted and its
    bound. Returns its ms."""
    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    check_forward(args, tag, what)
    ms = cuda_ms(lambda: tr.tiled_forward(*args), 20)
    work = forward_counts(*args)
    (bound, by), (old_bound, old_by) = forward_bound(args, work)
    log(f"[{tag}] tiled_forward on {what}: {ms:.4f} ms, bound {bound:.4f} ms ({by}; the old "
        f"yardstick gave {old_bound:.4f} ms ({old_by})); {int(args[1][-1])} listed rows")
    log_forward_counts(tag, what, work)
    return ms


def forward_bound(args, n: dict):
    """Bytes: each feature row that some pixel of its tile reaches read once
    (``walk_rows``: the rows past a tile's last stop are not needed), the
    offsets and the basis, and the outputs (rgb, T, last: 20 bytes a pixel)
    written once. Operations: those of the composited pairs only
    (``forward_counts``); a pair that is not composited does not change the
    result, and the kernel's cull skips most of them without per-pixel
    work. Returns the bound and, beside it, the old yardstick (every pair
    reached, and every row of the feature array)."""
    feats, offsets, basis = args
    t, p = offsets.numel() - 1, basis.shape[0]
    small = offsets.numel() * 4 + basis.numel() * 4 + t * p * 20
    new = bound_ms(n["walk_rows"] * feats.shape[1] * 4 + small,
                   FORWARD_OPS_PER_COMPOSITED * n["composited"])
    old = bound_ms(feats.numel() * 4 + small, FORWARD_OPS_PER_PAIR * n["reached"])
    return new, old


# each kernel's name in the profiler (its __global__ function in csrc/)
KERNEL_SYMBOLS = {
    "binkeys": "binkeys_kernel", "tiled_forward": "tile_forward_kernel",
    "tiled_backward": "tile_backward_kernel", "segsum_band": "segsum_band_kernel",
    "segsum_compact": "segsum_compact_kernel", "monotone_expand": "monotone_expand_kernel",
    "group_reduce": "group_reduce_kernel",
}


def kernel_launches(prof) -> dict:
    """The launches of each of the port's kernels that ``prof`` (a finished
    ``torch.profiler.profile``) saw run on the card, by kernel name: a
    measurement, independent of the wrappers' launch counters (which a
    replayed CUDA graph adds from its capture)."""
    import re

    from torch.autograd import DeviceType

    seen = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name, sym in KERNEL_SYMBOLS.items():
                if re.search(rf"\b{sym}\b", e.key):
                    seen[name] += e.count
    return seen


def device_records(prof) -> dict:
    """Every device activity ``prof`` recorded (kernels, copies, memsets),
    by name: its count."""
    from torch.autograd import DeviceType

    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


# profiler windows a measurement may take: the profiler loses device
# records now and then (a run of them, up to a whole window), which the
# program's graph and its other windows show ran (``--replay-probe``;
# PERF.md), so a window that saw fewer of the port's kernels than the
# counters, and none more, is measured again
PROFILE_WINDOWS = 3


def lost_records(seen: dict, counted: dict) -> bool:
    """Whether a window that disagrees with the counters fell short only,
    as a window that lost records does (never by a kernel more)."""
    return seen != counted and all(seen[k] <= counted[k] for k in seen)


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (host and device activity), the
    card synchronized at both ends: (its result, the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def profiled_launches(fn, tag: str, what: str):
    """``fn()`` (work that can run again) under the profiler: the port's
    kernels it saw equal to the counters' increments, or the run fails; a
    window that lost records (:func:`lost_records`) is measured again, up
    to ``PROFILE_WINDOWS`` windows. Returns (the result, the profile, the
    kernels seen)."""
    for _ in range(PROFILE_WINDOWS):
        before = counts()
        out, prof = profiled(fn)
        seen = kernel_launches(prof)
        counted = {k: v - before[k] for k, v in counts().items()}
        if not lost_records(seen, counted):
            break
        log(f"[{tag}] {what}: the profiler lost records ({seen} of {counted}); measured again")
    check_measured(tag, what, seen, counted)
    return out, prof, seen


def check_measured(tag: str, what: str, seen: dict, counted: dict) -> None:
    """The kernels the profiler saw against the counters' increments over
    the same calls: equal for every kernel, or the run fails."""
    check(seen == counted, f"[{tag}] {what}: the profiler saw launches {seen} but the launch "
          f"counters rose by {counted}")


def profile_device(fn, reps: int, what: str, tag: str, top: int = 14) -> dict:
    """Where the time of ``reps`` calls of ``fn`` goes: ``torch.profiler``
    device time by kernel, and the device's busy share of the wall. The
    port's kernels the profiler saw must equal the counters' increments
    over the ``reps`` calls (a replayed graph's included). Returns the busy
    and wall ms a call, the idle share and the launches seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):  # a window that lost records is measured again
        before = counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        seen = kernel_launches(prof)
        counted = {k: v - before[k] for k, v in counts().items()}
        if not lost_records(seen, counted):
            break
        log(f"[{tag}] {reps} {what}s profiled: the profiler lost records ({seen} of {counted}); "
            "measured again")
    check_measured(tag, f"{reps} {what}s profiled", seen, counted)
    log(f"[{tag}] the profiler saw " + ", ".join(f"{k} {v}" for k, v in seen.items() if v)
        + f" over {reps} {what}s, equal to the launch counters' increments")
    return dict(device_time(prof, reps, wall_ms, what, tag, top), launches=seen)


def device_time(prof, reps: int, wall_ms: float, what: str, tag: str, top: int = 14) -> dict:
    """The device time ``prof`` recorded over ``reps`` calls that took
    ``wall_ms`` in all: busy and wall ms a call, the idle share, and the
    ``top`` device activities by time, logged."""
    from torch.autograd import DeviceType

    rows = [  # device-side events only (kernels, copies), not the host ops
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    rows = [r for r in rows if r[0] > 0]
    busy = sum(r[0] for r in rows)
    out = dict(busy_ms=busy / reps, wall_ms=wall_ms / reps, idle_share=1 - busy / wall_ms)
    if not rows:
        log(f"[{tag}] profile: no device time recorded")
        return out
    log(f"[{tag}] profile of {reps} {what}s: wall {wall_ms / reps:.2f} ms/{what}, "
        f"device busy {busy / reps:.2f} ms/{what} (idle share {1 - busy / wall_ms:.3f})")
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        log(f"[{tag}]   {ms / reps:8.3f} ms/{what}  {n / reps:6.1f} calls/{what}  {key[:90]}")
    return out


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 7
class RingScene:
    """The JAX ``Scene``'s interface over in-memory frames, the train
    indexes tiled over the whole run as ``Scene`` tiles them."""

    def __init__(self, xyzs, rgbs, frames, total):
        import types

        self.pc = types.SimpleNamespace(xyzs=xyzs, rgbs=rgbs, nbr_points=xyzs.shape[0])
        self.frames, self.total = frames, total

    def nbr_data(self, split):
        return self.total if split == "train" else 0

    def get_data(self, split, index):
        return dict(self.frames[index % len(self.frames)])


def ring_views(n: int = 4, radius: float = 4.0, focal: float = 1111.0, size: int = 800):
    """(w2c, K) of ``n`` cameras on a ring looking at the origin, as the
    run directory's cameras (phase 3)."""
    views = []
    for k in range(n):
        th = 2.0 * math.pi * k / n
        pos = radius * np.array([-math.sin(th), 0.0, -math.cos(th)])
        rot = _look_at(pos)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = rot.T
        w2c[:3, 3] = -rot.T @ pos
        K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]], np.float32)
        views.append((w2c, K))
    return views


def training_data(n: int, seed: int, cfg, device):
    """The training init state, and the ring frames rendered by the port's
    forward from a ground-truth copy with other colours and opacities."""
    import dataclasses

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import init_gaussian_state
    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.ops.rasterize_tiled import isect_capacity
    from easy_gaussian_splatting_torch.ops.sh import rgb_to_sh0
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn, tune_inference_cfg

    rng = np.random.default_rng(seed)
    xyzs = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    state = init_gaussian_state(xyzs, rgbs, sh_degree=3, device=device)
    gt = state.params.map(torch.clone)
    gt_rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, size=n)
    gt.sh_0[:n] = torch.as_tensor(rgb_to_sh0(gt_rgb)[:, None, :], device=device)
    gt.sh_rest[:n] = torch.as_tensor(rng.normal(0.0, 0.1, size=(n, 15, 3)).astype(np.float32), device=device)
    gt.logit_opacities[:n] = torch.as_tensor(np.log(opac / (1.0 - opac)).astype(np.float32), device=device)
    gt_state = dataclasses.replace(state, params=gt)
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=device)
    frames = []
    with torch.no_grad():
        for w2c, K in ring_views():
            # capacity from the inference autotune; a frame that still
            # overflows renders again with 1.5x its count, as the viewer does
            vcfg = tune_inference_cfg(dataclasses.replace(cfg), gt_state, w2c, K, 800, 800)
            cam = CameraView(torch.as_tensor(w2c, device=device), torch.as_tensor(K, device=device), 800, 800)
            out = get_render_fn(vcfg)(gt, state.alive, cam, 3, bg)
            n_isects = int(out.num_isects)
            if n_isects > isect_capacity(state.capacity, vcfg.isect_mult):
                vcfg.isect_mult = n_isects * 1.5 / state.capacity
                out = get_render_fn(vcfg)(gt, state.alive, cam, 3, bg)
            check(int(out.num_isects) <= isect_capacity(state.capacity, vcfg.isect_mult),
                  "a ground-truth frame was truncated")
            frames.append(dict(K=K, height=800, width=800, w2c=w2c, image=out.image.cpu().numpy(),
                               mask=np.zeros((800, 800), np.float32)))
    return xyzs, rgbs, state, frames


# ------------------------------------------------------------------ phase 8
def near_eligibility_edge(feats, offsets, basis, last, row: int) -> bool:
    """Replay intersection ``row`` in f64 over the pixels of its tile that
    walk to it: does any eligibility decision lie within f32 rounding of
    its edge (see ``near_decision``)?"""
    import torch

    t = int(torch.searchsorted(offsets, torch.tensor([row], dtype=offsets.dtype,
                                                     device=offsets.device), right=True)) - 1
    f = feats[row].double()
    terms = basis[:, :7].double() * f[:7]
    s2 = terms.sum(dim=1)
    nlo = float(f[6])
    scale = terms.abs().sum(dim=1) + abs(nlo) + 1.0
    expo = torch.clamp(s2, min=nlo)
    d = torch.minimum((s2 - (nlo - 1e-3)).abs(), (expo - math.log(255.0)).abs()) / scale
    return bool(((d < 1e-5) & (last[t] >= row)).any())


def check_backward(call, tag: str = "8"):
    """Kernel against plain version on the recorded backward call: every
    column within BWD_TOL of its largest magnitude; rows outside it are
    counted and each must replay an eligibility decision at its rounding
    edge. Returns (max abs difference, plain ms of the one plain call)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    args, _ = call
    got = tr.tiled_backward(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = tr.tiled_backward_plain(*args)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    n_live = tr.NUM_LIVE_GRADS
    scale = want[:, :n_live].abs().amax(dim=0)
    err = (got - want).abs()
    rel = err[:, :n_live].amax(dim=0) / scale.clamp(min=1e-30)
    bad = (err[:, :n_live] > BWD_TOL * scale).any(dim=1).nonzero().flatten().tolist()
    log(f"[{tag}] tiled_backward: {got.shape[0]} rows, worst column error / column max "
        f"{float(rel.max()):.2e} (per column: {', '.join(f'{float(x):.1e}' for x in rel)}); "
        f"{len(bad)} rows outside {BWD_TOL} of their column's max")
    feats, offsets, basis = args[0], args[1], args[2]
    last = args[6]
    explained = sum(1 for r in bad[:64] if near_eligibility_edge(feats, offsets, basis, last, r))
    log(f"[{tag}] tiled_backward: {explained} of {min(len(bad), 64)} replayed rows have an "
        "eligibility decision within rounding of its edge")
    check(explained == min(len(bad), 64) and len(bad) <= 64,
          "tiled_backward: unexplained differences from the plain version")
    check(bool(torch.isfinite(got).all()), "tiled_backward: a value is not finite")
    check(bool((got[:, n_live:] == 0).all()), "tiled_backward: padding columns not zero")
    check(bool((got[int(offsets[-1]):] == 0).all()), "tiled_backward: rows past the tiles not zero")
    check(torch.equal(got, tr.tiled_backward(*args)), "tiled_backward: two launches differ")
    log(f"[{tag}] tiled_backward: finite, zero past the tiles' {int(offsets[-1])} rows and in "
        "columns 11-15, a second launch equal bit for bit")
    return float(err.max()), plain_ms


def check_segsum(call, capacity: int, tag: str = "8") -> float:
    """Kernel against plain version on the recorded call, at the rows the
    consumer reads (each live Gaussian's first row): within SEG_RTOL of the
    group's sum of magnitudes (the two versions add in another order)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import segments as seg

    (rows, g), _ = call
    got = seg.segsum_band(rows, g)
    want = seg.segsum_band_plain(rows, g)
    mag = seg.segsum_band_plain(rows.abs(), g)
    torch.cuda.synchronize()
    first = torch.ones_like(g, dtype=torch.bool)
    first[1:] = g[1:] != g[:-1]
    read = first & (g < capacity)
    err = (got - want).abs()[read]
    ok = err <= SEG_RTOL * mag[read]
    log(f"[{tag}] segsum_band: {rows.shape[0]} rows, {int(read.sum())} group starts read; "
        f"{int((~ok).sum())} values outside {SEG_RTOL} of the group's |sum|, max |diff| "
        f"{float(err.max()):.3e}")
    check(bool(ok.all()), "segsum_band disagrees with the plain version")
    return float(err.max())


def plain_swaps():
    """All four kernel wrappers replaced by their plain versions."""
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg
    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    stack = contextlib.ExitStack()
    stack.enter_context(swapped(bk, "binkeys", bk.binkeys_plain))
    stack.enter_context(swapped(tr, "tiled_forward", tr.tiled_forward_plain))
    stack.enter_context(swapped(tr, "tiled_backward", tr.tiled_backward_plain))
    stack.enter_context(swapped(seg, "segsum_band", seg.segsum_band_plain))
    return stack


def check_step_gradients(got, want, tol=STEP_GRAD_RTOL, tag="8",
                         what="kernels vs plain versions") -> None:
    """Each parameter's gradient (and absgrad) of one step against another's:
    relative L2 error at most ``tol``."""
    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES

    (g_k, abs_k, ld_k, _), (g_p, abs_p, ld_p, _) = got, want
    pairs = [(n, getattr(g_k, n), getattr(g_p, n)) for n in PARAM_NAMES] + [("absgrad", abs_k, abs_p)]
    errs = {}
    for name, a, b in pairs:
        errs[name] = float((a - b).norm() / b.norm().clamp(min=1e-30))
    log(f"[{tag}] whole step, {what}: loss " + f"{float(ld_k['total']):.6f} vs "
        f"{float(ld_p['total']):.6f}; relative L2 gradient error "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(all(v <= tol for v in errs.values()), f"whole-step gradients disagree: {what}")


# ------------------------------------------------------------------ phase 9
def counts():
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk
    from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg
    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    return {"binkeys": bk.launches, "tiled_forward": tr.launches,
            "tiled_backward": tr.backward_launches, "segsum_band": seg.launches,
            "segsum_compact": seg.compact_launches, "monotone_expand": seg.expand_launches,
            "group_reduce": gr.launches}


def zero_counts() -> None:
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk
    from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg
    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    bk.launches = tr.launches = tr.backward_launches = seg.launches = 0
    seg.compact_launches = seg.expand_launches = gr.launches = 0


PER_STEP = {"binkeys": 1, "tiled_forward": 1, "tiled_backward": 1, "segsum_band": 1}


def replays(step, model, height: int, width: int, sh_degree: int) -> bool:
    """Whether a call of ``step`` (a ``GraphedTrainStep``, single or sharded)
    with ``model`` at this frame size and SH degree replays a program it
    holds, capturing none (read from its private state: a check of the
    smoke's own)."""
    from easy_gaussian_splatting_torch.training.graphs import graph_signature

    sig = graph_signature(step.cfg, model.capacity, height, width, sh_degree, mesh=step.mesh)
    return (step.state is not None and step.state[0].shape[0] == model.capacity
            and sig in step.programs.entries)


class Delegate:
    """A call wrapped around ``obj``: calling it calls ``call``; the
    attributes in ``over`` are its own, any other is ``obj``'s."""

    def __init__(self, obj, call, **over):
        self._obj, self._call = obj, call
        self.__dict__.update(over)

    def __call__(self, *a, **k):
        return self._call(*a, **k)

    def __getattr__(self, name):
        return getattr(self._obj, name)


def train_recorded(cfg, scene, device, profile=(), keep: bool = False, profile_events=()):
    """The port's ``train()`` with each step timed (host clock between two
    synchronizes, and a pair of CUDA events a step in ``rec["step_events"]``),
    its launches, loss, intersections and capacity recorded, and the
    densify and reset events counted. On the card the steps are the graphed
    step's (``rec["graphed"]`` holds each ``GraphedTrainStep`` built, with its
    captures), under an NCCL mesh too; under a gloo mesh, the eager sharded
    step's (``make_mesh_train_step``). A graphed step numbered in
    ``profile`` that replays (captures nothing) runs under the profiler,
    outside its timing: the launches of each kernel it saw are the step's
    ``measured`` (:func:`check_replays` holds them to the counters); an
    event after a step numbered in ``profile_events`` runs under the profiler
    (its ``measured``, ``records`` and counted ``launches`` in its record,
    the growth inside a refine event in the refine event's window). With
    ``keep`` the graphed steps keep their programs when ``train()`` resets
    them (at its end), for the caller to replay. The refine events (their
    counts), the opacity resets and the intersection counts (the values
    the trainer read) are recorded in ``rec["events"]`` in order, each
    with its wall ms between two synchronizes, and each step's
    ``captured``: the step programs captured in its call."""
    import torch

    from easy_gaussian_splatting_torch.ops import rasterize_tiled
    from easy_gaussian_splatting_torch.ops.rasterize_tiled import isect_capacity
    from easy_gaussian_splatting_torch.parallel import gauss_shard, shard
    from easy_gaussian_splatting_torch.training import trainer as ttrainer

    rec = {"steps": [], "densify": 0, "reset": 0, "step_events": [], "graphed": [],
           "events": []}
    make_orig = ttrainer.make_train_step
    mesh_orig = ttrainer.make_mesh_train_step
    graphed_orig = ttrainer.GraphedTrainStep
    densify_orig = ttrainer.run_densify_with_growth
    sharded_orig = ttrainer.run_sharded_densify_with_growth
    reset_orig = ttrainer.make_reset_step
    counted_orig = ttrainer.counted_isects
    counter_orig = rasterize_tiled.make_isect_counter
    striped_orig = shard.make_striped_isect_counter
    grow_sharded_orig = gauss_shard.grow_state_sharded
    in_program = [False]  # a counter called while a program over the state captures it

    depth = [0]  # events inside an event (a growth inside a refine event)

    def event(kind, fn, *a, **k):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = fn(*a, **k)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        step, seen = len(rec["steps"]), {}
        if step in profile_events and depth[0] == 0:
            before = counts()
            (out, ms), prof = profiled(run)
            seen = dict(measured=kernel_launches(prof), records=device_records(prof),
                        launches={n: v - before[n] for n, v in counts().items()})
        else:
            out, ms = run()
        rec["events"].append(dict(kind=kind, step=step, ms=ms, **seen))
        return out

    def timed(step, mult, graphed=None):
        def call(model, adam, *a, **k):
            before = counts()
            caps = 0 if graphed is None else len(graphed.captures)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
            out = step(model, adam, *a, **k)
            events[1].record()
            rec["step_events"].append(events)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = counts()
            return out, dict(ms=ms, start=t0, launches={n: after[n] - before[n] for n in after},
                             captured=0 if graphed is None else len(graphed.captures) - caps)

        def run(model, adam, *a, **k):
            n = len(rec["steps"]) + 1
            if graphed is not None and n in profile and replays(
                    graphed, model, k["height"], k["width"], k["sh_degree"]):
                (out, st), prof = profiled(lambda: call(model, adam, *a, **k))
                st["measured"] = kernel_launches(prof)
                st["records"] = device_records(prof)
            else:
                out, st = call(model, adam, *a, **k)
            ld = out[2]
            rec["steps"].append(dict(
                st, loss=float(ld["total"]), isects=int(ld["isects"]),
                cap=isect_capacity(model.capacity, mult), capacity=model.capacity,
                sh=k["sh_degree"],
            ))
            return out

        return run

    def make(cfg_, render_fn):
        step = make_orig(cfg_, render_fn)
        run = timed(step, cfg_.isect_mult)
        run.step = step
        return run

    def make_mesh(cfg_, mesh, render_fn):
        step = mesh_orig(cfg_, mesh, render_fn)
        run = timed(step, cfg_.isect_mult)
        run.step = step
        return run

    def make_graphed(cfg_, step, dev, **kw):
        # it captures the step itself: a timed one synchronizes
        step = graphed_orig(cfg_, step.step, dev, **kw)
        rec["graphed"].append(step)
        # the call timed; the rest of the step (its state, programs, capture
        # ahead) reached through it, the growth timed, a retune's eager step
        # the timed one's
        return Delegate(step, timed(step, cfg_.isect_mult, step),
                        reset=(lambda: None) if keep else step.reset,
                        grown=lambda *a: event("grow", step.grown, *a),
                        use=lambda fn: step.use(fn.step))

    def densify(*a, **k):
        rec["densify"] += 1
        info = event("densify", densify_orig, *a, **k)
        rec["events"][-1]["info"] = info
        return info

    def sharded_densify(*a, **k):
        rec["densify"] += 1
        info = event("densify", sharded_orig, *a, **k)
        rec["events"][-1]["info"] = info
        return info

    def make_reset(*a, **k):
        step = reset_orig(*a, **k)

        def reset(*aa, **kk):
            rec["reset"] += 1
            return event("reset", step, *aa, **kk)

        return reset

    def counted(*a, **k):
        in_program[0] = True
        try:
            out = event("isects", counted_orig, *a, **k)
        finally:
            in_program[0] = False
        rec["events"][-1]["counts"] = out.cpu().tolist()
        return out

    def counter_of(make):
        def made(*a, **k):
            counter = make(*a, **k)

            def count(*aa, **kk):
                if in_program[0]:
                    return counter(*aa, **kk)
                out = event("isects", counter, *aa, **kk)
                rec["events"][-1]["counts"] = out.cpu().tolist()
                return out

            return count

        return made

    with swapped(ttrainer, "make_train_step", make), \
            swapped(ttrainer, "make_mesh_train_step", make_mesh), \
            swapped(ttrainer, "GraphedTrainStep", make_graphed), \
            swapped(ttrainer, "run_densify_with_growth", densify), \
            swapped(ttrainer, "run_sharded_densify_with_growth", sharded_densify), \
            swapped(ttrainer, "make_reset_step", make_reset), \
            swapped(ttrainer, "counted_isects", counted), \
            swapped(rasterize_tiled, "make_isect_counter", counter_of(counter_orig)), \
            swapped(shard, "make_striped_isect_counter", counter_of(striped_orig)), \
            swapped(gauss_shard, "grow_state_sharded",
                    lambda *a: event("grow", grow_sharded_orig, *a)):
        loop = ttrainer.train(cfg, scene=scene, device=device)
    return loop, rec


def check_replays(tag: str, rec, per_step: dict) -> None:
    """The profiled replays of a ``train()`` run: in each, the kernels the
    profiler saw run equal the launch counters' increments (which a replay
    adds from its capture), and each kernel of ``per_step`` ran exactly
    that many times; fails otherwise, or if no replay was profiled. A
    window that lost records is left out (and named), if no more than a
    third of them did."""
    prof = [(i + 1, s) for i, s in enumerate(rec["steps"]) if "measured" in s]
    check(prof, f"[{tag}] no replayed step was profiled")
    # a step cannot run again: a window that lost records (fewer device
    # records than most windows show, and none of the port's kernels more
    # than the counters) is left out, the others held exactly
    totals = [sum(s["records"].values()) for _, s in prof]
    usual = collections.Counter(totals).most_common(1)[0][0]
    lost = [(n, usual - t) for (n, s), t in zip(prof, totals)
            if t < usual and lost_records(s["measured"], s["launches"])]
    check(3 * len(lost) <= len(prof), f"[{tag}] the profiler lost records in {len(lost)} of "
          f"{len(prof)} replayed steps: {lost}")
    skip = {n for n, _ in lost}
    bad = [(n, s["measured"], s["launches"]) for n, s in prof if n not in skip and (
           s["measured"] != s["launches"]
           or any(s["measured"][k] != v for k, v in per_step.items()))]
    check(not bad, f"[{tag}] replayed steps whose kernels (profiler) differ from the counters "
          f"or from one of each a step: {bad[:3]}")
    prof = [(n, s) for n, s in prof if n not in skip]
    total = {k: sum(s["measured"][k] for _, s in prof) for k in prof[0][1]["measured"]}
    log(f"[{tag}] the profiler saw {len(prof)} replayed steps (steps "
        + " ".join(str(n) for n, _ in prof) + "): each ran "
        + ", ".join(f"{k} {v}" for k, v in per_step.items())
        + ", as the launch counters say; in all " + ", ".join(
            f"{k} {v}" for k, v in total.items() if v)
        + (f"; left out, the profiler having lost device records (step, records lost): {lost}"
           if lost else ""))


def log_captures(tag: str, rec) -> None:
    """Each capture of the graphed steps a ``train()`` run built."""
    caps = [c for g in rec["graphed"] for c in g.captures]
    log(f"[{tag}] graphed step: {len(caps)} captures (" + "; ".join(
        f"capacity {c['key'][0]}, sh {c['key'][3]}, isect_mult {c['key'][4]}: "
        f"warm-up {c['warmup_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, pool "
        f"{c['pool_bytes'] / 2**20:.0f} MiB" for c in caps) + ")")


def check_training(loop, rec, cfg, device) -> None:
    from easy_gaussian_splatting_torch.utils.checkpoint import load_checkpoint

    steps = rec["steps"]
    check(len(steps) == cfg.total_iterations == loop.step, f"trained {len(steps)} steps")
    short = [i + 1 for i, s in enumerate(steps)
             if any(s["launches"][n] < PER_STEP[n] for n in PER_STEP)]
    check(not short, f"a kernel was launched fewer times than its per-step count at steps {short}")
    truncated = [i + 1 for i, s in enumerate(steps) if s["isects"] > s["cap"]]
    check(not truncated, f"truncated steps: {truncated}")
    check(rec["densify"] >= 1 and rec["reset"] >= 1,
          f"{rec['densify']} densify events and {rec['reset']} opacity resets ran")
    losses = [s["loss"] for s in steps]
    early, later = float(np.mean(losses[:5])), float(np.mean(losses[5:10]))
    log(f"[9] loss: mean of steps 1-5 {early:.5f}, of steps 6-10 {later:.5f}; per step "
        + " ".join(f"{x:.4f}" for x in losses))
    check(later < early, "the loss did not fall before the first event")
    path = Path(cfg.output) / "checkpoints" / f"iterations_{cfg.total_iterations}.npz"
    state, sh, step, adam = load_checkpoint(path, device)
    want_steps = cfg.total_iterations - rec["densify"]  # densify steps skip Adam
    check(adam is not None and step == cfg.total_iterations and sh == 3,
          "the checkpoint lacks its optimizer state or step")
    check(all(int(v) == want_steps for v in adam.steps.values()),
          f"checkpoint Adam steps {dict((k, int(v)) for k, v in adam.steps.items())}, want {want_steps}")
    check(adam.mu.means.shape == state.params.means.shape and bool(adam.nu.sh_rest.abs().sum() > 0),
          "checkpoint Adam moments malformed")
    log(f"[9] checkpoint {path.name}: step {step}, {state.num_alive()} gaussians, Adam moments "
        f"and steps ({want_steps} per group) reloaded")


# ----------------------------------------------------------------- phase 10
def backward_counts(feats, offsets, basis, last) -> dict:
    """The backward's work on this data, in the kernel's layout of 64-pixel
    warps (``tile_raster.warp_pixels``): the (pixel, intersection) pairs
    down from each tile's horizon (``tile``: the rows the tile stages, for
    each of its pixels), from each warp's horizon (``warp``: the largest
    ``last`` of its pixels), and at or before the pixel's own ``last``
    (``pixel``);
    ``composited``, the pixel pairs the eligibility test accepts;
    ``warp_steps``, the (warp, intersection) pairs to the warp's horizon;
    ``warp_kept``, those the kernel's cull keeps (``warp_reach_plain``), the
    rows its warps walk; ``warp_rows``, those with at least one composited
    pixel (one warp sum each); the rows each tile stages, down from its
    horizon (``walk_max``, ``walk_p90``, ``walk_mean``)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr
    from easy_gaussian_splatting_torch.ops.rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH

    dev = last.device
    offs = offsets.long()
    start, end = offs[:-1], offs[1:]
    t, p = last.shape
    last64 = last.long()
    tile_len = (torch.minimum(last64.amax(1) + 1, end) - start).clamp(min=0)
    n = dict(tile=int(tile_len.sum()) * p, pixel=0, composited=0, tiles=t, warp_kept=0, warp_rows=0,
             walk_max=int(tile_len.max()), walk_mean=float(tile_len.double().mean()),
             walk_p90=float(torch.quantile(tile_len.double(), 0.9)))
    idx = tr.warp_pixels(p).to(dev)  # [warps, 64] pixel ids, p: none
    padded = torch.cat([last64, torch.full((t, 1), -1, dtype=torch.long, device=dev)], 1)
    warp_h = padded[:, idx].amax(2)  # [t, warps]
    warp_len = (torch.minimum(warp_h + 1, end[:, None]) - start[:, None]).clamp(min=0)
    n["warp"] = int((warp_len * idx.lt(p).sum(1)).sum())
    n["warp_steps"] = int(warp_len.sum())
    rects = [(basis[i[i < p], 3].min(), basis[i[i < p], 3].max(),
              basis[i[i < p], 4].min(), basis[i[i < p], 4].max()) for i in idx]
    for t0, t1, longest in tr._tile_batches((end - start).tolist(), p, 1 << 24):
        if longest == 0:
            continue
        lane = torch.arange(longest, device=feats.device)
        starts = offs[t0:t1, None]
        in_range = lane[None, :] < (offs[t0 + 1 : t1 + 1, None] - starts)
        gpos = starts + lane[None, :]
        f = feats[torch.where(in_range, gpos, torch.zeros_like(gpos))]
        s2 = tr._sigma2(f, basis)
        nlo = f[..., 6][:, None, :]
        alpha = torch.clamp(torch.exp(-torch.maximum(s2, nlo)), max=ALPHA_CLAMP)
        reach = in_range[:, None, :] & (gpos[:, None, :] <= last64[t0:t1, :, None])
        comp = reach & (s2 >= nlo - tr.SIGMA_EPS) & (alpha >= ALPHA_THRESH)
        n["pixel"] += int(reach.sum())
        n["composited"] += int(comp.sum())
        del s2, alpha, reach
        comp = torch.cat([comp, torch.zeros_like(comp[:, :1])], 1)
        n["warp_rows"] += int(comp[:, idx].any(2).sum())
        del comp
        rows = f.view(-1, f.shape[-1])
        for k, rect in enumerate(rects):
            walk = in_range & (gpos <= warp_h[t0:t1, k, None])
            n["warp_kept"] += int((walk & tr.warp_reach_plain(rows, rect).view(walk.shape)).sum())
    return n


def log_backward_counts(tag: str, what: str, n: dict) -> None:
    log(f"[{tag}] tiled_backward work on {what}: (pixel, intersection) pairs down from the "
        f"tile horizon {n['tile']}, from the 64-pixel warp horizon {n['warp']}, to each "
        f"pixel's last {n['pixel']}; composited "
        f"{n['composited']}; (warp, intersection) pairs to the warp horizon {n['warp_steps']}, "
        f"kept by the cull {n['warp_kept']}, with a composited pixel {n['warp_rows']}; rows "
        f"staged per tile max {n['walk_max']}, p90 {n['walk_p90']:.0f}, mean "
        f"{n['walk_mean']:.1f} over {n['tiles']} tiles")


def backward_bound(args, n: dict):
    """Bytes: the live feature rows read once (the tiles' ranges end at
    ``offsets[-1]``), every gradient row the function returns written once,
    the per-pixel cotangents, T and last read once. Operations: those of
    the composited pairs only (``backward_counts``); a pair that is not
    composited adds nothing to the result, and the kernel's cull skips most
    of them without per-pixel work."""
    from easy_gaussian_splatting_torch.ops.kernels.tile_raster import NUM_GRAD_COLS

    feats, offsets, basis, g_img, g_t, t_fin, last = args
    live = int(offsets[-1])
    nbytes = live * feats.shape[1] * 4 + feats.shape[0] * NUM_GRAD_COLS * 4 \
        + offsets.numel() * 4 + basis.numel() * 4 + g_img.numel() * 4 \
        + (g_t.numel() + t_fin.numel() + last.numel()) * 4
    return bound_ms(nbytes, BACKWARD_OPS_PER_COMPOSITED * n["composited"])


def segsum_bound(args):
    """Row i of a group of L rows adds the min(L - i, LOOK) - 1 rows after
    it, per column; each row is read and written once."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels.segments import LOOK

    rows, g = args
    sizes = torch.unique_consecutive(g, return_counts=True)[1].double()
    short = torch.clamp(sizes, max=LOOK)
    window_sum = short * (short + 1) / 2 + (sizes - short) * LOOK  # sum of min(k, LOOK)
    adds = float((window_sum - sizes).sum()) * rows.shape[1]
    return bound_ms(rows.numel() * 8 + g.numel() * 4, adds)


# ----------------------------------------------------------------- phase 11
REDUCTIONS = ("scan", "pallas", "dense")
STRATEGY_RTOL = 1e-4  # whole-step gradients of a reduction vs band, relative L2
# configs/nerf_synthetic.yaml with a schedule compressed so that one densify
# event runs, at step 10, and no opacity reset or checkpoint
REDUCE_SCHEDULE = dict(
    total_iterations=12, sh_degree_interval=0, refine_start=0, refine_every=10,
    reset_opacities_every=1000, save_model_iterations=[], save_optimizer_state=False,
    data_device_cache=False, log_every=1, dataloader_workers=2,
)
REDUCE_TIMED = range(4, 9)  # steps 5-9: the five before the event
REDUCE_PROFILED = set(range(1, 13)) - {i + 1 for i in REDUCE_TIMED}
# each reduction's own kernels and their launches per step ("dense" sums
# both of its populations in one group_reduce launch)
REDUCE_KERNELS = {
    "band": {"segsum_band": 1}, "scan": {},
    "pallas": {"segsum_compact": 1, "monotone_expand": 1}, "dense": {"group_reduce": 1},
}


def populations(call):
    """[(rows, b)]: the row blocks of a recorded ``group_reduce`` call and
    their group sizes (the head, then the tail population if any)."""
    (x, b), kw = call
    if kw.get("tail") is None:
        return [(x, b)]
    tail_b, tail_groups = kw["tail"]
    split = x.shape[0] - tail_b * tail_groups
    return [(x[:split], b), (x[split:], tail_b)]


def describe(call) -> str:
    return " and ".join(f"{x.shape[0]} rows in groups of {b}" for x, b in populations(call))


def check_group_reduce(calls) -> float:
    """Kernel against plain version on every recorded call, bit for bit (both
    add each group's rows in row order)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr

    err = 0.0
    for args, kw in calls:
        got, want = gr.group_reduce(*args, **kw), gr.group_reduce_plain(*args, **kw)
        err = max(err, float((got - want).abs().max()))
        check(torch.equal(got, want), "group_reduce differs from the plain version")
    log("[11] group_reduce: equal to the plain version on " + "; ".join(map(describe, calls)))
    return err


def check_segsum_compact(call) -> float:
    """Kernel against plain version at every written group: within SEG_RTOL
    of the group's sum of magnitudes (the plain version's ``index_add_``
    adds in another order on the card)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import segments as seg

    (rows, g), kw = call
    mg = kw["max_groups"]
    got = seg.segsum_compact(rows, g, mg)
    want = seg.segsum_compact_plain(rows, g, mg)
    mag = seg.segsum_compact_plain(rows.abs(), g, mg)
    torch.cuda.synchronize()
    k = min(int(seg.group_slots(g)[-1]) + 1, mg)
    err = (got[:k] - want[:k]).abs()
    ok = err <= SEG_RTOL * mag[:k]
    log(f"[11] segsum_compact: {rows.shape[0]} rows, {k} groups written (max_groups {mg}); "
        f"{int((~ok).sum())} values outside {SEG_RTOL} of the group's |sum|, max |diff| "
        f"{float(err.max()):.3e}")
    check(bool(ok.all()), "segsum_compact disagrees with the plain version")
    return float(err.max())


def check_monotone_expand(call) -> float:
    """Kernel against plain version, bit for bit (both gather)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import segments as seg

    args, _ = call
    got, want = seg.monotone_expand(*args), seg.monotone_expand_plain(*args)
    check(torch.equal(got, want), "monotone_expand differs from the plain version")
    log(f"[11] monotone_expand: equal to the plain version on {args[1].shape[0]} rows from "
        f"{args[0].shape[0]}")
    return float((got - want).abs().max())


def check_grid_binning(call):
    """The grid binning of a recorded call against the ``binkeys`` binning of
    the same call: the live prefix, offsets and counts must be equal, and
    the dense ids a permutation of [0, D). Returns (live entries, D)."""
    import torch

    from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt

    args, kwargs = call
    with swapped(trt, "BWD_REDUCE", "dense"):
        grid = trt.bin_gaussians(*args, **kwargs)
    with swapped(trt, "BWD_REDUCE", "band"):
        keys = trt.bin_gaussians(*args, **kwargs)
    n = int(keys.num_isects)
    check(int(grid.num_isects) == n, "grid and binkeys binnings count different intersections")
    for name in ("isect_flat", "isect_tile"):
        check(torch.equal(getattr(grid, name)[:n], getattr(keys, name)[:n]),
              f"grid and binkeys binnings differ in {name}")
    for name in ("tile_offsets", "counts"):
        check(torch.equal(getattr(grid, name), getattr(keys, name)),
              f"grid and binkeys binnings differ in {name}")
    d = grid.dense
    check(torch.equal(torch.sort(d).values, torch.arange(d.shape[0], device=d.device)),
          "the dense ids are not a permutation of the sort domain")
    log(f"[11] dense: grid binning equal to the binkeys binning on {n} live entries "
        f"(isect_flat, isect_tile, tile_offsets, counts); dense ids a permutation of D = {d.shape[0]}")
    return n, d.shape[0]


def group_reduce_bound(calls):
    """Every input row read once, every group sum written once; b - 1 adds
    per group and column."""
    nbytes = ops = 0
    for x, b in (pop for call in calls for pop in populations(call)):
        groups = x.shape[0] // b
        nbytes += x.numel() * 4 + groups * x.shape[1] * 4
        ops += (b - 1) * groups * x.shape[1]
    return bound_ms(nbytes, ops)


def segsum_compact_bound(call):
    """Rows and ids read once, the written groups' sums written once; one add
    per row past its group's first, per column."""
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg

    (rows, g), kw = call
    n_groups = int(seg.group_slots(g)[-1]) + 1
    written = min(n_groups, kw["max_groups"])
    nbytes = rows.numel() * 4 + g.numel() * 4 + written * rows.shape[1] * 4
    return bound_ms(nbytes, (rows.shape[0] - n_groups) * rows.shape[1])


def monotone_expand_bound(call):
    """Ranks and flags read once, each present row's input row read once,
    every output row written once; no arithmetic."""
    (compact, rank, present), _ = call
    n_read = int(present.sum())
    c = rank.shape[0]
    return bound_ms(c * 5 + n_read * compact.shape[1] * 4 + c * compact.shape[1] * 4, 0)


def time_reduction_kernels(name, rec):
    """(ms, plain ms, library ms, bound ms, bound by) per kernel of the
    reduction, on the calls recorded from the real step: kernels over 20
    launches, plain versions over 3, and one PyTorch call computing the
    same function (or nearly) as the yardstick."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg

    out = {}
    if name == "dense":
        calls = rec["group_reduce"]
        pops = [pop for call in calls for pop in populations(call)]
        for x, b in pops:
            library = lambda x=x, b=b: x.view(-1, b, x.shape[1]).sum(1)  # noqa: E731
            log(f"[11] library sum of {x.shape[0]} rows in groups of {b}: "
                f"{cuda_ms(library, 20):.4f} ms (device alone {queued_ms(library, 20):.4f})")
        for call in calls:
            kernel = lambda call=call: gr.group_reduce(*call[0], **call[1])  # noqa: E731
            log(f"[11] group_reduce launch, {describe(call)}: {cuda_ms(kernel, 20):.4f} ms "
                f"(device alone {queued_ms(kernel, 20):.4f})")
        # the step's launches, and the library's calls for the same
        # populations, back to back as the step makes them
        ms = cuda_ms(lambda: [gr.group_reduce(*a, **k) for a, k in calls], 20)
        lib = cuda_ms(lambda: [x.view(-1, b, x.shape[1]).sum(1) for x, b in pops], 20)
        plain = cuda_ms(lambda: [gr.group_reduce_plain(*a, **k) for a, k in calls], 3, 1)
        out["group_reduce"] = (ms, plain, lib) + group_reduce_bound(calls)
    elif name == "pallas":
        call = rec["segsum_compact"][0]
        (rows, g), kw = call
        mg = kw["max_groups"]
        lengths = torch.unique_consecutive(g, return_counts=True)[1]
        out["segsum_compact"] = (
            cuda_ms(lambda: seg.segsum_compact(rows, g, mg), 20),
            cuda_ms(lambda: seg.segsum_compact_plain(rows, g, mg), 3, 1),
            cuda_ms(lambda: torch.segment_reduce(rows, "sum", lengths=lengths), 20),
        ) + segsum_compact_bound(call)
        call = rec["monotone_expand"][0]
        (compact, rank, present), _ = call
        rank64 = rank.to(torch.int64)
        out["monotone_expand"] = (
            cuda_ms(lambda: seg.monotone_expand(compact, rank, present), 20),
            cuda_ms(lambda: seg.monotone_expand_plain(compact, rank, present), 3, 1),
            cuda_ms(lambda: compact.index_select(0, rank64), 20),
        ) + monotone_expand_bound(call)
    for k, (ms, plain, lib, bound, by) in out.items():
        log(f"[11] {k}: {ms:.4f} ms/step, plain {plain:.4f} ms, library {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
    return out


def reduction_step(name, grad_fn, band_step, step_args, step_kw):
    """Phase 11 (a): one real step under reduction ``name`` with its kernels
    recorded and checked against their plain versions, and its gradients
    against the band step's. Returns (max abs errors, recorded calls)."""
    import torch

    from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
    from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(trt, "BWD_REDUCE", name))
        rec = {k: stack.enter_context(recording(mod, k)) for mod, k in (
            (seg, "segsum_band"), (seg, "segsum_compact"), (seg, "monotone_expand"),
            (gr, "group_reduce"), (trt, "bin_gaussians"))}
        got = grad_fn(*step_args, **step_kw)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    pattern = {k: len(v) for k, v in rec.items() if k != "bin_gaussians"}
    want = {"segsum_band": 0, "segsum_compact": 0, "monotone_expand": 0, "group_reduce": 0}
    want.update(REDUCE_KERNELS[name])
    log(f"[11] {name}: one step's kernel calls {pattern}, peak device memory "
        f"{peak / 2**20:.0f} MiB")
    check(pattern == want, f"{name}: unexpected kernel call pattern {pattern}, want {want}")
    check_step_gradients(got, band_step, STRATEGY_RTOL, "11", f"{name} vs band")
    errs = {}
    if name == "pallas":
        errs["segsum_compact"] = check_segsum_compact(rec["segsum_compact"][0])
        errs["monotone_expand"] = check_monotone_expand(rec["monotone_expand"][0])
    elif name == "dense":
        errs["group_reduce"] = check_group_reduce(rec["group_reduce"])
        check_grid_binning(rec["bin_gaussians"][0])
    del got
    return errs, rec, peak


def train_reduction(name, xyzs, rgbs, frames, device, seed):
    """Phase 11 (b): ``train()`` under reduction ``name`` with the compressed
    schedule; each of its kernels' launches rise every step, the other
    reductions' kernels never, no step truncates, the loss is finite and
    falls before the densify event. Returns (launch counts, step ms, peak
    device memory)."""
    import random

    import torch

    from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
    from easy_gaussian_splatting_torch.training import trainer as ttrainer
    from easy_gaussian_splatting_torch.training.config import load_config

    cfg = load_config(REPO / "configs" / "nerf_synthetic.yaml", **REDUCE_SCHEDULE)
    random.seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with swapped(trt, "BWD_REDUCE", name):
        # one camera: every step sees the same view, so the loss of each
        # reduction falls step by step and the runs are comparable (over
        # the four ring views, 9 steps of learning move the loss less than
        # the views differ)
        loop, rec = train_recorded(cfg, RingScene(xyzs, rgbs, frames[:1], cfg.total_iterations),
                                   device, REDUCE_PROFILED)
    total = counts()
    peak = torch.cuda.max_memory_allocated()
    steps = rec["steps"]
    check(len(steps) == cfg.total_iterations == loop.step, f"{name}: trained {len(steps)} steps")
    check(rec["densify"] == 1 and rec["reset"] == 0,
          f"{name}: {rec['densify']} densify events and {rec['reset']} resets ran, want 1 and 0")
    own = dict(REDUCE_KERNELS[name], tiled_forward=1, tiled_backward=1)
    if name != "dense":
        own["binkeys"] = 1
    never = [k for k in ("segsum_band", "segsum_compact", "monotone_expand", "group_reduce")
             if k not in own] + (["binkeys"] if name == "dense" else [])
    short = [i + 1 for i, s in enumerate(steps) if any(s["launches"][k] < n for k, n in own.items())]
    check(not short, f"{name}: a kernel was launched fewer times than its per-step count at steps {short}")
    check(all(total[k] == 0 for k in never), f"{name}: another path's kernel ran: {total}")
    check(rec["graphed"], f"{name}: train() did not run the graphed step")
    log_captures(f"11 {name}", rec)
    check_replays(f"11 {name}", rec, own)
    truncated = [i + 1 for i, s in enumerate(steps) if s["isects"] > s["cap"]]
    check(not truncated, f"{name}: truncated steps {truncated}")
    losses = [s["loss"] for s in steps]
    check(all(math.isfinite(x) for x in losses), f"{name}: a loss is not finite")
    early, later = float(np.mean(losses[:4])), float(np.mean(losses[5:9]))
    step_ms = [steps[i]["ms"] for i in REDUCE_TIMED]
    log(f"[11] {name} train(): {loop.step} steps, {rec['densify']} densify event, "
        f"{loop.model.num_alive()} gaussians at the end; launches "
        + ", ".join(f"{k} {v}" for k, v in total.items() if v)
        + f"; loss mean of steps 1-4 {early:.5f}, of steps 6-9 {later:.5f} (per step "
        + " ".join(f"{x:.4f}" for x in losses) + "); step ms (steps 5-9) "
        + " ".join(f"{x:.2f}" for x in step_ms) + f", median {float(np.median(step_ms)):.2f}; "
        f"peak device memory {peak / 2**20:.0f} MiB")
    check(later < early, f"{name}: the loss did not fall before the densify event")
    # where a step's time goes, on the state after the run (autotuned config)
    with swapped(trt, "BWD_REDUCE", name):
        step_fn = ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg))
        f0 = [torch.as_tensor(frames[0][k], device=device) for k in ("w2c", "K", "image", "mask")]
        profile_device(
            lambda: step_fn(loop.model, loop.adam, *f0, 1e-4, True, False, False,
                            height=800, width=800, sh_degree=3),
            3, "step", f"11 {name}", top=8,
        )
    return total, float(np.median(step_ms)), peak


# ----------------------------------------------------------------- phase 12
def parent_kernels(root: Path):
    """The ``tile_raster``, ``group_reduce``, ``binkeys`` and ``segments``
    wrapper modules of another checkout of this repository, imported as a package of their own
    (they build their kernels from that checkout's sources into its own
    build directory), so that both trees' kernels run in one process."""
    import importlib
    import importlib.util

    name = "ab_parent_egs"
    pkg = root.resolve() / "easy_gaussian_splatting_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{name}.ops.kernels.{k}")
                 for k in ("tile_raster", "group_reduce", "binkeys", "segments"))


def ab_compare(root: Path, fw_inputs: dict, bw_inputs: dict, gr_calls, bk_calls: dict,
               compact_call) -> None:
    """Each redesigned kernel against the parent's on the same recorded
    inputs: outputs compared, then timed parent, change, change, parent
    (CUDA events over 20 launches each; ``binkeys`` also on the device alone,
    behind a device-side wait)."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk
    from easy_gaussian_splatting_torch.ops.kernels import group_reduce as gr
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg
    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    ptr, pgr, pbk, pseg = parent_kernels(root)
    cases = []
    # segsum_compact on phase 11's pallas call: the written groups within
    # SEG_RTOL of their |sum| (the parent also sums each group in row order)
    (rows, g), kw = compact_call
    mg = kw["max_groups"]
    k = min(int(seg.group_slots(g)[-1]) + 1, mg)
    p_out, c_out = pseg.segsum_compact(rows, g, mg), seg.segsum_compact(rows, g, mg)
    mag = seg.segsum_compact_plain(rows.abs(), g, mg)
    diff = (p_out[:k] - c_out[:k]).abs()
    outside = int((diff > SEG_RTOL * mag[:k]).sum())
    log(f"[12] segsum_compact on phase 11's pallas call: change vs parent on {k} written groups: "
        f"{outside} values outside {SEG_RTOL} of the group's |sum|, max |diff| {float(diff.max()):.1e}, "
        f"equal {torch.equal(p_out[:k], c_out[:k])}")
    check(outside == 0, "segsum_compact differs from the parent's")
    cases.append(("segsum_compact on phase 11's pallas call",
                  lambda: pseg.segsum_compact(rows, g, mg), lambda: seg.segsum_compact(rows, g, mg)))
    for what, a in fw_inputs.items():
        (p_rgb, p_t, p_last), (c_rgb, c_t, c_last) = ptr.tiled_forward(*a), tr.tiled_forward(*a)
        log(f"[12] tiled_forward on {what}: change vs parent: last equal {torch.equal(p_last, c_last)}, "
            f"final T equal {torch.equal(p_t, c_t)}, rgb max |diff| {float((p_rgb - c_rgb).abs().max()):.1e}")
        check(torch.equal(p_last, c_last) and torch.equal(p_t, c_t),
              f"tiled_forward differs from the parent's in last or T on {what}")
        cases.append((f"tiled_forward on {what}", lambda a=a: ptr.tiled_forward(*a),
                      lambda a=a: tr.tiled_forward(*a)))
    for what, a in bw_inputs.items():
        d = (ptr.tiled_backward(*a) - tr.tiled_backward(*a)).abs().amax(0)[: tr.NUM_LIVE_GRADS]
        log(f"[12] tiled_backward on {what}: change vs parent max |diff| per column "
            + ", ".join(f"{float(x):.1e}" for x in d))
        cases.append((f"tiled_backward on {what}", lambda a=a: ptr.tiled_backward(*a),
                      lambda a=a: tr.tiled_backward(*a)))
    check(all(torch.equal(pgr.group_reduce(*a, **k), gr.group_reduce(*a, **k)) for a, k in gr_calls),
          "group_reduce differs from the parent's")
    cases.append(("group_reduce, the dense step's populations",
                  lambda: [pgr.group_reduce(*a, **k) for a, k in gr_calls],
                  lambda: [gr.group_reduce(*a, **k) for a, k in gr_calls]))
    queued = []
    for what, (a, k) in bk_calls.items():
        check(all(torch.equal(g, w) for g, w in zip(bk.binkeys(*a, **k), pbk.binkeys(*a, **k))),
              f"binkeys differs from the parent's on {what}")
        log(f"[12] binkeys on {what}: keys, flats and counts equal to the parent's")
        parent = lambda a=a, k=k: pbk.binkeys(*a, **k)  # noqa: E731
        change = lambda a=a, k=k: bk.binkeys(*a, **k)  # noqa: E731
        cases.append((f"binkeys on {what}", parent, change))
        queued.append((f"binkeys on {what}, device alone", parent, change))
    for what, parent, change in cases:
        p1, c1, c2, p2 = (cuda_ms(fn, 20) for fn in (parent, change, change, parent))
        log(f"[12] {what}: parent {p1:.4f} ms, change {c1:.4f}, change {c2:.4f}, parent "
            f"{p2:.4f}; change / parent {(c1 + c2) / (p1 + p2):.3f}")
    for what, parent, change in queued:
        p1, c1, c2, p2 = (queued_ms(fn, 20) for fn in (parent, change, change, parent))
        log(f"[12] {what}: parent {p1:.4f} ms, change {c1:.4f}, change {c2:.4f}, parent "
            f"{p2:.4f}; change / parent {(c1 + c2) / (p1 + p2):.3f}")


# ----------------------------------------------------------------- phase 13
# configs/tandt_db.yaml with a schedule compressed so that the 60 steps hold
# the profiler window (steps 10-14), evals at steps 1, 30 and 60, one densify
# event (step 40), no opacity reset and a checkpoint at the end; SH 3 from
# the first step, as phases 7-11 train
DATA_SCHEDULE = dict(
    total_iterations=60, sh_degree_interval=0, refine_start=0, refine_every=40,
    reset_opacities_every=1000, eval_every=30, eval_render_num=3, profile_steps=5,
    save_model_iterations=[60], save_optimizer_state=True, log_every=10,
)
DATA_TIMED = range(15, 29)  # steps 16-29: after the profiler window, before the event
DATA_PROFILED = set(range(31, 40))  # replays profiled: after the timed steps and train()'s window
STREAM_STEPS = 30  # the streamed run (>= the 21 train frames the Scene tiles)
STREAM_TIMED = range(10, 29)  # its steps 11-29
# scripts/validate_e2e.py's defaults (--iters 800 --size 128) and its own
# gate, run through the port's e2e script
E2E_ITERS, E2E_SIZE, E2E_MIN_PSNR = 800, 128, 22.0


@contextlib.contextmanager
def data_path_records():
    """Record the frame caches ``train()`` builds and the evals it runs."""
    from easy_gaussian_splatting_torch.evaluation import evaluator as ev
    from easy_gaussian_splatting_torch.scene import device_cache as dc

    rec = {"caches": [], "evals": []}
    build_orig, evaluate_orig = dc.build_cache, ev.Evaluator.evaluate

    def build(scene, split, *a, **k):
        cache = build_orig(scene, split, *a, **k)
        rec["caches"].append((split, cache))
        return cache

    def evaluate(self, *a, **k):
        metrics = evaluate_orig(self, *a, **k)
        rec["evals"].append((k.get("cache"), metrics))
        return metrics

    with swapped(dc, "build_cache", build), swapped(ev.Evaluator, "evaluate", evaluate):
        yield rec


def iteration_ms(steps, timed) -> list:
    """Host-clock intervals between consecutive steps' starts: the step, its
    frame's fetch (and upload, when streamed) and the loop's own work."""
    return [(steps[i + 1]["start"] - steps[i]["start"]) * 1e3 for i in timed]


def train_data_path(scene_dir: Path, out_dir: Path, device, card: str) -> dict:
    """Phase 13 (a): ``train(cfg)`` with no scene object on the COLMAP scene
    at ``scene_dir``, the frame caches on (the config's default), evals and
    the profiler window; then a streamed run of a few steps."""
    import random

    import torch

    from easy_gaussian_splatting_torch.training.config import dump_config, load_config
    from easy_gaussian_splatting_torch.utils.checkpoint import load_checkpoint

    cfg = load_config(REPO / "configs" / "tandt_db.yaml", **DATA_SCHEDULE, data=str(scene_dir),
                      output=str(out_dir))
    check(cfg.data_device_cache, "the config turned the device frame cache off")
    log("[13] config: configs/tandt_db.yaml with " + json.dumps(DATA_SCHEDULE)
        + f", data {scene_dir.name}, data_device_cache {cfg.data_device_cache}")
    # the resolved config, as the train CLI writes it: phase 15's eval reads it
    out_dir.mkdir(parents=True, exist_ok=True)
    dump_config(cfg, out_dir / "config.yaml")
    random.seed(cfg.random_seed)
    np.random.seed(cfg.random_seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with data_path_records() as drec:
        loop, rec = train_recorded(cfg, None, device, DATA_PROFILED)
    train_s = time.perf_counter() - t0
    total = counts()
    peak = torch.cuda.max_memory_allocated()
    steps = rec["steps"]
    check(len(steps) == cfg.total_iterations == loop.step, f"trained {len(steps)} steps")
    caches = dict(drec["caches"])
    check(set(caches) == {"train", "eval"} and all(c is not None for c in caches.values()),
          f"the frame caches were not both built: {caches}")
    for split, c in caches.items():
        log(f"[13] {split} frame cache resident on the card: {c.num_frames} frames, "
            f"{c.nbytes / 2**20:.1f} MiB")
    log(f"[13] train(): {loop.step} steps in {train_s:.1f} s, {rec['densify']} densify event, "
        f"{loop.model.num_alive()} gaussians at the end (capacity {loop.model.capacity}); launches "
        + ", ".join(f"{k} {v}" for k, v in total.items() if v))
    short = [i + 1 for i, st in enumerate(steps)
             if any(st["launches"][n] < PER_STEP[n] for n in PER_STEP)]
    check(not short, f"a kernel was launched fewer times than its per-step count at steps {short}")
    check(rec["graphed"], "[13] train() did not run the graphed step")
    log_captures("13", rec)
    check_replays("13", rec, PER_STEP)
    truncated = [i + 1 for i, st in enumerate(steps) if st["isects"] > st["cap"]]
    check(not truncated, f"truncated steps: {truncated}")
    check(rec["densify"] == 1 and rec["reset"] == 0,
          f"{rec['densify']} densify events and {rec['reset']} resets ran, want 1 and 0")
    losses = [st["loss"] for st in steps]
    check(all(math.isfinite(x) for x in losses), "a loss is not finite")
    early, later = float(np.mean(losses[:10])), float(np.mean(losses[30:40]))
    log(f"[13] loss: mean of steps 1-10 {early:.5f}, of steps 31-40 {later:.5f}; per step "
        + " ".join(f"{x:.4f}" for x in losses))
    check(later < early, "the loss did not fall before the densify event")
    evals = drec["evals"]
    check(len(evals) == 3 and all(c is caches["eval"] for c, _ in evals),
          f"{len(evals)} evals ran, want 3 from the eval cache")
    for step, (_, m) in zip((1, 30, 60), evals):
        vals = {k: m[k] for k in ("psnr", "ssim", "lpips_proxy", "fps", "latency_ms",
                                  "latency_device_ms")}
        check(all(math.isfinite(v) for v in vals.values()), f"eval at step {step}: {vals}")
        check(vals["latency_device_ms"] < vals["latency_ms"],
              f"eval at step {step}: the device latency is above the blocking host latency")
        log(f"[13] eval at step {step}: " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
            + f", {sum(k.startswith('render_') for k in m)} side-by-side renders")
    trace = out_dir / "profile" / "trace.json"
    check(trace.exists() and trace.stat().st_size > 0, f"no profiler trace at {trace}")
    log(f"[13] profiler trace (steps 10-14): {trace.relative_to(out_dir)}, "
        f"{trace.stat().st_size / 2**20:.1f} MiB")
    ckpt = out_dir / "checkpoints" / f"iterations_{cfg.total_iterations}.npz"
    state, sh, step, adam = load_checkpoint(ckpt, device)
    check(step == cfg.total_iterations and adam is not None
          and state.num_alive() == loop.model.num_alive(), "the checkpoint did not reload")
    log(f"[13] checkpoint {ckpt.name}: step {step}, SH {sh}, {state.num_alive()} gaussians, "
        "Adam state reloaded")
    step_ms = [steps[i]["ms"] for i in DATA_TIMED]
    it_ms = iteration_ms(steps, DATA_TIMED)
    dev_ms = [s.elapsed_time(e) for s, e in rec["step_events"]]
    dev_step = float(np.median([dev_ms[i] for i in DATA_TIMED]))
    del loop, state, adam, drec
    torch.cuda.empty_cache()

    # the same path with each step's frame streamed from the host, decoded
    # ahead by the config's prefetch threads
    log(f"[13] card: {card}")
    log(f"[13] cached: step median (steps 16-29, host clock between synchronizes) "
        f"{float(np.median(step_ms)):.2f} ms, on CUDA events {dev_step:.2f} ms, loop "
        f"iteration median {float(np.median(it_ms)):.2f} ms; peak device memory in train() "
        f"{peak / 2**20:.0f} MiB")
    scfg = load_config(REPO / "configs" / "tandt_db.yaml", **dict(
        DATA_SCHEDULE, total_iterations=STREAM_STEPS, refine_start=1000, profile_steps=0,
        eval_every=1000, save_model_iterations=[]), data=str(scene_dir), output=None,
        data_device_cache=False)
    random.seed(cfg.random_seed)
    np.random.seed(cfg.random_seed)
    with data_path_records() as srec:
        sloop, stream = train_recorded(scfg, None, device)
    check(not srec["caches"] and sloop.step == STREAM_STEPS, "the streamed run built a cache")
    s_step = float(np.median([stream["steps"][i]["ms"] for i in STREAM_TIMED]))
    s_dev = [s.elapsed_time(e) for s, e in stream["step_events"]]
    s_dev_step = float(np.median([s_dev[i] for i in STREAM_TIMED]))
    s_it = float(np.median(iteration_ms(stream["steps"], STREAM_TIMED)))
    log(f"[13] streamed (data_device_cache false, dataloader_workers {scfg.dataloader_workers}, "
        f"{STREAM_STEPS} steps): step median (steps 11-29) {s_step:.2f} ms, on CUDA events "
        f"{s_dev_step:.2f} ms, loop iteration median {s_it:.2f} ms")
    return dict(launches=total, step_ms=float(np.median(step_ms)), it_ms=float(np.median(it_ms)),
                peak=peak, stream_step_ms=s_step, stream_it_ms=s_it)


def convergence(workdir: Path) -> dict:
    """Phase 13 (b): scripts/validate_e2e.py's defaults through the port's e2e
    script (``validate_e2e.main``): a Blender scene rendered by the port's
    oracle, ``train(cfg)`` for 800 steps, then the eval split (the test
    directory) of a Scene rebuilt after re-seeding; below the gate fails."""
    from easy_gaussian_splatting_torch import validate_e2e

    argv = ["--iters", str(E2E_ITERS), "--size", str(E2E_SIZE), "--min-psnr", str(E2E_MIN_PSNR),
            "--out", str(workdir), "--device", DEVICE]
    log("[13] e2e: python -m easy_gaussian_splatting_torch.validate_e2e " + " ".join(argv))
    out = validate_e2e.main(argv)
    log(f"[13] e2e: {E2E_ITERS} steps in {out['train_s']:.1f} s "
        f"({E2E_ITERS / out['train_s']:.1f} it/s), {out['gaussians']} gaussians; eval on the test "
        f"frames: psnr {out['psnr']:.2f} dB, ssim {out['ssim']:.4f}, lpips_proxy "
        f"{out['lpips_proxy']:.4f} (gate {E2E_MIN_PSNR} dB)")
    check(out["passed"] and out["psnr"] >= E2E_MIN_PSNR,
          f"e2e psnr {out['psnr']:.2f} below {E2E_MIN_PSNR}")
    return out


# ----------------------------------------------------------------- phase 14
BATCH = 4  # bench.py's batched point
BATCH_STEPS = 10  # timed batched steps, chained as training chains them
BATCH_KERNELS = ("binkeys", "tiled_forward", "tiled_backward", "segsum_band")


def batched_step(cfg, state0, frames, single_ms: float, device, card: str) -> dict:
    """Phase 14: the port's ``make_batched_train_step`` on the first
    ``BATCH`` ring views at phase 8's state and binning: held against its
    sequential reference (``make_grad_fn`` per view, the gradients summed in
    view order and divided by B, the statistics view by view, one
    ``adam_update``), each main-path kernel launched B times a step, no
    view truncated; then ``BATCH_STEPS`` chained steps timed."""
    import torch

    from easy_gaussian_splatting_torch.models.density import update_statistics
    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES, GaussianParams
    from easy_gaussian_splatting_torch.models.optimizer import adam_update, init_adam_state
    from easy_gaussian_splatting_torch.ops.rasterize_tiled import isect_capacity
    from easy_gaussian_splatting_torch.training import trainer as ttrainer

    views = [torch.stack([torch.as_tensor(f[k], device=device) for f in frames[:BATCH]])
             for k in ("w2c", "K", "image", "mask")]
    kw = dict(height=800, width=800, sh_degree=3)
    lr = cfg.means_lr_init
    render_fn = ttrainer.get_render_fn(cfg)
    step = ttrainer.make_batched_train_step(cfg, render_fn)
    adam0 = init_adam_state(state0.params)
    icap = isect_capacity(state0.capacity, cfg.isect_mult)

    # the sequential reference, on the card
    grad_fn = ttrainer.make_grad_fn(cfg, render_fn)
    total, stats = state0.params.map(torch.zeros_like), state0.stats
    for i in range(BATCH):
        g, a, _, radii = grad_fn(state0, *(v[i] for v in views), **kw)
        stats = update_statistics(stats, radii, a, 800, 800)
        total = GaussianParams(**{n: getattr(total, n) + getattr(g, n) for n in PARAM_NAMES})
        del g, a, radii
    lrs = dict(means=lr, log_scales=cfg.log_scales_lr, quats=cfg.quats_lr, sh_0=cfg.sh_0_lr,
               sh_rest=cfg.sh_rest_lr, logit_opacities=cfg.logit_opacities_lr)
    want_params, want_adam = adam_update(state0.params, total.map(lambda x: x / float(BATCH)),
                                         adam0, lrs, {n: False for n in PARAM_NAMES})
    del total

    zero_counts()
    got, got_adam, ld = step(state0, adam0, *views, lr, True, False, False, **kw)
    torch.cuda.synchronize()
    one = counts()
    check(all(one[k] == BATCH for k in BATCH_KERNELS),
          f"one batched step launched {one}, want {BATCH} of each of {BATCH_KERNELS}")
    check(int(ld["isects"]) <= icap, f"a view was truncated: {int(ld['isects'])} > {icap}")
    diffs, equal = {}, True
    for name in PARAM_NAMES:
        for what, a, b in (("params", got.params, want_params), ("mu", got_adam.mu, want_adam.mu),
                           ("nu", got_adam.nu, want_adam.nu)):
            x, y = getattr(a, name), getattr(b, name)
            equal &= torch.equal(x, y)
            diffs[f"{what}.{name}"] = float((x - y).abs().max())
        # where the gradient clears 1e-3 of the group's largest, the first
        # Adam step moves a parameter by ~lr * sign(g) in both
        mu = getattr(want_adam.mu, name).abs()
        clear = mu > 1e-3 * mu.max()
        d = (getattr(got.params, name) - getattr(want_params, name)).abs()[clear]
        d = float(d.max()) if d.numel() else 0.0
        check(d <= 1e-6 + 1e-3 * lrs[name],
              f"batched step: {name} differs from the sequential reference by {d:.3e}")
        m_got, m_want = getattr(got_adam.mu, name), getattr(want_adam.mu, name)
        rel = float((m_got - m_want).norm() / m_want.norm().clamp(min=1e-30))
        check(rel <= STEP_GRAD_RTOL, f"batched step: {name}'s mean gradient off by {rel:.2e}")
    for k in ("grad_norm_accum", "collecting_counts", "max_radii"):
        x, y = getattr(got.stats, k), getattr(stats, k)
        equal &= torch.equal(x, y)
        diffs[f"stats.{k}"] = float((x - y).abs().max())
    again = step(state0, adam0, *views, lr, True, False, False, **kw)[0]
    repeat = all(torch.equal(getattr(again.params, n), getattr(got.params, n)) for n in PARAM_NAMES)
    log(f"[14] batched step, B = {BATCH} ring views 800x800, {state0.num_alive()} gaussians "
        f"(capacity {state0.capacity}), isect_mult {cfg.isect_mult}: worst view {int(ld['isects'])} "
        f"intersections of capacity {icap}; launches in one step "
        + ", ".join(f"{k} {one[k]}" for k in BATCH_KERNELS))
    log(f"[14] vs the sequential reference on the card: "
        + ("bit for bit equal" if equal else "not bit for bit") + "; max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items() if v or k.startswith("params")))
    log(f"[14] a second batched step on the same inputs: "
        + ("equal bit for bit" if repeat else "differs") + f"; loss {float(ld['total']):.6f}")
    del got, got_adam, again, want_params, want_adam, stats

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    model, adam, times, worst = state0, adam0, [], []
    for _ in range(BATCH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, adam, ld = step(model, adam, *views, lr, True, False, False, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        worst.append(int(ld["isects"]))
    timed = counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(timed[k] == BATCH * BATCH_STEPS for k in BATCH_KERNELS),
          f"{BATCH_STEPS} batched steps launched {timed}")
    check(max(worst) <= icap, f"a batched step was truncated: {max(worst)} > {icap}")
    med = float(np.median(times[1:]))
    log(f"[14] card: {card}")
    log(f"[14] {BATCH_STEPS} batched steps (host clock between synchronizes): median of steps "
        f"2-{BATCH_STEPS} {med:.2f} ms, {med / BATCH:.2f} ms per view, against phase 10's "
        f"single-view step median {single_ms:.2f} ms; each " + " ".join(f"{x:.1f}" for x in times)
        + f"; peak device memory {peak / 2**20:.0f} MiB; launches " + ", ".join(
            f"{k} {timed[k]}" for k in BATCH_KERNELS))
    del model, adam
    profile_device(lambda: step(state0, adam0, *views, lr, True, False, False, **kw), 3,
                   "batched step", "14", top=8)
    return dict(launches=timed, step_ms=med, peak=peak)


# ----------------------------------------------------------------- phase 15
VIEW_STEPS = 24  # the view_online run (>= the 21 train frames the Scene tiles)
VIEW_TIMED = range(5, 23)  # its steps 6-23
VIEW_REQUEST = dict(yaw=0.6, pitch=0.3, radius=4.0, target=[0, 0, 0], fov=1.0,
                    width=1280, height=720)


def eval_cli(run_dir: Path, eager: bool = False, tag: str = "15") -> dict:
    """Phase 15 (a): the port's eval command on phase 13 (a)'s run directory:
    the binning tuned again, no truncated frame, finite metrics per split.
    The evaluator replays its frame and LPIPS programs (CUDA graphs); with
    ``eager`` (phase 18 (b)) it renders eagerly instead. Returns the
    launches, each split's metrics and the ``Evaluator``s built."""
    from easy_gaussian_splatting_torch import eval as teval
    from easy_gaussian_splatting_torch.evaluation import evaluator as tev
    from easy_gaussian_splatting_torch.training import trainer as ttrainer

    tuned, evaluators, chains = [], [], {}
    tune, evaluate, chain_ms = ttrainer.tune_inference_cfg, tev.Evaluator.evaluate, tev.Evaluator._chain_ms

    def record(cfg, *a, **k):
        out = tune(cfg, *a, **k)
        tuned.append(out.isect_mult)
        return out

    def recorded(self, *a, **k):
        evaluators.append(self)
        return evaluate(self, *a, **k)

    def chain_recorded(self, *a):
        chains[id(self)] = (self, a)  # each evaluator's last latency chain
        return chain_ms(self, *a)

    zero_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(ttrainer, "tune_inference_cfg", record))
        stack.enter_context(swapped(tev.Evaluator, "evaluate", recorded))
        stack.enter_context(swapped(tev.Evaluator, "_chain_ms", chain_recorded))
        if eager:
            stack.enter_context(swapped(tev.Evaluator, "_programs_on", lambda self, device: None))
        results = teval.main(["-p", str(run_dir), "--device", DEVICE])
    secs = time.perf_counter() - t0
    launches = counts()
    check(len(tuned) == 1 and set(results) == {"train", "eval"},
          f"eval: {len(tuned)} autotunes, splits {sorted(results)}")
    check(all((ev._programs is None) == eager for ev in evaluators),
          f"[{tag}] eval: the evaluator's programs are not what was asked (eager {eager})")
    mode = "eager" if eager else "graphed"
    for split, m in results.items():
        vals = {k: m[k] for k in ("psnr", "ssim", "lpips_proxy", "fps", "latency_ms",
                                  "latency_device_ms")}
        check(all(math.isfinite(v) for v in vals.values()), f"eval {split}: {vals}")
        check(m["max_isects"] <= m["isect_cap"], f"eval {split}: a truncated frame")
        log(f"[{tag}] eval ({mode}) {split} split: " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
            + f"; worst frame {m['max_isects']} intersections of capacity {m['isect_cap']}, "
            f"{m['rerenders']} passes again")
    check(launches["binkeys"] > 0 and launches["tiled_forward"] > 0, f"eval launched {launches}")
    log(f"[{tag}] eval ({mode}): python -m easy_gaussian_splatting_torch.eval -p {run_dir.name} in "
        f"{secs:.1f} s, autotuned isect_mult {tuned[0]}; launches binkeys {launches['binkeys']}, "
        f"tiled_forward {launches['tiled_forward']}")
    return dict(launches=launches, results=results, evaluators=evaluators,
                chains=list(chains.values()), secs=secs)


# the out-of-process client: posts the request every 16 ms until the server
# refuses (train() stopped it), then prints each answered request's ms
CLIENT_SRC = r"""
import json, sys, time, urllib.request
port, payload, times = int(sys.argv[1]), sys.argv[2].encode(), []
while True:
    req = urllib.request.Request(f"http://localhost:{port}/render", data=payload, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            if r.headers.get("Content-Type") != "image/jpeg" or not r.read():
                break
    except OSError:
        break
    times.append((time.perf_counter() - t0) * 1e3)
    time.sleep(0.016)
print(json.dumps(times))
"""


class ThreadClient:
    """Posts ``VIEW_REQUEST`` every 16 ms from a thread of this process."""

    def __init__(self, port: int):
        import threading

        self.port, self.times, self.errors = port, [], []
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.done.is_set():
            try:
                _, ctype, ms = http(self.port, "/render", VIEW_REQUEST)
                if ctype != "image/jpeg":
                    self.errors.append(f"content type {ctype}")
                    return
                self.times.append(ms)
            except Exception as e:  # recorded and checked by the phase
                self.errors.append(repr(e))
                return
            time.sleep(0.016)

    def finish(self, stop):
        self.close()
        self.thread.join(60)
        if self.thread.is_alive():
            self.errors.append("the client thread did not end")
        stop()

    def close(self):
        self.done.set()


class ProcessClient:
    """Posts ``VIEW_REQUEST`` every 16 ms from a process of its own, as a
    browser does."""

    def __init__(self, port: int):
        self.times, self.errors = [], []
        self.proc = subprocess.Popen([sys.executable, "-c", CLIENT_SRC, str(port),
                                      json.dumps(VIEW_REQUEST)], stdout=subprocess.PIPE, text=True)

    def finish(self, stop):
        stop()  # the client ends at its first refused request
        try:
            out, _ = self.proc.communicate(timeout=60)
            self.times = json.loads(out)
        except (subprocess.TimeoutExpired, ValueError) as e:
            self.errors.append(repr(e))
        finally:
            self.close()

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def view_online(scene_dir: Path, out_dir: Path, cached_ms: float, device, card: str,
                client_kind) -> dict:
    """Phase 15 (b): ``train(cfg)`` on phase 13 (a)'s scene with the training
    viewer, a client (``ThreadClient`` or ``ProcessClient``) posting 1280x720
    ``/render`` requests at the page's dragging cadence (16 ms) while the
    loop renders the newest one between steps."""
    import random
    import threading

    import torch

    from easy_gaussian_splatting_torch.training.config import load_config
    from easy_gaussian_splatting_torch.viewer import integration

    cfg = load_config(REPO / "configs" / "tandt_db.yaml", **dict(
        DATA_SCHEDULE, total_iterations=VIEW_STEPS, refine_start=1000, profile_steps=0,
        eval_every=1000, save_model_iterations=[]), data=str(scene_dir), output=str(out_dir),
        view_online=True)
    built, frames, clients = [], [], []
    construct = integration.construct_training_viewer

    def build(loop, cfg_, output_dir):
        viewer = construct(loop, cfg_, output_dir, port=0)
        render, stop = viewer.delay_render._render, viewer.stop

        def timed(cam):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(cam)  # ends in the image's copy to the host
            frames.append(((time.perf_counter() - t0) * 1e3, dict(viewer.base_render_func.stats),
                           threading.current_thread() is threading.main_thread()))
            return img

        viewer.delay_render._render = timed
        viewer.stop = lambda: clients[0].finish(stop)
        built.append(viewer)
        clients.append(client_kind(viewer.port))
        return viewer

    random.seed(cfg.random_seed)
    np.random.seed(cfg.random_seed)
    try:
        with swapped(integration, "construct_training_viewer", build):
            loop, rec = train_recorded(cfg, None, device)
    finally:  # train() stops the viewer, and with it the client, unless it raised
        for c in clients:
            c.close()
    what = "thread" if client_kind is ThreadClient else "process"
    check(len(built) == 1 and loop.step == VIEW_STEPS, f"{len(built)} viewers, {loop.step} steps")
    times = clients[0].times
    check(not clients[0].errors and times, f"the client ({what}) failed: {clients[0].errors}")
    check(frames and all(on_loop for _, _, on_loop in frames), "a frame was not rendered on the loop")
    check(all(st["num_isects"] <= st["isect_cap"] for _, st, _ in frames), "a served frame truncated")
    steps = rec["steps"]
    short = [i + 1 for i, st in enumerate(steps)
             if any(st["launches"][n] < PER_STEP[n] for n in PER_STEP)]
    check(not short, f"a kernel was launched fewer times than its per-step count at steps {short}")
    check(rec["graphed"], "[15] train() did not run the graphed step")
    log_captures("15", rec)
    step_ms = float(np.median([steps[i]["ms"] for i in VIEW_TIMED]))
    it_ms = float(np.median(iteration_ms(steps, VIEW_TIMED)))
    log(f"[15] card: {card}")
    log(f"[15] view_online, client in a {what}: {loop.step} steps, {len(times)} /render 1280x720 "
        f"requests answered from the mailbox (median {float(np.median(times)):.1f} ms), "
        f"{len(frames)} frames rendered by the loop between steps (median "
        f"{float(np.median([ms for ms, _, _ in frames])):.1f} ms, "
        f"{sum(st['rerenders'] for _, st, _ in frames)} rendered again); step median (steps "
        f"6-23) {step_ms:.2f} ms against phase 13's cached {cached_ms:.2f} ms, loop iteration "
        f"median {it_ms:.2f} ms")
    return dict(step_ms=step_ms, it_ms=it_ms, frames=len(frames), requests=len(times))


# ----------------------------------------------------------------- phase 16
# the mesh on the card: MESH_WORLD ranks of one world share cuda:0 under gloo
# (NCCL refuses two ranks on one device, so it gets a world of one). Two
# processes time-share one card here: their times are no scaling number.
MESH_WORLD = 2
MESH_TIMEOUT_S = 600.0  # a rank's collectives fail after this, and its spawn too
# the gradient bands of tests/test_parallel.py (relative to the reference's
# largest |g|): tiled uniform stripes 5e-4, adaptive 5e-3
MESH_GRAD_RTOL = {"uniform": 5e-4, "adaptive": 5e-3}
# (a) renders with 16-pixel tiles, so that the two 400-row stripes start on
# a tile edge of the full frame (400 = 25 x 16; not so at the config's 32).
# The tiled renderer's output depends on where the tile grid falls: binning
# caps a Gaussian's support at 3 sigma per tile, and the kernels composite
# every pixel of a binned tile down to alpha 1/255, so a grid offset from
# the full frame's composites the 3-3.3 sigma ring of every Gaussian with
# opacity above 0.35 in other pixels. The adaptive stripes start on
# arbitrary rows: they are held to the single-device render of the same
# windows, and their distance from the full frame's step is printed.
MESH_TILE = 16
LOSS_RTOL_16 = {"uniform": 1e-6, "adaptive": 5e-5}  # tests/test_parallel.py's
MESH_GRAD_MODES = (("tiles:2 uniform", "tiles:2", "uniform"),
                   ("tiles:2 adaptive", "tiles:2", "adaptive"),
                   ("gauss:2 uniform", "gauss:2", "uniform"))
# phase 13 (a)'s scene and configs/tandt_db.yaml with a schedule cut to 21
# steps (the Scene's least: one a train frame): an eval at step 1 (rank 0),
# one densify event at step 15 and a checkpoint at the end
MESH_SCHEDULE = dict(
    total_iterations=21, sh_degree_interval=0, refine_start=0, refine_every=15,
    reset_opacities_every=1000, eval_every=1000, eval_render_num=1, profile_steps=0,
    save_model_iterations=[21], save_optimizer_state=False, log_every=1,
)
MESH_TIMED = range(1, 14)  # steps 2-14: after the eval, before the event
MESH_KERNELS = ("binkeys", "tiled_forward", "tiled_backward", "segsum_band")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(job: str, world: int, backend: str, kwargs: dict) -> list:
    """Run ``job`` on ``world`` ranks spawned from this process (one world
    over ``tcp://localhost``, ``backend``); every rank's result, or a
    failure with the traceback of the rank that raised. Every process is
    joined or killed before this returns."""
    import multiprocessing as mp
    import pickle

    out = RUN_DIR / "mesh"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob(f"{job}_rank*"):
        f.unlink()
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=mesh_rank, args=(job, r, world, port, backend, kwargs, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT_S + 120
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    errors = [f.read_text() for f in sorted(out.glob(f"{job}_rank*.err"))]
    check(not late and not errors and all(p.exitcode == 0 for p in procs),
          f"[16] {job}: ranks {late} still running, exit codes "
          f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [pickle.loads((out / f"{job}_rank{r}.pkl").read_bytes()) for r in range(world)]


def mesh_rank(job, rank, world, port, backend, kwargs, out):
    """A spawned rank: joins the world, runs ``job`` and writes its result
    (or its traceback) under ``out``."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    from easy_gaussian_splatting_torch.parallel import collectives as col
    from easy_gaussian_splatting_torch.parallel import distributed

    try:
        distributed.initialize(f"tcp://localhost:{port}", world, rank, device=DEVICE,
                               backend=backend, timeout_s=MESH_TIMEOUT_S)
        res = MESH_JOBS[job](rank, **kwargs)
        res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        res["collectives"] = {f"{name} ({be})": n for (name, be), n in sorted(col.CALLS.items())}
        dist.barrier()
        dist.destroy_process_group()
        Path(out, f"{job}_rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        Path(out, f"{job}_rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _mesh_inputs(state_path):
    """Phase 8's state, first frame and tuned binning from ``state_path``."""
    import dataclasses

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import (
        GaussianModelState,
        GaussianParams,
        zero_stats,
    )
    from easy_gaussian_splatting_torch.training.config import load_config

    blob = torch.load(state_path, map_location=DEVICE)
    cfg = dataclasses.replace(load_config(REPO / "configs" / "nerf_synthetic.yaml", **TRAIN_SCHEDULE),
                              **blob["binning"])
    alive = blob["alive"]
    state = GaussianModelState(params=GaussianParams(**blob["params"]), alive=alive,
                               stats=zero_stats(alive.shape[0], alive.device))
    return cfg, state, blob["frame"]


def windowed_grads(cfg, state, w2c, K, image, mask, partition: str, n: int):
    """The single-device reference of an ``n``-stripe step: each rank's
    window (``partition``'s) rendered in this process, the image
    reassembled, one loss and one backward: (grads, absgrad, loss dict,
    radii)."""
    import torch

    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES, GaussianParams
    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.parallel import shard
    from easy_gaussian_splatting_torch.training import trainer as tt

    render_fn = tt.get_render_fn(cfg)
    h, w = image.shape[:2]
    bg = tt._background(cfg, image.device)
    leaves, absd = tt.grad_leaves(state.params, state.capacity)
    if partition == "adaptive":
        b = shard.adaptive_row_bounds(state.params, state.alive, w2c, K, h, n)
        cams = [CameraView(w2c, K, w, h, full_height=h, y_offset=b[i].to(torch.float32),
                           y_limit=(b[i + 1] - b[i]).to(torch.float32)) for i in range(n)]
    else:
        cams = [CameraView(w2c, K, w, h // n, full_height=h,
                           y_offset=torch.full((), float(i * h // n), device=image.device))
                for i in range(n)]
    outs = [render_fn(leaves, state.alive, cam, 3, bg, absd) for cam in cams]
    full = torch.cat([o.image for o in outs])
    if partition == "adaptive":
        full = shard.reassemble_adaptive(full, b, n, h)
    ld = tt.cfg_loss(cfg, full, image, mask, leaves, state.alive)
    g = tt.param_grads(ld["total"], leaves, absd)
    radii = torch.stack([o.radii for o in outs]).amax(0)
    return (GaussianParams(**dict(zip(PARAM_NAMES, g[:-1]))), g[-1],
            {k: v.detach() for k, v in ld.items()}, radii)


def _grad_errors(got, want) -> dict:
    """Each gradient's largest |difference| relative to the single step's
    largest |g|, absgrad's likewise, whether the radii are equal, the
    loss's relative difference."""
    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES

    (g, a, ld, r), (wg, wa, wld, wr) = got, want

    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))

    errs = {n: rel(getattr(g, n), getattr(wg, n)) for n in PARAM_NAMES}
    errs["absgrad"] = rel(a, wa)
    return dict(errs=errs, radii_equal=bool((r == wr).all()),
                loss_rel=abs(float(ld["total"]) / float(wld["total"]) - 1.0))


def mesh_grads_job(rank, state_path):
    """Phase 16 (a) on a rank of a gloo world: each mode's sharded pre-Adam
    gradients (its kernel launches, the time of the call and every rank's
    binning work from the striped counter), then one ``gauss:2`` and one
    ``tiles:2`` train step; rank 0 holds each against the single-device
    step."""
    import dataclasses
    import hashlib

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES
    from easy_gaussian_splatting_torch.models.optimizer import init_adam_state
    from easy_gaussian_splatting_torch.parallel import gauss_shard, shard
    from easy_gaussian_splatting_torch.parallel.mesh import GAUSS_AXIS, mesh_from_shape
    from easy_gaussian_splatting_torch.training import trainer as tt

    cfg, state, (w2c, K, image, mask) = _mesh_inputs(state_path)
    h, w = image.shape[:2]
    kw = dict(height=h, width=w)
    ref = tt.make_grad_fn(cfg, tt.get_render_fn(cfg))(state, w2c, K, image, mask, sh_degree=3,
                                                     **kw) if rank == 0 else None
    res, launches = {"modes": {}}, dict.fromkeys(counts(), 0)
    if rank == 0:
        # the config's own tiles: at 800 rows the second window's tile grid
        # is offset by 16 rows from the full frame's (see MESH_TILE)
        cfg_t = dataclasses.replace(cfg, **torch.load(state_path)["config_binning"])
        full_t = tt.make_grad_fn(cfg_t, tt.get_render_fn(cfg_t))(
            state, w2c, K, image, mask, sh_degree=3, **kw)
        res["config_tiles"] = dict(tile=cfg_t.tile_size, rows=h // MESH_WORLD, **_grad_errors(
            windowed_grads(cfg_t, state, w2c, K, image, mask, "uniform", MESH_WORLD), full_t))
        del full_t
    for name, shape, partition in MESH_GRAD_MODES:
        mcfg = dataclasses.replace(cfg, stripe_partition=partition)
        mesh = mesh_from_shape(shape, DEVICE)
        gauss = GAUSS_AXIS in mesh.axis_names
        rf = tt.get_render_fn(mcfg)
        make = gauss_shard.make_gauss_sharded_grad_fn if gauss else shard.make_sharded_grad_fn
        model = gauss_shard.shard_state(state, mesh) if gauss else state
        fn = make(mcfg, mesh, rf, h, w)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(model, w2c, K, image, mask, sh_degree=3)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        own = counts()
        for k in launches:
            launches[k] += own[k]
        work = shard.make_striped_isect_counter(
            mesh, mcfg.tile_size, mcfg.max_tiles, mcfg.max_tiles, ov_frac=mcfg.ov_frac,
            small_budget=mcfg.small_budget, reduce="none", partition=partition,
        )(state.params, state.alive, w2c, K, **kw)
        mode = dict(ms=ms, launches=own, isects=[int(x) for x in work[:, 0].tolist()],
                    step_isects=int(got[2]["isects"]))
        if rank == 0:
            mode["vs_full"] = _grad_errors(got, ref)
            mode["vs_windows"] = _grad_errors(got, windowed_grads(
                mcfg, state, w2c, K, image, mask, partition, mesh.size))
        res["modes"][name] = mode
        del got, model
    lr = cfg.means_lr_init
    flags = (lr, True, False, False)
    single = None
    if rank == 0:
        single = tt.make_train_step(cfg, tt.get_render_fn(cfg))(
            state, init_adam_state(state.params), w2c, K, image, mask, *flags, sh_degree=3, **kw)[0]
    res["steps"] = {}
    for shape in ("gauss:2", "tiles:2"):
        mcfg = dataclasses.replace(cfg, stripe_partition="uniform")
        mesh = mesh_from_shape(shape, DEVICE)
        gauss = GAUSS_AXIS in mesh.axis_names
        rf = tt.get_render_fn(mcfg)
        model, adam = state, init_adam_state(state.params)
        if gauss:
            model, adam = gauss_shard.shard_state(model, mesh), gauss_shard.shard_state(adam, mesh)
            step = gauss_shard.make_gauss_sharded_train_step(mcfg, mesh, rf, h, w)
        else:
            step = shard.make_sharded_train_step(mcfg, mesh, rf, h, w)
        zero_counts()
        model = step(model, adam, w2c, K, image, mask, *flags, sh_degree=3)[0]
        torch.cuda.synchronize()
        for k, v in counts().items():
            launches[k] += v
        if gauss:
            model = gauss_shard.gather_state(model, mesh)
        out = dict(digest=hashlib.sha256(b"".join(
            getattr(model.params, n).cpu().numpy().tobytes() for n in PARAM_NAMES)).hexdigest())
        if rank == 0:
            out["rel_l2"] = {n: float((getattr(model.params, n) - getattr(single.params, n)).norm()
                                      / getattr(single.params, n).norm().clamp(min=1e-30))
                             for n in PARAM_NAMES}
        res["steps"][shape] = out
        del model, adam
    res["launches"] = launches
    return res


def mesh_nccl_job(rank, state_path):
    """Phase 16 (a) on a world of one NCCL rank: ``tiles:1``'s gradients
    against the single step's, bit for bit (the stripe is the whole image:
    y_offset 0, y_limit H)."""
    import dataclasses

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES
    from easy_gaussian_splatting_torch.parallel import shard
    from easy_gaussian_splatting_torch.parallel.mesh import mesh_from_shape
    from easy_gaussian_splatting_torch.training import trainer as tt

    cfg, state, (w2c, K, image, mask) = _mesh_inputs(state_path)
    h, w = image.shape[:2]
    want = tt.make_grad_fn(cfg, tt.get_render_fn(cfg))(state, w2c, K, image, mask, height=h,
                                                      width=w, sh_degree=3)
    mcfg = dataclasses.replace(cfg, stripe_partition="uniform")
    zero_counts()
    got = shard.make_sharded_grad_fn(mcfg, mesh_from_shape("tiles:1", DEVICE),
                                     tt.get_render_fn(mcfg), h, w)(
        state, w2c, K, image, mask, sh_degree=3)
    torch.cuda.synchronize()
    launches = {k: counts()[k] for k in MESH_KERNELS}
    (g, a, ld, r), (wg, wa, wld, wr) = got, want
    equal = {n: torch.equal(getattr(g, n), getattr(wg, n)) for n in PARAM_NAMES}
    equal.update(absgrad=torch.equal(a, wa), radii=torch.equal(r, wr),
                 loss=bool(ld["total"] == wld["total"]))
    return dict(equal=equal, launches=launches, **_grad_errors(got, want))


def mesh_train_job(rank, scene_dir, out_dir, shape, seed):
    """Phase 16 (b) on a rank: ``train(cfg)`` under ``shape`` on phase 13
    (a)'s scene, each step timed (host clock between synchronizes) with its
    launches and intersections, the densify events and their capacities
    recorded; a digest of the final parameters."""
    import hashlib
    import random

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES
    from easy_gaussian_splatting_torch.parallel import gauss_shard, shard
    from easy_gaussian_splatting_torch.training import trainer as tt
    from easy_gaussian_splatting_torch.training.config import load_config

    cfg = load_config(REPO / "configs" / "tandt_db.yaml", **MESH_SCHEDULE, data=scene_dir,
                      output=out_dir, mesh_shape=shape)
    steps, events = [], []

    def timed(make):
        def made(*a, **k):
            step = make(*a, **k)

            def run(*a, **k):
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a, **k)
                torch.cuda.synchronize()
                after = counts()
                steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                  launches={n: after[n] - before[n] for n in MESH_KERNELS},
                                  isects=int(out[2]["isects"]), loss=float(out[2]["total"])))
                return out

            return run

        return made

    def densify(run):
        def wrapped(loop, *a, **k):
            cap0 = loop.model.capacity
            info = run(loop, *a, **k)
            events.append(dict(cap0=cap0, cap1=loop.model.capacity, info=info))
            return info

        return wrapped

    overflows = []

    def sharded_densify(make):
        def made(*a, **k):
            step = make(*a, **k)

            def run(*a, **k):
                out = step(*a, **k)
                overflows.append(bool(out[3]))
                return out

            return run

        return made

    random.seed(seed)
    np.random.seed(seed)
    zero_counts()
    with swapped(shard, "make_sharded_train_step", timed(shard.make_sharded_train_step)), \
            swapped(gauss_shard, "make_gauss_sharded_train_step",
                    timed(gauss_shard.make_gauss_sharded_train_step)), \
            swapped(gauss_shard, "make_sharded_densify_step",
                    sharded_densify(gauss_shard.make_sharded_densify_step)), \
            swapped(tt, "run_densify_with_growth", densify(tt.run_densify_with_growth)), \
            swapped(tt, "run_sharded_densify_with_growth",
                    densify(tt.run_sharded_densify_with_growth)):
        loop = tt.train(cfg, device=DEVICE)
    total = counts()
    digest = hashlib.sha256(b"".join(getattr(loop.model.params, n).cpu().numpy().tobytes()
                                     for n in PARAM_NAMES)
                            + loop.model.alive.cpu().numpy().tobytes()).hexdigest()
    return dict(steps=steps, events=events, overflows=overflows, digest=digest,
                capacity=loop.model.capacity, alive=loop.model.num_alive(),
                max_capacity=cfg.max_capacity, launches=total)


MESH_JOBS = {"grads": mesh_grads_job, "nccl": mesh_nccl_job, "train": mesh_train_job}


def mesh_gradients(cfg8, state0, frames, card: str):
    """Phase 16 (a): phase 8's state and first frame, its binning tuned
    again for ``MESH_TILE``-pixel tiles, on ``MESH_WORLD`` gloo ranks sharing
    the card (each ``MESH_GRAD_MODES`` mode, then a ``gauss:2`` and a
    ``tiles:2`` step), then on one NCCL rank (``tiles:1``). Returns rank 0's
    launches and the file of the state and frames (phase 18 (c) reads it,
    then removes it)."""
    import dataclasses

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES
    from easy_gaussian_splatting_torch.training.trainer import tune_inference_cfg

    frame0 = frames[0]
    cfg = tune_inference_cfg(dataclasses.replace(cfg8, tile_size=MESH_TILE), state0,
                             frame0["w2c"], frame0["K"], 800, 800, margin=1.2)
    path = RUN_DIR / "mesh_state.pt"
    torch.save(dict(params={n: getattr(state0.params, n) for n in PARAM_NAMES},
                    alive=state0.alive,
                    frame=[torch.as_tensor(frame0[k], device=DEVICE)
                           for k in ("w2c", "K", "image", "mask")],
                    frames=[[torch.as_tensor(f[k], device=DEVICE)
                             for k in ("w2c", "K", "image", "mask")] for f in frames[:2]],
                    binning=dict(tile_size=cfg.tile_size, isect_mult=cfg.isect_mult,
                                 small_budget=cfg.small_budget, ov_frac=cfg.ov_frac),
                    config_binning=dict(tile_size=cfg8.tile_size, isect_mult=cfg8.isect_mult,
                                        small_budget=cfg8.small_budget, ov_frac=cfg8.ov_frac)),
               path)
    t0 = time.perf_counter()
    ranks = spawn_ranks("grads", MESH_WORLD, "gloo", dict(state_path=str(path)))
    log(f"[16] card: {card}; {MESH_WORLD} gloo ranks time-share cuda:0 (the card's machine has one "
        f"GPU): no time below is a scaling number; (a) took {time.perf_counter() - t0:.1f} s; "
        f"tile {cfg.tile_size}, isect_mult {cfg.isect_mult}, small_budget {cfg.small_budget}, "
        f"ov_frac {cfg.ov_frac}")
    for name, _, partition in MESH_GRAD_MODES:
        m0 = ranks[0]["modes"][name]
        isects = m0["isects"]
        for r, res in enumerate(ranks):
            m = res["modes"][name]
            log(f"[16] {name} rank {r}: launches " + ", ".join(
                f"{k} {m['launches'][k]}" for k in MESH_KERNELS)
                + f"; its intersections {isects[r]}; the call {m['ms']:.1f} ms")
        log(f"[16] {name}: intersections per rank {isects}, max/mean "
            f"{max(isects) / max(np.mean(isects), 1):.3f} (the partition's load balance); the "
            f"step's isects (the fullest rank) {m0['step_isects']}")
        rtol = MESH_GRAD_RTOL[partition]
        for what, e in (("the single-device step", m0["vs_full"]),
                        ("the single-device render of the same windows", m0["vs_windows"])):
            worst = max(e["errs"].values())
            log(f"[16] {name} vs {what}: largest |diff| / max |g| "
                + ", ".join(f"{k} {v:.2e}" for k, v in e["errs"].items())
                + f" (band {rtol:g}: {'held' if worst <= rtol else 'missed'}); radii equal "
                f"{e['radii_equal']}; loss off by {e['loss_rel']:.2e}")
        # the windows' reference isolates the mesh from where the tile grid
        # falls: held everywhere; the full frame's step where the stripes
        # start on its tile edges (uniform; see MESH_TILE)
        held = [m0["vs_windows"]] + ([m0["vs_full"]] if partition == "uniform" else [])
        for e in held:
            worst = max(e["errs"].values())
            check(worst <= rtol and e["radii_equal"] and e["loss_rel"] <= LOSS_RTOL_16[partition],
                  f"[16] {name}: gradients off by {worst:.2e} (band {rtol:g}), radii equal "
                  f"{e['radii_equal']}, loss off by {e['loss_rel']:.2e}")
        for res in ranks:
            check(all(res["modes"][name]["launches"][k] >= 1 for k in MESH_KERNELS),
                  f"[16] {name}: a rank launched a main-path kernel no time")
    e = ranks[0]["config_tiles"]
    log(f"[16] at the config's {e['tile']}-pixel tiles, {MESH_WORLD} windows of {e['rows']} rows rendered on one "
        f"device vs the full frame's step: largest |diff| / max |g| "
        + ", ".join(f"{k} {v:.2e}" for k, v in e["errs"].items())
        + f"; loss off by {e['loss_rel']:.2e} (the tile grid, not the mesh: why (a) renders with "
        f"{MESH_TILE}-pixel tiles)")
    for shape, st in ranks[0]["steps"].items():
        worst = max(st["rel_l2"].values())
        same = all(res["steps"][shape]["digest"] == st["digest"] for res in ranks)
        log(f"[16] one {shape} train step vs the single step: parameters' relative L2 "
            + ", ".join(f"{k} {v:.2e}" for k, v in st["rel_l2"].items())
            + f" (limit {STEP_GRAD_RTOL:g}); ranks' parameters equal bit for bit: {same}")
        check(worst <= STEP_GRAD_RTOL and same, f"[16] {shape} step off by {worst:.2e}")
    for r, res in enumerate(ranks):
        log(f"[16] (a) rank {r}: peak device memory {res['peak_mib']:.0f} MiB; collectives "
            + ", ".join(f"{k} {v}" for k, v in res["collectives"].items()))
    nccl = spawn_ranks("nccl", 1, "nccl", dict(state_path=str(path)))[0]
    differ = [k for k, v in nccl["equal"].items() if not v]
    log(f"[16] tiles:1 on one NCCL rank vs the single step: bit for bit equal {not differ}"
        + (f" (differ: {', '.join(differ)})" if differ else "") + "; launches "
        + ", ".join(f"{k} {nccl['launches'][k]}" for k in MESH_KERNELS)
        + f"; peak {nccl['peak_mib']:.0f} MiB; collectives "
        + ", ".join(f"{k} {v}" for k, v in nccl["collectives"].items()))
    check(not differ, f"[16] tiles:1 on NCCL is not bit for bit: {differ}")
    return ranks[0]["launches"], path


def mesh_training(scene_dir: Path, cached_ms: float, card: str) -> dict:
    """Phase 16 (b): ``train(cfg)`` under ``tiles:2``, then ``gauss:2``, on
    ``MESH_WORLD`` gloo ranks sharing the card, from phase 13 (a)'s scene;
    rank 0's checkpoint then loads in the single-device viewer path."""
    import torch

    from easy_gaussian_splatting_torch.launch_viewer import load_run
    from easy_gaussian_splatting_torch.training.config import dump_config, load_config
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn
    from easy_gaussian_splatting_torch.viewer.integration import make_gs_render_func

    log("[16] (b) config: configs/tandt_db.yaml with " + json.dumps(MESH_SCHEDULE)
        + f", data {scene_dir.name}; {MESH_WORLD} gloo ranks on cuda:0")
    launches = dict.fromkeys(counts(), 0)
    for shape in ("tiles:2", "gauss:2"):
        out_dir = RUN_DIR / f"train16_{shape.replace(':', '')}"
        cfg = load_config(REPO / "configs" / "tandt_db.yaml", **MESH_SCHEDULE, data=str(scene_dir),
                          output=str(out_dir), mesh_shape=shape)
        out_dir.mkdir(parents=True, exist_ok=True)
        dump_config(cfg, out_dir / "config.yaml")  # as the train CLI's rank 0 writes it
        t0 = time.perf_counter()
        ranks = spawn_ranks("train", MESH_WORLD, "gloo", dict(
            scene_dir=str(scene_dir), out_dir=str(out_dir), shape=shape, seed=cfg.random_seed))
        took = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            steps = res["steps"]
            check(len(steps) == MESH_SCHEDULE["total_iterations"], f"[16] {shape} rank {r}: "
                  f"{len(steps)} steps")
            short = [i + 1 for i, st in enumerate(steps)
                     if any(st["launches"][k] < 1 for k in MESH_KERNELS)]
            check(not short, f"[16] {shape} rank {r}: a kernel did not launch at steps {short}")
            check(all(math.isfinite(st["loss"]) for st in steps), f"[16] {shape}: a loss is not finite")
            med = float(np.median([steps[i]["ms"] for i in MESH_TIMED]))
            log(f"[16] {shape} rank {r}: step median (steps 2-14, host clock between synchronizes) "
                f"{med:.2f} ms beside phase 13 (a)'s single-device {cached_ms:.2f} ms (two "
                f"processes time-share one card: not a scaling number); launches "
                + ", ".join(f"{k} {res['launches'][k]}" for k in MESH_KERNELS)
                + f"; intersections per step (the fullest rank's) "
                + " ".join(str(st["isects"]) for st in steps)
                + f"; peak {res['peak_mib']:.0f} MiB; collectives "
                + ", ".join(f"{k} {v}" for k, v in res["collectives"].items()))
        r0 = ranks[0]
        check(len(r0["events"]) == 1, f"[16] {shape}: {len(r0['events'])} densify events, want 1")
        ev = r0["events"][0]
        losses = [st["loss"] for st in r0["steps"]]
        log(f"[16] {shape}: {len(losses)} steps in {took:.1f} s (spawn and scene load included); loss "
            + " ".join(f"{x:.4f}" for x in losses) + f"; densify at step 15: {ev['info']}; "
            f"capacity {r0['capacity']}, {r0['alive']} gaussians at the end")
        same = all(res["digest"] == r0["digest"] for res in ranks)
        log(f"[16] {shape}: the ranks' final parameters equal bit for bit: {same}")
        check(same, f"[16] {shape}: the ranks ended with different parameters")
        if shape.startswith("gauss"):
            n = 2  # the gauss axis
            cap0 = ev["cap0"] * n
            grown = min(cap0 * 2, r0["max_capacity"])
            grown -= grown % n
            want = grown if (ev["info"]["nbr_gaussians"] > 0.85 * cap0 or any(r0["overflows"])) \
                else cap0
            log(f"[16] {shape}: capacity {cap0} before the event, {r0['capacity']} after, the "
                f"growth arithmetic says {want} ({ev['info']['nbr_gaussians']} alive, overflow "
                f"{any(r0['overflows'])})")
            check(r0["capacity"] == want, f"[16] {shape}: capacity {r0['capacity']}, want {want}")
        for k in launches:
            launches[k] += r0["launches"][k]
        # rank 0's run directory in the single-device viewer path
        vcfg, state, sh, cams = load_run(out_dir, device=DEVICE)
        bg = torch.full((3,), 1.0 if vcfg.white_background else 0.0, device=DEVICE)
        img = make_gs_render_func(lambda: state, lambda: sh, bg, get_render_fn(vcfg), cfg=vcfg,
                                  base_pixels=int(cams[0].width) * int(cams[0].height))(cams[0])
        check(np.isfinite(img).all() and img.shape[:2] == (int(cams[0].height), int(cams[0].width)),
              f"[16] {shape}: rank 0's checkpoint rendered a bad frame")
        log(f"[16] {shape}: rank 0's checkpoint ({state.num_alive()} gaussians) in the viewer path: "
            f"{img.shape[1]}x{img.shape[0]} frame, finite, mean {float(np.mean(img)):.4f}")
        del state
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase 17
# the compiled step at full width: phase 8's state and ring frames under the
# phase-9 schedule (densify at 20, 30, 40, the opacity reset at 30; no SH
# bump: sh_degree_interval 0), started at the capacity rung just above the
# population (1,048,576 for 1M), so that the first densify event grows it
# and the graphed step captures again
COMPILED_STEPS = 40
MIXED_STEPS = 8  # (a): frames of two sizes in turn
MIXED_HEIGHTS = (800, 600)  # their heights (width 800)
COMPILED_BASELINE_STEPS = 3  # (b): graphed against eager under each path
COMPILED_PATHS = (("band", "pallas"), ("scan", "pallas"), ("pallas", "pallas"),
                  ("dense", "pallas"), ("band", "xla"))  # (BWD_REDUCE, BINNING_IMPL)
COMPILED_PAIRS = 3  # (c): eager (p) and graphed (c) runs, p c p c p c
COMPILED_PAIR_STEPS = 12  # steps a run; the medians over steps 3-12
COMPILED_SIZES = ("dataset", "orbit_720p", "rung_180p")  # (d), phase 5's requests


def state_digest(model, adam, ld):
    """One int64 a state leaf (its bits summed as integers, so any changed
    bit shows) and each loss scalar, on the card: a step's fingerprint."""
    import torch

    from easy_gaussian_splatting_torch.training.graphs import state_leaves

    def bits(x):
        x = x.detach().reshape(-1)
        if x.dtype == torch.float32:
            x = x.view(torch.int32)
        return x.to(torch.int64).sum()

    losses = [ld[k].to(torch.float32).reshape(()).view(torch.int32).to(torch.int64) for k in sorted(ld)]
    return torch.stack([bits(x) for x in state_leaves(model, adam)] + losses)


def clone_state(model, adam):
    from easy_gaussian_splatting_torch.training.graphs import state_from, state_leaves

    return state_from([x.clone() for x in state_leaves(model, adam)])


def compiled_run(step_fn, model, adam, frames, cfg, steps: int, schedule: bool, device):
    """``steps`` steps of ``step_fn`` over the ring frames in turn. With
    ``schedule``, the phase-9 schedule's flags and events (densify with
    growth, the opacity reset); without, every step inside the refine window
    and no event. Returns the loop state, each step's digest and loss dict
    (host floats), the capacities and where device memory's peak rose (after
    which step or densify event)."""
    import torch

    from easy_gaussian_splatting_torch.models.density import reset_opacities
    from easy_gaussian_splatting_torch.ops.lr_schedule import log_lerp_schedule
    from easy_gaussian_splatting_torch.training import trainer as ttrainer

    means_lr = log_lerp_schedule(cfg.means_lr_init, cfg.means_lr_final,
                                 cfg.means_lr_schedule_max_steps)
    loop = ttrainer.TrainLoopState(model=model, adam=adam, active_sh_degree=3)
    gen = torch.Generator(device=device).manual_seed(cfg.random_seed)
    densify = ttrainer.make_densify_step(cfg)
    tensors = [[torch.as_tensor(f[k], device=device) for k in ("w2c", "K", "image", "mask")]
               for f in frames]
    digests, losses, capacities, peaks = [], [], [], []
    for step in range(1, steps + 1):
        in_refine = not schedule or cfg.refine_start < step <= cfg.refine_stop
        densify_now = schedule and in_refine and (step - cfg.refine_start) % cfg.refine_every == 0
        reset_now = (schedule and in_refine
                     and (step - cfg.refine_start) % cfg.reset_opacities_every == 0)
        loop.model, loop.adam, ld = step_fn(
            loop.model, loop.adam, *tensors[(step - 1) % len(tensors)], means_lr(step),
            in_refine, densify_now, reset_now, height=frames[0]["height"],
            width=frames[0]["width"], sh_degree=3)
        digests.append(state_digest(loop.model, loop.adam, ld))
        losses.append({k: v.clone() for k, v in ld.items()})
        capacities.append(loop.model.capacity)
        peaks.append((f"step {step}", torch.cuda.max_memory_allocated()))
        if densify_now:
            ttrainer.run_densify_with_growth(loop, densify, gen, cfg)
            peaks.append((f"the densify event after step {step}", torch.cuda.max_memory_allocated()))
        if reset_now:
            loop.model, loop.adam = reset_opacities(loop.model, loop.adam, cfg.min_opacity)
    torch.cuda.synchronize()
    losses = [{k: float(v) for k, v in ld.items()} for ld in losses]
    rises = [(what, p) for i, (what, p) in enumerate(peaks) if i == 0 or p > peaks[i - 1][1]]
    return loop, torch.stack(digests).cpu().numpy(), losses, capacities, rises


def mixed_run(step_fn, model, adam, frames, cfg, device):
    """``MIXED_STEPS`` steps inside the refine window over two ring frames
    in turn, the second cropped to 800x600 (a scene whose frames come in
    two sizes). Returns the state (``.model``, ``.adam``), each step's
    digest and loss dict (host floats) and each step's ms (host clock
    between synchronizes)."""
    import types

    import torch

    views = []
    for f, h in zip(frames, MIXED_HEIGHTS):
        views.append(([torch.as_tensor(f["w2c"], device=device), torch.as_tensor(f["K"], device=device),
                       torch.as_tensor(f["image"][:h], device=device),
                       torch.as_tensor(f["mask"][:h], device=device)], h))
    digests, losses, ms = [], [], []
    for step in range(MIXED_STEPS):
        view, h = views[step % len(views)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, adam, ld = step_fn(model, adam, *view, cfg.means_lr_init, True, False, False,
                                  height=h, width=800, sh_degree=3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        digests.append(state_digest(model, adam, ld))
        losses.append({k: float(v) for k, v in ld.items()})
    loop = types.SimpleNamespace(model=model, adam=adam)
    return loop, torch.stack(digests).cpu().numpy(), losses, ms


def step_memory(cfg, state0, frames, device) -> None:
    """(e): where one step's device memory goes at phase 8's state, eager
    and graphed: the peak allocated above what was allocated before the
    call, and the bytes allocated in all (``allocated_bytes.all.allocated``
    of ``torch.cuda.memory_stats``); for the graphed step's first call, of
    its warm-up calls and of its capture apart, beside the pool it grew."""
    import torch

    from easy_gaussian_splatting_torch.models.optimizer import init_adam_state
    from easy_gaussian_splatting_torch.training import graphs
    from easy_gaussian_splatting_torch.training import trainer as ttrainer

    def total():
        return torch.cuda.memory_stats()["allocated_bytes.all.allocated"]

    view = [torch.as_tensor(frames[0][k], device=device) for k in ("w2c", "K", "image", "mask")]
    kw = dict(height=800, width=800, sh_degree=3)
    adam0 = init_adam_state(state0.params)
    render_fn = ttrainer.get_render_fn(cfg)
    out = {}

    def measure(name, fn):
        torch.cuda.synchronize()
        base, t0 = torch.cuda.memory_allocated(), total()
        torch.cuda.reset_peak_memory_stats()
        r = fn()
        torch.cuda.synchronize()
        out[name] = ((torch.cuda.max_memory_allocated() - base) / 2**20, (total() - t0) / 2**20)
        return r

    model, adam = clone_state(state0, adam0)
    eager = ttrainer.make_train_step(cfg, render_fn)
    measure("eager step", lambda: eager(model, adam, *view, 1e-4, True, False, False, **kw))
    del eager

    def measure_capture(fn):
        base, t0 = torch.cuda.memory_allocated(), total()
        torch.cuda.reset_peak_memory_stats()
        r = fn()
        out["capture"] = ((torch.cuda.max_memory_allocated() - base) / 2**20,
                          (total() - t0) / 2**20)
        return r

    class Probe(graphs.Captured):
        """``Captured`` with its warm-up calls' memory and its capture's
        measured apart (host-side allocator queries only)."""

        def __init__(self, fn, device, pool=None, warmup=None, what="program", stream=None):
            torch.cuda.synchronize()
            base = (torch.cuda.memory_allocated(), total())
            torch.cuda.reset_peak_memory_stats()
            calls = []

            def warm():
                (warmup or fn)()
                calls.append(None)
                if len(calls) == graphs.WARMUP_CALLS:
                    torch.cuda.synchronize()
                    out["warm-up calls"] = ((torch.cuda.max_memory_allocated() - base[0]) / 2**20,
                                            (total() - base[1]) / 2**20)

            super().__init__(lambda: measure_capture(fn), device, pool, warm, what, stream)

    model, adam = clone_state(state0, adam0)
    with swapped(graphs, "Captured", Probe):
        step = graphs.GraphedTrainStep(cfg, ttrainer.make_train_step(cfg, render_fn), device)
        step(model, adam, *view, 1e-4, True, False, False, **kw)
    pool = step.captures[0]["pool_bytes"] / 2**20
    measure("replay", lambda: step(model, adam, *view, 1e-4, True, False, False, **kw))
    step.reset()
    del model, adam, step
    torch.cuda.empty_cache()
    log(f"[17] (e) one step at phase 8's state (capacity {state0.capacity}), MiB above what was "
        f"allocated before (peak; allocated in all): "
        + "; ".join(f"{k} {a:.0f}; {b:.0f}" for k, (a, b) in out.items())
        + f"; the capture's pool {pool:.0f}")


def compare_runs(tag: str, what: str, eager, graphed, name: str = "graphed") -> None:
    """``name`` (the graphed run) against eager: every step's fingerprint,
    every loss scalar and the final state bit for bit (fails otherwise, with
    where they part and by how much)."""
    from easy_gaussian_splatting_torch.training.graphs import state_leaves

    (e_loop, e_dig, e_loss, *_), (g_loop, g_dig, g_loss, *_) = eager, graphed
    e_leaves = state_leaves(e_loop.model, e_loop.adam)
    g_leaves = state_leaves(g_loop.model, g_loop.adam)
    same_final = all(a.shape == b.shape and bool((a == b).all()) for a, b in zip(e_leaves, g_leaves))
    same_steps = e_dig.shape == g_dig.shape and bool((e_dig == g_dig).all())
    same_losses = e_loss == g_loss
    if same_final and same_steps and same_losses:
        log(f"[{tag}] {what}: {name} equal to eager bit for bit ({len(e_loss)} steps: every "
            f"step's state fingerprint, every loss scalar ({', '.join(sorted(e_loss[0]))}), the "
            f"final params, alive, stats, Adam moments and steps)")
        return
    first = next((i + 1 for i in range(min(len(e_dig), len(g_dig)))
                  if not (e_dig[i] == g_dig[i]).all()), None)
    rel_loss = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(g_loss, e_loss) for k in b)
    rel_param = max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
                    for a, b in zip(g_leaves[:6], e_leaves[:6]) if a.shape == b.shape)
    log(f"[{tag}] {what}: {name} DIFFERS from eager: first at step {first}; max relative loss "
        f"difference {rel_loss:.3e}, final max |d param| / max |param| {rel_param:.3e}")
    check(False, f"[{tag}] {what}: the {name} step is not bit for bit the eager step")


def compiled_step(cfg8, state0, frames, serve, device, card: str) -> None:
    """Phase 17: the graphed step and the graphed served render against
    their eager versions at full width; step medians, the device's busy time
    and idle share, capture times and peak memory."""
    import dataclasses

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import _round_up_capacity, compact_capacity
    from easy_gaussian_splatting_torch.models.optimizer import init_adam_state
    from easy_gaussian_splatting_torch.ops import rasterize_tiled as trt
    from easy_gaussian_splatting_torch.ops.rasterize_tiled import isect_capacity
    from easy_gaussian_splatting_torch.training import trainer as ttrainer
    from easy_gaussian_splatting_torch.training.graphs import WARMUP_CALLS, GraphedTrainStep
    from easy_gaussian_splatting_torch.training.trainer import tune_inference_cfg
    from easy_gaussian_splatting_torch.viewer import integration
    from easy_gaussian_splatting_torch.viewer.integration import make_gs_render_func

    log(f"[17] card: {card}")
    # ---- (a) 40 steps of the phase-9 schedule: eager, eager with the flags
    # and learning rate as 0-d tensors on the card (the graph's inputs), then
    # graphed
    small, _ = compact_capacity(state0, _round_up_capacity(state0.num_alive()))
    adam0 = init_adam_state(small.params)
    # the intersection capacity is relative to the Gaussian capacity: tuned
    # again for the smaller buffer, with room for the densify events
    f0 = frames[0]
    cfg = tune_inference_cfg(dataclasses.replace(cfg8), small, f0["w2c"], f0["K"], 800, 800,
                             margin=2.0)
    render_fn = ttrainer.get_render_fn(cfg)
    runs, peaks = {}, {}
    graphed_step = None
    eager_step = ttrainer.make_train_step(cfg, render_fn)

    def tensor_flags(model, adam, w2c, K, image, mask, lr, *flags, **kw):
        return eager_step(model, adam, w2c, K, image, mask,
                          torch.tensor(lr, dtype=torch.float32, device=device),
                          *(torch.tensor(f, device=device) for f in flags), **kw)

    for mode in ("eager", "eager, tensor flags", "graphed"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what the earlier modes' results hold stays allocated: each peak is
        # read above this run's start
        start = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        model, adam = clone_state(small, adam0)
        if mode == "eager":
            fn = eager_step
        elif mode == "graphed":
            fn = graphed_step = GraphedTrainStep(cfg, ttrainer.make_train_step(cfg, render_fn),
                                                   device)
        else:
            fn = tensor_flags
        t0 = time.perf_counter()
        runs[mode] = compiled_run(fn, model, adam, frames, cfg, COMPILED_STEPS, True, device)
        secs = time.perf_counter() - t0
        peaks[mode] = torch.cuda.max_memory_allocated() - start[0]
        peaks[mode + " reserved"] = torch.cuda.max_memory_reserved() - start[1]
        del model, adam, fn
        _, _, losses, capacities, rises = runs[mode]
        truncated = sum(ld["isects"] > isect_capacity(c, cfg.isect_mult)
                        for ld, c in zip(losses, capacities))
        log(f"[17] (a) {mode}: {COMPILED_STEPS} steps in {secs:.1f} s, capacity {capacities[0]} -> "
            f"{capacities[-1]}, isect_mult {cfg.isect_mult}, {truncated} truncated steps, loss step 1 "
            f"{losses[0]['total']:.5f}, step {COMPILED_STEPS} {losses[-1]['total']:.5f}; peak device "
            f"memory above the run's start (its state included) {peaks[mode] / 2**20:.0f} MiB "
            f"allocated, {peaks[mode + ' reserved'] / 2**20:.0f} MiB reserved; the peak rose after "
            + ", ".join(f"{what} ({(p - start[0]) / 2**20:.0f})" for what, p in rises))
    caps = graphed_step.captures
    check(len(caps) >= 2 and len({c["key"][0] for c in caps}) >= 2,
          f"[17] (a) no capture after the capacity grew: {[c['key'][0] for c in caps]}")
    log(f"[17] (a) {len(caps)} captures: " + "; ".join(
        f"capacity {c['key'][0]}: warm-up ({WARMUP_CALLS} calls) {c['warmup_ms']:.1f} ms, "
        f"capture {c['capture_ms']:.1f} ms, pool {c['pool_bytes'] / 2**20:.0f} MiB" for c in caps))
    compare_runs("17", "(a) 40 steps of the phase-9 schedule", runs["eager"],
                 runs["eager, tensor flags"], "eager with tensor flags")
    compare_runs("17", "(a) 40 steps of the phase-9 schedule", runs["eager"], runs["graphed"])
    graphed_step.reset()
    del runs, graphed_step, eager_step, small, adam0
    torch.cuda.empty_cache()

    # ---- (a) frames of two sizes in turn: one capture a size, kept
    adam0 = init_adam_state(state0.params)
    eager = mixed_run(ttrainer.make_train_step(cfg8, ttrainer.get_render_fn(cfg8)),
                      *clone_state(state0, adam0), frames, cfg8, device)
    fn_g = GraphedTrainStep(cfg8, ttrainer.make_train_step(cfg8, ttrainer.get_render_fn(cfg8)),
                            device)
    graphed = mixed_run(fn_g, *clone_state(state0, adam0), frames, cfg8, device)
    sizes = [c["key"][1:3] for c in fn_g.captures]
    check(sizes == [(h, 800) for h in MIXED_HEIGHTS],
          f"[17] (a) frames of two sizes in turn captured {sizes}, want one capture a size")
    log(f"[17] (a) frames of two sizes in turn (800x800, 800x600), {MIXED_STEPS} steps: "
        f"{len(sizes)} captures ("
        + "; ".join(f"{c['key'][2]}x{c['key'][1]}: capture {c['capture_ms']:.1f} ms, "
                    f"pool +{c['pool_bytes'] / 2**20:.0f} MiB" for c in fn_g.captures)
        + "); step ms eager " + " ".join(f"{x:.1f}" for x in eager[3])
        + ", graphed " + " ".join(f"{x:.1f}" for x in graphed[3]))
    compare_runs("17", f"(a) frames of two sizes in turn, {MIXED_STEPS} steps", eager, graphed)
    fn_g.reset()
    del eager, graphed, fn_g
    torch.cuda.empty_cache()

    step_memory(cfg8, state0, frames, device)

    # ---- (b) every backward reduction, and the grid binning
    adam0 = init_adam_state(state0.params)
    for reduce, binning in COMPILED_PATHS:
        with swapped(trt, "BWD_REDUCE", reduce), swapped(trt, "BINNING_IMPL", binning):
            fn_e = ttrainer.make_train_step(cfg8, ttrainer.get_render_fn(cfg8))
            eager = compiled_run(fn_e, *clone_state(state0, adam0), frames,
                                 cfg8, COMPILED_BASELINE_STEPS, False, device)
            fn_g = GraphedTrainStep(cfg8, ttrainer.make_train_step(cfg8, ttrainer.get_render_fn(cfg8)),
                                    device)
            graphed = compiled_run(fn_g, *clone_state(state0, adam0), frames,
                                   cfg8, COMPILED_BASELINE_STEPS, False, device)
            cap = fn_g.captures[0]
            compare_runs("17", f"(b) {reduce} reduction, {binning} binning, "
                         f"{COMPILED_BASELINE_STEPS} steps (capture {cap['capture_ms']:.1f} ms, "
                         f"pool {cap['pool_bytes'] / 2**20:.0f} MiB)", eager, graphed)
            fn_g.reset()
            del eager, graphed, fn_e, fn_g
            torch.cuda.empty_cache()

    # ---- (c) step medians, eager (p) and graphed (c) in turn
    render_fn = ttrainer.get_render_fn(cfg8)
    tensors = [[torch.as_tensor(f[k], device=device) for k in ("w2c", "K", "image", "mask")]
               for f in frames]
    kw = dict(height=frames[0]["height"], width=frames[0]["width"], sh_degree=3)
    medians, replays, last = [], [], {}
    for i in range(2 * COMPILED_PAIRS):
        mode = ("eager", "graphed")[i % 2]
        fn = ttrainer.make_train_step(cfg8, render_fn)
        if mode == "graphed":
            fn = GraphedTrainStep(cfg8, fn, device)
        model, adam = clone_state(state0, adam0)
        step_ms, dispatch_ms = [], []
        for s in range(COMPILED_PAIR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, adam, _ = fn(model, adam, *tensors[s % len(tensors)], cfg8.means_lr_init,
                                True, False, False, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step_ms.append((t2 - t0) * 1e3)
            dispatch_ms.append((t1 - t0) * 1e3)
        medians.append((mode, float(np.median(step_ms[2:])), float(np.median(dispatch_ms[2:]))))
        if mode == "graphed":  # the host time of the replay alone, inside the call
            replay_ms = []
            for _ in range(COMPILED_PAIR_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn.program.replay()
                replay_ms.append((time.perf_counter() - t0) * 1e3)
            replays.append(float(np.median(replay_ms)))
        if i >= 2 * COMPILED_PAIRS - 2:  # the last pair is profiled below
            last[mode] = (fn, model, adam)
        elif mode == "graphed":
            fn.reset()
        del model, adam, fn
    prof = {}
    for mode, (fn, model, adam) in last.items():
        prof[mode] = profile_device(
            lambda: fn(model, adam, *tensors[0], cfg8.means_lr_init, True, False, False, **kw),
            3, "step", f"17 (c) {mode}", top=8)
        if mode == "graphed":
            fn.reset()
    del last, fn, model, adam
    torch.cuda.empty_cache()
    pairs = [(medians[2 * j][1], medians[2 * j + 1][1]) for j in range(COMPILED_PAIRS)]
    log("[17] (c) step medians (steps 3-12, host clock between synchronizes), p c p c p c: "
        + ", ".join(f"{m} {ms:.2f} ms" for m, ms, _ in medians)
        + f"; graphed at or below eager in {sum(c <= p for p, c in pairs)} of {COMPILED_PAIRS} pairs")
    log("[17] (c) dispatch (host time inside the step call, the loop's `dispatch` bucket), medians: "
        + ", ".join(f"{m} {d:.2f} ms" for m, _, d in medians)
        + "; of the graphed call, the graph's replay alone (host) "
        + ", ".join(f"{r:.2f} ms" for r in replays))
    for mode in ("eager", "graphed"):
        p = prof[mode]
        check(all(p["launches"][k] == 3 * n for k, n in PER_STEP.items()),
              f"[17] (c) the profiler did not see one of each kernel a {mode} step: {p['launches']}")
        log(f"[17] (c) {mode} step, 3 back to back: device busy {p['busy_ms']:.2f} ms/step, wall "
            f"{p['wall_ms']:.2f} ms/step, idle share {p['idle_share']:.3f}; the profiler saw "
            + ", ".join(f"{k} {p['launches'][k]}" for k in PER_STEP))

    # ---- (d) the served render, graphed and eager, at three sizes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    closures = {}
    for g in (False, True):
        with contextlib.ExitStack() as stack:
            if not g:  # the eager closure: no GraphedRender
                stack.enter_context(swapped(integration, "GraphedRender", lambda *a, **k: None))
            closures[g] = make_gs_render_func(
                lambda: serve["state"], lambda: serve["sh_degree"], serve["background"],
                ttrainer.get_render_fn(serve["cfg"]), cfg=serve["cfg"], base_pixels=serve["base_px"])
    check(closures[True].graphed is not None and closures[False].graphed is None,
          "[17] (d) the closures are not one graphed, one eager")
    for name in COMPILED_SIZES:
        cam = serve["cams"][name]
        want = closures[False](cam)
        rer_e = closures[False].stats["rerenders"]
        got = closures[True](cam)
        rer_g = closures[True].stats["rerenders"]
        check(got.shape == want.shape and np.array_equal(got, want),
              f"[17] (d) {name}: the graphed frame differs from the eager frame "
              f"(max |diff| {float(np.abs(got - want).max()):.3e})")
        times = {False: [], True: []}
        for _ in range(REQUEST_REPEATS):
            for g in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                closures[g](cam)  # ends with the image on the host
                times[g].append((time.perf_counter() - t0) * 1e3)
        _, _, seen = profiled_launches(lambda: closures[True](cam), "17",
                                       f"(d) {name}: one graphed frame")
        st = closures[True].stats
        check(seen["binkeys"] == seen["tiled_forward"] == 1 + st["rerenders"],
              f"[17] (d) {name}: a graphed frame ran {seen}")
        log(f"[17] (d) {name}: the profiler saw binkeys {seen['binkeys']} and tiled_forward "
            f"{seen['tiled_forward']} in one graphed frame, as the launch counters say")
        log(f"[17] (d) {name} {cam.width}x{cam.height}: graphed frame equal to eager bit for bit; "
            f"closure latency median (host clock, image on the host, {REQUEST_REPEATS} each) eager "
            f"{float(np.median(times[False])):.2f} ms, graphed {float(np.median(times[True])):.2f} ms; "
            f"re-renders on the first frame eager {rer_e}, graphed {rer_g}; {st['num_isects']} "
            f"intersections of capacity {st['isect_cap']}")
    caps = closures[True].graphed.captures
    log(f"[17] (d) {len(caps)} render captures: " + "; ".join(
        f"{c['key'][0]}x{c['key'][1]} sh {c['key'][2]}: capture {c['capture_ms']:.1f} ms, pool "
        f"{c['pool_bytes'] / 2**20:.0f} MiB" for c in caps))
    log(f"[17] (e) peak device memory (max_memory_allocated / max_memory_reserved; (a) above "
        f"each run's start, its state included): (a) eager "
        f"{peaks['eager'] / 2**20:.0f} / {peaks['eager reserved'] / 2**20:.0f} MiB, eager with "
        f"tensor flags {peaks['eager, tensor flags'] / 2**20:.0f} / "
        f"{peaks['eager, tensor flags reserved'] / 2**20:.0f} MiB, graphed "
        f"{peaks['graphed'] / 2**20:.0f} / {peaks['graphed reserved'] / 2**20:.0f} MiB; (d) "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} / "
        f"{torch.cuda.max_memory_reserved() / 2**20:.0f} MiB (both closures, the served model "
        f"and phase 8's state resident)")
    del closures
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 18
# the JAX package's other jitted programs as CUDA graphs: the batched step,
# the eval's frame and LPIPS, the sharded steps under NCCL (a world of one
# rank: the card's machine has one GPU, and NCCL refuses two ranks on one)
GRAPHED_PAIRS = 3  # (a): eager (p) and graphed (c) batched runs, p c p c p c
MESH_GRAPH_SHAPES = ("tiles:1", "gauss:1", "gauss:1,tiles:1")
MESH_GRAPH_STEPS = 8  # (c): steps a run, a densify event after step 4 and a reset after 6
MESH_GRAPH_DENSIFY, MESH_GRAPH_RESET = 4, 6
MESH_TRAIN_SHAPES = ("tiles:1", "gauss:1")
# (c) train(cfg): MESH_SCHEDULE from the capacity rung just above 13a's 1M
# sparse points, so that the densify event at step 15 grows it (a second
# capture); the profiled replays: steps 3-8 and 17-20
MESH_TRAIN_CAPACITY = 1_048_576
MESH_TRAIN_PROFILED = set(range(3, 9)) | set(range(17, 21))


def batched_graphed(cfg, state0, frames, device, card: str) -> dict:
    """Phase 18 (a): phase 14's ``BATCH_STEPS`` batched steps, eager and
    through ``GraphedTrainStep`` over ``make_batched_train_step`` in turn (p c p c p c),
    each run from a clone of phase 8's state: every step's fingerprint and
    loss scalars and the final state bit for bit equal to the first eager
    run's; step medians (steps 2-10, host clock between synchronizes) and
    peak device memory above each run's start; then 3 steps of each under
    the profiler (device busy, idle share, the kernels seen held to the
    launch counters). Returns the graphed runs' launches (this path's)."""
    import torch

    from easy_gaussian_splatting_torch.models.optimizer import init_adam_state
    from easy_gaussian_splatting_torch.training import trainer as ttrainer
    from easy_gaussian_splatting_torch.training.graphs import GraphedTrainStep

    views = [torch.stack([torch.as_tensor(f[k], device=device) for f in frames[:BATCH]])
             for k in ("w2c", "K", "image", "mask")]
    kw = dict(height=800, width=800, sh_degree=3)
    lr = cfg.means_lr_init
    render_fn = ttrainer.get_render_fn(cfg)
    adam0 = init_adam_state(state0.params)
    launches = dict.fromkeys(counts(), 0)
    medians, peaks, captures, want, last = [], [], [], None, {}
    for i in range(2 * GRAPHED_PAIRS):
        mode = ("eager", "graphed")[i % 2]
        fn = ttrainer.make_batched_train_step(cfg, render_fn)
        if mode == "graphed":
            fn = GraphedTrainStep(cfg, fn, device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        model, adam = clone_state(state0, adam0)
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        digests, losses, ms = [], [], []
        for _ in range(BATCH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, adam, ld = fn(model, adam, *views, lr, True, False, False, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            digests.append(state_digest(model, adam, ld))
            losses.append({k: float(v) for k, v in ld.items()})
        torch.cuda.synchronize()
        peaks.append((mode, (torch.cuda.max_memory_allocated() - start) / 2**20))
        medians.append((mode, float(np.median(ms[1:]))))
        run = (types.SimpleNamespace(model=model, adam=adam), torch.stack(digests).cpu().numpy(),
               losses)
        if mode == "graphed":
            for k, v in counts().items():
                launches[k] += v - before[k]
            captures += fn.captures
            compare_runs("18", f"(a) {BATCH_STEPS} batched steps, B = {BATCH}, run {i + 1}",
                         want, run)
        elif want is None:
            want = run
        if i >= 2 * GRAPHED_PAIRS - 2:  # the last pair is profiled below
            last[mode] = (fn, model, adam)
        elif mode == "graphed":
            fn.reset()
        del run, model, adam, fn
    del want
    prof = {}
    for mode, (fn, model, adam) in last.items():
        prof[mode] = profile_device(lambda: fn(model, adam, *views, lr, True, False, False, **kw),
                                    3, "batched step", f"18 (a) {mode}", top=6)
        if mode == "graphed":
            fn.reset()
    del last, fn, model, adam
    torch.cuda.empty_cache()
    pairs = [(medians[2 * j][1], medians[2 * j + 1][1]) for j in range(GRAPHED_PAIRS)]
    log(f"[18] card: {card}")
    log(f"[18] (a) batched step B = {BATCH}, 800x800: step medians (steps 2-{BATCH_STEPS}, host "
        f"clock between synchronizes), p c p c p c: " + ", ".join(
            f"{m} {x:.2f} ms" for m, x in medians)
        + f"; graphed at or below eager in {sum(c <= p for p, c in pairs)} of {GRAPHED_PAIRS} pairs")
    log("[18] (a) peak device memory above each run's start (its state included): " + ", ".join(
        f"{m} {x:.0f} MiB" for m, x in peaks) + f"; {len(captures)} captures (" + "; ".join(
        f"B {c['key'][-2]}, capacity {c['key'][0]}: warm-up {c['warmup_ms']:.1f} ms, "
        f"capture {c['capture_ms']:.1f} ms, pool {c['pool_bytes'] / 2**20:.0f} MiB"
        for c in captures) + ")")
    for mode in ("eager", "graphed"):
        p = prof[mode]
        check(all(p["launches"][k] == 3 * BATCH * n for k, n in PER_STEP.items()),
              f"[18] (a) the profiler did not see {BATCH} of each kernel a {mode} batched step: "
              f"{p['launches']}")
        log(f"[18] (a) {mode} batched step, 3 back to back: device busy {p['busy_ms']:.2f} "
            f"ms/step, wall {p['wall_ms']:.2f} ms/step, idle share {p['idle_share']:.3f}")
    check(all(launches[k] >= GRAPHED_PAIRS * BATCH_STEPS * BATCH for k in BATCH_KERNELS),
          f"[18] (a) the graphed batched runs launched {launches}")
    return dict(launches=launches, medians=medians)


def eval_graphed(graphed: dict, run_dir: Path, card: str) -> None:
    """Phase 18 (b): phase 15's eval (graphed: the evaluator's frame and
    LPIPS programs) against the same command with the evaluator eager:
    each split's psnr, ssim, proxy LPIPS, largest intersection count,
    capacity and passes again equal; FPS and latencies of both; then a
    replay of each program the graphed evaluators hold under the profiler
    (its kernels held to the launch counters)."""
    eager = eval_cli(run_dir, eager=True, tag="18 (b)")
    log(f"[18] card: {card}")
    for split in ("train", "eval"):
        g, e = graphed["results"][split], eager["results"][split]
        same = {k: g[k] == e[k] for k in ("psnr", "ssim", "lpips_proxy", "max_isects",
                                           "isect_cap", "rerenders")}
        lp = abs(g["lpips_proxy"] - e["lpips_proxy"]) / max(abs(e["lpips_proxy"]), 1e-30)
        log(f"[18] (b) eval {split} split, graphed vs eager: "
            + ", ".join(f"{k} {'equal' if v else 'DIFFERS'}" for k, v in same.items())
            + f" (lpips_proxy relative difference {lp:.3e}); passes again {g['rerenders']}; fps "
            f"graphed {g['fps']:.2f}, eager {e['fps']:.2f}; latency_ms graphed "
            f"{g['latency_ms']:.2f}, eager {e['latency_ms']:.2f}; latency_device_ms graphed "
            f"{g['latency_device_ms']:.2f}, eager {e['latency_device_ms']:.2f}")
        check(all(v for k, v in same.items() if k != "lpips_proxy") and lp <= 1e-6,
              f"[18] (b) eval {split}: the graphed metrics differ from the eager ones: {same}")
    log(f"[18] (b) the command in {graphed['secs']:.1f} s graphed, {eager['secs']:.1f} s eager")
    seen_frames = 0
    for ev in graphed["evaluators"]:
        for key, program in list(ev._programs.entries.items()):
            _, _, seen = profiled_launches(program.replay, "18 (b)",
                                           f"a replay of the eval's {key[0]} program {key[1:]}")
            if key[0] == "frame":
                check(seen["binkeys"] == seen["tiled_forward"] == 1,
                      f"[18] (b) a replay of the eval's frame program ran {seen}")
                seen_frames += 1
        ev._programs.reset()
    check(seen_frames == len(graphed["evaluators"]) >= 2,
          f"[18] (b) {seen_frames} frame programs replayed under the profiler")
    log(f"[18] (b) the profiler saw binkeys 1 and tiled_forward 1 in a replay of each of the "
        f"{seen_frames} evaluators' frame programs, and in their LPIPS programs none of the port's "
        f"kernels, as the launch counters say")
    # the latency chain: captured (no launch) and replayed twice, each
    # replay LATENCY_CHAIN renders
    from easy_gaussian_splatting_torch.evaluation.evaluator import LATENCY_CHAIN

    check(len(graphed["chains"]) == len(graphed["evaluators"]),
          f"[18] (b) {len(graphed['chains'])} latency chains for "
          f"{len(graphed['evaluators'])} evaluators")
    for ev, args in graphed["chains"]:
        _, _, seen = profiled_launches(lambda: ev._chain_ms(*args), "18 (b)",
                                       "the latency chain (a capture and two replays)")
        check(seen["binkeys"] == seen["tiled_forward"] == 2 * LATENCY_CHAIN,
              f"[18] (b) the latency chain's two replays ran {seen}")
    log(f"[18] (b) the profiler saw binkeys {2 * LATENCY_CHAIN} and tiled_forward "
        f"{2 * LATENCY_CHAIN} in each of the {len(graphed['chains'])} latency chains (a capture "
        "and two replays), as the launch counters say")


def _mesh_graph_run(step_fn, model, adam, frames, cfg, mesh, device):
    """``MESH_GRAPH_STEPS`` sharded steps over ``frames`` in turn with a
    densify event (the trainer's growth logic: the sharded one under a gauss
    axis) after step ``MESH_GRAPH_DENSIFY`` and an opacity reset after
    ``MESH_GRAPH_RESET``: (loop, digests, losses, capacities, step ms)."""
    import torch

    from easy_gaussian_splatting_torch.models.density import reset_opacities
    from easy_gaussian_splatting_torch.parallel import gauss_shard
    from easy_gaussian_splatting_torch.parallel.mesh import GAUSS_AXIS
    from easy_gaussian_splatting_torch.training import trainer as tt

    loop = tt.TrainLoopState(model=model, adam=adam, active_sh_degree=3)
    gen = torch.Generator(device=device).manual_seed(cfg.random_seed)
    if GAUSS_AXIS in mesh.axis_names:
        sharded = gauss_shard.make_sharded_densify_step(tt._dcfg(cfg), mesh)

        def densify():
            tt.run_sharded_densify_with_growth(loop, sharded, gen, cfg, mesh)
    else:
        plain = tt.make_densify_step(cfg)

        def densify():
            tt.run_densify_with_growth(loop, plain, gen, cfg)
    digests, losses, caps, ms = [], [], [], []
    for i in range(1, MESH_GRAPH_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.model, loop.adam, ld = step_fn(
            loop.model, loop.adam, *frames[(i - 1) % len(frames)], cfg.means_lr_init / i, True,
            i == MESH_GRAPH_DENSIFY, i == MESH_GRAPH_RESET, height=800, width=800, sh_degree=3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        digests.append(state_digest(loop.model, loop.adam, ld))
        losses.append({k: float(v) for k, v in ld.items()})
        caps.append(loop.model.capacity)
        if i == MESH_GRAPH_DENSIFY:
            densify()
        if i == MESH_GRAPH_RESET:
            loop.model, loop.adam = reset_opacities(loop.model, loop.adam, cfg.min_opacity)
    return loop, torch.stack(digests).cpu().numpy(), losses, caps, ms


def mesh_graph_steps_job(rank, state_path):
    """Phase 18 (c) on a world of one NCCL rank: under each of
    ``MESH_GRAPH_SHAPES`` the sharded step eager (``make_mesh_train_step``)
    and through ``GraphedTrainStep(..., mesh=)`` over it, from phase 8's state
    compacted to the capacity rung above its population, so that the densify
    event grows it (a second capture): whether every step's fingerprint and
    loss scalars and the final state are equal bit for bit, the captures,
    the collectives a replay adds, the step medians and a profile of 3
    replays (its kernels held to the launch counters)."""
    import dataclasses

    import torch

    from easy_gaussian_splatting_torch.models.gaussians import _round_up_capacity, compact_capacity
    from easy_gaussian_splatting_torch.models.optimizer import init_adam_state
    from easy_gaussian_splatting_torch.parallel import gauss_shard
    from easy_gaussian_splatting_torch.parallel.mesh import GAUSS_AXIS, mesh_from_shape
    from easy_gaussian_splatting_torch.training import trainer as tt
    from easy_gaussian_splatting_torch.training.graphs import GraphedTrainStep, state_leaves

    blob = torch.load(state_path, map_location=DEVICE)
    cfg8, state, _ = _mesh_inputs(state_path)
    cfg8 = dataclasses.replace(cfg8, **blob["config_binning"])
    frames = blob["frames"]
    small, _ = compact_capacity(state, _round_up_capacity(state.num_alive()))
    del state
    w2c0, K0 = (x.cpu().numpy() for x in frames[0][:2])
    cfg = tt.tune_inference_cfg(dataclasses.replace(cfg8), small, w2c0, K0, 800, 800, margin=2.0)
    res = {}
    for shape in MESH_GRAPH_SHAPES:
        mcfg = dataclasses.replace(cfg, mesh_shape=shape)
        mesh = mesh_from_shape(shape, DEVICE)
        gauss = GAUSS_AXIS in mesh.axis_names
        render_fn = tt.get_render_fn(mcfg)
        runs = {}
        for mode in ("eager", "graphed"):
            model, adam = clone_state(small, init_adam_state(small.params))
            if gauss:
                model = gauss_shard.shard_state(model, mesh)
                adam = gauss_shard.shard_state(adam, mesh)
            fn = tt.make_mesh_train_step(mcfg, mesh, render_fn)
            if mode == "graphed":
                fn = GraphedTrainStep(mcfg, fn, DEVICE, mesh=mesh)
            runs[mode] = _mesh_graph_run(fn, model, adam, frames, mcfg, mesh, DEVICE) + (fn,)
            del model, adam
        (e_loop, e_dig, e_loss, e_caps, e_ms, _), (g_loop, g_dig, g_loss, g_caps, g_ms, graphed) = (
            runs["eager"], runs["graphed"])
        final = all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(
            state_leaves(e_loop.model, e_loop.adam), state_leaves(g_loop.model, g_loop.adam)))
        out = dict(steps=bool(e_dig.shape == g_dig.shape and (e_dig == g_dig).all()),
                   losses=e_loss == g_loss, final=final, capacities=g_caps,
                   eager_caps=e_caps, eager_ms=float(np.median(e_ms[1:MESH_GRAPH_DENSIFY])),
                   graphed_ms=float(np.median(g_ms[1:MESH_GRAPH_DENSIFY])),
                   captures=[(c["key"][0], c["warmup_ms"], c["capture_ms"],
                              c["pool_bytes"] / 2**20) for c in graphed.captures],
                   collectives={f"{n} ({b})": v for (n, b), v in
                                sorted(graphed.program.collectives.items()) if v})
        del runs, e_loop
        torch.cuda.empty_cache()
        model, adam = g_loop.model, g_loop.adam
        out["profile"] = profile_device(
            lambda: graphed(model, adam, *frames[0], cfg.means_lr_init, True, False, False,
                            height=800, width=800, sh_degree=3),
            3, "sharded step", f"18 (c) {shape} graphed", top=4)
        graphed.reset()
        del graphed, g_loop, model, adam
        torch.cuda.empty_cache()
        res[shape] = out
    return res


def mesh_graph_train_job(rank, scene_dir, out_dir, seed):
    """Phase 18 (c) ``train(cfg)`` on a world of one rank under each of
    ``MESH_TRAIN_SHAPES``: ``MESH_SCHEDULE`` from the capacity rung above
    phase 13 (a)'s sparse points (the densify event grows it), each step's
    loss, a digest of the final state (params, alive, Adam), the densify
    events and captures, the trainer's "runs eagerly" lines, and on NCCL
    the profiled replays held to the launch counters."""
    import hashlib
    import logging
    import random

    import torch
    import torch.distributed as dist

    from easy_gaussian_splatting_torch.training.config import load_config
    from easy_gaussian_splatting_torch.training.graphs import state_leaves

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            if record.getMessage().startswith("the train step runs eagerly"):
                self.lines.append(record.getMessage())

    backend = str(dist.get_backend())
    res = {}
    for shape in MESH_TRAIN_SHAPES:
        cfg = load_config(REPO / "configs" / "tandt_db.yaml", **MESH_SCHEDULE, data=scene_dir,
                          output=str(Path(out_dir) / f"{backend}_{shape.replace(':', '')}"),
                          mesh_shape=shape, initial_capacity=MESH_TRAIN_CAPACITY)
        lines = Lines()
        pkg = logging.getLogger("easy_gaussian_splatting_torch")
        pkg.addHandler(lines)
        pkg.setLevel(logging.INFO)
        random.seed(seed)
        np.random.seed(seed)
        zero_counts()
        try:
            loop, rec = train_recorded(cfg, None, DEVICE, MESH_TRAIN_PROFILED)
        finally:
            pkg.removeHandler(lines)
        launches = counts()
        if backend == "nccl":
            check(len(rec["graphed"]) >= 1, f"[18] (c) train() under {shape} on NCCL built no "
                  "graphed step")
            check_replays(f"18 (c) {shape}", rec, PER_STEP)
            log_captures(f"18 (c) {shape}", rec)
        digest = hashlib.sha256(b"".join(x.detach().cpu().numpy().tobytes()
                                         for x in state_leaves(loop.model, loop.adam))).hexdigest()
        res[shape] = dict(
            losses=[st["loss"] for st in rec["steps"]], digest=digest, densify=rec["densify"],
            capacity=loop.model.capacity, eager_lines=lines.lines, launches=launches,
            reads=[(e["kind"], e["step"], e.get("info"), e.get("counts"))
                   for e in rec["events"] if e["kind"] in ("densify", "isects")],
            event_ms=[(e["kind"], e["step"], e["ms"]) for e in rec["events"]],
            programs=[(c["key"][0], c["key"][1], c["capture_ms"], c["pool_bytes"])
                      for g in rec["graphed"] for c in g.programs.captures
                      if isinstance(c["key"][0], str)],
            captures=[(c["key"][0], c["capture_ms"]) for g in rec["graphed"]
                      for c in g.captures],
            step_ms=float(np.median([st["ms"] for st in rec["steps"][2:14]])))
        del loop, rec
        torch.cuda.empty_cache()
    return res


MESH_JOBS.update(graph_steps=mesh_graph_steps_job, graph_train=mesh_graph_train_job)


def mesh_graph_steps(state_path: Path, card: str) -> None:
    """Phase 18 (c), the steps: ``mesh_graph_steps_job`` on one NCCL rank."""
    t0 = time.perf_counter()
    res = spawn_ranks("graph_steps", 1, "nccl", dict(state_path=str(state_path)))[0]
    log(f"[18] card: {card}; (c) one NCCL rank (NCCL refuses two ranks on one device: capture "
        f"across two or more ranks is not measured here), {time.perf_counter() - t0:.1f} s")
    for shape, r in res.items():
        if isinstance(r, dict) and "steps" in r:
            caps = r["captures"]
            log(f"[18] (c) {shape}: {MESH_GRAPH_STEPS} steps, capacity {r['capacities'][0]} -> "
                f"{r['capacities'][-1]}; graphed vs eager: every step's fingerprint "
                f"{'equal' if r['steps'] else 'DIFFERS'}, loss scalars "
                f"{'equal' if r['losses'] else 'DIFFER'}, final state "
                f"{'equal' if r['final'] else 'DIFFERS'}; {len(caps)} captures (" + "; ".join(
                    f"capacity {c}: warm-up {w:.1f} ms, capture {m:.1f} ms, pool {pool:.0f} MiB"
                    for c, w, m, pool in caps)
                + f"); a replay's collectives " + ", ".join(
                    f"{k} {v}" for k, v in r["collectives"].items())
                + f"; step medians (steps 2-{MESH_GRAPH_DENSIFY}) eager {r['eager_ms']:.2f} ms, "
                f"graphed {r['graphed_ms']:.2f} ms; 3 replays: device busy "
                f"{r['profile']['busy_ms']:.2f} ms/step, idle share {r['profile']['idle_share']:.3f}")
            check(r["steps"] and r["losses"] and r["final"],
                  f"[18] (c) {shape}: the graphed sharded step is not bit for bit the eager one")
            check(len(caps) == 2 and caps[0][0] != caps[1][0] and r["capacities"] == r["eager_caps"],
                  f"[18] (c) {shape}: captures {caps}, want one before and one after the growth")
            check(all(r["profile"]["launches"][k] == 3 * n for k, n in PER_STEP.items()),
                  f"[18] (c) {shape}: the profiler saw {r['profile']['launches']} in 3 replays")
    state_path.unlink()


def mesh_graph_training(scene_dir: Path, card: str) -> dict:
    """Phase 18 (c), ``train(cfg)``: ``mesh_graph_train_job`` on one NCCL
    rank (graphed) and on one gloo rank (eager, and logged so), each shape's
    losses and final state equal bit for bit. Returns the NCCL run's
    launches (this path's), summed over the shapes."""
    out = RUN_DIR / "train18"
    runs = {}
    for backend in ("nccl", "gloo"):
        t0 = time.perf_counter()
        runs[backend] = spawn_ranks("graph_train", 1, backend, dict(
            scene_dir=str(scene_dir), out_dir=str(out), seed=0))[0]
        runs[backend]["secs"] = time.perf_counter() - t0
    log(f"[18] card: {card}; (c) train(cfg), configs/tandt_db.yaml with "
        + json.dumps(MESH_SCHEDULE) + f", initial_capacity {MESH_TRAIN_CAPACITY}: one NCCL rank "
        f"({runs['nccl']['secs']:.1f} s) against one gloo rank ({runs['gloo']['secs']:.1f} s)")
    launches = dict.fromkeys(counts(), 0)
    for shape in MESH_TRAIN_SHAPES:
        n, g = runs["nccl"][shape], runs["gloo"][shape]
        same = n["losses"] == g["losses"] and n["digest"] == g["digest"]
        log(f"[18] (c) train() under {shape}: NCCL (graphed, {len(n['captures'])} captures: "
            + ", ".join(f"capacity {c} in {m:.1f} ms" for c, m in n["captures"])
            + f") vs gloo (eager): losses and final state (params, alive, stats, Adam) "
            + ("equal bit for bit" if same else "DIFFER") + f"; {n['densify']} densify event, "
            f"capacity {MESH_TRAIN_CAPACITY} -> {n['capacity']}; step medians (steps 3-14) NCCL "
            f"{n['step_ms']:.2f} ms, gloo {g['step_ms']:.2f} ms; the gloo run logged: "
            + " | ".join(g["eager_lines"]))
        check(same, f"[18] (c) train() under {shape}: NCCL graphed and gloo eager differ")
        check(len(n["captures"]) >= 2 and n["capacity"] > MESH_TRAIN_CAPACITY and n["densify"] == 1,
              f"[18] (c) train() under {shape}: captures {n['captures']}, capacity {n['capacity']}")
        check(not n["eager_lines"] and len(g["eager_lines"]) == 1
              and "gloo collectives" in g["eager_lines"][0],
              f"[18] (c) train() under {shape}: eager lines NCCL {n['eager_lines']}, gloo "
              f"{g['eager_lines']}")
        # phase 19 (d): the refine event and the (striped) counter as programs
        # over the NCCL rank's state, against gloo's eager ones
        kinds = collections.Counter(k for k, *_ in n["programs"])
        log(f"[19] (d) train() under {shape}, one NCCL rank (densify and the striped counter "
            f"graphed) vs one gloo rank (eager): every event's counts and every intersection "
            f"count the trainer read " + ("equal bit for bit" if n["reads"] == g["reads"]
                                          else "DIFFER") + f" ({len(n['reads'])} reads); "
            f"NCCL programs over the state: " + ", ".join(
                f"{k} {c} ({m:.1f} ms, pool +{b / 2**20:.0f} MiB)" for k, c, m, b in n["programs"])
            + "; event wall ms NCCL / gloo: " + ", ".join(
                f"{a[0]} {a[1]}: {a[2]:.1f} / {b[2]:.1f}"
                for a, b in zip(n["event_ms"], g["event_ms"])))
        check(n["reads"] == g["reads"] and kinds["densify"] >= 1 and kinds["isects"] >= 1,
              f"[19] (d) train() under {shape}: NCCL reads {n['reads']} vs gloo {g['reads']}, "
              f"programs {dict(kinds)}")
        for k in launches:
            launches[k] += n["launches"][k]
    check(all(launches[k] > 0 for k in MESH_KERNELS),
          f"[18] (c) a main-path kernel never launched under the graphed mesh: {launches}")
    return launches


# ----------------------------------------------------------------- phase 19
# phase 13 (a)'s scene and configs/tandt_db.yaml with a schedule that puts
# four refine events (steps 10, 20, 30, 40), an opacity reset (40, after
# the last event: a reset lowers the intersection count, and the next
# event's check would tune the binning again, which drops every program,
# those captured ahead too), two SH bumps (20, 40) and evals at steps 1 and
# 30 in 45 steps; the capacity is chosen from a probe run so that one
# event past the first grows it and the events before do not
REFINE_SCHEDULE = dict(
    total_iterations=45, sh_degree_interval=20, refine_start=0, refine_every=10,
    reset_opacities_every=40, eval_every=30, eval_render_num=1, profile_steps=0,
    save_model_iterations=[], log_every=10,
)
REFINE_PROBE_STEPS = 41  # the probe: every event, none of them growing
# (name, the refine programs graphed, the capture ahead, the evaluator's
# programs shared with the step's): the port before this slice (refine
# eager, the evaluator's own copy of the model), then graphed, then graphed
# with the capture ahead
REFINE_RUNS = (("eager", False, False, False), ("graphed", True, False, True),
               ("precompiled", True, True, True))
REFINE_KINDS = ("densify", "reset", "isects", "frame", "lpips")
# the precompiled run's steps whose replays, and the events after which,
# run under the profiler (the third and fourth refine events, their
# counters and the reset), and its eval (by index) that does: step 30's
REFINE_PROFILED = {30, 31, 40}
REFINE_PROFILED_EVAL = 1


def refine_run(scene_dir: Path, out_dir: Path, graph_refine: bool, precompile: bool,
               shared_eval: bool, profile=(), **overrides) -> dict:
    """One phase-19 ``train(cfg)`` run: ``REFINE_SCHEDULE`` on phase 13
    (a)'s scene, the refine programs graphed or eager (``graph_refine``
    False swaps the trainer's densify and reset steps and its counter
    program for the eager functions), the capture ahead on or off
    (``precompile`` False swaps ``StepPrecompiler`` for one that captures
    nothing), the evaluator's programs the step's (``shared_eval``) or its
    own with a copy of the model (the port before). ``profile`` names the
    steps whose replays, and the events after which, run under the
    profiler (``train_recorded``). Returns its steps, events (with wall
    ms), the final state's digest, every capture of a program over the
    state, the precompiler's records, each eval's peak allocated memory
    above the run's start and the capacity it ran at, the run's peak, and
    the launches."""
    import random

    import torch

    from easy_gaussian_splatting_torch.evaluation import evaluator as ev
    from easy_gaussian_splatting_torch.training import precompile as pc
    from easy_gaussian_splatting_torch.training import trainer as tt
    from easy_gaussian_splatting_torch.training.config import load_config
    from easy_gaussian_splatting_torch.training.graphs import state_from

    cfg = load_config(REPO / "configs" / "tandt_db.yaml", **dict(REFINE_SCHEDULE, **overrides),
                      data=str(scene_dir), output=str(out_dir))
    peaks, made, run_peak = [], [], [0]
    evaluate_orig, init_orig = ev.Evaluator.evaluate, ev.Evaluator.__init__
    densify_orig, reset_orig = tt.make_densify_step, tt.make_reset_step

    def evaluate(self, scene, split, model, *a, **k):
        torch.cuda.synchronize()
        run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated() - start)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() - start
        seen, launched = None, counts()
        if profile and len(peaks) == REFINE_PROFILED_EVAL:
            out, prof = profiled(lambda: evaluate_orig(self, scene, split, model, *a, **k))
            seen = kernel_launches(prof)
        else:
            out = evaluate_orig(self, scene, split, model, *a, **k)
        torch.cuda.synchronize()
        peaks.append(dict(peak=torch.cuda.max_memory_allocated() - start, before=before,
                          capacity=model.capacity, measured=seen,
                          launches={n: v - launched[n] for n, v in counts().items()}))
        return out

    def own_copy(self, num, render_fn, programs=None):  # the port before: a copy of its own
        init_orig(self, num, render_fn)

    class Recorded(pc.StepPrecompiler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    class Off(Recorded):  # the capture ahead off: every step captures at its first use
        def warm(self, *a, **k):
            return None

    def eager_counted(graphed, counter, cfg_, w2c, K, *, height, width, mesh=None):
        model = state_from(graphed.state)[0]
        return counter(model.params, model.alive, w2c, K, height=height, width=width)

    random.seed(cfg.random_seed)
    np.random.seed(cfg.random_seed)
    gc.collect()  # an earlier run's tensors freed now, not inside this one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    zero_counts()
    with contextlib.ExitStack() as stack:
        if not graph_refine:
            stack.enter_context(swapped(tt, "make_densify_step",
                                        lambda cfg_, graphed=None: densify_orig(cfg_)))
            stack.enter_context(swapped(tt, "make_reset_step",
                                        lambda cfg_, graphed=None: reset_orig(cfg_)))
            stack.enter_context(swapped(tt, "counted_isects", eager_counted))
        stack.enter_context(swapped(pc, "StepPrecompiler", Recorded if precompile else Off))
        stack.enter_context(swapped(ev.Evaluator, "evaluate", evaluate))
        if not shared_eval:
            stack.enter_context(swapped(ev.Evaluator, "__init__", own_copy))
        t0 = time.perf_counter()
        loop, rec = train_recorded(cfg, None, DEVICE, profile, profile_events=profile)
        secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated() - start)
    launches = counts()
    check(rec["graphed"], "[19] train() did not run the graphed step")
    step = rec["graphed"][0]
    digest = state_digest(loop.model, loop.adam, {}).cpu().numpy()
    out = dict(steps=rec["steps"], events=rec["events"], digest=digest, secs=secs,
               captures=list(step.programs.captures), peaks=peaks, launches=launches,
               capacity=loop.model.capacity, alive=loop.model.num_alive(),
               warmed=made[0].warmed if made else [], failures=made[0].failures if made else [],
               losses=[st["loss"] for st in rec["steps"]], peak=run_peak[0])
    del loop, rec, step
    torch.cuda.empty_cache()
    return out


def _alive_after_events(run) -> list:
    """(step, alive count, the intersection count the trainer read after the
    event) of each densify event of a run, and the autotune's count."""
    events, out, tuned = run["events"], [], None
    for i, e in enumerate(events):
        if e["kind"] == "isects" and tuned is None:
            tuned = e["counts"][0]
        if e["kind"] == "densify":
            after = next((x["counts"][0] for x in events[i + 1:] if x["kind"] == "isects"), None)
            out.append((e["step"], e["info"]["nbr_gaussians"], after))
    return out, tuned


def refine_programs(scene_dir: Path, card: str) -> dict:
    """Phase 19: the refine-event programs over the live state and the
    capture ahead, in ``train(cfg)`` on phase 13 (a)'s scene. A probe run
    at the config's capacity gives each event's population and the
    intersection count the trainer reads after it; the capacity is set so
    that event k (the first past the first whose population grew and whose
    count did not fall below the autotune's, so the binning is not tuned
    again on the grown state) grows it and none before does. Then the runs
    of ``REFINE_RUNS``: (a) eager and graphed refine programs bit for bit
    (losses, every event's counts, every count the trainer read, the final
    state's digest), each event's wall time in both and each program's
    capture and pool; (b) the evals' peak memory, the evaluator's copy
    (eager run) against the shared programs (graphed run), lower by at least
    236 B a slot; (c) with the capture ahead, the growth's and the SH
    bumps' first steps capture nothing, their programs captured ahead
    (``ahead``) at earlier steps, and their wall times beside the graphed
    run's, which captured at first use; no warm failed."""
    t0 = time.perf_counter()
    probe = refine_run(scene_dir, RUN_DIR / "train19_probe", True, False, True,
                       total_iterations=REFINE_PROBE_STEPS, eval_every=1000)
    after, tuned = _alive_after_events(probe)
    log(f"[19] probe ({REFINE_PROBE_STEPS} steps at capacity {probe['steps'][0]['capacity']}, "
        f"{time.perf_counter() - t0:.1f} s): the autotune read {tuned} intersections; after each "
        "event (step, gaussians, intersections): " + ", ".join(map(str, after)))
    pick = [j for j in range(1, len(after))
            if after[j][1] > max(a[1] for a in after[:j]) + 1000
            and after[j][2] is not None and after[j][2] >= tuned]
    check(pick, f"[19] no event past the first grew the population past the events before it "
          f"with an intersection count at or above the autotune's: {after}, {tuned}")
    j = pick[0]
    lo = max(a[1] for a in after[:j])
    capacity = int((lo + after[j][1]) / 2 / 0.85) // 64 * 64
    log(f"[19] initial_capacity {capacity}: the event at step {after[j][0]} grows it "
        f"({lo} <= 0.85 x {capacity} < {after[j][1]})")
    runs = {}
    for name, graph_refine, precompile, shared_eval in REFINE_RUNS:
        runs[name] = refine_run(scene_dir, RUN_DIR / f"train19_{name}", graph_refine, precompile,
                                shared_eval, REFINE_PROFILED if name == "precompiled" else (),
                                initial_capacity=capacity)
    log(f"[19] card: {card}; configs/tandt_db.yaml with " + json.dumps(REFINE_SCHEDULE)
        + f", initial_capacity {capacity}; runs " + ", ".join(
            f"{n} {r['secs']:.1f} s" for n, r in runs.items()))
    eager, graphed, pre = runs["eager"], runs["graphed"], runs["precompiled"]
    caps = [st["capacity"] for st in graphed["steps"]]
    grow_step = next((i + 1 for i in range(1, len(caps)) if caps[i] != caps[i - 1]), None)
    check(grow_step is not None and grow_step - 1 == after[j][0] and caps[0] == capacity,
          f"[19] the capacity grew at step {grow_step}, want after step {after[j][0]}: {caps}")

    # every line first, then the checks (one run shows every miss)
    bad = []

    def want(ok: bool, msg: str) -> None:
        if not ok:
            bad.append(msg)

    # (a) graphed against eager, bit for bit
    def reads(run):
        return [(e["kind"], e["step"], e.get("info"), e.get("counts")) for e in run["events"]
                if e["kind"] in ("densify", "isects")]

    for name in ("graphed", "precompiled"):
        r = runs[name]
        same = (r["losses"] == eager["losses"] and reads(r) == reads(eager)
                and np.array_equal(r["digest"], eager["digest"]))
        log(f"[19] (a) {name} against eager refine: every loss, every event's counts, every "
            f"intersection count the trainer read and the final state's digest "
            + ("equal bit for bit" if same else "DIFFER"))
        want(same, f"(a) the {name} run differs from the eager one")
    events = {n: [e for e in r["events"] if e["kind"] != "grow"] for n, r in runs.items()}
    log("[19] (a) events (after step; wall ms between synchronizes, eager / graphed / "
        "precompiled, * under the profiler): " + "; ".join(
            f"{e['kind']} {e['step']}: " + " / ".join(
                f"{events[n][i]['ms']:.2f}" + ("*" if "measured" in events[n][i] else "")
                for n in ("eager", "graphed", "precompiled"))
            for i, e in enumerate(events["eager"])))
    grows = {n: [e for e in r["events"] if e["kind"] == "grow"] for n, r in runs.items()}
    log("[19] (a) the growth (wall ms, eager one pass into new buffers / into the buffers "
        "prepared ahead): " + ", ".join(
            f"{n} " + " ".join(f"{e['ms']:.2f}" for e in g) for n, g in grows.items()))
    progs = [c for c in graphed["captures"] if c["key"][0] in REFINE_KINDS]
    log("[19] (a) programs over the state, graphed run: " + "; ".join(
        f"{', '.join(map(str, c['key'][:2]))}: warm-up {c['warmup_ms']:.1f} ms, capture "
        f"{c['capture_ms']:.1f} ms, pool +{c['pool_bytes'] / 2**20:.0f} MiB" for c in progs))
    for kind in ("densify", "reset", "isects", "frame"):
        want(any(c["key"][0] == kind for c in progs), f"(a) no {kind} program captured")
    want(not any(c["key"][0] in ("densify", "reset", "isects") for c in eager["captures"]),
         "(a) the eager run captured a refine program")
    # the precompiled run's profiled replays: its steps, and the events and
    # the eval whose programs replay over the state, seen by the profiler
    # as the launch counters (which a replay adds from its capture) say
    check_replays("19", {"steps": pre["steps"]}, PER_STEP)
    windows = [(f"{e['kind']} after step {e['step']}", e["measured"], e["launches"])
               for e in pre["events"] if "measured" in e]
    windows += [(f"eval {i + 1}", p["measured"], p["launches"])
                for i, p in enumerate(pre["peaks"]) if p["measured"] is not None]
    lost = [w[0] for w in windows if lost_records(w[1], w[2])]
    kinds = {w[0].split(" ")[0] for w in windows if w[0] not in lost}
    log("[19] (a) profiled in the precompiled run (kernels seen / counted): " + "; ".join(
        f"{w}: " + ", ".join(f"{k} {m[k]}/{c[k]}" for k in m if m[k] or c[k])
        + (" (the profiler lost records)" if w in lost else "") for w, m, c in windows))
    want(3 * len(lost) <= len(windows) and all(w[1] == w[2] for w in windows if w[0] not in lost)
         and {"densify", "isects", "reset", "eval"} <= kinds
         and all(w[1]["binkeys"] > 0 for w in windows if w[0].startswith(("isects", "eval"))),
         f"(a) the profiled events and eval differ from the launch counters: {windows}")

    # (b) the eval's peak memory: the evaluator's own copy against none
    rows = []
    for pe, pg in zip(eager["peaks"], graphed["peaks"]):
        clone = 236 * pg["capacity"]
        rows.append((pe, pg, clone))
        want(pe["capacity"] == pg["capacity"] and pe["peak"] - pg["peak"] >= clone,
             f"(b) eval peak {pg['peak']} not below the copying evaluator's {pe['peak']} by the "
             f"copy's {clone} bytes")
    want(len(rows) == 2, f"(b) {len(rows)} evals, want 2")
    log("[19] (b) eval peak allocated above the run's start, MiB (capacity: copying evaluator, "
        "the programs sharing the step's and reading its buffers, difference, the copy 236 B a "
        "slot; allocated at the eval's start, copying / sharing): " + "; ".join(
            f"{pg['capacity']}: {pe['peak'] / 2**20:.1f}, {pg['peak'] / 2**20:.1f}, "
            f"{(pe['peak'] - pg['peak']) / 2**20:.1f}, {k / 2**20:.1f}; "
            f"{pe['before'] / 2**20:.1f} / {pg['before'] / 2**20:.1f}" for pe, pg, k in rows))

    # (c) the capture ahead
    want(not pre["failures"], f"(c) a capture ahead failed: {pre['failures']}")
    sigs = [(st["capacity"], st["sh"]) for st in pre["steps"]]
    firsts = [i for i in range(1, len(sigs)) if sigs[i] not in sigs[:i]]
    ahead = {(c["key"][0], c["key"][3]) for c in pre["captures"]
             if c["ahead"] and not isinstance(c["key"][0], str)}
    lines, warmed_growth, warmed_sh = [], False, False
    for i in firsts:
        g, p = graphed["steps"][i], pre["steps"][i]
        kind = "growth" if i + 1 == grow_step else "SH bump"
        hit = p["captured"] == 0 and sigs[i] in ahead
        warmed_growth |= hit and kind == "growth"
        warmed_sh |= hit and kind == "SH bump"
        lines.append(f"step {i + 1} ({kind}, capacity {sigs[i][0]}, sh {sigs[i][1]}): "
                     f"precompiled {p['ms']:.1f} ms, {p['captured']} captured"
                     f"{', captured ahead' if sigs[i] in ahead else ''}; graphed "
                     f"{g['ms']:.1f} ms, {g['captured']} captured")
    log("[19] (c) first steps of new signatures: " + "; ".join(lines))
    log("[19] (c) captures ahead (key, wall ms, MiB held for the grown state): " + "; ".join(
        f"capacity {w['key'][0]} sh {w['key'][3]}: {w['ms']:.1f} ms, "
        f"{w['held_bytes'] / 2**20:.0f} MiB" for w in pre["warmed"]))
    # net of the warms: the first steps' wall time saved against the warms
    # paid on the loop's thread, and each run's peak allocated memory
    first_g = sum(graphed["steps"][i]["ms"] for i in firsts)
    first_p = sum(pre["steps"][i]["ms"] for i in firsts)
    warm_ms = sum(w["ms"] for w in pre["warmed"])
    log(f"[19] (c) net: the first steps of new signatures {first_g:.1f} ms graphed, "
        f"{first_p:.1f} ms precompiled, plus {warm_ms:.1f} ms of {len(pre['warmed'])} warms: "
        f"{first_g - first_p - warm_ms:+.1f} ms saved in the run; peak allocated above the "
        "run's start: " + ", ".join(f"{n} {r['peak'] / 2**20:.0f} MiB" for n, r in runs.items()))
    want(warmed_growth and warmed_sh, "(c) the growth's or an SH bump's program was not "
         "captured ahead of its first step")
    want(all(graphed["launches"][k] > 0 for k in MESH_KERNELS),
         f"a main-path kernel never launched in the graphed run: {graphed['launches']}")
    median = {n: float(np.median([st["ms"] for st in r["steps"][2:9]])) for n, r in runs.items()}
    log("[19] (c) step medians (steps 3-9, host clock): " + ", ".join(
        f"{n} {m:.2f} ms" for n, m in median.items()))
    check(not bad, "[19] " + "; ".join(bad))
    return graphed["launches"]


# ----------------------------------------------------------------- phase 20
BENCH_TIMEOUT_S = 600  # the bench's whole matrix, a subprocess
# the root bench.py's keys of a point, and its matrix: (N, B)
BENCH_PROBE_KEYS = {"gaussians", "step_ms", "it_per_s", "isects", "mpix_per_s", "sol_ms",
                    "bw_util"}
BENCH_MATRIX = [(100_000, 1), (1_000_000, 1), (3_000_000, 1), (100_000, 4)]
BENCH_PROFILED = 3  # replays of each in-process point under the profiler
# the points whose first warm-up call holds the kernels against their plain
# versions: the most slots, and the batched step
BENCH_CHECKED = [(3_000_000, 1), (100_000, 4)]


def bench_matrix(kind: str, card: str) -> dict:
    """Phase 20 (a): ``python -m easy_gaussian_splatting_torch.bench`` as a
    user runs it, the whole matrix: exit 0, its last line one JSON object
    with the root ``bench.py``'s keys, every point of the matrix there with
    no ``error`` and finite positive numbers, ``backend`` the card (the
    bench raises on a second capture or a truncated step); its point
    lines (captures, peaks) logged. Returns the result."""
    cmd = [sys.executable, "-m", "easy_gaussian_splatting_torch.bench"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"[20] the bench exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    log(f"[20] python -m easy_gaussian_splatting_torch.bench: exit 0 in {wall:.1f} s; last "
        f"line: {lines[-1]}")
    check(set(result) == {"metric", "value", "unit", "vs_baseline", "detail"}
          and result["metric"] == "train_iters_per_sec" and result["unit"] == "it/s",
          f"[20] the bench's result has keys {sorted(result)}")
    detail = result["detail"]
    check(set(detail) == {"step_ms", "gaussians", "image", "mpix_per_s", "backend",
                          "scale_probe"} and detail["image"] == "800x800",
          f"[20] the bench's detail has keys {sorted(detail)}")
    check(detail["backend"] == kind, f"[20] backend {detail['backend']!r}, not the card {kind!r}")
    probes = detail["scale_probe"]
    check([(p.get("gaussians"), p.get("camera_batch", 1)) for p in probes] == BENCH_MATRIX,
          f"[20] the matrix ran {probes}")
    for p in probes:
        keys = BENCH_PROBE_KEYS | ({"camera_batch"} if p.get("camera_batch", 1) > 1 else set())
        check(set(p) == keys, f"[20] a point has keys {sorted(p)}, not {sorted(keys)}")
        check(all(math.isfinite(p[k]) and p[k] > 0 for k in BENCH_PROBE_KEYS),
              f"[20] a point's numbers are not finite and positive: {p}")
    for ln in lines[:-1]:
        log(f"[20] {ln}")
    log(f"[20] card: {card}")
    for p in probes:
        log(f"[20] {p['gaussians']} gaussians, B {p.get('camera_batch', 1)}: step_ms "
            f"{p['step_ms']}, it_per_s {p['it_per_s']}, isects {p['isects']}, sol_ms "
            f"{p['sol_ms']}, bw_util {p['bw_util']}, mpix_per_s {p['mpix_per_s']} (peaks on "
            "the bench's line above)")
    return result


def bench_replays(card: str) -> dict:
    """Phase 20 (b): the bench's 100k point at B = 1 and 4 in process:
    ``bench_point`` as the command calls it, under the launch counters (the
    counter's ``binkeys``, the warm-up calls, the capture's replay and each
    timed replay: B of each main-path kernel a call), then a point of each
    stepped again with ``BENCH_PROFILED`` replays under the profiler, each
    seeing B of each main-path kernel as the counters say, and one capture.
    Returns the launches of the two ``bench_point`` runs."""
    import torch

    from easy_gaussian_splatting_torch import bench as tbench
    from easy_gaussian_splatting_torch.training.graphs import WARMUP_CALLS

    zero_counts()
    runs = [(1, tbench.ITERS_SMALL), (4, tbench.ITERS_BATCHED)]
    for b, iters in runs:
        out = tbench.bench_point(100_000, 800, 800, iters=iters, batch=b)
        log(f"[20] in process, 100000 gaussians, B {b}: step_ms {out['step_ms']}")
    launches = counts()
    want = {k: sum(b * (WARMUP_CALLS + 1 + iters) * n + (k == "binkeys") for b, iters in runs)
            for k, n in PER_STEP.items()}
    got = {k: launches[k] for k in PER_STEP}
    check(got == want and not any(v for k, v in launches.items() if k not in PER_STEP),
          f"[20] bench_point's launches {launches}, want {want} (the counter's binkeys, "
          f"{WARMUP_CALLS} warm-up calls, the capture's replay and the timed replays)")
    log("[20] launches of the two bench_point runs: " + ", ".join(
        f"{k} {v}" for k, v in got.items()) + " (each: the counter's binkeys, "
        f"{WARMUP_CALLS} warm-up calls, the capture's replay and the timed replays, B a call)")
    for b, _ in runs:
        p = tbench.prepare_point(100_000, 800, 800, batch=b)
        model, adam, _ = p.step(p.model, p.adam)  # the capture

        def replay(model, adam):
            t0 = time.perf_counter()  # after the profiler's synchronize
            out = p.step(model, adam)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        steps = []
        for _ in range(BENCH_PROFILED):
            before = counts()
            ((model, adam, _), wall_ms), prof = profiled(lambda: replay(model, adam))
            steps.append(dict(measured=kernel_launches(prof), records=device_records(prof),
                              launches={k: v - before[k] for k, v in counts().items()}))
        check(len(p.graphed.captures) == 1,
              f"[20] B {b}: {len(p.graphed.captures)} captures, not 1")
        p.graphed.reset()
        check_replays("20", {"steps": steps}, {k: b * n for k, n in PER_STEP.items()})
        log(f"[20] card: {card}; 100000 gaussians, B {b}, the last profiled replay:")
        device_time(prof, 1, wall_ms, "step", "20", top=10)
        del p, model, adam
    return launches


@contextlib.contextmanager
def first_eager_calls(module, name: str, k: int):
    """Record the arguments of the first ``k`` calls of ``module.name`` made
    outside a graph capture (a graphed step's first warm-up call)."""
    import torch

    calls = []
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        if len(calls) < k and not torch.cuda.is_current_stream_capturing():
            calls.append((args, kwargs))
        return orig(*args, **kwargs)

    with swapped(module, name, rec):
        yield calls


def bench_kernels() -> dict:
    """Phase 20 (c): the four main-path kernels against their plain versions
    on the bench's own inputs, recorded from the first eager warm-up call
    of each ``BENCH_CHECKED`` point's graphed step (B calls of each kernel
    a point): binkeys equal, tiled_forward and tiled_backward within TOL
    and BWD_TOL with every flipped pixel or row replayed to a decision at
    its rounding edge, segsum_band within SEG_RTOL. Returns each kernel's
    largest absolute difference."""
    import torch

    from easy_gaussian_splatting_torch import bench as tbench
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg
    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    errs = dict.fromkeys(PER_STEP, 0.0)
    for n, b in BENCH_CHECKED:
        p = tbench.prepare_point(n, 800, 800, batch=b)
        capacity = p.model.capacity
        with contextlib.ExitStack() as stack:
            rec = {name: stack.enter_context(first_eager_calls(mod, name, b)) for mod, name in (
                (bk, "binkeys"), (tr, "tiled_forward"), (tr, "tiled_backward"),
                (seg, "segsum_band"))}
            p.step(p.model, p.adam)  # two warm-up calls, the capture, its replay
        p.graphed.reset()
        del p
        torch.cuda.empty_cache()
        check(all(len(c) == b for c in rec.values()),
              f"[20] {n} gaussians, B {b}: recorded {({k: len(c) for k, c in rec.items()})} "
              f"calls, want {b} of each")
        what = f"{n} gaussians, B {b}"
        errs["binkeys"] = max(errs["binkeys"], check_binkeys(rec["binkeys"]))
        log(f"[20] (c) {what}: binkeys keys, flats and counts equal to the plain version ("
            + "; ".join(describe_binkeys(c) for c in rec["binkeys"]) + ")")
        for i in range(b):
            fw_err, _ = check_forward(rec["tiled_forward"][i][0], "20",
                                      f"the bench's {what}, view {i}")
            bw_err, _ = check_backward(rec["tiled_backward"][i], "20")
            seg_err = check_segsum(rec["segsum_band"][i], capacity, "20")
            errs["tiled_forward"] = max(errs["tiled_forward"], fw_err)
            errs["tiled_backward"] = max(errs["tiled_backward"], bw_err)
            errs["segsum_band"] = max(errs["segsum_band"], seg_err)
        del rec
        torch.cuda.empty_cache()
    log("[20] (c) largest |kernel - plain| at the bench's points: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


# ------------------------------------------------------------------ main
REPLAY_PROBE_WINDOWS = 200  # profiled replays of the last program after the probe's runs
PROBE_DIR = REPO / "build" / "replay_probe"  # what --replay-probe writes (kept after the run)


def replay_probe(runs: int, gaussians: int, seed: int, device, card: str) -> None:
    """``--replay-probe RUNS``: whether a profiled replay whose kernels fall
    short of the launch counters ran fewer kernels or the profiler lost
    their records. Phase 13 (a)'s ``train()`` (its scene, schedule, evals
    and profiler window) ``RUNS`` times, every replayed step under the
    profiler and every CUDA graph in debug mode; then
    ``REPLAY_PROBE_WINDOWS`` replays of the last run's program, each in a
    profiler window of its own, every other one after a small kernel run
    and waited for inside the window ("settled"). Per
    window: the port's kernels seen against the counters' increments and
    every device record seen against the window most windows show; the
    program's nodes of the port's kernels from its debug dump. The windows
    that differ go to ``PROBE_DIR/replay_probe.json``, the dump beside it."""
    import re

    import torch

    from easy_gaussian_splatting_torch.training.config import load_config
    from easy_gaussian_splatting_torch.utils.synthetic import generate_colmap_scene

    class DebugGraph(torch.cuda.CUDAGraph):
        # the graph kept (keep_graph, an argument of both __new__ and the
        # binding's __init__) and debug mode on: debug_dump needs both
        def __new__(cls):
            return super().__new__(cls, True)

        def __init__(self):
            super().__init__(True)
            self.enable_debug_mode()

    scene_dir = RUN_DIR / "colmap_800"
    generate_colmap_scene(scene_dir, n_images=24, image_size=800, n_gaussians=20000,
                          n_points=gaussians, sh_degree=3, seed=seed, gt_renderer="tiled",
                          device=device)
    windows = []  # (where, measured, counted, records)
    with swapped(torch.cuda, "CUDAGraph", DebugGraph):
        for r in range(runs):
            cfg = load_config(REPO / "configs" / "tandt_db.yaml", **DATA_SCHEDULE,
                              data=str(scene_dir), output=str(RUN_DIR / f"probe{r}"))
            zero_counts()
            # every step but those of train()'s own profiler window (from step 10)
            loop, rec = train_recorded(cfg, None, device,
                                       set(range(1, cfg.total_iterations + 1)) - set(range(8, 18)),
                                       keep=r == runs - 1)
            windows += [(f"run {r} step {n}", s["measured"], s["launches"], s["records"])
                        for n, s in enumerate(rec["steps"], 1) if "measured" in s]
        program = rec["graphed"][-1].program
        dump = RUN_DIR / "probe_graph.dot"
        program.graph.debug_dump(str(dump))
        text = dump.read_text() if dump.exists() else ""
        PROBE_DIR.mkdir(parents=True, exist_ok=True)
        if text:
            shutil.copy(dump, PROBE_DIR / "replay_probe_graph.dot")
        # a node's function is its mangled name: ..._14binkeys_kernelEPKf...
        nodes = {name: len(re.findall(rf"\d{sym}E", text)) for name, sym in KERNEL_SYMBOLS.items()}
        log(f"[probe] the last program's debug dump: {len(text)} bytes, "
            f"{text.count('label="{KERNEL')} kernel nodes, {text.count('label="{MEMSET')} memset "
            "nodes; the port's kernels among them " + ", ".join(
                f"{k} {v}" for k, v in nodes.items() if v))
        def settled():
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()
            program.replay()

        for i in range(REPLAY_PROBE_WINDOWS):
            before = counts()
            _, prof = profiled(settled if i % 2 else program.replay)
            windows.append((f"replay {i}" + (" settled" if i % 2 else ""),
                            kernel_launches(prof), {k: v - before[k] for k, v in counts().items()},
                            device_records(prof)))
        rec["graphed"][-1].reset()
        del loop, rec, program
    groups = collections.defaultdict(list)
    for w in windows:
        groups[w[0].split(" ")[0] + (" settled" if "settled" in w[0] else "")].append(w)
    out = {"card": card, "kernel_nodes": nodes, "groups": {}}
    for name, ws in groups.items():
        common = collections.Counter(json.dumps(w[3], sort_keys=True) for w in ws).most_common(1)[0]
        mode = json.loads(common[0])
        short = [w for w in ws if w[1] != w[2]]
        odd = [dict(window=w[0], measured=w[1], counted=w[2],
                    missing={k: v - w[3].get(k, 0) for k, v in mode.items() if w[3].get(k, 0) < v},
                    extra={k: v - mode.get(k, 0) for k, v in w[3].items() if v > mode.get(k, 0)})
               for w in ws if json.dumps(w[3], sort_keys=True) != common[0]]
        out["groups"][name] = dict(windows=len(ws), common=common[1], short=len(short), odd=odd)
        log(f"[probe] {name}: {len(ws)} profiled windows, {common[1]} with the most common device "
            f"records ({sum(mode.values())} in all), {len(odd)} with others, {len(short)} with a "
            "port kernel fewer than the counters; " + "; ".join(
                f"{o['window']}: missing {sum(o['missing'].values())} ("
                + ", ".join(f"{k[:48]} {v}" for k, v in list(o["missing"].items())[:4])
                + f"), extra {sum(o['extra'].values())}" for o in odd[:8]))
    path = PROBE_DIR / "replay_probe.json"
    path.write_text(json.dumps(out, indent=1))
    log(f"[probe] card: {card}; every window that differs: {path.relative_to(REPO)}")


def http(port: int, path: str, payload=None):
    url = f"http://localhost:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type")
    return body, ctype, (time.perf_counter() - t0) * 1e3


def run(args) -> dict:
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    from easy_gaussian_splatting_torch.launch_viewer import build_viewer, load_run
    from easy_gaussian_splatting_torch.ops.kernels import _build
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk
    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr
    from easy_gaussian_splatting_torch.training.graphs import WARMUP_CALLS
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn
    from easy_gaussian_splatting_torch.viewer import integration
    from easy_gaussian_splatting_torch.viewer.integration import make_gs_render_func

    device = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1] device: {kind}, device count {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"[1] nvidia-smi: {card}")

    t0 = time.perf_counter()
    build_s = _build.build_all()
    log(f"[2] build: {time.perf_counter() - t0:.1f} s wall, per kernel "
        + ", ".join(f"{k} {v:.1f} s" for k, v in build_s.items()))
    for name, report in _build.ptxas_reports.items():
        for line in report.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[2] ptxas {name}: {line.strip()}")
    if args.replay_probe:
        replay_probe(args.replay_probe, args.gaussians, args.seed, device, card)
        return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}

    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    write_run_dir(RUN_DIR, args.gaussians, args.seed, device)
    log(f"[3] run dir: {args.gaussians} gaussians, SH 3, written in {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: the kernels against their plain versions at the
    # inputs one served 800x800 frame gives them
    cfg, state, sh_degree, cams = load_run(RUN_DIR, device=device)
    background = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=device)
    base_px = cams[0].width * cams[0].height

    def closure():
        # eager (no GraphedRender): the recorded kernel calls are the frame's
        # own, and the plain versions (which read offsets on the host) run
        with swapped(integration, "GraphedRender", lambda *a, **k: None):
            return make_gs_render_func(
                lambda: state, lambda: sh_degree, background, get_render_fn(cfg),
                cfg=cfg, base_pixels=base_px,
            )

    probe = closure()
    with recording(bk, "binkeys") as bk_calls, recording(tr, "tiled_forward") as fw_calls:
        probe(cams[0])
    stats = probe.stats
    log(f"[4] capacity {state.capacity}, tuned isect_mult {cfg.isect_mult}, small_budget "
        f"{cfg.small_budget}, ov_frac {cfg.ov_frac}; 800x800 frame: {stats['num_isects']} "
        f"intersections (capacity {stats['isect_cap']})")
    check(len(bk_calls) == 1 and len(fw_calls) == 1, "unexpected kernel call pattern")
    bk_err = check_binkeys(bk_calls)
    log(f"[4] binkeys: keys, flats and counts equal to the plain version "
        f"({describe_binkeys(bk_calls[0])})")
    fw_err, _ = check_forward(fw_calls[0][0])

    # ---- phase 5: serve
    zero_counts()
    t0 = time.perf_counter()
    viewer = build_viewer(RUN_DIR, port=0, device=device)
    try:
        log(f"[5] viewer on port {viewer.port}, built in {time.perf_counter() - t0:.1f} s")
        after_build = (bk.launches, tr.launches)
        served = []
        inner = viewer.render_func

        def capture(cam):
            img = inner(cam)
            served.append((cam, img, dict(viewer.base_render_func.stats)))
            return img

        viewer.render_func = capture
        body, _, _ = http(viewer.port, "/cameras")
        check(len(json.loads(body)) == len(cams), "/cameras lists the wrong cameras")
        fov = 2.0 * math.atan(400.0 / 1111.0)
        requests = {
            "dataset": dict(yaw=math.pi, pitch=0.0, radius=4.0, target=[0, 0, 0],
                            fov=fov, width=800, height=800),
            "orbit_720p": dict(yaw=0.6, pitch=0.3, radius=4.0, target=[0, 0, 0],
                               fov=1.0, width=1280, height=720),
            "rung_180p": dict(yaw=0.9, pitch=0.2, radius=4.0, target=[0, 0, 0],
                              fov=1.0, width=320, height=180, sh_cap=1),
        }
        latency, first = {}, {}
        from PIL import Image

        for name, payload in requests.items():
            times = []
            for _ in range(REQUEST_REPEATS):
                body, ctype, ms = http(viewer.port, "/render", payload)
                times.append(ms)
                im = Image.open(io.BytesIO(body))
                check(ctype == "image/jpeg" and im.size == SIZES[name],
                      f"/render {name}: got {ctype} {im.size}")
                st = served[-1][2]
                check(st["num_isects"] <= st["isect_cap"], f"/render {name}: truncated frame")
                first.setdefault(name, served[-1])
            latency[name] = times
            st = first[name][2]
            log(f"[5] /render {name} x{REQUEST_REPEATS}: {im.size[0]}x{im.size[1]} jpeg, "
                f"{st['num_isects']} intersections of capacity {st['isect_cap']} "
                f"({st['rerenders']} re-renders on the first request)")
        served_all = counts()
        served_counts = (served_all["binkeys"], served_all["tiled_forward"])
        frames = len(served) + sum(st["rerenders"] for _, _, st in served)
        log(f"[5] launches: binkeys {served_counts[0]} (after build {after_build[0]}), "
            f"tiled_forward {served_counts[1]} (after build {after_build[1]}) over "
            f"{frames} rendered frames")
        check(all(c > 0 for c in served_counts), "a kernel was never launched")
        check(served_counts[0] > after_build[0] and served_counts[1] > after_build[1],
              "a kernel's launches did not rise during the requests")
    finally:
        viewer.stop()

    # the served 800x800 frame against the same frame from the plain versions
    cam0, img0, _ = first["dataset"]
    ref = closure()
    with swapped(bk, "binkeys", bk.binkeys_plain), swapped(tr, "tiled_forward", tr.tiled_forward_plain):
        ref_img = ref(cam0)
    d = np.abs(img0 - ref_img).max(axis=-1)
    share = float((d <= TOL).mean())
    log(f"[5] served 800x800 frame vs plain-kernel frame: {share:.6f} of pixels within "
        f"{TOL}, {int((d > TOL).sum())} differ, max |diff| {d.max():.3e}")
    check(share >= MIN_AGREE, "served frame disagrees with the plain-kernel frame")

    # ---- phase 6: numbers
    log(f"[6] card: {card}")
    for a, k in bk_calls:
        launch = lambda a=a, k=k: bk.binkeys(*a, **k)  # noqa: E731
        log(f"[6] binkeys launch, {describe_binkeys((a, k))}: "
            f"{cuda_ms(launch, 20):.4f} ms (device alone {queued_ms(launch, 20):.4f})")
    bk_ms = cuda_ms(lambda: [bk.binkeys(*a, **k) for a, k in bk_calls], 20)
    bk_plain = cuda_ms(lambda: [bk.binkeys_plain(*a, **k) for a, k in bk_calls], 3, 1)
    bk_bound, bk_by = bound_ms(*binkeys_bound(bk_calls))
    fw_args = fw_calls[0][0]
    fw_ms = cuda_ms(lambda: tr.tiled_forward(*fw_args), 20)
    fw_plain = cuda_ms(lambda: tr.tiled_forward_plain(*fw_args), 2, 1)
    fw_work = forward_counts(*fw_args)
    (fw_bound, fw_by), (old_bound, old_by) = forward_bound(fw_args, fw_work)
    log(f"[6] binkeys: {bk_ms:.4f} ms/frame ({len(bk_calls)} launches back to back), plain "
        f"{bk_plain:.4f} ms, bound {bk_bound:.4f} ms ({bk_by})")
    log(f"[6] tiled_forward: {fw_ms:.4f} ms/frame, plain {fw_plain:.4f} ms, bound "
        f"{fw_bound:.4f} ms ({fw_by}; the rows walked and the composited pairs; the old "
        f"yardstick, every row and the {fw_work['reached']} pairs reached, gave "
        f"{old_bound:.4f} ms ({old_by})); {int(fw_args[1][-1])} listed rows of "
        f"{fw_args[0].shape[0]}")
    log_forward_counts("6", "the served 800x800 frame", fw_work)
    warm = WARMUP_CALLS * len(viewer.base_render_func.graphed.captures)
    log(f"[6] launches per rendered frame: binkeys {(served_counts[0] - after_build[0]) / frames:g}, "
        f"tiled_forward {(served_counts[1] - after_build[1]) / frames:g} (a replay adds one of "
        f"each; {warm} of each are the captures' warm-up calls, {WARMUP_CALLS} a capture)")
    render = viewer.base_render_func  # the served closure, its capacities tuned
    for name in requests:
        cam = first[name][0]
        render_ms = []
        for _ in range(REQUEST_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(cam)  # ends in the image's copy to the host
            torch.cuda.synchronize()
            render_ms.append((time.perf_counter() - t0) * 1e3)
        req = latency[name]
        log(f"[6] latency {name}: HTTP request first {req[0]:.1f} ms, median of the rest "
            f"{float(np.median(req[1:])):.1f} ms (render + JPEG + HTTP); render alone "
            f"median {float(np.median(render_ms)):.1f} ms over {REQUEST_REPEATS}")
    log(f"[6] max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    profile_device(lambda: render(first["dataset"][0]), 3, "frame", "6")
    caps = render.graphed.captures
    check(caps, "[6] the served closure captured no render")
    log(f"[6] the served closure replays {len(caps)} captured renders: " + "; ".join(
        f"{c['key'][0]}x{c['key'][1]} sh {c['key'][2]} isect_mult {c['key'][4]:.3f} in "
        f"{c['capture_ms']:.1f} ms" for c in caps))
    # phase 17 (d) serves the same model again
    serve = dict(state=state, sh_degree=sh_degree, background=background, cfg=cfg, base_px=base_px,
                 cams={name: first[name][0] for name in requests})
    del viewer, render, probe, ref, stats
    torch.cuda.empty_cache()

    # ---- phase 7: training data
    import dataclasses
    import random

    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.ops.kernels import segments as seg
    from easy_gaussian_splatting_torch.training import trainer as ttrainer
    from easy_gaussian_splatting_torch.training.config import load_config
    from easy_gaussian_splatting_torch.training.trainer import tune_inference_cfg

    t0 = time.perf_counter()
    tcfg = load_config(REPO / "configs" / "nerf_synthetic.yaml", **TRAIN_SCHEDULE,
                       output=str(RUN_DIR / "train"))
    xyzs, rgbs, state0, frames = training_data(args.gaussians, args.seed, tcfg, device)
    log(f"[7] training data: {args.gaussians} gaussians (capacity {state0.capacity}), SH 3, "
        f"{len(frames)} ring frames 800x800 rendered from the ground-truth copy in "
        f"{time.perf_counter() - t0:.1f} s")
    log("[7] config: configs/nerf_synthetic.yaml with " + json.dumps(TRAIN_SCHEDULE))

    # ---- phase 8: the kernels at the inputs of one real step (the first
    # step's state, camera and the trainer's capacity autotune)
    f0 = frames[0]
    w2c0, K0 = (torch.as_tensor(f0[k], device=device) for k in ("w2c", "K"))
    img0, mask0 = (torch.as_tensor(f0[k], device=device) for k in ("image", "mask"))
    cfg8 = tune_inference_cfg(dataclasses.replace(tcfg), state0, f0["w2c"], f0["K"], 800, 800, margin=1.2)
    grad_fn = ttrainer.make_grad_fn(cfg8, ttrainer.get_render_fn(cfg8))
    step_kw = dict(height=800, width=800, sh_degree=3)
    with recording(tr, "tiled_backward") as bw_calls, recording(seg, "segsum_band") as seg_calls, \
            recording(bk, "binkeys") as bk8_calls:
        got = grad_fn(state0, w2c0, K0, img0, mask0, **step_kw)
    check(len(bw_calls) == 1 and len(seg_calls) == 1 and len(bk8_calls) == 1,
          "unexpected kernel call pattern")
    check_binkeys(bk8_calls)
    log(f"[8] binkeys: keys, flats and counts equal to the plain version "
        f"({describe_binkeys(bk8_calls[0])})")
    del bk8_calls  # phase 12 records the step's binning again
    log(f"[8] one step: isect_mult {cfg8.isect_mult}, {bw_calls[0][0][0].shape[0]} intersection "
        f"rows, {int(got[3].gt(0).sum())} visible gaussians")
    bw_err, bw_plain = check_backward(bw_calls[0])
    seg_err = check_segsum(seg_calls[0], state0.capacity)
    with plain_swaps():
        want = grad_fn(state0, w2c0, K0, img0, mask0, **step_kw)
    check_step_gradients(got, want)
    band_step = got  # phase 11 holds the other reductions against it
    del want

    # ---- phase 9: train
    random.seed(args.seed)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    loop, rec = train_recorded(tcfg, RingScene(xyzs, rgbs, frames, tcfg.total_iterations), device,
                               PROFILED_STEPS)
    train_s = time.perf_counter() - t0
    train_counts = counts()
    train_peak = torch.cuda.max_memory_allocated()
    log(f"[9] train(): {loop.step} steps in {train_s:.1f} s, {rec['densify']} densify events, "
        f"{rec['reset']} opacity resets, {loop.model.num_alive()} gaussians at the end (capacity "
        f"{loop.model.capacity}), final isect_mult {tcfg.isect_mult}")
    log("[9] launches in train(): " + ", ".join(f"{k} {v}" for k, v in train_counts.items()))
    check(rec["graphed"], "[9] train() did not run the graphed step")
    log_captures("9", rec)
    log("[9] intersections / capacity per step: "
        + " ".join(f"{s['isects']}/{s['cap']}" for s in rec["steps"]))
    check_training(loop, rec, tcfg, device)
    check_replays("9", rec, PER_STEP)

    # ---- phase 10: numbers
    step_ms = [rec["steps"][i]["ms"] for i in TIMED_STEPS]
    bw_args, seg_args = bw_calls[0][0], seg_calls[0][0]
    bw_ms = cuda_ms(lambda: tr.tiled_backward(*bw_args), 20)
    seg_ms = cuda_ms(lambda: seg.segsum_band(*seg_args), 20)
    seg_plain = cuda_ms(lambda: seg.segsum_band_plain(*seg_args), 3, 1)
    bw_work = backward_counts(bw_args[0], bw_args[1], bw_args[2], bw_args[6])
    bw_bound, bw_by = backward_bound(bw_args, bw_work)
    seg_bound, seg_by = segsum_bound(seg_args)
    log(f"[10] card: {card}")
    log(f"[10] train step (steps 15-19, host clock between synchronizes): median "
        f"{float(np.median(step_ms)):.2f} ms, each " + " ".join(f"{x:.2f}" for x in step_ms)
        + f"; all 40: " + " ".join(f"{s['ms']:.1f}" for s in rec["steps"]))
    log(f"[10] tiled_backward: {bw_ms:.4f} ms/step, plain {bw_plain:.4f} ms (one call), bound "
        f"{bw_bound:.4f} ms ({bw_by}) on phase 8's inputs")
    log_backward_counts("10", "phase 8's inputs", bw_work)
    forward_numbers(bw_args[:3], "10", "phase 8's inputs")
    log(f"[10] segsum_band: {seg_ms:.4f} ms/step, plain {seg_plain:.4f} ms, bound "
        f"{seg_bound:.4f} ms ({seg_by}); {seg_args[0].shape[0]} rows")
    log("[10] launches per step in train(): " + ", ".join(
        f"{k} {v / loop.step:g}" for k, v in train_counts.items()))
    log(f"[10] max_memory_allocated during train(): {train_peak / 2**20:.0f} MiB")
    step_fn = ttrainer.make_train_step(tcfg, ttrainer.get_render_fn(tcfg))
    fp = frames[0]
    fp_t = [torch.as_tensor(fp[k], device=device) for k in ("w2c", "K", "image", "mask")]
    with recording(tr, "tiled_backward") as post_calls:
        profile_device(
            lambda: step_fn(loop.model, loop.adam, *fp_t, 1e-4, True, False, False, **step_kw),
            3, "step", "10",
        )
    # the backward on the state after the opacity reset: the inputs of the
    # profile's first step
    post_args = post_calls[0][0]
    del loop, step_fn, post_calls
    torch.cuda.empty_cache()
    check_backward((post_args, {}), "10")
    post_ms = cuda_ms(lambda: tr.tiled_backward(*post_args), 20)
    post_work = backward_counts(post_args[0], post_args[1], post_args[2], post_args[6])
    post_bound, post_by = backward_bound(post_args, post_work)
    log(f"[10] tiled_backward after the opacity reset: {post_ms:.4f} ms/step, bound "
        f"{post_bound:.4f} ms ({post_by}); {int(post_args[1][-1])} live rows of "
        f"{post_args[0].shape[0]}")
    log_backward_counts("10", "the post-reset inputs", post_work)
    forward_numbers(post_args[:3], "10", "the post-reset inputs")

    # ---- phase 11: the other backward reductions, each checked on the
    # inputs of phase 8's step, then driven through a short train() run
    # (band first, as the baseline of the same schedule)
    log("[11] train() config: configs/nerf_synthetic.yaml with " + json.dumps(REDUCE_SCHEDULE))
    runs = {}
    reduce_counts, reduce_errs, reduce_numbers = {}, {}, {}
    for name in ("band",) + REDUCTIONS:
        errs, rec, step_peak = reduction_step(
            name, grad_fn, band_step, (state0, w2c0, K0, img0, mask0), step_kw)
        reduce_errs.update(errs)
        reduce_numbers.update(time_reduction_kernels(name, rec))
        if name == "dense":
            gr_calls = rec["group_reduce"]
        if name == "pallas":
            compact_call = rec["segsum_compact"][0]
        del rec
        torch.cuda.empty_cache()
        runs[name] = train_reduction(name, xyzs, rgbs, frames, device, args.seed) + (step_peak,)
        reduce_counts.update({k: runs[name][0][k] for k in REDUCE_KERNELS[name]})
    log(f"[11] card: {card}")
    for name, (total, ms, peak, step_peak) in runs.items():
        per_step = ", ".join(f"{k} {total[k] / REDUCE_SCHEDULE['total_iterations']:g}"
                             for k in REDUCE_KERNELS[name])
        log(f"[11] {name}: train step median (steps 5-9) {ms:.2f} ms; peak device memory in "
            f"train() {peak / 2**20:.0f} MiB, in one phase-8 step {step_peak / 2**20:.0f} MiB; "
            f"own kernels per step: {per_step or 'none'}")

    # ---- phase 12 (with --ab-parent): the redesigned kernels against the
    # parent commit's on the same recorded inputs
    if args.ab_parent:
        with recording(bk, "binkeys") as bk8_calls:
            grad_fn(state0, w2c0, K0, img0, mask0, **step_kw)
        ab_compare(
            Path(args.ab_parent),
            {"the served frame": fw_args, "phase 8's inputs": bw_args[:3],
             "the post-reset inputs": post_args[:3]},
            {"phase 8's inputs": bw_args, "the post-reset inputs": post_args}, gr_calls,
            {"the served frame": bk_calls[0], "phase 8's binning": bk8_calls[0]}, compact_call)
        del bk8_calls

    # ---- phase 14: the batched step at full width, on phase 8's state
    # (it runs before phase 13, which frees that state)
    del band_step, grad_fn, post_args
    torch.cuda.empty_cache()
    batched = batched_step(cfg8, state0, frames, float(np.median(step_ms)), device, card)
    # ---- phase 18 (a): the batched step graphed against eager
    torch.cuda.empty_cache()
    batched_g = batched_graphed(cfg8, state0, frames, device, card)

    # ---- phase 16 (a): the mesh's gradients and steps on phase 8's state,
    # then phase 18 (c)'s graphed sharded steps on one NCCL rank
    torch.cuda.empty_cache()
    mesh_launches, mesh_state = mesh_gradients(cfg8, state0, frames, card)
    mesh_graph_steps(mesh_state, card)

    # ---- phase 17: the compiled step and the graphed served render against
    # their eager versions (phase 8's state and frames; the served model)
    torch.cuda.empty_cache()
    compiled_step(cfg8, state0, frames, serve, device, card)

    # ---- phase 13: train(cfg) from a data path, at full width from a
    # COLMAP directory, then the convergence check
    from easy_gaussian_splatting_torch.utils.synthetic import generate_colmap_scene

    del state0, img0, mask0, frames, bw_calls, seg_calls
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scene_dir = RUN_DIR / "colmap_800"
    generate_colmap_scene(scene_dir, n_images=24, image_size=800, n_gaussians=20000,
                          n_points=args.gaussians, sh_degree=3, seed=args.seed,
                          gt_renderer="tiled", device=device)
    log(f"[13] colmap scene: 24 images 800x800 of 20000 SH-3 ground-truth gaussians (the port's "
        f"tiled renderer), {args.gaussians} sparse points, written in {time.perf_counter() - t0:.1f} s")
    data_run = train_data_path(scene_dir, RUN_DIR / "train13", device, card)
    e2e = convergence(RUN_DIR / "e2e")
    log(f"[13] card: {card}; data path step median {data_run['step_ms']:.2f} ms cached, "
        f"{data_run['stream_step_ms']:.2f} ms streamed; e2e psnr {e2e['psnr']:.2f} dB")

    # ---- phase 15: the command lines: eval on phase 13 (a)'s run directory,
    # then training with the viewer on its scene (13 (b) ran the e2e script)
    torch.cuda.empty_cache()
    eval_run = eval_cli(RUN_DIR / "train13")
    # ---- phase 18 (b): that eval against the same command with the
    # evaluator eager
    eval_graphed(eval_run, RUN_DIR / "train13", card)
    del eval_run["evaluators"], eval_run["chains"]
    for client in (ThreadClient, ProcessClient):
        view_online(scene_dir, RUN_DIR / f"train15_{client.__name__}", data_run["step_ms"],
                    device, card, client)

    # ---- phase 16 (b): train(cfg) under a mesh on phase 13 (a)'s scene
    torch.cuda.empty_cache()
    for k, v in mesh_training(scene_dir, data_run["step_ms"], card).items():
        mesh_launches[k] += v
    check(all(mesh_launches[k] > 0 for k in MESH_KERNELS),
          f"[16] a main-path kernel never launched under the mesh: {mesh_launches}")
    # ---- phase 18 (c): train(cfg) on one NCCL rank, graphed, against one
    # gloo rank, eager
    torch.cuda.empty_cache()
    mesh_graphed = mesh_graph_training(scene_dir, card)

    # ---- phase 19: the refine-event programs over the live state and the
    # capture ahead, in train(cfg) on phase 13 (a)'s scene ((d) ran in 18 (c))
    torch.cuda.empty_cache()
    refine_launches = refine_programs(scene_dir, card)

    # ---- phase 20: the port's bench, its matrix as a user runs it, then
    # its 100k points in process under the counters and the profiler, then
    # the kernels against their plain versions at its 3M and batched points
    torch.cuda.empty_cache()
    bench_matrix(kind, card)
    bench_launches = bench_replays(card)
    bench_errs = bench_kernels()

    measured = {
        "binkeys": ("binkeys.cu", "binkeys.py:154", bk_err, bk_ms, bk_plain, bk_bound, bk_by),
        "tiled_forward": ("tile_forward.cu", "tile_raster.py:355", fw_err, fw_ms, fw_plain,
                          fw_bound, fw_by),
        "tiled_backward": ("tile_backward.cu", "tile_raster.py:616", bw_err, bw_ms, bw_plain,
                           bw_bound, bw_by),
        "segsum_band": ("segsum_band.cu", "segments.py:267", seg_err, seg_ms, seg_plain,
                        seg_bound, seg_by),
    }
    kernels = [
        dict(name=name, route="cuda", source=f"easy_gaussian_splatting_torch/csrc/{src}",
             replaces=f"easy_gaussian_splatting_tpu/ops/pallas/{tpu}",
             launches=train_counts[name], launches_served=served_all[name],
             launches_data_path=data_run["launches"][name],
             launches_batched=batched["launches"][name],
             launches_eval_cli=eval_run["launches"][name],
             launches_mesh=mesh_launches[name],
             launches_batched_graphed=batched_g["launches"][name],
             launches_mesh_graphed=mesh_graphed[name],
             launches_refine=refine_launches[name], launches_bench=bench_launches[name],
             max_abs_err=err, max_abs_err_bench=bench_errs[name],
             ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None)
        for name, (src, tpu, err, ms, plain, bound, by) in measured.items()
    ]
    sources = {"segsum_compact": ("segsum_compact.cu", "segments.py:181"),
               "monotone_expand": ("monotone_expand.cu", "segments.py:363"),
               "group_reduce": ("group_reduce.cu", "group_reduce.py:28")}
    for name, (src, tpu) in sources.items():
        ms, plain, lib, bound, by = reduce_numbers[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"easy_gaussian_splatting_torch/csrc/{src}",
            replaces=f"easy_gaussian_splatting_tpu/ops/pallas/{tpu}",
            launches=reduce_counts[name], launches_served=served_all[name],
            launches_data_path=data_run["launches"][name],
            launches_batched=batched["launches"][name],
            launches_eval_cli=eval_run["launches"][name],
            launches_mesh=mesh_launches[name],
            launches_batched_graphed=batched_g["launches"][name],
            launches_mesh_graphed=mesh_graphed[name],
            launches_refine=refine_launches[name], launches_bench=bench_launches[name],
            max_abs_err=reduce_errs[name], max_abs_err_bench=None,
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gaussians", type=int, default=1_000_000)
    parser.add_argument("--ab-parent", metavar="DIR",
                        help="another checkout (the parent commit): time its tiled_forward, "
                             "tiled_backward, group_reduce, binkeys and segsum_compact beside this tree's on the "
                             "same inputs (phase 12)")
    parser.add_argument("--replay-probe", type=int, metavar="RUNS", default=0,
                        help="after the build, only phase 13 (a)'s train() RUNS times with every "
                             "replay profiled, then profiled replays of its last program: which "
                             "device records each profiler window lost (no other phase runs)")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        result = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
