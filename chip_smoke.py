#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0] [--gaussians 1000000]

Drives ``easy_gaussian_splatting_torch`` (never the JAX package) through
its offline viewer, the main path of this part of the port:

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
   launch counts must rise during the requests;
6. numbers: request latency, each kernel's and plain version's time
   (CUDA events), its lower bound on this card, launches per frame and
   peak device memory, then one JSON line of kernels.

The last line of stdout is ``{"ok": true, "device": {...}}``; any failed
phase exits non-zero before it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import time
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
# quadratic, the inside test, the compare); tiled_forward per (pixel,
# intersection) pair reached (7-term polynomial, exp, eligibility tests)
BINKEYS_OPS_PER_CELL = 75
FORWARD_OPS_PER_PAIR = 20

TOL = 1e-4  # rgb / final-T agreement of kernel and plain forward
MIN_AGREE = 0.9999  # share of pixels that must agree within TOL
REQUEST_REPEATS = 5
SIZES = {"dataset": (800, 800), "orbit_720p": (1280, 720), "rung_180p": (320, 180)}


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


def check_binkeys(calls, plain) -> float:
    """Kernel against plain version on every recorded call: keys, flats
    and counts must be equal. Returns the largest absolute difference."""
    from easy_gaussian_splatting_torch.ops.kernels import binkeys as bk

    max_err = 0
    for args, kwargs in calls:
        got = bk.binkeys(*args, **kwargs)
        want = plain(*args, **kwargs)
        for name, g, w in zip(("keys", "flats", "count_small", "count_full"), got, want):
            diff = int((g != w).sum())
            if g.numel():
                max_err = max(max_err, int((g.long() - w.long()).abs().max()))
            check(diff == 0, (
                f"binkeys {name} differ from the plain version in {diff} of "
                f"{g.numel()} entries (n_keys={kwargs['n_keys']}): the exact "
                "tile test rounded differently"
            ))
    return float(max_err)


def compare_frames(got_rgb, got_t, want_rgb, want_t):
    """Per-pixel agreement mask of two forward outputs within TOL."""
    d_rgb = (got_rgb - want_rgb).abs().amax(dim=-1)
    d_t = (got_t - want_t).abs()
    return (d_rgb <= TOL) & (d_t <= TOL), float(d_rgb.max())


def check_forward(call, plain):
    """Kernel against plain version on the recorded forward call. Pixels
    outside TOL, and pixels inside it whose last contributor differs, are
    flipped decisions: each must replay an eligibility or stop decision
    within rounding of its edge. Returns the largest rgb difference."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels import tile_raster as tr

    (feats, offsets, basis), _ = call
    k_rgb, k_t, k_last = tr.tiled_forward(feats, offsets, basis)
    p_rgb, p_t, p_last = plain(feats, offsets, basis)
    torch.cuda.synchronize()
    agree, max_err = compare_frames(k_rgb, k_t, p_rgb, p_t)
    n_px = agree.numel()
    n_bad = int((~agree).sum())
    last_only = agree & (k_last != p_last)
    share = 1.0 - n_bad / n_px
    log(f"[4] tiled_forward: {n_px - n_bad}/{n_px} pixels within {TOL} (share "
        f"{share:.6f}), max rgb |diff| {max_err:.3e}; {int(last_only.sum())} more "
        "agree in rgb but differ in last contributor")
    flipped = ((~agree) | last_only).nonzero().tolist()
    replayed = flipped[:64]
    explained = sum(1 for t, p in replayed if near_decision(feats, offsets, basis, t, p))
    log(f"[4] tiled_forward: {explained} of {len(replayed)} replayed flipped pixels "
        "have a stop/eligibility decision within rounding of its edge")
    check(share >= MIN_AGREE, f"tiled_forward agrees on only {share:.6f} of pixels")
    check(explained == len(replayed), "tiled_forward: unexplained pixel differences")
    return max_err


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


def binkeys_bound(calls):
    """(bytes, f32 ops) the binkeys calls of one frame must move and do."""
    nbytes = ops = 0
    for args, kwargs in calls:
        fgeo, igeo = args
        n, m, n_keys = fgeo.shape[1], kwargs["m"], kwargs["n_keys"]
        nbytes += fgeo.numel() * 4 + igeo.numel() * 4 + n * n_keys * 12 + n * 8
        ops += BINKEYS_OPS_PER_CELL * int(igeo[3].clamp(max=m).sum())
    return nbytes, ops


def forward_pairs(feats, offsets, basis, max_elems: int = 1 << 26) -> int:
    """(pixel, intersection) pairs the forward walk reaches on this data:
    each pixel's intersections up to and including the one that stops it."""
    import torch

    from easy_gaussian_splatting_torch.ops.kernels.tile_raster import SIGMA_EPS

    offs = offsets.long()
    counts = (offs[1:] - offs[:-1]).tolist()
    p = basis.shape[0]
    total = 0
    for t in range(len(counts)):
        n = counts[t]
        if n == 0:
            continue
        s = int(offs[t])
        chunk = max(1, max_elems // p)
        T = torch.ones(p, dtype=torch.float64, device=feats.device)
        alive = torch.ones(p, dtype=torch.bool, device=feats.device)
        for c0 in range(0, n, chunk):
            f = feats[s + c0 : s + min(n, c0 + chunk)]
            s2 = basis[:, :7] @ f[:, :7].T
            nlo = f[:, 6][None, :]
            alpha = torch.exp(-torch.maximum(s2, nlo)).clamp(max=0.999)
            elig = (s2 >= nlo - SIGMA_EPS) & (alpha >= 1.0 / 255.0)
            om = torch.where(elig, 1.0 - alpha, torch.ones_like(alpha)).double()
            excl = torch.cumprod(torch.cat([T[:, None], om[:, :-1]], dim=1), dim=1)
            stop = elig & (excl * om < 1e-4)
            stopped_before = torch.cumsum(stop.int(), dim=1) - stop.int() > 0
            reached = ~stopped_before & alive[:, None]
            total += int(reached.sum())
            alive = alive & ~stop.any(dim=1)
            T = excl[:, -1] * om[:, -1]
            if not bool(alive.any()):
                break
    return total


def profile_frames(render, cam, frames: int = 3, top: int = 14) -> None:
    """Where a served frame's time goes: ``torch.profiler`` device time by
    kernel over a few frames, and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    render(cam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render(cam)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    rows = [  # device-side events only (kernels, copies), not the host ops
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    rows = [r for r in rows if r[0] > 0]
    busy = sum(r[0] for r in rows)
    if not rows:
        log("[6] profile: no device time recorded")
        return
    log(f"[6] profile of {frames} 800x800 frames: wall {wall_ms / frames:.2f} ms/frame, "
        f"device busy {busy / frames:.2f} ms/frame (idle share {1 - busy / wall_ms:.3f})")
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        log(f"[6]   {ms / frames:8.3f} ms/frame  {n / frames:6.1f} calls/frame  {key[:90]}")


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ main
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
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn
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
    check(len(bk_calls) == 2 and len(fw_calls) == 1, "unexpected kernel call pattern")
    bk_err = check_binkeys(bk_calls, bk.binkeys_plain)
    log(f"[4] binkeys: keys, flats and counts equal to the plain version "
        f"({', '.join(str(tuple(a[0].shape)) for a, _ in bk_calls)} rows)")
    fw_err = check_forward(fw_calls[0], tr.tiled_forward_plain)

    # ---- phase 5: serve
    bk.launches = tr.launches = 0
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
        served_counts = (bk.launches, tr.launches)
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
    fa, fb = bk_calls
    bk_ms = sum(cuda_ms(lambda a=a, k=k: bk.binkeys(*a, **k), 20) for a, k in (fa, fb))
    bk_plain = sum(cuda_ms(lambda a=a, k=k: bk.binkeys_plain(*a, **k), 3, 1) for a, k in (fa, fb))
    (feats, offs, basis), _ = fw_calls[0]
    fw_ms = cuda_ms(lambda: tr.tiled_forward(feats, offs, basis), 20)
    fw_plain = cuda_ms(lambda: tr.tiled_forward_plain(feats, offs, basis), 2, 1)
    bk_bound, bk_by = bound_ms(*binkeys_bound(bk_calls))
    pairs = forward_pairs(feats, offs, basis)
    p, n_tiles = basis.shape[0], offs.shape[0] - 1
    fw_bytes = feats.numel() * 4 + offs.numel() * 4 + basis.numel() * 4 + n_tiles * p * 20
    fw_bound, fw_by = bound_ms(fw_bytes, FORWARD_OPS_PER_PAIR * pairs)
    log(f"[6] card: {card}")
    log(f"[6] binkeys: {bk_ms:.4f} ms/frame (2 launches), plain {bk_plain:.4f} ms, "
        f"bound {bk_bound:.4f} ms ({bk_by})")
    log(f"[6] tiled_forward: {fw_ms:.4f} ms/frame, plain {fw_plain:.4f} ms, bound "
        f"{fw_bound:.4f} ms ({fw_by}); {feats.shape[0]} intersection rows, {pairs} "
        f"(pixel, intersection) pairs reached")
    log(f"[6] launches per rendered frame: binkeys {(served_counts[0] - after_build[0]) / frames:g}, "
        f"tiled_forward {(served_counts[1] - after_build[1]) / frames:g}")
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
    profile_frames(render, first["dataset"][0])
    kernels = [
        dict(name="binkeys", route="cuda",
             source="easy_gaussian_splatting_torch/csrc/binkeys.cu",
             replaces="easy_gaussian_splatting_tpu/ops/pallas/binkeys.py:154",
             launches=served_counts[0], max_abs_err=bk_err, ms=bk_ms,
             plain_ms=bk_plain, bound_ms=bk_bound, bound_by=bk_by, library_ms=None),
        dict(name="tiled_forward", route="cuda",
             source="easy_gaussian_splatting_torch/csrc/tile_forward.cu",
             replaces="easy_gaussian_splatting_tpu/ops/pallas/tile_raster.py:355",
             launches=served_counts[1], max_abs_err=fw_err, ms=fw_ms,
             plain_ms=fw_plain, bound_ms=fw_bound, bound_by=fw_by, library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gaussians", type=int, default=1_000_000)
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
