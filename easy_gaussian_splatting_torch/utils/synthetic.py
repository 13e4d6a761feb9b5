"""Procedural datasets for end-to-end runs; counterpart of
``easy_gaussian_splatting_tpu/utils/synthetic.py``.

No dataset ships with the repository, so a full run (loaders -> training ->
densify -> eval -> checkpoints) trains on a generated scene: a colourful
ground-truth Gaussian scene rendered from a ring of cameras and written in
the on-disk formats the loaders read, Blender (``transforms_*.json`` and
PNGs) and COLMAP (``sparse/0/*.bin`` and images). The ground truth is drawn
with numpy from a seed, as the JAX module draws it, and rendered by this
package's oracle (``ops/rasterize_ref.py``) or its tiled renderer, on
``device``.
"""

from __future__ import annotations

import functools
import json
import struct
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from .. import resolve_device

SH_C0 = 0.28209479177387814


def make_gt_gaussians(
    n: int = 300,
    seed: int = 0,
    sh_degree: int = 0,
    layout: str = "box",
    aniso: float = 1.0,
):
    """A colourful, fittable ground-truth Gaussian scene: (means, scales,
    quats, SH coefficients [n, (sh_degree+1)^2, 3], opacities), numpy.

    The DC term encodes a base albedo; ``sh_degree >= 1`` adds random
    higher-order coefficients so the scene is view-dependent. Scales shrink
    with n^(1/3) so dense scenes stay resolvable. ``layout="unbounded"``:
    70% of the population in [-1.2, 1.2]^3, 30% on background shells out to
    radius ~12 (depth spans two orders of magnitude). ``aniso > 1``
    stretches each axis by lognormal factors with ratios up to ~aniso."""
    rng = np.random.default_rng(seed)
    if layout == "unbounded":
        n_core = int(n * 0.7)
        core = rng.uniform(-1.2, 1.2, size=(n_core, 3))
        u = rng.uniform(0.0, 1.0, size=(n - n_core,))
        r = 2.5 / np.maximum(u, 1e-3) ** 0.6  # heavy tail, r in [2.5, ~160]
        r = np.minimum(r, 12.0)
        d = rng.normal(size=(n - n_core, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        means = np.concatenate([core, d * r[:, None]], axis=0).astype(np.float32)
        # background Gaussians scale with their distance (constant angular size)
        rad_scale = np.concatenate([np.ones(n_core), r / 2.5], axis=0)[:, None]
    else:
        means = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
        rad_scale = np.ones((n, 1))
    f = min(1.0, (300.0 / max(n, 1)) ** (1.0 / 3.0))
    scales = (rng.uniform(0.04, 0.14, size=(n, 3)) * f * rad_scale).astype(np.float32)
    if aniso > 1.0:
        stretch = np.exp(rng.uniform(-0.5 * np.log(aniso), 0.5 * np.log(aniso), size=(n, 3)))
        scales = (scales * stretch).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    base = rng.uniform(0.05, 0.95, size=(n, 1, 3))
    k = (sh_degree + 1) ** 2
    shs = np.zeros((n, k, 3), np.float32)
    shs[:, :1] = (base - 0.5) / SH_C0
    if k > 1:
        # decaying amplitude per degree keeps blended colours mostly in [0, 1]
        amp = np.concatenate(
            [np.full(2 * d + 1, 0.25 / (2.0 ** (d - 1))) for d in range(1, sh_degree + 1)]
        )
        shs[:, 1:] = (rng.normal(size=(n, k - 1, 3)) * amp[None, :, None]).astype(np.float32)
    opac = rng.uniform(0.5, 0.95, size=(n,)).astype(np.float32)
    return means, scales, quats, shs, opac


def _lookat_w2c(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenCV-convention world->camera: z forward, y down."""
    z = target - pos
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    return np.linalg.inv(c2w)


def ring_cameras(n: int, radius: float = 3.2, height_jitter: float = 0.8, seed: int = 1) -> np.ndarray:
    """n w2c matrices on a ring looking at the origin."""
    rng = np.random.default_rng(seed)
    w2cs = []
    for i in range(n):
        theta = 2.0 * np.pi * i / n
        h = rng.uniform(-height_jitter, height_jitter)
        pos = np.array([radius * np.sin(theta), h, radius * np.cos(theta)])
        w2cs.append(_lookat_w2c(pos, np.zeros(3)))
    return np.stack(w2cs)


def _sh_degree_of(shs) -> int:
    return {1: 0, 4: 1, 9: 2, 16: 3}[shs.shape[1]]


def _render_oracle(gt, w2c, width, height, fx, background, device) -> torch.Tensor:
    """The exact O(N*P) oracle, SH along each camera->Gaussian direction."""
    from ..ops.projection import CameraIntrinsics, project_gaussians
    from ..ops.rasterize_ref import rasterize
    from ..ops.sh import eval_sh_color_flat

    means, scales, quats, shs, opac = (torch.as_tensor(x, device=device) for x in gt)
    w2c = torch.as_tensor(w2c.astype(np.float32), device=device)
    fx_t = torch.tensor(fx, dtype=torch.float32, device=device)
    intr = CameraIntrinsics(fx_t, fx_t, torch.tensor(width / 2, dtype=torch.float32, device=device),
                            torch.tensor(height / 2, dtype=torch.float32, device=device),
                            width, height)
    proj = project_gaussians(means, quats, scales, w2c, intr)
    opac_eff = opac * (proj.radii > 0.0).to(torch.float32)
    cam_pos = -w2c[:3, :3].T @ w2c[:3, 3]
    dirs = means - cam_pos[None, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    n = means.shape[0]
    colors = eval_sh_color_flat(_sh_degree_of(shs), shs[:, 0], shs[:, 1:].reshape(n, -1), dirs)
    img, _ = rasterize(proj.means2d, proj.conics, colors, opac_eff, proj.depths, background,
                       None, height, width, chunk=128)
    return torch.clamp(img, 0.0, 1.0)


@functools.lru_cache(maxsize=1)
def _tiled_render_fn():
    from ..ops.rasterize_tiled import make_tiled_render_fn

    return make_tiled_render_fn(isect_mult=24)


def _render_tiled(gt, w2c, width, height, fx, background, device) -> torch.Tensor:
    """The production tiled renderer; refuses a truncated binning, which
    would corrupt the frames every downstream PSNR gate trusts."""
    from ..models.gaussians import GaussianParams
    from ..models.render import CameraView

    means, scales, quats, shs, opac = (torch.as_tensor(x, device=device) for x in gt)
    n, k = shs.shape[0], shs.shape[1]
    sh_pad = torch.cat([shs, torch.zeros((n, 16 - k, 3), device=device)], 1)
    params = GaussianParams(
        means=means,
        log_scales=torch.log(torch.clamp(scales, min=1e-12)),
        quats=quats,
        sh_0=sh_pad[:, :1],
        sh_rest=sh_pad[:, 1:],
        logit_opacities=torch.log(opac / torch.clamp(1.0 - opac, min=1e-6)),
    )
    K = torch.tensor([[fx, 0.0, width / 2.0], [0.0, fx, height / 2.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=device)
    camera = CameraView(w2c=torch.as_tensor(w2c.astype(np.float32), device=device), K=K,
                        width=width, height=height)
    out = _tiled_render_fn()(params, torch.ones(n, dtype=torch.bool, device=device), camera,
                             _sh_degree_of(shs), background, None)
    n_isect, cap = int(out.num_isects), 24 * n
    if n_isect > 0.95 * cap:
        raise RuntimeError(
            f"tiled GT render near/over intersection capacity ({n_isect} of {cap}); use "
            "method='oracle' or reduce the scene"
        )
    return torch.clamp(out.image, 0.0, 1.0)


def render_gt(
    gt, w2c: np.ndarray, width: int, height: int, fx: float,
    white_background: bool, method: str = "oracle", device: str | torch.device = "cuda",
) -> np.ndarray:
    """Render the ground-truth scene (uint8 [H, W, 3]). ``method="oracle"``:
    the exact reference rasterizer, independent of the production path;
    ``method="tiled"``: the production tiled renderer, far faster at 100k+
    Gaussians, for scale-regime scenes."""
    dev = resolve_device(device)
    background = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    render = _render_tiled if method == "tiled" else _render_oracle
    with torch.no_grad():
        img = render(gt, w2c, width, height, fx, background, dev)
    return (img.cpu().numpy() * 255.0 + 0.5).astype(np.uint8)


def _write_mask(path: Path, size: int, seed: int) -> None:
    """A filled disk of 'ignore' pixels at a seeded position (exercises the
    mask-compositing loss)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    c = rng.uniform(0.25, 0.75, size=2) * size
    r = 0.12 * size
    yy, xx = np.mgrid[0:size, 0:size]
    disk = ((xx - c[0]) ** 2 + (yy - c[1]) ** 2) < r * r
    Image.fromarray((disk * 255).astype(np.uint8)).save(path)


def generate_blender_scene(
    out_dir: Path,
    n_train: int = 24,
    n_test: int = 6,
    image_size: int = 128,
    n_gaussians: int = 300,
    white_background: bool = True,
    seed: int = 0,
    sh_degree: int = 0,
    with_masks: bool = False,
    layout: str = "box",
    aniso: float = 1.0,
    gt_renderer: str = "oracle",
    device: str | torch.device = "cuda",
) -> Path:
    """Write a Blender-format dataset rendered from a GT Gaussian scene."""
    from PIL import Image

    out_dir = Path(out_dir)
    gt = make_gt_gaussians(n_gaussians, seed, sh_degree=sh_degree, layout=layout, aniso=aniso)
    fov_x = 0.9
    fx = image_size / (2.0 * np.tan(fov_x / 2.0))

    for split, n, cam_seed in [("train", n_train, 1), ("test", n_test, 2)]:
        (out_dir / split).mkdir(parents=True, exist_ok=True)
        if with_masks:
            (out_dir / f"{split}_masks").mkdir(parents=True, exist_ok=True)
        w2cs = ring_cameras(n, seed=cam_seed)
        frames = []
        for i, w2c in enumerate(w2cs):
            img = render_gt(gt, w2c, image_size, image_size, fx, white_background,
                            method=gt_renderer, device=device)
            Image.fromarray(img).save(out_dir / split / f"r_{i}.png")
            if with_masks:
                _write_mask(out_dir / f"{split}_masks" / f"r_{i}.png", image_size,
                            seed=cam_seed * 1000 + i)
            c2w = np.linalg.inv(w2c)
            c2w_gl = c2w.copy()
            c2w_gl[:3, 1:3] *= -1  # OpenCV -> OpenGL (the loader flips back)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w_gl.tolist()})
        with open(out_dir / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": fov_x, "frames": frames}, f)
    return out_dir


# one points3D.bin record: id, xyz, rgb, error, an empty track
_POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                          ("error", "<f8"), ("track_len", "<u8")])


def generate_colmap_scene(
    out_dir: Path,
    n_images: int = 24,
    image_size: int = 128,
    n_gaussians: int = 300,
    n_points: int = 2000,
    seed: int = 0,
    sh_degree: int = 0,
    with_masks: bool = False,
    layout: str = "box",
    aniso: float = 1.0,
    gt_renderer: str = "oracle",
    device: str | torch.device = "cuda",
) -> Path:
    """Write a COLMAP-format dataset (binary sparse model + images)
    rendered from a GT Gaussian scene; the init point cloud samples the GT
    Gaussian centres with colour noise (standing in for SfM points). The
    point records are written in one block, byte for byte as the JAX
    module's per-point writes."""
    from PIL import Image

    out_dir = Path(out_dir)
    sparse = out_dir / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)

    gt = make_gt_gaussians(n_gaussians, seed, sh_degree=sh_degree, layout=layout, aniso=aniso)
    means, scales, quats, shs, opac = gt
    colors = np.clip(shs[:, 0] * SH_C0 + 0.5, 0.0, 1.0)  # albedo for SfM
    rng = np.random.default_rng(seed + 7)
    fx = fy = image_size * 1.1
    cx = cy = image_size / 2.0

    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, image_size, image_size))
        f.write(struct.pack("<dddd", fx, fy, cx, cy))

    w2cs = ring_cameras(n_images, seed=3)
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i, w2c in enumerate(w2cs):
            q = _rotmat_to_quat(w2c[:3, :3])
            t = w2c[:3, 3]
            f.write(struct.pack("<idddddddi", i + 1, *q, *t, 1))
            f.write(f"im_{i:04d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
            img = render_gt(gt, w2c, image_size, image_size, fx, False, method=gt_renderer,
                            device=device)
            Image.fromarray(img).save(out_dir / "images" / f"im_{i:04d}.png")
            if with_masks:
                (out_dir / "masks").mkdir(exist_ok=True)
                _write_mask(out_dir / "masks" / f"im_{i:04d}.png", image_size, seed=9000 + i)

    # init point cloud: GT centres + jitter (SfM-like)
    idx = rng.integers(0, n_gaussians, size=n_points)
    pts = means[idx] + rng.normal(scale=0.03, size=(n_points, 3))
    cols = np.clip(colors[idx] * 255 + rng.normal(scale=20, size=(n_points, 3)), 0, 255).astype(np.uint8)
    records = np.zeros(n_points, _POINT_RECORD)
    records["id"] = np.arange(n_points)
    records["xyz"] = pts.astype(np.float64)
    records["rgb"] = cols
    records["error"] = 0.1
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_points))
        f.write(records.tobytes())
    return out_dir


def _rotmat_to_quat(R: np.ndarray) -> Tuple[float, float, float, float]:
    """Rotation matrix -> wxyz quaternion (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return float(w), float(x), float(y), float(z)
