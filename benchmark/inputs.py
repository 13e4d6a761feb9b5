"""A cell's inputs, made from ``--seed``: the late-training state (the
Gaussians and their Adam moments), the training views and their target
images, the viewer's orbit, the view order and the learning rate.

The state is drawn on the device with a ``torch.Generator`` in a few large
calls, in float32, the type the program trains in. The recipe of the
Gaussians is ``easy_gaussian_splatting_torch/utils/synthetic.py``'s
``make_gt_gaussians`` (layouts ``box`` and ``unbounded``; scales that
shrink with the cube root of the count, as its spacing rule does) and the
cameras its ``ring_cameras``, rewritten here from commit
cecd31169c04ec6e0b647a102e329261f797bf62 so that the yardstick stays as it
is when the program changes. Targets are smooth procedural images drawn
on the device; the program renders none of them. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

SH_C0 = 0.28209479177387814
LEAF_WIDTHS = {"means": 3, "log_scales": 3, "quats": 4, "sh_0": 3, "sh_rest": 45,
               "logit_opacities": 1}
LEAF_SHAPES = {"means": (3,), "log_scales": (3,), "quats": (4,), "sh_0": (1, 3),
               "sh_rest": (15, 3), "logit_opacities": ()}
SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) & SEED_MASK)


def _split(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, col = {}, 0
    for name, width in LEAF_WIDTHS.items():
        out[name] = flat[:, col:col + width].reshape((flat.shape[0],) + LEAF_SHAPES[name])
        col += width
    return out


def gaussians(scene: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The scene's ``gaussians`` Gaussians (alive rows only), float32 on
    ``device``: means, log-scales, unit quaternions (wxyz), SH degree 3 and
    logit opacities."""
    n = scene["gaussians"]
    gen = generator(seed, 1, device)
    u = torch.rand((n, 11), generator=gen, device=device)
    z = torch.randn((n, 52), generator=gen, device=device)
    rad_scale = torch.ones(n, device=device)
    if scene["layout"] == "unbounded":
        # 70% in [-1.2, 1.2]^3, 30% on shells out to radius 12 whose
        # Gaussians grow with their distance (constant angular size)
        n_core = int(n * 0.7)
        means = (u[:, 0:3] * 2.0 - 1.0) * 1.2
        r = torch.clamp(2.5 / torch.clamp(u[n_core:, 10], min=1e-3) ** 0.6, max=12.0)
        d = z[n_core:, 49:52]
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        means[n_core:] = d * r[:, None]
        rad_scale[n_core:] = r / 2.5
    else:
        means = u[:, 0:3] * 2.0 - 1.0
    f = min(1.0, (300.0 / max(n, 1)) ** (1.0 / 3.0))
    scales = (0.04 + 0.10 * u[:, 3:6]) * f * rad_scale[:, None]
    quats = z[:, 0:4] / torch.linalg.norm(z[:, 0:4], dim=1, keepdim=True)
    base = 0.05 + 0.9 * u[:, 6:9]
    amp = torch.tensor([0.25] * 3 + [0.125] * 5 + [0.0625] * 7, device=device)
    opac = 0.5 + 0.45 * u[:, 9]
    return {
        "means": means.contiguous(),
        "log_scales": torch.log(scales),
        "quats": quats.contiguous(),
        "sh_0": ((base - 0.5) / SH_C0)[:, None, :].contiguous(),
        "sh_rest": (z[:, 4:49].reshape(n, 15, 3) * amp[None, :, None]).contiguous(),
        "logit_opacities": torch.log(opac) - torch.log1p(-opac),
    }


def moments(scene: dict, adam: dict, seed: int, device):
    """Adam's first and second moments of the alive rows, float32: a
    converged second moment of each group's gradient scale (``grad_rms``,
    times U(0.5, 1.5)) and a first moment a hundredth of it, of random sign,
    as late training's gradients, whose signs change from step to step,
    leave them."""
    n = scene["gaussians"]
    gen = generator(seed, 2, device)
    z = torch.randn((n, 59), generator=gen, device=device)
    u = torch.rand((n, 59), generator=gen, device=device)
    scale = torch.cat([torch.full((w,), float(adam["grad_rms"][k]), device=device)
                       for k, w in LEAF_WIDTHS.items()])
    mu = _split((0.01 * scale) * z)
    nu = _split(scale * scale * (0.5 + u))
    return {k: v.contiguous() for k, v in mu.items()}, {k: v.contiguous() for k, v in nu.items()}


def _look_at(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenCV world->camera (z forward, y down) of a camera at ``pos``
    looking at ``target``."""
    z = target - pos
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    return np.linalg.inv(c2w).astype(np.float32)


def intrinsics(fx: float, fy: float, width: int, height: int) -> np.ndarray:
    return np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32)


def train_views(scene: dict, seed: int):
    """The training cameras: [V, 4, 4] world->camera on a ring around the
    origin and the config's intrinsics [3, 3]. Every seed has the same set
    of heights, evenly spread over the config's range, in its own order,
    and its own phase of the ring, so that seeds change the views and not
    the work."""
    cam = scene["camera"]
    rng = np.random.default_rng([seed & SEED_MASK, 3])
    v = scene["views"]
    phase = rng.uniform(0.0, 2.0 * math.pi)
    lo, hi = cam["height"]
    heights = lo + (hi - lo) * (rng.permutation(v) + 0.5) / v
    w2cs = []
    for i in range(v):
        th = phase + 2.0 * math.pi * i / v
        pos = np.array([cam["radius"] * math.sin(th), heights[i], cam["radius"] * math.cos(th)])
        w2cs.append(_look_at(pos, np.zeros(3)))
    return np.stack(w2cs), intrinsics(scene["fx"], scene["fy"], scene["width"], scene["height"])


def targets(scene: dict, seed: int, device) -> torch.Tensor:
    """[V, H, W, 3] float32 targets in [0, 1]: a smooth field from a coarse
    grid, detail from a grid four times finer and a little per-pixel noise,
    each view its own."""
    h, w, v = scene["height"], scene["width"], scene["views"]
    gh = 6
    gw = max(1, round(gh * w / h))
    out = torch.empty((v, h, w, 3), device=device)
    for k in range(v):
        gen = generator(seed, 1000 + k, device)
        coarse = torch.rand((1, 3, gh, gw), generator=gen, device=device)
        fine = torch.rand((1, 3, 4 * gh, 4 * gw), generator=gen, device=device)
        noise = torch.rand((h, w, 3), generator=gen, device=device)
        img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                              align_corners=False)
        img = img + 0.3 * (torch.nn.functional.interpolate(fine, size=(h, w), mode="bilinear",
                                                           align_corners=False) - 0.5)
        out[k] = torch.clamp(img[0].permute(1, 2, 0) + 0.05 * (noise - 0.5), 0.0, 1.0)
    return out


def view_order(views: int, seed: int, steps: int) -> np.ndarray:
    """The view of each step: a new seeded permutation every epoch, as
    ``train()`` walks its shuffled frames."""
    rng = np.random.default_rng([seed & SEED_MASK, 4])
    epochs = -(-steps // views)
    return np.concatenate([rng.permutation(views) for _ in range(epochs)])[:steps]


def means_lr(recipe: dict, step: int) -> float:
    """The means' learning rate at ``step``: a lerp in log space from
    ``means_lr_init`` to ``means_lr_final`` over
    ``means_lr_schedule_max_steps``."""
    t = min(1.0, step / recipe["means_lr_schedule_max_steps"])
    return float(np.exp(np.log(recipe["means_lr_init"]) * (1.0 - t)
                        + np.log(recipe["means_lr_final"]) * t))


def learning_rates(recipe: dict, step: int) -> Dict[str, float]:
    """Each group's learning rate at ``step``."""
    lrs = {k: recipe[f"{k}_lr"] for k in LEAF_WIDTHS if k != "means"}
    lrs["means"] = means_lr(recipe, step)
    return lrs


def orbit(scene: dict, mix: dict, seed: int, frame: int):
    """The viewer's camera of ``frame``: (world->camera [4, 4], K [3, 3]) on
    an orbit around the origin at the training cameras' distance, rising
    and falling, its phase drawn from the seed; the vertical field of view
    of the training cameras at the mix's frame size."""
    rng = np.random.default_rng([seed & SEED_MASK, 5])
    phase = rng.uniform(0.0, 2.0 * math.pi)
    cam = scene["camera"]
    th = phase + 2.0 * math.pi * frame / mix["frames_per_orbit"]
    mid = 0.5 * (cam["height"][0] + cam["height"][1])
    amp = 0.5 * (cam["height"][1] - cam["height"][0])
    hgt = mid + amp * math.sin(2.0 * math.pi * frame / mix["bob_period"])
    pos = np.array([cam["radius"] * math.sin(th), hgt, cam["radius"] * math.cos(th)])
    f = 0.5 * mix["height"] / (0.5 * scene["height"] / scene["fy"])
    return _look_at(pos, np.zeros(3)), intrinsics(f, f, mix["width"], mix["height"])
