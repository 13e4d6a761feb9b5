"""Plain reference of the densify phase: each view's screen statistics,
their accumulation, the refine event (clone, split and prune) and the
opacity reset, as Kerbl et al. 2023 (arXiv 2308.04079, section 5.2) adapt
the Gaussians' density, in the form the port trains.

A train step is ``train.py``'s (the image, the loss, its gradient and
Adam, float64 in ``hi``, compositing in float32 over the tile lists of
``program32.py``); here its compositing gradient also sums, for each
Gaussian, the absolute value of each pixel's gradient with respect to the
Gaussian's screen mean, x and y apart (its "absolute screen gradient"), and
reads the Gaussian's screen radius from ``render.splats``.

Departures from the published method, each the port's recipe:

- the densify test is on the mean of each Gaussian's absolute screen
  gradient over the views that saw it (``|sum_px |dL/dx|, sum_px |dL/dy||``
  times ``max(H, W)``), the absolute gradient of AbsGS (Ye et al. 2024),
  not the norm of the summed view-space gradient;
- a Gaussian whose largest scale is at or above ``densify_scale_thresh``
  (an absolute length, not a share of the scene's extent) splits into
  ``num_splits`` children and is removed; a smaller one is cloned in place
  (the copy is not moved along its gradient);
- every event prunes Gaussians below ``min_opacity``, those whose largest
  screen radius since the last event passed ``prune_radii_ratio_thresh`` of
  ``max(H, W)`` (from the first event on, not only after the first reset)
  and those larger than ``prune_scale_thresh``; a new Gaussian is pruned at
  once by the opacity and scale tests;
- the population lives in fixed-capacity slots: the new Gaussians fill the
  free slots (the dead ones and those this event prunes) in index order,
  clones first, then each split's children by copy; those past the last
  free slot are dropped; the Adam moments of every slot but the surviving
  Gaussians are zeroed and the step counts kept;
- the opacity reset sets each opacity to ``min(opacity / 2, 2 *
  min_opacity)`` (clamped to [1e-6, 1 - 1e-6]) and zeroes that group's
  moments, where the paper resets to 0.01.

Everything runs in the dtype it is given (float64 for the reference,
float32 for the control), on the device of its inputs. Imports nothing of
the port.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from . import render as R
from . import train as T
from .program32 import binning32

LEAVES = T.LEAVES
STATS = ("grad", "count", "max_radii")
COUNTS = ("split", "clone", "prune_low_opacity", "prune_large_radii", "prune_large_scale")


def composite_backward(s: R.Splats, tiles: R.Tiles, width: int, height: int,
                       g_rgb: torch.Tensor, g_t: torch.Tensor, acc_dtype=torch.float64,
                       tf32: bool = False):
    """``render.composite_backward``, and each Gaussian's absolute screen
    gradient: the sums over pixels of ``|dL/d mean_x|`` and ``|dL/d mean_y|``
    of each pixel's term. Returns dL/d (means2d [N, 2], conics [N, 3],
    colors [N, 3], opacities [N]) and the absolute sums [N, 2]."""
    n = s.means2d.shape[0]
    dev = s.means2d.device
    v_m = torch.zeros((n, 2), dtype=acc_dtype, device=dev)
    v_abs = torch.zeros((n, 2), dtype=acc_dtype, device=dev)
    v_con = torch.zeros((n, 3), dtype=acc_dtype, device=dev)
    v_col = torch.zeros((n, 3), dtype=acc_dtype, device=dev)
    v_op = torch.zeros(n, dtype=acc_dtype, device=dev)
    g_rgb = g_rgb.reshape(-1, 3).to(torch.float32)
    g_t = g_t.reshape(-1).to(torch.float32)
    for ids, longest in R._batches(tiles, R.BACKWARD_BATCH_PAIRS):
        bt = R._batch(s, tiles, ids, longest, width, height)
        gi = torch.where(bt.real[..., None], g_rgb[bt.pix], torch.zeros(()).to(g_rgb))
        gt = torch.where(bt.real, g_t[bt.pix], torch.zeros(()).to(g_t))
        col = s.colors[bt.idx]
        w = torch.where(bt.comp, bt.alpha * bt.excl, torch.zeros_like(bt.alpha))
        dotc = R.matmul(gi, col.transpose(1, 2), tf32)  # [B, P, L]
        dw = dotc * w
        suffix = torch.flip(torch.cumsum(torch.flip(dw, [-1]), dim=-1), [-1]) - dw
        t_fin = bt.om.prod(dim=-1, keepdim=True)
        s_g = suffix + gt[..., None] * t_fin
        v_alpha = torch.where(bt.comp, dotc * bt.excl - s_g / bt.om, torch.zeros_like(dw))
        op = s.opacities[bt.idx][:, None, :]
        v_sigma = -op * bt.g * v_alpha
        con = s.conics[bt.idx]
        a, b, c = (con[..., k][:, None, :] for k in range(3))
        dx, dy = bt.dx, bt.dy
        gx, gy = v_sigma * (a * dx + b * dy), v_sigma * (b * dx + c * dy)
        rows = bt.idx[bt.in_range]
        sel = bt.in_range

        def add(dst, val):
            dst.index_add_(0, rows, val[sel].to(acc_dtype))

        add(v_m, torch.stack([gx.sum(1), gy.sum(1)], -1))
        add(v_abs, torch.stack([gx.abs().sum(1), gy.abs().sum(1)], -1))
        add(v_con, torch.stack([(0.5 * v_sigma * dx * dx).sum(1), (v_sigma * dx * dy).sum(1),
                                (0.5 * v_sigma * dy * dy).sum(1)], -1))
        add(v_col, R.matmul(w.transpose(1, 2), gi, tf32))
        add(v_op, (bt.g * v_alpha).sum(1))
        del bt, w, dotc, dw, suffix, s_g, v_alpha, v_sigma, gx, gy
    return v_m, v_con, v_col, v_op, v_abs


def step(params: Dict[str, torch.Tensor], w2c, K, target: torch.Tensor, width: int,
         height: int, background: torch.Tensor, lambda_ssim: float, tile_size: int,
         max_tiles: int, tf32: bool = False, loss_rows: int | None = None):
    """``train.step`` with the view's statistics: (loss, {leaf: gradient},
    absolute screen gradient [N, 2], screen radius [N], 0 where culled)."""
    hi = params["means"].dtype
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    s = R.splats(leaves, w2c, K, width, height, tf32=tf32)
    tiles = R.bin_tiles(binning32(params, w2c, K, width, height), width, height, tile_size,
                        max_tiles)
    s32 = R.to32(s)
    rgb, t_fin, _ = R.composite(s32, tiles, width, height, tf32)
    rgb = rgb.to(hi).requires_grad_(True)
    t_fin = t_fin.to(hi).requires_grad_(True)
    image = R.clip01(rgb + t_fin[..., None] * background.to(hi))
    total = T.loss(image, target.to(hi), lambda_ssim, tf32, loss_rows)
    g_rgb, g_t = torch.autograd.grad(total, [rgb, t_fin])
    *v, v_abs = composite_backward(s32, tiles, width, height, g_rgb, g_t, hi, tf32)
    torch.autograd.backward([s.means2d, s.conics, s.colors, s.opacities], [x.to(hi) for x in v])
    grads = {k: leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k])
             for k in LEAVES}
    return float(total.detach()), grads, v_abs.to(hi), s.radii.detach().to(hi)


def zero_stats(n: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(n, dtype=dtype, device=device) for k in STATS}


def update_statistics(stats: Dict[str, torch.Tensor], radii: torch.Tensor,
                      absgrad: torch.Tensor, height: int, width: int) -> Dict[str, torch.Tensor]:
    """One view added to the statistics of the Gaussians it sees (radius >
    0): the norm of the absolute screen gradient times ``max(H, W)`` summed,
    the views counted, the largest radius over ``max(H, W)`` kept."""
    hw = float(max(height, width))
    seen = radii > 0
    grad = torch.linalg.norm(absgrad, dim=-1) * hw
    return {
        "grad": stats["grad"] + torch.where(seen, grad, torch.zeros_like(grad)),
        "count": stats["count"] + seen.to(stats["count"].dtype),
        "max_radii": torch.where(seen, torch.maximum(stats["max_radii"], radii / hw),
                                 stats["max_radii"]),
    }


def rotation(q: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] rotations of the quaternions ``q`` (wxyz), normalised."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def densify_and_prune(params: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
                      nu: Dict[str, torch.Tensor], alive: torch.Tensor,
                      stats: Dict[str, torch.Tensor], noise: torch.Tensor, recipe: dict):
    """One refine event over the capacity's slots (``alive`` [C] bool, the
    statistics [C], the split noise [C, 3] drawn for each destination
    slot). Returns the new parameters, moments and alive mask, the event's
    counts (``COUNTS``, ``nbr_gaussians``) and whether it needed more slots
    than were free."""
    ns = recipe["num_splits"]
    scales = torch.exp(params["log_scales"])
    max_scale = scales.amax(-1)
    opac = torch.sigmoid(params["logit_opacities"])
    avg = torch.nan_to_num(stats["grad"] / (stats["count"] + 1e-8), nan=0.0)
    high = (avg >= recipe["densify_grad_thresh"]) & alive
    big = max_scale >= recipe["densify_scale_thresh"]
    split, clone = big & high, ~big & high
    low = opac < recipe["min_opacity"]
    large_r = stats["max_radii"] > recipe["prune_radii_ratio_thresh"]
    large_s = max_scale > recipe["prune_scale_thresh"]
    survive = alive & ~((low | large_r | large_s | split) & alive)

    free = torch.nonzero(~survive).squeeze(1)
    clone_src, split_src = torch.nonzero(clone).squeeze(1), torch.nonzero(split).squeeze(1)
    src = torch.cat([clone_src] + [split_src] * ns)
    is_split = torch.cat([torch.zeros_like(clone_src, dtype=torch.bool)]
                         + [torch.ones_like(split_src, dtype=torch.bool)] * ns)
    overflow = src.shape[0] > free.shape[0]
    k = min(src.shape[0], free.shape[0])  # past the last free slot: dropped
    src, is_split, dst = src[:k], is_split[:k], free[:k]

    new = {name: v[src].clone() for name, v in params.items()}
    s_src = scales[src]
    offset = (rotation(new["quats"]) @ (s_src * noise[dst].to(s_src.dtype))[..., None])[..., 0]
    sp = is_split[:, None]
    new["means"] = torch.where(sp, new["means"] + offset, new["means"])
    new["log_scales"] = torch.where(
        sp, torch.log(torch.clamp(s_src / (0.8 * ns), min=1e-12)), new["log_scales"])
    out = {name: v.clone() for name, v in params.items()}
    for name in LEAVES:
        out[name][dst] = new[name]

    new_max = torch.where(is_split, s_src.amax(-1) / (0.8 * ns), s_src.amax(-1))
    new_low = opac[src] < recipe["min_opacity"]
    prune_new = new_low | (new_max > recipe["prune_scale_thresh"])
    alive_out = survive.clone()
    alive_out[dst] = ~prune_new

    def keep(t):
        return t * survive.reshape((-1,) + (1,) * (t.dim() - 1)).to(t.dtype)

    c0 = int((low & alive).sum() + new_low.sum())
    c1 = int(((low | large_r) & alive).sum() + new_low.sum())
    c2 = int(((low | large_r | large_s) & alive).sum() + prune_new.sum())
    info = {"split": int(split_src.shape[0]), "clone": int(clone_src.shape[0]),
            "prune_low_opacity": c0, "prune_large_radii": c1 - c0,
            "prune_large_scale": c2 - c1, "nbr_gaussians": int(alive_out.sum())}
    return (out, {n: keep(v) for n, v in mu.items()}, {n: keep(v) for n, v in nu.items()},
            alive_out, info, overflow)


def reset_opacities(params: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
                    nu: Dict[str, torch.Tensor], min_opacity: float):
    """The opacity reset: new logits and the opacity group's moments zeroed."""
    opac = torch.sigmoid(params["logit_opacities"])
    target = torch.clamp(torch.clamp(opac * 0.5, max=min_opacity * 2.0), 1e-6, 1.0 - 1e-6)
    out = dict(params, logit_opacities=torch.log(target) - torch.log1p(-target))
    name = "logit_opacities"
    return (out, dict(mu, **{name: torch.zeros_like(mu[name])}),
            dict(nu, **{name: torch.zeros_like(nu[name])}))


def follow(params: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
           nu: Dict[str, torch.Tensor], steps: Dict[str, int], views: Sequence,
           lrs: Sequence[Dict[str, float]], capacity: int, max_capacity: int,
           noise: Callable[[int], torch.Tensor], recipe: dict, *, width: int, height: int,
           background: torch.Tensor, tf32: bool = False,
           loss_rows: int | None = None) -> dict:
    """Train steps with statistics from the state (``params`` and moments of
    the alive Gaussians, in ``hi``; zero statistics) over ``views`` ([(w2c,
    K, target)]), the last one the refine event's step (its Adam update
    skipped), then the event over ``capacity`` slots, the Gaussians in the
    first ones, with the split noise ``noise(capacity)``. An event that
    needs more slots than are free is taken again at twice the capacity
    (at most ``max_capacity``), as the port grows its state and retries
    with the same draw. Returns each step's loss, the first step's
    gradients, the statistics the event read, and the state before and
    after the event (``pre``, ``post``: params, moments and alive mask over
    the slots) with the event's counts (``info``)."""
    p, m, v = dict(params), dict(mu), dict(nu)
    n = p["means"].shape[0]
    dt, dev = p["means"].dtype, p["means"].device
    stats = zero_stats(n, dt, dev)
    losses: List[float] = []
    first = None
    last = len(views) - 1
    for k, ((w2c, K, target), lr) in enumerate(zip(views, lrs)):
        total, grads, absgrad, radii = step(
            p, w2c, K, target, width, height, background, recipe["lambda_ssim"],
            recipe["tile_size"], recipe["max_tiles"], tf32, loss_rows)
        losses.append(total)
        first = grads if first is None else first
        with torch.no_grad():
            stats = update_statistics(stats, radii, absgrad, height, width)
            if k < last:
                for name in LEAVES:
                    p[name], m[name], v[name] = T.adam(p[name], m[name], v[name], grads[name],
                                                       steps[name] + k + 1, lr[name])

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        out[:n] = x
        return out

    while True:
        pp = {k: pad(x) for k, x in p.items()}
        pp["quats"][n:, 0] = 1.0
        pm, pv = {k: pad(x) for k, x in m.items()}, {k: pad(x) for k, x in v.items()}
        alive = torch.arange(capacity, device=dev) < n
        with torch.no_grad():
            out, om, ov, alive_out, info, overflow = densify_and_prune(
                pp, pm, pv, alive, {k: pad(x) for k, x in stats.items()},
                noise(capacity).to(dt), recipe)
        if not overflow or capacity >= max_capacity:
            break
        capacity = min(2 * capacity, max_capacity)
    return dict(losses=losses, first=first, stats=stats, info=info,
                pre=(pp, pm, pv, alive), post=(out, om, ov, alive_out))
