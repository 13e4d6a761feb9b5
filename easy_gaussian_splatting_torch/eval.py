"""Evaluation CLI: the metrics of a trained run directory on the card.

    python -m easy_gaussian_splatting_torch.eval -p RUN_DIR [-i ITERATIONS] [--device cuda]

The flags of the repository's ``eval.py``, plus ``--device``. The run
directory holds ``config.yaml`` and ``checkpoints/iterations_<N>.npz``, as
written by either package. Its config is read again and the global
generators re-seeded, so the train/eval split is the one training used;
the checkpoint (the largest iteration unless one is named) is compacted to
its alive population; the binning is tuned on the first eval (else train)
frame; then the train split (each frame once) and the eval split are
evaluated, each from a frame cache on the device when it fits.

Unlike the JAX package's eval, which sizes the intersection capacity from
one probe frame and never checks it, a split whose renders exceed the
capacity is evaluated again with the capacity grown to 1.5x the largest
count (within the memory budget), and each such pass is logged.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from . import resolve_device

logger = logging.getLogger(__name__)


class CountingRender:
    """A render function that keeps each frame's intersection count on the
    device (no synchronisation), so a split's overflow is read once, after
    its evaluation. An eager render counts itself; a render captured into a
    CUDA graph does not (nothing runs while the graph is captured), and a
    replay runs no Python, so the ``Evaluator`` hands over the count output
    of each frame its program replays (``record``)."""

    def __init__(self, render_fn):
        self.render_fn = render_fn
        self.counts = []

    def __call__(self, *args, **kwargs):
        out = self.render_fn(*args, **kwargs)
        n = out.num_isects
        if n is not None and not (n.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.counts.append(n)
        return out

    def record(self, n: torch.Tensor) -> None:
        """A replayed frame's count (a copy of its program's output)."""
        self.counts.append(n)


def evaluate_split(cfg, scene, split: str, state, sh_degree: int, background, cache=None
                   ) -> Dict[str, Any]:
    """The ``Evaluator``'s metrics of ``split``, evaluated again with a grown
    intersection capacity while a frame overflows it. ``cfg.isect_mult``
    keeps the grown value. Adds ``max_isects`` (the largest count of the
    final pass), ``isect_cap`` and ``rerenders`` (passes run again) to the
    tiled renderer's metrics."""
    from .evaluation.evaluator import Evaluator
    from .ops.rasterize_tiled import isect_capacity, max_isect_cap
    from .training.trainer import get_render_fn

    rerenders = 0
    while True:
        render = CountingRender(get_render_fn(cfg))
        m = Evaluator(cfg.eval_render_num, render).evaluate(
            scene, split, state, sh_degree, background,
            num_workers=cfg.dataloader_workers, cache=cache,
        )
        if cfg.renderer != "tiled" or not render.counts:
            return m
        counts = torch.stack(render.counts).cpu()
        n, icap = int(counts.max()), isect_capacity(state.capacity, cfg.isect_mult)
        m.update(max_isects=n, isect_cap=icap, rerenders=rerenders)
        if n <= icap:
            return m
        grown = min(n * 1.5 / state.capacity, max_isect_cap(cfg.isect_hbm_budget_mb) / state.capacity)
        if grown <= cfg.isect_mult:
            logger.warning(f"{split} split: {n} intersections > capacity {icap} at the memory "
                           f"budget ({cfg.isect_hbm_budget_mb} MB): frames truncated")
            return m
        logger.warning(
            f"{split} split: {int((counts > icap).sum())} of {len(counts)} renders exceeded "
            f"capacity {icap} (largest {n} intersections): rendering the split again at "
            f"isect_mult {grown:.4f}"
        )
        cfg.isect_mult = grown
        rerenders += 1


def eval(path: str | Path, iterations: Optional[int] = None,
         device: str | torch.device = "cuda") -> Dict[str, Dict[str, Any]]:
    """Evaluate the run directory ``path``; returns each evaluated split's
    metrics (``"train"``, ``"eval"``) and logs the JAX eval's line per
    split."""
    from .models.gaussians import compact_for_inference
    from .scene.device_cache import build_cache
    from .scene.scene import Scene
    from .training.config import load_config
    from .training.trainer import tune_inference_cfg
    from .utils.checkpoint import find_checkpoint, load_checkpoint
    from .utils.logging import set_global_state

    dev = resolve_device(device)
    run_dir = Path(path)
    cfg = load_config(run_dir / "config.yaml")
    set_global_state(cfg.random_seed, cfg.device)
    cfg.output = None
    cfg.eval_render_num = 0

    cpt = find_checkpoint(run_dir, iterations)
    logger.info(f"load checkpoint from {cpt}")
    state, active_sh_degree, _, _ = load_checkpoint(cpt, dev)
    logger.info(f"nbr_gaussians: {state.num_alive()}")
    # forward only: drop the dead capacity slots (same images)
    state = compact_for_inference(state)

    scene = Scene.from_config(cfg)
    # evaluate each train image once
    scene.train_indexes = list(set(scene.train_indexes))

    # the dumped config carries the pre-autotune binning defaults
    split0 = "eval" if scene.nbr_data("eval") > 0 else "train"
    d0 = scene.get_data(split0, 0)
    cfg = tune_inference_cfg(cfg, state, d0["w2c"], d0["K"], d0["height"], d0["width"])

    background = torch.full(
        (3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32, device=dev
    )
    results: Dict[str, Dict[str, Any]] = {}
    for set_name, split in [("train set", "train"), ("eval set", "eval")]:
        if scene.nbr_data(split) == 0:
            logger.info(f"{set_name} is empty, skip evaluation")
            continue
        cache = None
        if cfg.data_device_cache:
            cache = build_cache(scene, split, cfg.data_device_cache_mb, device=dev)
        m = evaluate_split(cfg, scene, split, state, active_sh_degree, background, cache)
        lpips_tag = "lpips" if "lpips" in m else "lpips_proxy"
        logger.info(
            f"evaluation in {set_name:>10s}: psnr={m['psnr']:6.3f}, "
            f"ssim={m['ssim']:6.3f}, {lpips_tag}={m[lpips_tag]:6.3f}, "
            f"fps={m['fps']:6.3f}, "
            f"latency={m.get('latency_ms', 0.0):6.1f}ms, "
            f"device_latency={m.get('latency_device_ms', 0.0):6.1f}ms"
        )
        results[split] = m
    return results


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", "-p", type=str, required=True)
    parser.add_argument("--iterations", "-i", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return eval(args.path, args.iterations, args.device)


if __name__ == "__main__":
    main()
