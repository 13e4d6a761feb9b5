"""End-to-end validation on a generated scene, on the card.

    python -m easy_gaussian_splatting_torch.validate_e2e [--iters 2000] [--size 128]
        [--renderer tiled|ref] [--format blender|colmap] [--out DIR] [--device cuda] ...

The flags of the repository's ``scripts/validate_e2e.py``, plus
``--device``. It writes a scene rendered from a ground-truth Gaussian model
(``utils/synthetic.py``; ``--gt-renderer`` picks ``render_gt``'s method),
writes the resolved ``config.yaml`` into ``<out>/run`` as the train CLI
does, trains from scratch through ``train()`` (densify, prune, reset, SH
schedule and all), then re-seeds, rebuilds the scene and evaluates its
eval split. Below ``--min-psnr`` the run fails (exit code 1). The run
directory it leaves is one that ``eval`` and ``launch_viewer`` read.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=2000)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--renderer", default="tiled")
    parser.add_argument("--format", default="blender")
    parser.add_argument("--out", default="")
    parser.add_argument("--init-points", type=int, default=4000)
    parser.add_argument("--gt-gaussians", type=int, default=300,
                        help="ground-truth scene population (hard regime: >=10000)")
    parser.add_argument("--gt-sh-degree", type=int, default=0,
                        help="view dependence: SH degree of the generated scene")
    parser.add_argument("--masks", action="store_true",
                        help="generate per-frame ignore masks (mask-compositing loss)")
    parser.add_argument("--cameras", type=int, default=24)
    parser.add_argument("--layout", default="box", choices=("box", "unbounded"),
                        help="scene layout: box=[-1,1]^3; unbounded=a core and heavy-tailed "
                        "background shells")
    parser.add_argument("--aniso", type=float, default=1.0,
                        help="scale anisotropy: per-axis lognormal stretch ratio")
    parser.add_argument("--gt-renderer", default="oracle", choices=("oracle", "tiled"),
                        help="render_gt's method for the ground-truth frames: oracle "
                        "(independent of the production path) or tiled (far faster at 100k+ "
                        "ground-truth Gaussians)")
    parser.add_argument("--densify-grad-thresh", type=float, default=0.0,
                        help="override cfg.densify_grad_thresh (0 = config default)")
    parser.add_argument("--max-tiles", type=int, default=0,
                        help="override cfg.max_tiles (0 = config default)")
    parser.add_argument("--min-psnr", type=float, default=22.0,
                        help="validation gate (lower for hard scenes or short runs)")
    parser.add_argument("--reuse-data", action="store_true",
                        help="skip generation when the dataset directory already exists")
    parser.add_argument("--resume-from", default="")
    parser.add_argument("--reference-schedule", action="store_true",
                        help="the original 30k-step schedule (eval and SH bumps every "
                        "2000, refine 500-15000 every 200, opacity reset every 2000, "
                        "checkpoints at 7000 and the end) instead of the one compressed "
                        "from --iters")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def _schedule(iters: int, reference: bool) -> Dict[str, Any]:
    if reference:
        return dict(
            eval_every=2000, eval_render_num=1, sh_degree_interval=2000, refine_start=500,
            refine_stop=15000, refine_every=200, reset_opacities_every=2000,
            save_model_iterations=sorted(
                {i for i in (7000, *range(10000, iters + 1, 4000), iters) if i <= iters}
            ),
            save_optimizer_state=True, log_every=200,
        )
    return dict(
        eval_every=max(200, iters // 4), eval_render_num=1,
        sh_degree_interval=max(100, iters // 8), refine_start=100,
        refine_stop=int(iters * 0.6), refine_every=100,
        reset_opacities_every=max(600, iters // 3), save_model_iterations=[iters],
        log_every=100,
    )


def main(argv=None) -> Dict[str, Any]:
    """Generate, train, evaluate; returns the eval split's metrics with
    ``gaussians``, ``train_s``, ``run_dir`` and ``passed`` (the gate)."""
    import torch

    from . import resolve_device
    from .evaluation.evaluator import Evaluator
    from .scene.scene import Scene
    from .training.config import config_from_dict, dump_config
    from .training.trainer import get_render_fn, train
    from .utils.logging import set_global_state
    from .utils.synthetic import generate_blender_scene, generate_colmap_scene

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    workdir = Path(args.out) if args.out else Path(tempfile.mkdtemp())
    data_dir = workdir / "data"
    out_dir = workdir / "run"
    out_dir.mkdir(parents=True, exist_ok=True)

    skip_gen = args.reuse_data and (
        (data_dir / "transforms_train.json").exists() or (data_dir / "sparse").exists()
    )
    print(f"reusing existing {args.format} scene at {data_dir}" if skip_gen
          else f"generating {args.format} scene at {data_dir} ...")
    gen = dict(image_size=args.size, n_gaussians=args.gt_gaussians,
               sh_degree=args.gt_sh_degree, with_masks=args.masks, layout=args.layout,
               aniso=args.aniso, gt_renderer=args.gt_renderer, device=device)
    if args.format == "blender":
        if not skip_gen:
            generate_blender_scene(data_dir, n_train=args.cameras,
                                   n_test=max(2, args.cameras // 4), **gen)
        fmt_keys = dict(data_format="blender", white_background=True, eval_in_test=True,
                        blender_init_points=args.init_points)
    else:
        if not skip_gen:
            generate_colmap_scene(data_dir, n_images=args.cameras, n_points=args.init_points,
                                  **gen)
        fmt_keys = dict(data_format="colmap", white_background=False, eval_split_ratio=0.2)
    if args.masks:
        fmt_keys["use_masks"] = True

    extra = {}
    if args.densify_grad_thresh > 0.0:
        extra["densify_grad_thresh"] = args.densify_grad_thresh
    if args.max_tiles > 0:
        extra["max_tiles"] = args.max_tiles
    cfg = config_from_dict(dict(
        data=str(data_dir), output=str(out_dir), total_iterations=args.iters, eval=True,
        sh_degree=3, renderer=args.renderer, dataloader_workers=2,
        **_schedule(args.iters, args.reference_schedule), **fmt_keys, **extra,
    ))
    set_global_state(cfg.random_seed, cfg.device)
    # the resolved config, as the train CLI writes it, so that eval and
    # launch_viewer read the run directory afterwards
    dump_config(cfg, out_dir / "config.yaml")

    t0 = time.time()
    loop = train(cfg, resume_from=args.resume_from or None, device=device)
    wall = time.time() - t0
    print(f"trained {args.iters} iters in {wall:.1f}s ({args.iters / wall:.2f} it/s)")

    # Re-seed before rebuilding the Scene: the COLMAP ratio split shuffles
    # with the global generator, which training advanced; without the
    # re-seed the rebuilt eval split would hold train frames.
    set_global_state(cfg.random_seed, cfg.device)
    scene = Scene.from_config(cfg)
    evaluator = Evaluator(0, get_render_fn(cfg))
    background = torch.full((3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32,
                            device=device)
    m = evaluator.evaluate(scene, "eval", loop.model, loop.active_sh_degree, background)
    lpips_tag = "lpips" if evaluator.lpips.kind == "vgg" else "lpips_proxy"
    n_alive = loop.model.num_alive()
    print(f"RESULT: psnr={m['psnr']:.2f} ssim={m['ssim']:.4f} {lpips_tag}={m[lpips_tag]:.4f} "
          f"fps={m['fps']:.2f} gaussians={n_alive}")
    passed = m["psnr"] >= args.min_psnr
    print("VALIDATION OK" if passed else f"VALIDATION FAILED: psnr below {args.min_psnr}")
    return dict(m, gaussians=n_alive, train_s=wall, run_dir=out_dir, passed=passed)


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
