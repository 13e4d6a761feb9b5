"""Training CLI: train a scene on the card, then evaluate every checkpoint.

    python -m easy_gaussian_splatting_torch.train -c CONFIG -d DATA [-o OUTPUT]
        [--view_online] [--resume CHECKPOINT] [--profile STEPS] [--device cuda]

The flags of the repository's ``train.py``, plus ``--device``. It creates
``<output>/<data stem>/<timestamp>/``, writes the resolved ``config.yaml``
there, trains with ``train()`` (checkpoints, TensorBoard, ``cameras.json``
and, with ``--view_online``, the training viewer), then runs this package's
``eval`` on each saved iteration. ``--profile N`` records a profiler trace
of N steps (``cfg.profile_steps``).

Several ranks (a config with ``mesh_shape``): each rank runs this command
and joins the world first, before anything touches the device
(``parallel.maybe_initialize_from_env``: ``torchrun`` with
``EGS_TORCH_DISTRIBUTED=1``, or ``EGS_TORCH_COORDINATOR``,
``EGS_TORCH_NUM_PROCESSES`` and ``EGS_TORCH_PROCESS_ID`` per rank). Every
rank trains in rank 0's run directory; rank 0 alone writes it and
evaluates.
"""

from __future__ import annotations

import argparse
import logging
from datetime import datetime
from pathlib import Path

from . import resolve_device
from .training.config import Config, dump_config, load_config

logger = logging.getLogger(__name__)


def parse_cfg(args) -> Config:
    if not Path(args.data).exists():
        raise FileNotFoundError(f"data does not exist: {args.data}")
    cfg = load_config(args.config, data=args.data, view_online=args.view_online)
    project_name = Path(cfg.data).stem
    stamp = datetime.now().strftime(r"%m-%d_%H-%M-%S")
    cfg.output = str(Path(args.output) / project_name / stamp)
    return cfg


def main(argv=None) -> Path:
    """Train and evaluate; returns the run directory."""
    import torch.distributed as dist

    from .eval import eval as run_eval
    from .parallel import maybe_initialize_from_env
    from .training.trainer import train
    from .utils.logging import set_global_state

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", "-c", type=str, required=True)
    parser.add_argument("--data", "-d", type=str, required=True)
    parser.add_argument("--output", "-o", type=str, default="output")
    parser.add_argument("--view_online", action="store_true")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint (.npz with optimizer state) to resume from")
    parser.add_argument("--profile", type=int, default=0,
                        help="trace this many training steps with torch.profiler")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    # several ranks: join the world before anything touches the device (a
    # no-op unless the EGS_TORCH_* variables ask for it)
    maybe_initialize_from_env(args.device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    device = resolve_device(args.device)

    cfg = parse_cfg(args)
    if dist.is_initialized():  # rank 0's run directory (its clock named it)
        out = [cfg.output]
        dist.broadcast_object_list(out, src=0)
        cfg.output = out[0]
    cfg.profile_steps = args.profile
    set_global_state(cfg.random_seed, cfg.device)

    if cfg.total_iterations not in cfg.save_model_iterations:
        logger.warning("total_iterations is not in save_model_iterations, appending")
        cfg.save_model_iterations.append(cfg.total_iterations)

    if rank0:
        logger.info(f"output dir: {cfg.output}")
        Path(cfg.output).mkdir(parents=True)
        dump_config(cfg, Path(cfg.output) / "config.yaml")
        logger.info("----------------------- train -----------------------")
    train(cfg, resume_from=args.resume, device=device)
    if not rank0:
        return Path(cfg.output)
    logger.info("training finished")
    logger.info("--------------------- evaluation ---------------------")
    for iteration in cfg.save_model_iterations:
        run_eval(cfg.output, iteration, device=device)
    return Path(cfg.output)


if __name__ == "__main__":
    main()
