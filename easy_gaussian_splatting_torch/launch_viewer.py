"""Offline viewer: serve a trained run directory on the card.

    python -m easy_gaussian_splatting_torch.launch_viewer -p RUN_DIR [-i N] [--port P] [--device cuda]

The flags of the repository's ``launch_viewer.py``, plus ``--device``.
The run directory holds ``config.yaml``, ``cameras.json`` and
``checkpoints/iterations_<N>.npz``, as written by either package.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from . import resolve_device
from .models.gaussians import compact_for_inference
from .training.config import load_config
from .training.trainer import get_render_fn, tune_inference_cfg
from .utils.checkpoint import find_checkpoint, load_checkpoint
from .utils.logging import configure_logging
from .viewer.integration import load_camera_states, make_gs_render_func
from .viewer.server import Viewer


def load_run(path, iterations=None, device="cuda"):
    """Load a run directory for serving: the checkpoint, compacted to its
    alive population, and the config with its binning tuned on the first
    dataset camera. Returns (cfg, state, sh_degree, camera_states)."""
    dev = resolve_device(device)
    path = Path(path)
    cfg = load_config(path / "config.yaml")
    state, sh_degree, _, _ = load_checkpoint(find_checkpoint(path, iterations), dev)
    state = compact_for_inference(state)
    camera_states = load_camera_states(path)
    if camera_states:
        # the dumped config carries pre-autotune binning defaults
        c0 = camera_states[0]
        cfg = tune_inference_cfg(cfg, state, c0.w2c, c0.K, int(c0.height), int(c0.width))
    return cfg, state, sh_degree, camera_states


def build_viewer(path, iterations=None, port=9981, device="cuda", host="localhost") -> Viewer:
    """Load ``path`` (see :func:`load_run`) and start a viewer serving it;
    ``port=0`` binds a free port (``Viewer.port``)."""
    cfg, state, sh_degree, camera_states = load_run(path, iterations, device)
    background = torch.full(
        (3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32,
        device=state.params.means.device,
    )
    base_px = (
        int(camera_states[0].width) * int(camera_states[0].height)
        if camera_states else None
    )
    render_func = make_gs_render_func(
        lambda: state, lambda: sh_degree, background, get_render_fn(cfg),
        cfg=cfg, base_pixels=base_px,
    )
    return Viewer(
        render_func, camera_states, host=host, port=port,
        video_output_dir=Path(path) / "videos",
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", "-p", type=str, required=True)
    parser.add_argument("--iterations", "-i", type=int, default=None)
    parser.add_argument("--port", type=int, default=9981)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    configure_logging()
    viewer = build_viewer(args.path, args.iterations, args.port, args.device)
    print("viewer is running, press Ctrl+C to exit")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()


if __name__ == "__main__":
    main()
