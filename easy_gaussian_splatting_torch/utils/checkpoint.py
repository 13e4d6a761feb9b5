"""Checkpoint IO; counterpart of
``easy_gaussian_splatting_tpu/utils/checkpoint.py`` with the same ``.npz``
layout (``params/<name>``, ``alive``, optionally ``adam/mu/<name>`` and
``adam/nu/<name>``, and a ``__meta__`` JSON header of format
``easy_gaussian_splatting_tpu/v1`` whose ``adam_steps`` holds the
per-group step counts), so a checkpoint written by either package, with
or without optimizer state, loads in the other."""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.gaussians import (
    GaussianModelState,
    PARAM_NAMES,
    params_from_numpy,
    zero_stats,
)
from ..models.optimizer import AdamState

logger = logging.getLogger(__name__)

FORMAT = "easy_gaussian_splatting_tpu/v1"


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(
    path: Path,
    state: GaussianModelState,
    active_sh_degree: int,
    step: int,
    adam: Optional[AdamState] = None,
) -> None:
    """Save model arrays (and optionally the optimizer state) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for name in PARAM_NAMES:
        arrays[f"params/{name}"] = _np(getattr(state.params, name))
    arrays["alive"] = _np(state.alive)
    meta: Dict[str, Any] = {
        "format": FORMAT,
        "active_sh_degree": int(active_sh_degree),
        "step": int(step),
        "has_optimizer": adam is not None,
    }
    if adam is not None:
        for name in PARAM_NAMES:
            arrays[f"adam/mu/{name}"] = _np(getattr(adam.mu, name))
            arrays[f"adam/nu/{name}"] = _np(getattr(adam.nu, name))
        meta["adam_steps"] = {k: int(v) for k, v in adam.steps.items()}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    logger.info(f"saved checkpoint to {path}")


def load_checkpoint(
    path: Path, device: str | torch.device = "cuda"
) -> Tuple[GaussianModelState, int, int, Optional[AdamState]]:
    """Load a checkpoint. Returns (state, active_sh_degree, step, adam);
    ``adam`` is None when the checkpoint carries no optimizer state."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: unknown checkpoint format {meta.get('format')!r}")
        params = params_from_numpy({n: z[f"params/{n}"] for n in PARAM_NAMES}, dev)
        alive = torch.as_tensor(z["alive"]).to(dev)
        adam = None
        if meta.get("has_optimizer"):
            adam = AdamState(
                mu=params_from_numpy({n: z[f"adam/mu/{n}"] for n in PARAM_NAMES}, dev),
                nu=params_from_numpy({n: z[f"adam/nu/{n}"] for n in PARAM_NAMES}, dev),
                steps={
                    k: torch.tensor(int(v), dtype=torch.int32, device=dev)
                    for k, v in meta["adam_steps"].items()
                },
            )
    state = GaussianModelState(
        params=params, alive=alive, stats=zero_stats(alive.shape[0], dev)
    )
    return state, meta["active_sh_degree"], meta["step"], adam


def find_checkpoint(run_dir: Path, iterations: Optional[int] = None) -> Path:
    """Pick ``iterations_<N>.npz`` under ``<run_dir>/checkpoints``: the named
    iteration if given, else the max."""
    cpt_dir = Path(run_dir) / "checkpoints"
    if iterations is not None:
        target = cpt_dir / f"iterations_{iterations}.npz"
        if not target.exists():
            raise ValueError(f"cannot find checkpoint for iteration {iterations}")
        return target
    candidates = sorted(cpt_dir.glob("iterations_*.npz"))
    if not candidates:
        raise ValueError(f"no checkpoint found under {cpt_dir}")
    return max(candidates, key=lambda p: int(p.stem.split("_")[1]))
