"""Config system: flat YAML -> typed dataclass; counterpart of
``easy_gaussian_splatting_tpu/training/config.py`` with the same keys and
defaults, so ``configs/*.yaml`` and any ``config.yaml`` a JAX run dumped
load unchanged (and the JAX package reads what this one dumps)."""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Config:
    # data
    data_format: str = "colmap"  # colmap | blender
    white_background: bool = False
    dataloader_workers: int = 3
    device: str = "cuda"  # informational; entry points take --device
    random_seed: int = 0
    log_every: int = 200

    # eval split
    eval: bool = True
    eval_split_ratio: float = 0.125
    eval_in_val: bool = False
    eval_in_test: bool = False
    eval_every: int = 2000
    eval_render_num: int = 3

    # schedule
    total_iterations: int = 30000
    save_model_iterations: List[int] = dataclasses.field(
        default_factory=lambda: [7000, 30000]
    )

    # SH
    sh_degree: int = 3
    sh_degree_interval: int = 2000

    # masks
    use_masks: bool = False
    mask_expand_pixels: int = 0

    # learning rates
    means_lr_init: float = 0.001
    means_lr_final: float = 0.00001
    means_lr_schedule_max_steps: int = 30000
    log_scales_lr: float = 0.01
    quats_lr: float = 0.001
    sh_0_lr: float = 0.0025
    sh_rest_lr: float = 0.000125
    logit_opacities_lr: float = 0.05

    # density control
    refine_start: int = 500
    refine_stop: int = 15000
    refine_every: int = 200
    reset_opacities_every: int = 2000
    min_opacity: float = 0.005
    densify_grad_thresh: float = 0.0005
    densify_scale_thresh: float = 0.5
    num_splits: int = 2
    prune_radii_ratio_thresh: float = 0.15
    prune_scale_thresh: float = 1.0

    # loss
    lambda_ssim: float = 0.2
    use_scale_regularization: bool = False
    max_scale_ratio: float = 10.0
    lambda_scale: float = 0.1

    # CLI-injected
    data: str = ""
    output: Optional[str] = None
    view_online: bool = False

    # renderer and binning (same meaning as in the JAX package)
    renderer: str = "tiled"  # tiled | ref (oracle; small scenes only)
    raster_chunk: int = 256  # gaussians per compositing chunk (ref renderer)
    tile_size: int = 32  # pixel tile edge for the tiled renderer (<= 32)
    isect_mult: float = 3.0  # intersection capacity / gaussian capacity
    max_tiles: int = 4  # duplication budget: max_tiles^2 tiles/gaussian
    ov_frac: float = 0.125  # overflow-population capacity / capacity
    max_capacity: int = 4_194_304
    shrink_capacity: bool = True
    initial_capacity: int = 0
    save_optimizer_state: bool = False
    mesh_shape: str = ""
    stripe_partition: str = "adaptive"
    stripe_interleave: int = 1
    blender_init_points: int = 100000
    profile_steps: int = 0
    data_device_cache: bool = True
    data_device_cache_mb: int = 6144
    small_budget: int = 9  # population-A cells per gaussian
    isect_hbm_budget_mb: int = 6144  # device-memory budget of the isect buffers

    def validate(self) -> None:
        if self.data_format not in ("colmap", "blender"):
            raise ValueError(f"invalid data_format: {self.data_format}")
        if self.renderer not in ("tiled", "ref"):
            raise ValueError(f"invalid renderer: {self.renderer}")
        if self.sh_degree < 0 or self.sh_degree > 3:
            raise ValueError("sh_degree must be in [0, 3]")
        if self.num_splits < 1:
            raise ValueError("num_splits must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def config_from_dict(d: Dict[str, Any]) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = {k: v for k, v in d.items() if k not in known}
    if unknown:
        logger.warning(f"ignoring unknown config keys: {sorted(unknown)}")
    cfg = Config(**{k: v for k, v in d.items() if k in known})
    cfg.validate()
    return cfg


def load_config(path: str | Path, **overrides: Any) -> Config:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"config does not exist: {path}")
    with open(path, "r") as f:
        d = yaml.safe_load(f) or {}
    d.update(overrides)
    return config_from_dict(d)


def dump_config(cfg: Config, path: str | Path) -> None:
    with open(path, "w") as f:
        yaml.dump(cfg.to_dict(), f, sort_keys=False)
