"""The scene and the host-side data pipeline; counterpart of
``easy_gaussian_splatting_tpu/scene/scene.py``.

``Scene`` dispatches to a loader by ``data_format``, tiles the train
indexes so that one pass over them is exactly ``total_iterations`` steps,
exports ``cameras.json`` for the viewer and decodes each frame when it is
asked for. ``get_data(split, i)`` returns the frame dict of ``types.py``
(numpy ``K`` [3, 3], ``w2c`` [4, 4], ``image`` [H, W, 3] and ``mask``
[H, W] f32, ints ``height`` and ``width``). ``prefetch_frames`` decodes
frames ahead of the training loop on worker threads; any object with
``nbr_data`` and ``get_data`` serves as its scene.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import random
from pathlib import Path
from typing import Any, Dict, Iterator, List, Literal, Optional, Sequence

from .blender import load_blender_data
from .colmap import load_colmap_data

logger = logging.getLogger(__name__)


class Scene:
    def __init__(
        self,
        data_path: str,
        data_format: Literal["colmap", "blender"],
        output_path: Optional[str],
        total_iterations: int,
        eval: bool,
        eval_split_ratio: float,
        eval_in_val: bool,
        eval_in_test: bool,
        use_masks: bool,
        mask_expand_pixels: int,
        white_background: bool,
        blender_init_points: int = 100000,
    ):
        if data_format == "colmap":
            loaded = load_colmap_data(
                data_path, use_masks, mask_expand_pixels, eval, eval_split_ratio,
                white_background,
            )
        elif data_format == "blender":
            loaded = load_blender_data(
                data_path, use_masks, mask_expand_pixels, eval, eval_in_val, eval_in_test,
                white_background, init_points=blender_init_points,
            )
        else:
            raise ValueError(f"invalid data_format: {data_format}")
        self.frames, self.pc, self.train_indexes, self.eval_indexes = loaded

        if total_iterations < len(self.train_indexes):
            raise ValueError("the number of iterations is less than the number of training images")
        reps = total_iterations // len(self.train_indexes) + 1
        self.train_indexes = (self.train_indexes * reps)[:total_iterations]

        if output_path is not None:
            self._export_cameras_json(Path(output_path) / "cameras.json")

    @classmethod
    def from_config(cls, cfg, output_path: Optional[str] = None) -> "Scene":
        """The scene ``train()`` builds from a config's data keys."""
        return cls(
            cfg.data, cfg.data_format, output_path, cfg.total_iterations, cfg.eval,
            cfg.eval_split_ratio, cfg.eval_in_val, cfg.eval_in_test, cfg.use_masks,
            cfg.mask_expand_pixels, cfg.white_background,
            blender_init_points=cfg.blender_init_points,
        )

    def nbr_data(self, split: Literal["train", "eval"]) -> int:
        return len(self.train_indexes if split == "train" else self.eval_indexes)

    def get_data(self, split: Literal["train", "eval"], index: int) -> Dict[str, Any]:
        if split == "train":
            frame = self.frames[self.train_indexes[index]]
        elif split == "eval":
            frame = self.frames[self.eval_indexes[index]]
        else:
            raise ValueError(f"invalid split: {split}")
        return frame.load()

    def _export_cameras_json(self, save_path: Path):
        save_path.parent.mkdir(parents=True, exist_ok=True)
        with open(save_path, "w") as f:
            json.dump([frame.to_json(i) for i, frame in enumerate(self.frames)], f)


def prefetch_frames(
    scene,
    split: str,
    order: Optional[Sequence[int]] = None,
    shuffle: bool = False,
    num_workers: int = 3,
    prefetch_depth: int = 4,
) -> Iterator[Dict[str, Any]]:
    """Yield decoded frame dicts in ``order`` (default: dataset order),
    decoding up to ``prefetch_depth`` frames ahead on worker threads. The
    shuffle draws from Python's ``random``, as the JAX package's does."""
    n = scene.nbr_data(split)
    if order is None:
        order = list(range(n))
    if shuffle:
        order = list(order)
        random.shuffle(order)
    if num_workers <= 0:
        for idx in order:
            yield scene.get_data(split, idx)
        return

    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        pending: List[concurrent.futures.Future] = []
        it = iter(order)
        for _ in range(prefetch_depth):
            idx = next(it, None)
            if idx is None:
                break
            pending.append(pool.submit(scene.get_data, split, idx))
        while pending:
            fut = pending.pop(0)
            idx = next(it, None)
            if idx is not None:
                pending.append(pool.submit(scene.get_data, split, idx))
            yield fut.result()
