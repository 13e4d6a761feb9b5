"""Device-resident frame cache: the split uploaded once, each step's frame
indexed on the device; counterpart of
``easy_gaussian_splatting_tpu/scene/device_cache.py``.

Streaming a frame a step costs one host-to-device copy of its image and
mask (7.7 MB at 800x800) on the step's path. A 3DGS dataset holds tens to a
few hundred frames, so the whole split fits on the card: one upload at
start, then ``get(i)`` is one index per field on the device. Frames are
grouped by their decoded (height, width), so each group stacks into one
``[N, H, W, 3]`` tensor per field (a COLMAP scene may mix camera
resolutions). Repeated (index-tiled) frames share one copy. A byte budget
guards device memory: a split that does not fit makes ``build_cache``
return None, and the caller streams instead.
"""

from __future__ import annotations

import concurrent.futures
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


class DeviceFrameCache:
    """Stacked frames of one split of a ``Scene`` on ``device``.

    ``get(index)`` takes a split index (the space of ``Scene.get_data``)
    and returns the same dict, with f32 tensors on the device for
    ``image``, ``mask``, ``w2c`` and ``K``."""

    def __init__(
        self,
        scene,
        split: str,
        budget_mb: int = 6144,
        num_workers: int = 4,
        pad_rows_to: int = 1,
        device: str | torch.device = "cuda",
    ):
        """``pad_rows_to``: pad each frame's height up to a multiple at
        upload (image rows 0, mask rows 1, which the mask-compositing loss
        ignores), as the JAX cache does for a mesh's stripes."""
        self._pad_rows_to = max(1, int(pad_rows_to))
        self._indexes = scene.train_indexes if split == "train" else scene.eval_indexes
        frame_ids = sorted(set(self._indexes))
        # budget check from the declared frame sizes (a decoded image is
        # never larger: the file on disk may only be a downscaled copy)
        est = sum(scene.frames[i].height * scene.frames[i].width * 4 * 4 for i in frame_ids)
        self.available = est <= budget_mb * (1 << 20)
        self.nbytes = 0
        self.num_frames = len(frame_ids)
        if not self.available:
            logger.info(
                f"device frame cache: {split} split needs ~{est / 1e6:.0f} MB > budget "
                f"{budget_mb} MB: streaming host-to-device copies instead"
            )
            return

        # decode every unique frame once (threads: PIL's decode releases the
        # GIL), group by decoded shape, stack, upload once per group
        with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
            decoded = list(pool.map(lambda i: scene.frames[i].load(), frame_ids))
        groups: Dict[Tuple[int, int], List[int]] = {}
        for pos, d in enumerate(decoded):
            groups.setdefault((d["height"], d["width"]), []).append(pos)
        self._groups: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._slot: Dict[int, Tuple[Tuple[int, int], int]] = {}
        for (h, w), positions in groups.items():
            pr = self._pad_rows_to
            hp = -(-h // pr) * pr
            imgs = np.zeros((len(positions), hp, w, 3), np.float32)
            masks = np.ones((len(positions), hp, w), np.float32)  # pad rows masked out
            w2cs = np.empty((len(positions), 4, 4), np.float32)
            ks = np.empty((len(positions), 3, 3), np.float32)
            for slot, pos in enumerate(positions):
                d = decoded[pos]
                imgs[slot, :h] = d["image"]
                masks[slot, :h] = d["mask"]
                w2cs[slot] = d["w2c"]
                ks[slot] = d["K"]
                self._slot[frame_ids[pos]] = ((h, w), slot)
            self._groups[(h, w)] = {
                k: torch.from_numpy(v).to(device)
                for k, v in (("image", imgs), ("mask", masks), ("w2c", w2cs), ("K", ks))
            }
            self.nbytes += imgs.nbytes + masks.nbytes
        logger.info(
            f"device frame cache: {split} split resident on {device} ({len(frame_ids)} frames, "
            f"{self.nbytes / 1e6:.0f} MB, {len(groups)} size group(s))"
        )

    def get(self, index: int) -> Dict[str, Any]:
        (h, w), slot = self._slot[self._indexes[index]]
        g = self._groups[(h, w)]
        return dict(image=g["image"][slot], mask=g["mask"][slot], w2c=g["w2c"][slot],
                    K=g["K"][slot], height=h, width=w)


def build_cache(
    scene, split: str, budget_mb: int, num_workers: int = 4, pad_rows_to: int = 1,
    device: str | torch.device = "cuda",
) -> Optional[DeviceFrameCache]:
    """A cache of ``split`` on ``device``, or None when it does not fit the
    byte budget (the caller streams instead)."""
    cache = DeviceFrameCache(scene, split, budget_mb, num_workers, pad_rows_to=pad_rows_to,
                             device=device)
    return cache if cache.available else None
