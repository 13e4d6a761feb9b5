"""The host-side data pipeline; counterpart of ``prefetch_frames`` in
``easy_gaussian_splatting_tpu/scene/scene.py``.

A scene is any object with the JAX ``Scene``'s interface: ``nbr_data(split)``
and ``get_data(split, i)`` returning the frame dict of
``easy_gaussian_splatting_tpu/scene/types.py`` (numpy ``K`` [3, 3],
``w2c`` [4, 4], ``image`` [H, W, 3] and ``mask`` [H, W] f32, ints
``height`` and ``width``). Frames decode ahead of the training loop on
worker threads.
"""

from __future__ import annotations

import concurrent.futures
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence


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
