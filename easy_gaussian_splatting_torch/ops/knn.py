"""k-nearest-neighbor distances for Gaussian scale initialization;
counterpart of ``easy_gaussian_splatting_tpu/ops/knn.py`` (its host
KD-tree path: init-time k-NN is a one-shot O(N log N) problem)."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def knn_dists(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Distances [N, k] to the k nearest neighbors (self excluded)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if n <= k:
        raise ValueError(f"need more than k={k} points, got {n}")
    d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
    return np.asarray(d[:, 1:], np.float32)  # drop self (distance 0)
