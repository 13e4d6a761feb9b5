"""k-nearest-neighbor distances for Gaussian scale initialization;
counterpart of ``easy_gaussian_splatting_tpu/ops/knn.py``: the host KD-tree
when scipy is there (init-time k-NN is a one-shot O(N log N) problem), else
a chunked brute-force k-min on the device of the points
(:func:`knn_dists_device`, the counterpart of ``_knn_dists_device``)."""

from __future__ import annotations

import numpy as np
import torch


def knn_dists_device(points: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """Distances [N, k] to the k nearest neighbors (self excluded), on the
    device of ``points`` [N, 3] f32: chunks of ``chunk`` query rows, each
    a [chunk, N] block of squared distances |q|^2 + |p|^2 - 2 q.p with its
    own index masked out, and k passes of min extraction, as the JAX
    package's ``_knn_dists_device``."""
    n = points.shape[0]
    sq_norms = (points * points).sum(-1)  # [N]
    cols = torch.arange(n, device=points.device)
    out = torch.empty((n, k), dtype=torch.float32, device=points.device)
    for start in range(0, n, chunk):
        q = points[start:start + chunk]  # [c, 3]
        qn = (q * q).sum(-1)
        d2 = qn[:, None] + sq_norms[None, :] - 2.0 * (q @ points.T)  # [c, N]
        rows = torch.arange(start, start + q.shape[0], device=points.device)
        d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
        mins = []
        for _ in range(k):
            m, am = d2.min(dim=1)
            mins.append(m)
            d2 = torch.where(cols[None, :] == am[:, None], torch.inf, d2)
        out[start:start + q.shape[0]] = torch.sqrt(torch.clamp(torch.stack(mins, 1), min=0.0))
    return out


def knn_dists(points: np.ndarray, k: int = 3, chunk: int = 4096,
              device: str | torch.device = "cpu") -> np.ndarray:
    """Distances [N, k] to the k nearest neighbors (self excluded): scipy's
    KD-tree when it imports, else :func:`knn_dists_device` on ``device``
    with ``chunk`` bounded so a [chunk, N] block stays near 2 GB (the JAX
    package's bound)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if n <= k:
        raise ValueError(f"need more than k={k} points, got {n}")
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        cKDTree = None
    if cKDTree is not None:
        d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
        return np.asarray(d[:, 1:], np.float32)  # drop self (distance 0)
    max_chunk = max(64, int(512e6 // max(n, 1)) // 64 * 64)
    chunk = min(chunk, max_chunk, max(8, n))
    pts = torch.as_tensor(points, device=device)
    return knn_dists_device(pts, k, chunk).cpu().numpy()
