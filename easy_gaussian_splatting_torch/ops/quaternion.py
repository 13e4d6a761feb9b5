"""Quaternion utilities (wxyz convention); counterpart of
``easy_gaussian_splatting_tpu/ops/quaternion.py``."""

from __future__ import annotations

import torch

from .clip import maximum


def normalized_quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Convert already-normalized quaternions (wxyz, [..., 4]) to rotation
    matrices [..., 3, 3]."""
    if quat.shape[-1] != 4:
        raise ValueError(f"last dimension must be 4, got {quat.shape[-1]}")
    w, x, y, z = torch.unbind(quat, dim=-1)
    mat = torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z),
            2.0 * (x * y - w * z),
            2.0 * (x * z + w * y),
            2.0 * (x * y + w * z),
            1.0 - 2.0 * (x * x + z * z),
            2.0 * (y * z - w * x),
            2.0 * (x * z - w * y),
            2.0 * (y * z + w * x),
            1.0 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return mat.reshape(quat.shape[:-1] + (3, 3))


def quat_to_rotmat(quat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions (wxyz) then convert to rotation matrices."""
    norm = torch.linalg.norm(quat, dim=-1, keepdim=True)
    return normalized_quat_to_rotmat(quat / maximum(norm, eps))
