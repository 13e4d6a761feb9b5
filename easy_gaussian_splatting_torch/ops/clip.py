"""Differentiable clamps with JAX's gradient at a tie.

``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` split the gradient 0.5 /
0.5 between their operands where they are equal; ``torch.clamp`` passes
all of it to the input. Ties are common on the training path (a pixel
no Gaussian covers renders exactly the white background, 1.0; a black
point's colour lands exactly on 0), so every differentiable clamp whose
JAX counterpart is one of those goes through here: ``torch.maximum`` and
``torch.minimum`` against a 0-dim bound split the gradient the same way.
"""

from __future__ import annotations

import torch


def _bound(x: torch.Tensor, v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=x.dtype, device=x.device)


def maximum(x: torch.Tensor, lo) -> torch.Tensor:
    """``jnp.maximum(x, lo)`` for a scalar or tensor bound."""
    return torch.maximum(x, _bound(x, lo))


def minimum(x: torch.Tensor, hi) -> torch.Tensor:
    """``jnp.minimum(x, hi)`` for a scalar or tensor bound."""
    return torch.minimum(x, _bound(x, hi))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    return minimum(maximum(x, lo), hi)
