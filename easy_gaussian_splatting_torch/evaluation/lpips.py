"""LPIPS (VGG16 backbone); counterpart of
``easy_gaussian_splatting_tpu/evaluation/lpips.py``.

ImageNet-normalised inputs through VGG16's features, channel-unit-
normalised activations at the five relu taps, squared differences weighted
by linear heads, averaged over space and summed over taps. The
convolutions are ``F.conv2d`` in f32 (the package turns TF32 off for
cuDNN, so the card computes what the CPU does, to rounding).

Weights:
- ``EGS_TORCH_LPIPS_WEIGHTS=<path.npz>`` supplies real pretrained VGG16
  convolutions and LPIPS heads, in the file format of the JAX package's
  ``EGS_TPU_LPIPS_WEIGHTS`` (``scripts/export_lpips_weights.py`` writes
  it). With it the metric is reported as ``lpips``.
- Without it, a deterministic proxy: He-initialised VGG16 convolutions
  from a fixed numpy seed and uniform (1/C) heads, the JAX package's
  proxy to the bit. Its values track quality within this repository but
  are not comparable to published LPIPS numbers; it is reported as
  ``lpips_proxy``.
- A set but missing weights path is an error, never a silent fallback.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

WEIGHTS_ENV = "EGS_TORCH_LPIPS_WEIGHTS"
# VGG16 feature plan (conv channels, "M" a 2x2 max pool); LPIPS taps the
# activations after the last relu of each block
VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
LPIPS_TAPS = (1, 3, 6, 9, 12)  # conv indexes after which features are tapped
TAP_CHANNELS = (64, 128, 256, 512, 512)
# ImageNet normalisation of LPIPS with normalize=True ([0, 1] inputs)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

PROXY_SEED = 0


def proxy_weights(seed: int = PROXY_SEED) -> Dict[str, np.ndarray]:
    """Deterministic He-initialised VGG16 convolutions + uniform heads."""
    rng = np.random.default_rng(seed)
    arrays: Dict[str, np.ndarray] = {}
    in_ch = 3
    conv_i = 0
    for item in VGG16_PLAN:
        if item == "M":
            continue
        fan_in = in_ch * 9
        arrays[f"conv{conv_i}_w"] = (
            rng.normal(size=(item, in_ch, 3, 3)) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        arrays[f"conv{conv_i}_b"] = np.zeros((item,), np.float32)
        in_ch = item
        conv_i += 1
    for i, ch in enumerate(TAP_CHANNELS):
        arrays[f"lin{i}_w"] = np.full((ch,), 1.0 / ch, np.float32)
    return arrays


class LPIPS:
    """``kind`` is "vgg" (pretrained weights) or "proxy" (seeded weights).
    ``device_fn(a, b)`` takes two [H, W, 3] images in [0, 1] (tensors on
    any device) and returns the distance as a 0-d tensor on that device;
    the weights and the input normalisation go to each device once, so a
    call after the first copies nothing from the host (the evaluator
    captures it in a CUDA graph per image size)."""

    def __init__(self, kind: str, weights: Dict[str, np.ndarray]):
        self.kind = kind
        self._weights = weights
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _wts(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._on:
            wts = dict(self._weights, shift=np.asarray(_SHIFT, np.float32).reshape(1, 3, 1, 1),
                       scale=np.asarray(_SCALE, np.float32).reshape(1, 3, 1, 1))
            self._on[device] = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
                                for k, v in wts.items()}
        return self._on[device]

    def _features(self, x: torch.Tensor, wts):
        feats = []
        conv_i = 0
        for item in VGG16_PLAN:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(F.conv2d(x, wts[f"conv{conv_i}_w"], wts[f"conv{conv_i}_b"], padding=1))
                if conv_i in LPIPS_TAPS:
                    feats.append(x)
                conv_i += 1
        return feats

    @torch.no_grad()
    def device_fn(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        wts = self._wts(a.device)

        def prep(img):
            x = torch.movedim(img.to(torch.float32), -1, 0)[None] * 2.0 - 1.0
            return (x - wts["shift"]) / wts["scale"]

        total = torch.zeros((), device=a.device)
        for i, (xa, xb) in enumerate(zip(self._features(prep(a), wts), self._features(prep(b), wts))):
            na = xa / torch.clamp(torch.linalg.norm(xa, dim=1, keepdim=True), min=1e-10)
            nb = xb / torch.clamp(torch.linalg.norm(xb, dim=1, keepdim=True), min=1e-10)
            w = wts[f"lin{i}_w"].view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((na - nb) ** 2 * w, dim=1))
        return total

    def __call__(self, a: np.ndarray, b: np.ndarray) -> float:
        return float(self.device_fn(torch.as_tensor(np.asarray(a, np.float32)),
                                    torch.as_tensor(np.asarray(b, np.float32))))


@functools.lru_cache(maxsize=1)
def get_lpips() -> LPIPS:
    path = os.environ.get(WEIGHTS_ENV, "")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{WEIGHTS_ENV}={path} does not exist: refusing to fall back (unset it to use "
                "the deterministic proxy metric, or export real weights with "
                "scripts/export_lpips_weights.py)"
            )
        weights = dict(np.load(path))
        logger.info(f"LPIPS-VGG enabled with pretrained weights from {path}")
        return LPIPS("vgg", weights)
    logger.warning(
        f"LPIPS: no pretrained weights ({WEIGHTS_ENV} unset): using the deterministic proxy "
        f"metric (seeded random VGG16, seed {PROXY_SEED}). Its values are reproducible and "
        "track perceptual quality within this repository, but are not comparable to "
        "published LPIPS-VGG numbers."
    )
    return LPIPS("proxy", proxy_weights())
