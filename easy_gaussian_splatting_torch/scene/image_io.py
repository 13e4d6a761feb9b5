"""Image and mask IO; counterpart of
``easy_gaussian_splatting_tpu/scene/image_io.py``, with PIL as that module
uses it:
- RGB images load as uint8; RGBA images are alpha-composited onto a white
  or black background;
- masks are single-channel, any value >= 1 becomes 1 (1 = object to
  remove), then dilated by ``expand_pixels`` with a (2e x 2e)
  shifted-window OR;
- when the on-disk image is a uniformly downscaled version of the declared
  camera resolution, intrinsics are rescaled by the common factor (an
  aspect mismatch is an error).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def load_image(image_path: Path, white_background: bool) -> np.ndarray:
    """Load an RGB(A) image as uint8 [H, W, 3]; RGBA composited on the
    configured background."""
    image = Image.open(image_path)
    if image.mode == "RGB":
        return np.asarray(image, dtype=np.uint8)
    if image.mode == "RGBA":
        arr = np.asarray(image, dtype=np.float64)
        bg_val = 255.0 if white_background else 0.0
        alpha = arr[..., 3:4] / 255.0
        rgb = arr[..., :3] * alpha + bg_val * (1.0 - alpha)
        return rgb.astype(np.uint8)
    raise ValueError(f"only 'RGB' or 'RGBA' images are supported, got '{image.mode}'")


def expand_mask(mask: np.ndarray, expand_pixels: int) -> np.ndarray:
    """Dilate a binary mask with a (2e x 2e) shifted-window OR:
    out[y, x] = 1 if any mask value in the window
    [y-e+1 .. y+e] x [x-e+1 .. x+e] is set (the window is asymmetric by
    half a pixel because its size is even)."""
    if expand_pixels == 0:
        return mask
    from .. import native as _native

    native_out = _native.dilate_mask(mask, expand_pixels)
    if native_out is not None:
        return native_out
    e = expand_pixels
    h, w = mask.shape
    padded = np.zeros((h + 2 * e, w + 2 * e), dtype=bool)
    padded[e : e + h, e : e + w] = mask > 0
    out = np.zeros((h, w), dtype=bool)
    for dy in range(1, 2 * e + 1):
        for dx in range(1, 2 * e + 1):
            out |= padded[dy : dy + h, dx : dx + w]
    return out.astype(np.uint8)


def load_mask(mask_path: Path, expand_pixels: int) -> np.ndarray:
    """Load a mask: any pixel >= 1 -> 1, then dilate. Returns uint8 [H, W]."""
    mask = np.asarray(Image.open(mask_path), dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"only 2D masks are supported, got {mask.ndim}D")
    mask = (mask >= 1).astype(np.uint8)
    return expand_mask(mask, expand_pixels)


def get_downscale_factor(orig_h: int, orig_w: int, target_h: int, target_w: int) -> float:
    """Uniform downscale factor between the declared camera resolution and
    the on-disk image; raises if the aspect ratio changed."""
    if orig_h == target_h and orig_w == target_w:
        return 1.0
    fh = target_h / orig_h
    fw = target_w / orig_w
    if abs(fh - fw) > 1e-3:
        raise ValueError(f"inconsistent downscale factors: height {fh} vs width {fw}")
    return (fh + fw) / 2.0
