"""easy_gaussian_splatting_torch — the PyTorch / CUDA port of
``easy_gaussian_splatting_tpu``.

The same 3D Gaussian Splatting renderer, written for an NVIDIA Hopper
card: plain tensor code is PyTorch, and every kernel the JAX package wrote
in Pallas for the TPU is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``, built at first use by ``ops/kernels/_build.py``). Module paths
and names mirror the JAX package so each function's counterpart is easy
to find; the JAX package is the reference this one is tested against.

This package never imports ``jax``, ``flax`` or ``easy_gaussian_splatting_tpu``.
"""

__version__ = "0.1.0"

import torch

# The reference runs f32 matmuls at "highest" precision; TF32 keeps only
# ~3 decimal digits, which moves compositing results and eligibility edges.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. Entry points default to the card
    and raise when none is present: the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
