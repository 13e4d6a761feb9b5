"""The view-dependent colour of every Gaussian slot: the CUDA kernels
``csrc/sh_color.cu`` (one forward launch, one backward launch, one
``torch.autograd.Function``) and their plain PyTorch version.

The colour is SH of degree 0..3 (``ops/sh.py``'s constants and flattened
coefficient layout) along the unit direction from the camera centre
(``-R^T t`` of ``w2c``) to the mean, the norm bounded below by 1e-8, then
``maximum(raw + 0.5, 0)``. No Pallas kernel stands behind it: the JAX
package computes it with ``jnp`` ops (``models/render.py``'s direction and
``ops/sh.py::eval_sh_color_flat``), which XLA fuses on the TPU. As eager
PyTorch ops it is some fifty full-width ops and their autograd chain, in
which each of the 15 column slices of ``sh_rest`` writes a full-width
gradient buffer and the 15 are summed. The kernels move what the work
needs at degree 3, 216 B a row forward and 420 B backward, and keep
every intermediate out of device memory.

The kernels hold the plain version's conventions: half the gradient at a
tie of either ``maximum`` (the clamp's, as ``ops/clip.py`` gives it, and
the norm's bound), no gradient through the norm at a zero direction,
zeros for the coefficients above the degree and, at degree 0, no gradient
for ``means``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .segments import _device_index
from ..clip import maximum
from ..sh import eval_sh_color_flat

# kernel launches made by `sh_color` (the plain version never counts):
# forward, and backward (one for each forward a gradient flows back through)
launches = 0
backward_launches = 0


def sh_color_plain(degree: int, means, sh_0, sh_rest, w2c, sh_eval=eval_sh_color_flat):
    """The colour [C, 3] as PyTorch ops: the unit directions from the
    camera centre of ``w2c`` to ``means``, then ``sh_eval`` over the
    flattened coefficients."""
    r_cw = w2c[:3, :3]
    t_cw = w2c[:3, 3]
    cam = [
        -(r_cw[0, j] * t_cw[0] + r_cw[1, j] * t_cw[1] + r_cw[2, j] * t_cw[2])
        for j in range(3)
    ]
    dirs = torch.stack([means[:, j] - cam[j] for j in range(3)], dim=1)
    dirs = dirs / maximum(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
    c = sh_0.shape[0]
    return sh_eval(degree, sh_0.reshape(c, 3), sh_rest.reshape(c, -1), dirs)


def _check(degree: int, means, sh_0, sh_rest, w2c) -> None:
    c = means.shape[0]
    if not 0 <= degree <= 3:
        raise ValueError(f"sh_color: degree must be in [0, 3], got {degree}")
    for name, x, shape in (("means", means, (c, 3)), ("sh_0", sh_0, (c, 1, 3)),
                           ("w2c", w2c, (4, 4))):
        if tuple(x.shape) != shape:
            raise ValueError(f"sh_color: {name} must be {list(shape)}, got {list(x.shape)}")
    if sh_rest.dim() != 3 or sh_rest.shape[0] != c or sh_rest.shape[2] != 3:
        raise ValueError(f"sh_color: sh_rest must be [{c}, R, 3], got {list(sh_rest.shape)}")
    if not (degree + 1) ** 2 - 1 <= sh_rest.shape[1] <= 15:
        raise ValueError(f"sh_color: degree {degree} needs {(degree + 1) ** 2 - 1} to 15 rest "
                         f"coefficients, sh_rest has {sh_rest.shape[1]}")
    for name, x in (("sh_0", sh_0), ("sh_rest", sh_rest), ("w2c", w2c), ("means", means)):
        if x.device != means.device or x.dtype != torch.float32:
            raise ValueError(f"sh_color: {name} must be f32 on {means.device}, got {x.dtype} on "
                             f"{x.device}")
    if w2c.requires_grad:
        raise ValueError("sh_color: the kernels give w2c no gradient")


def _launch(name: str, argtypes, *args) -> None:
    fn = getattr(_build.load("sh_color"), f"egs_sh_color_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"sh_color {name} kernel launch failed: CUDA error {err}")


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _forward(degree: int, means, sh_0, sh_rest, w2c) -> torch.Tensor:
    dev = means.device
    color = torch.empty((means.shape[0], 3), dtype=torch.float32, device=dev)
    _launch("forward", [_P, _P, _P, _I, _P, _LL, _I, _P, _I, _P],
            means.data_ptr(), sh_0.data_ptr(), sh_rest.data_ptr(), sh_rest.shape[1],
            w2c.data_ptr(), means.shape[0], degree, color.data_ptr(), _device_index(dev),
            torch.cuda.current_stream(dev).cuda_stream)
    global launches
    launches += 1
    return color


def _backward(degree: int, grad, means, sh_0, sh_rest, w2c):
    dev = means.device
    d_means = torch.empty_like(means) if degree > 0 else None
    d_sh0, d_rest = torch.empty_like(sh_0), torch.empty_like(sh_rest)
    _launch("backward", [_P, _P, _P, _P, _I, _P, _LL, _I, _P, _P, _P, _I, _P],
            grad.data_ptr(), means.data_ptr(), sh_0.data_ptr(), sh_rest.data_ptr(),
            sh_rest.shape[1], w2c.data_ptr(), means.shape[0], degree,
            None if d_means is None else d_means.data_ptr(), d_sh0.data_ptr(),
            d_rest.data_ptr(), _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    global backward_launches
    backward_launches += 1
    return d_means, d_sh0, d_rest


class _SHColor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means, sh_0, sh_rest, w2c, degree):
        ctx.degree = degree
        ctx.save_for_backward(means, sh_0, sh_rest, w2c)
        return _forward(degree, means, sh_0, sh_rest, w2c)

    @staticmethod
    def backward(ctx, grad):
        d_means, d_sh0, d_rest = _backward(ctx.degree, grad.contiguous(), *ctx.saved_tensors)
        return d_means, d_sh0, d_rest, None, None


def sh_color(degree: int, means, sh_0, sh_rest, w2c, sh_eval=eval_sh_color_flat):
    """The colour [C, 3] of ``means`` [C, 3], ``sh_0`` [C, 1, 3] and
    ``sh_rest`` [C, R, 3] (R <= 15) at SH degree ``degree`` seen from the
    camera of ``w2c`` [4, 4], differentiable in the first three. CPU
    tensors take the plain version; CUDA tensors launch the kernels, which
    compute ``ops/sh.py::eval_sh_color_flat`` whatever ``sh_eval`` is.

    ``sh_eval`` is the plain version's SH step alone. It exists so that
    the benchmark's CPU fault test, which patches ``models/render.py``'s
    ``eval_sh_color_flat``, still reaches the colour; it goes once that
    test plants its fault in this module."""
    if means.device.type == "cpu":
        return sh_color_plain(degree, means, sh_0, sh_rest, w2c, sh_eval)
    _check(degree, means, sh_0, sh_rest, w2c)
    return _SHColor.apply(means.contiguous(), sh_0.contiguous(), sh_rest.contiguous(),
                          w2c.contiguous(), degree)
