"""The view-dependent SH colour (``ops/kernels/sh_color.py``,
``csrc/sh_color.cu``): on the CPU the wrapper's plain path against the
JAX package's render composition, the launch counters' order and the
kernel's build; on the card (``cuda`` marker; skipped elsewhere) the
kernels against the plain version and a graphed step with the kernels
inside against its eager step.

Only the CPU test imports JAX, inside it, so on the card the file runs
without the suite's conftest:

    python -m pytest tests/test_torch_sh_color.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch
from test_torch_graphs import CFG, H, W, assert_bitwise, leaves, scene_arrays, torch_state

from easy_gaussian_splatting_torch.ops import sh as tsh
from easy_gaussian_splatting_torch.ops.kernels import _build
from easy_gaussian_splatting_torch.ops.kernels import sh_color as shc
from easy_gaussian_splatting_torch.training import graphs
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.training.config import config_from_dict

N_TIE, N_ZERO = 7, 3  # rows at the clamp's tie, rows at the camera centre


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the SH colour's kernels run only there")
    return torch.device("cuda")


def _w2c(rng):
    """A world->camera matrix of a camera at distance ~4 looking at the
    origin, rotated about a random axis."""
    a = rng.normal(size=3)
    a /= np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = rng.uniform(0, np.pi)
    rot = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = rot
    w2c[:3, 3] = [0.1, -0.2, 4.0]
    return w2c


def _tie_sh0(device) -> torch.Tensor:
    """An f32 value s with C0 * s + 0.5 == 0 exactly in f32 on ``device``:
    the raw colour of a black point, which lands on the clamp's tie."""
    s = torch.tensor(-0.5 / tsh.C0, dtype=torch.float32, device=device)
    for _ in range(64):
        v = tsh.C0 * s + 0.5
        if v.item() == 0.0:
            return s
        s = torch.nextafter(s, s + (1.0 if v.item() < 0 else -1.0))
    raise AssertionError("no f32 value lands on the tie")


def _inputs(rng, c, n_rest, device):
    """means [c, 3], sh_0 [c, 1, 3], sh_rest [c, n_rest, 3], w2c [4, 4] and
    an upstream gradient [c, 3]; the first N_TIE rows a black point (no
    rest coefficients, colour at the clamp's tie), the next N_ZERO rows at
    the camera centre (a zero direction)."""
    means = torch.as_tensor(rng.uniform(-2, 2, size=(c, 3)).astype(np.float32), device=device)
    sh_0 = torch.as_tensor(rng.normal(0, 0.8, size=(c, 1, 3)).astype(np.float32), device=device)
    sh_rest = torch.as_tensor(rng.normal(0, 0.3, size=(c, n_rest, 3)).astype(np.float32),
                              device=device)
    w2c = torch.as_tensor(_w2c(rng), device=device)
    grad = torch.as_tensor(rng.normal(size=(c, 3)).astype(np.float32), device=device)
    sh_0[:N_TIE] = _tie_sh0(device)
    sh_rest[:N_TIE] = 0.0
    r, t = w2c[:3, :3], w2c[:3, 3]
    cam = torch.stack([-(r[0, j] * t[0] + r[1, j] * t[1] + r[2, j] * t[2]) for j in range(3)])
    means[N_TIE:N_TIE + N_ZERO] = cam
    return means, sh_0, sh_rest, w2c, grad


def _jax_colour_and_grads(degree, means, sh_0, sh_rest, w2c, grad):
    """The JAX package's colour on the same inputs (its render's direction
    from the camera centre of ``w2c``, then ``ops/sh.py``'s
    ``eval_sh_color_flat``) and its gradients of means, sh_0 and sh_rest
    under the upstream ``grad``, as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from easy_gaussian_splatting_tpu.ops import sh as jsh

    w = jnp.asarray(w2c.numpy())
    r_cw, t_cw = w[:3, :3], w[:3, 3]
    cam = [-(r_cw[0, j] * t_cw[0] + r_cw[1, j] * t_cw[1] + r_cw[2, j] * t_cw[2])
           for j in range(3)]

    def colour(m, s0, sr):
        dirs = jnp.stack([m[:, j] - cam[j] for j in range(3)], axis=1)
        dirs = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-8)
        c = s0.shape[0]
        return jsh.eval_sh_color_flat(degree, s0.reshape(c, 3), sr.reshape(c, -1), dirs)

    col, vjp = jax.vjp(colour, *(jnp.asarray(x.numpy()) for x in (means, sh_0, sh_rest)))
    return np.asarray(col), [np.asarray(g) for g in vjp(jnp.asarray(grad.numpy()))]


def _colour_and_grads(fn, degree, means, sh_0, sh_rest, w2c, grad):
    """``fn``'s colour and the gradients of means, sh_0 and sh_rest under
    the upstream ``grad`` (None where the colour does not reach one)."""
    xs = [x.detach().clone().requires_grad_(True) for x in (means, sh_0, sh_rest)]
    col = fn(degree, *xs, w2c)
    return col.detach(), torch.autograd.grad(col, xs, grad, allow_unused=True)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_wrapper_on_the_cpu_is_the_render_composition(rng, degree):
    """CPU tensors take the plain ops, held to the JAX package's render
    composition on the same inputs: the colours and the gradients of
    means, sh_0 and sh_rest within 1e-5 of each tensor's largest value,
    and the tie rows as JAX's rule gives them (colour 0, half the upstream
    gradient to sh_0). At the camera centre JAX's norm has no finite
    gradient (0 times an infinite derivative) while PyTorch's norm has a
    zero subgradient, so there the means gradient is only checked finite
    and of the 1e-8 bound's size. The kernels' counters do not move."""
    args = _inputs(rng, 300, 15, "cpu")
    before = (shc.launches, shc.backward_launches)
    col, grads = _colour_and_grads(shc.sh_color, degree, *args)
    assert (shc.launches, shc.backward_launches) == before
    want_col, want_grads = _jax_colour_and_grads(degree, *args)
    special = N_TIE + N_ZERO
    np.testing.assert_allclose(col.numpy(), want_col, rtol=0,
                               atol=1e-5 * np.abs(want_col).max())
    assert (col[:N_TIE] == 0).all()  # the tie rows clamp to 0
    for name, g, w in zip(("means", "sh_0", "sh_rest"), grads, want_grads):
        g = np.zeros_like(w) if g is None else g.numpy()  # no gradient: JAX's zeros
        if name == "means":
            assert g.shape == w.shape and np.isfinite(g).all()
            assert not np.isfinite(w[N_TIE:special]).all() or degree == 0
            g, w = np.delete(g, np.s_[N_TIE:special], 0), np.delete(w, np.s_[N_TIE:special], 0)
        np.testing.assert_allclose(g.reshape(w.shape), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=name)
    np.testing.assert_array_equal(grads[1][:N_TIE].reshape(-1, 3).numpy(),
                                  ((0.5 * args[4][:N_TIE]) * tsh.C0).numpy())
    if degree > 0:
        zero = grads[0][N_TIE:special]
        assert zero.abs().amax() > 1e6  # the 1e-8 bound's gradient


def test_counters_keep_the_seven_main_path_counters_first():
    """Readers zip the first seven counters with their kernels' names (the
    benchmark's traced window, the profiling tests), so the SH colour's two
    come after them, and the Adam kernel's after those."""
    names = [(mod.__name__.rsplit(".", 1)[-1], attr) for mod, attr in graphs._counters()]
    assert names == [
        ("binkeys", "launches"), ("tile_raster", "launches"), ("tile_raster", "backward_launches"),
        ("segments", "launches"), ("segments", "compact_launches"),
        ("segments", "expand_launches"), ("group_reduce", "launches"),
        ("sh_color", "launches"), ("sh_color", "backward_launches"), ("adam", "launches"),
    ]
    assert len(graphs.launch_counts()) == len(names)


def test_sh_color_builds_through_build_py():
    """The kernel builds like the others, with no extra flags, and adds no
    header: every library's hash covers every header, so a new one would
    rebuild all of them."""
    assert _build.EXTRA_FLAGS["sh_color"] == ()
    assert sorted(p.name for p in _build.SRC_DIR.glob("*.cuh")) == [
        "tile_cull.cuh", "tile_eligibility.cuh"]
    assert all((_build.SRC_DIR / f"{name}.cu").exists() for name in _build.EXTRA_FLAGS)
    assert _build._lib_path("sh_color").name.startswith("libsh_color-")


@pytest.mark.parametrize("case", ["degree", "rest_short", "rest_long", "dtype", "sh_0_shape",
                                  "w2c_grad"])
def test_kernel_wrapper_checks_its_inputs(rng, case):
    """What the kernels do not take raises before a launch."""
    means, sh_0, sh_rest, w2c, _ = _inputs(rng, 40, 15, "cpu")
    degree = 3
    if case == "degree":
        degree = 4
    elif case == "rest_short":
        sh_rest = sh_rest[:, :8]
    elif case == "rest_long":
        sh_rest = torch.zeros((40, 16, 3))
    elif case == "dtype":
        means = means.double()
    elif case == "sh_0_shape":
        sh_0 = sh_0.reshape(40, 3)
    else:
        w2c = w2c.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="sh_color"):
        shc._check(degree, means, sh_0, sh_rest, w2c)


# ----------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("degree,n_rest", [(0, 15), (1, 15), (2, 15), (3, 15), (1, 3), (2, 8)])
def test_kernels_match_plain(cuda, rng, degree, n_rest):
    """The forward colours and the gradients of means, sh_0 and sh_rest
    against the plain version on the card, over 5,003 rows (a ragged last
    block and a count of floats not a multiple of four), at each degree
    and with fewer stored coefficients than degree 3's.

    The kernels round the camera centre, the basis and the raw colour as
    the plain ops do, but the norm and the direction's gradient in their
    own order, so the directions differ by a few ulp: each tensor is held
    to within twice the plain f32 version's own distance from the float64
    composition, plus 1e-6 of its norm. The rows at the clamp's tie and at
    the camera centre are held to the f32 plain version directly (in
    float64 neither is a tie or a zero direction): colours equal, the tie's
    half gradient to sh_0 equal bit for bit, and the zero direction's
    means gradient (the upstream gradient over the 1e-8 bound, some 1e7)
    within 1e-5 of the row's largest value."""
    c = 5003
    args = _inputs(rng, c, n_rest, cuda)
    before = (shc.launches, shc.backward_launches)
    k_col, (k_m, k_s, k_r) = _colour_and_grads(shc.sh_color, degree, *args)
    assert (shc.launches, shc.backward_launches) == (before[0] + 1, before[1] + 1)
    p_col, (p_m, p_s, p_r) = _colour_and_grads(shc.sh_color_plain, degree, *args)
    r_col, (r_m, r_s, r_r) = _colour_and_grads(shc.sh_color_plain, degree,
                                               *(x.double() for x in args))
    torch.cuda.synchronize()
    if degree == 0:  # the colour reaches neither means nor sh_rest: the
        # plain version gives None, the kernels no means gradient and zeros
        assert k_m is None and p_m is None and p_r is None
        p_r, r_r = torch.zeros_like(k_r), torch.zeros_like(k_r).double()
    checked = [("colour", k_col, p_col, r_col), ("sh_0", k_s, p_s, r_s),
               ("sh_rest", k_r, p_r, r_r)] + ([("means", k_m, p_m, r_m)] if degree else [])
    special = N_TIE + N_ZERO
    for name, k, p, r in checked:
        k, p, r = k[special:].double(), p[special:].double(), r[special:]
        own = (p - r).norm().item()
        assert (k - r).norm().item() <= 2 * own + 1e-6 * r.norm().item(), (name, own)
    used = 3 * ((degree + 1) ** 2 - 1)
    assert (k_r.reshape(c, 3 * n_rest)[:, used:] == 0).all()  # zeros above the degree
    # the tie rows: colour 0, sh_0's gradient half the upstream's times C0
    assert (k_col[:N_TIE] == 0).all() and (p_col[:N_TIE] == 0).all()
    assert torch.equal(k_s[:N_TIE], p_s[:N_TIE])
    assert torch.equal(k_s[:N_TIE].reshape(-1, 3), (0.5 * args[4][:N_TIE]) * tsh.C0)
    assert torch.equal(k_col[N_TIE:special], p_col[N_TIE:special])
    if degree > 0:
        assert (k_m[:N_TIE] == 0).all()  # no rest coefficients: no direction gradient
        zero_k, zero_p = k_m[N_TIE:special], p_m[N_TIE:special]
        assert zero_p.abs().amax() > 1e6  # the 1e-8 bound's gradient
        torch.testing.assert_close(zero_k, zero_p, rtol=0,
                                   atol=1e-5 * zero_p.abs().amax().item())


@pytest.mark.cuda
def test_graphed_step_with_the_kernels_equals_eager(cuda, rng):
    """One train step at each SH degree, eager and as a captured CUDA graph
    from the same state: the kernels run inside both (one forward and one
    backward launch an eager step; the warm-up calls' and the replay's in
    the capture's call), and the state and loss dict are equal bit for
    bit."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    render_fn = ttrainer.get_render_fn(cfg)
    frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
    eager = ttrainer.make_train_step(cfg, render_fn)
    graphed = graphs.GraphedTrainStep(cfg, ttrainer.make_train_step(cfg, render_fn), cuda)
    for degree in range(4):
        kw = dict(height=H, width=W, sh_degree=degree)
        before = (shc.launches, shc.backward_launches)
        out = eager(*torch_state(arrays, alive, cuda), *frame, 1e-3, True, False, False, **kw)
        want = {k: v.clone() for k, v in leaves(*out).items()}
        assert (shc.launches, shc.backward_launches) == (before[0] + 1, before[1] + 1)
        before = (shc.launches, shc.backward_launches)
        out = graphed(*torch_state(arrays, alive, cuda), *frame, 1e-3, True, False, False, **kw)
        calls = graphs.WARMUP_CALLS + 1
        assert (shc.launches, shc.backward_launches) == (before[0] + calls, before[1] + calls)
        assert_bitwise(leaves(*out), want)
    assert len(graphed.captures) == 4  # one program a degree
