"""Camera and colour math parity: the PyTorch port against the JAX package on
the same numpy inputs. Tolerance rtol 1e-5 / atol 1e-6: both run f32, in
the same expression order, but reductions (norms) may sum in another
order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from easy_gaussian_splatting_tpu.ops import knn as jknn
from easy_gaussian_splatting_tpu.ops import projection as jproj
from easy_gaussian_splatting_tpu.ops import quaternion as jquat
from easy_gaussian_splatting_tpu.ops import sh as jsh
from easy_gaussian_splatting_torch.ops import knn as tknn
from easy_gaussian_splatting_torch.ops import projection as tproj
from easy_gaussian_splatting_torch.ops import quaternion as tquat
from easy_gaussian_splatting_torch.ops import sh as tsh

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


def test_quat_to_rotmat(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    _close(tquat.quat_to_rotmat(torch.as_tensor(q)), jquat.quat_to_rotmat(jnp.asarray(q)))
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    _close(
        tquat.normalized_quat_to_rotmat(torch.as_tensor(qn)),
        jquat.normalized_quat_to_rotmat(jnp.asarray(qn)),
    )


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_color_flat(rng, degree):
    n = 64
    sh0 = rng.normal(size=(n, 3)).astype(np.float32)
    rest = rng.normal(0.0, 0.3, size=(n, 45)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = tsh.eval_sh_color_flat(degree, *(torch.as_tensor(x) for x in (sh0, rest, dirs)))
    want = jsh.eval_sh_color_flat(degree, *(jnp.asarray(x) for x in (sh0, rest, dirs)))
    _close(got, want)
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)


def test_sh0_roundtrip(rng):
    rgb = rng.uniform(size=(20, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh0(torch.as_tensor(rgb)), jsh.rgb_to_sh0(jnp.asarray(rgb)))
    _close(tsh.sh0_to_rgb(tsh.rgb_to_sh0(torch.as_tensor(rgb))), rgb)


def _camera(yaw=0.3):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    w2c[:3, 3] = [0.2, -0.1, 4.0]
    K = np.array([[90.0, 0, 36.0], [0, 85.0, 20.0], [0, 0, 1]], np.float32)
    return w2c, K


def test_project_gaussians_culling_and_clamp(rng):
    """Means in front of, beside and behind the camera: culled entries
    (near plane, off-screen) get radius 0 in both, and the frustum clamp
    of the Jacobian shapes the far-off-axis conics alike."""
    n = 300
    means = rng.uniform(-4.0, 4.0, size=(n, 3)).astype(np.float32)
    means[:20, 2] = -4.5  # behind the camera
    means[20:40, 0] = 9.0  # far off axis: clamped Jacobian
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-4.0, -1.0, size=(n, 3))).astype(np.float32)
    w2c, K = _camera()
    intr_t = tproj.CameraIntrinsics.from_K(torch.as_tensor(K), 72, 40)
    intr_j = jproj.CameraIntrinsics.from_K(jnp.asarray(K), 72, 40)
    assert float(intr_t.fx) == float(intr_j.fx) and float(intr_t.cy) == float(intr_j.cy)
    got = tproj.project_gaussians(
        torch.as_tensor(means), torch.as_tensor(quats), torch.as_tensor(scales),
        torch.as_tensor(w2c), intr_t,
    )
    want = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
        jnp.asarray(w2c), intr_j,
    )
    radii_t, radii_j = got.radii.numpy(), np.asarray(want.radii)
    np.testing.assert_array_equal(radii_t > 0, radii_j > 0)
    assert 0 < (radii_t > 0).sum() < n  # some culled, some kept
    assert np.all(radii_t[:20] == 0)
    live = radii_j > 0
    np.testing.assert_allclose(radii_t, radii_j, atol=1.0)  # ceil may step
    assert np.mean(radii_t == radii_j) > 0.95
    for name in ("means2d", "depths", "cam_means"):
        _close(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(
        got.conics.numpy()[live], np.asarray(want.conics)[live], **TOL
    )


def test_knn_dists(rng):
    pts = rng.uniform(-1.0, 1.0, size=(500, 3)).astype(np.float32)
    np.testing.assert_allclose(tknn.knn_dists(pts, k=3), jknn.knn_dists(pts, k=3), **TOL)
    with pytest.raises(ValueError):
        tknn.knn_dists(pts[:3], k=3)
