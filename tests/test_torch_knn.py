"""The k-NN of the Gaussians' initial scales without scipy: the port's
chunked brute-force fallback (``ops/knn.py::knn_dists_device``) against the
JAX package's ``_knn_dists_device`` on the same seeded cloud, and the
port's model module importing and initialising with scipy hidden."""

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_gaussian_splatting_tpu.ops import knn as jknn
from easy_gaussian_splatting_torch.ops import knn as tknn

# the same expansion |q|^2 + |p|^2 - 2 q.p in f32 on both sides; the matmul
# and the sums may round in another order
TOL = dict(rtol=1e-4, atol=1e-5)


def _cloud(n=300, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("chunk", [64, 300])
def test_knn_fallback_matches_jax_device_knn(chunk, monkeypatch):
    """With scipy hidden ``knn_dists`` takes the brute-force fallback: at a
    chunk smaller than N (the chunk loop runs, a partial last chunk) and at
    one chunk, the distances equal JAX's ``_knn_dists_device``'s."""
    pts = _cloud()
    monkeypatch.setitem(sys.modules, "scipy.spatial", None)
    got = tknn.knn_dists(pts, k=3, chunk=chunk)
    want = np.asarray(jknn._knn_dists_device(jnp.asarray(pts), 3, chunk))
    np.testing.assert_allclose(got, want, **TOL)
    assert got.shape == (300, 3) and np.all(np.diff(got, axis=1) >= 0)
    # and the KD-tree's, where scipy is there
    monkeypatch.undo()
    np.testing.assert_allclose(got, tknn.knn_dists(pts, k=3), **TOL)


def test_knn_fallback_runs_on_the_points_device():
    """The fallback works on the device of the points it is given."""
    pts = torch.as_tensor(_cloud(50))
    got = tknn.knn_dists_device(pts, 2, 16)
    assert got.device == pts.device and got.shape == (50, 2)
    want = np.sort(np.linalg.norm(_cloud(50)[:, None] - _cloud(50)[None], axis=-1), axis=1)[:, 1:3]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_model_module_imports_and_initialises_without_scipy():
    """A process where scipy cannot be imported: the port's model module
    imports, and ``init_gaussian_state`` sizes its scales from the fallback."""
    code = textwrap.dedent("""
        import sys
        sys.modules["scipy"] = None
        sys.modules["scipy.spatial"] = None
        import numpy as np
        from easy_gaussian_splatting_torch.models import gaussians
        pts = np.random.default_rng(0).uniform(-1, 1, size=(200, 3)).astype(np.float32)
        rgbs = np.zeros((200, 3), np.uint8)
        state = gaussians.init_gaussian_state(pts, rgbs, 0, device="cpu")
        assert "scipy.spatial" not in sys.modules or sys.modules["scipy.spatial"] is None
        print(float(state.params.log_scales[:200].mean()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert np.isfinite(float(out.stdout.strip().splitlines()[-1]))
