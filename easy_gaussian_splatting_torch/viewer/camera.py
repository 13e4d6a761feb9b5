"""Camera state, training-mode mailbox, SE3 interpolation, video export;
this package's own copy of ``easy_gaussian_splatting_tpu/viewer/camera.py``
(numpy only).

- ``CameraState``: w2c (OpenCV convention) + intrinsics + size, fov
  helpers, camera-to-camera distance;
- ``DelayRender``: viewer threads deposit the latest requested camera and
  at once get the last frame; the training loop renders the newest
  deposited camera once per iteration (the loop owns the card's cadence);
- ``camera_interpolation``: SE3 log/exp interpolation between keyframes
  with frame counts proportional to inter-camera distance;
- ``RecordManager``: renders the interpolated path and writes a video
  (``imageio``, imported only when a video is exported).
"""

from __future__ import annotations

import logging
import threading
from datetime import datetime
from pathlib import Path
from typing import Callable, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


# ----------------------------------------------------------------- SO3/SE3
def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle [3] -> rotation matrix."""
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle [3]."""
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near pi: extract axis from R + I
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs from off-diagonals
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        axis = axis / (np.linalg.norm(axis) + 1e-12)
        return theta * axis
    w = (
        theta
        / (2.0 * np.sin(theta))
        * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        )
    )
    return w


def _so3_left_jacobian(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    K = np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    )
    if theta < 1e-6:
        return np.eye(3) + 0.5 * K
    K = K / theta
    return (
        np.eye(3)
        + (1 - np.cos(theta)) / theta * K
        + (theta - np.sin(theta)) / theta * (K @ K)
    )


def se3_log(T: np.ndarray) -> np.ndarray:
    """4x4 rigid transform -> twist [6] (rho, w)."""
    w = so3_log(T[:3, :3])
    V = _so3_left_jacobian(w)
    rho = np.linalg.solve(V, T[:3, 3])
    return np.concatenate([rho, w])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist [6] (rho, w) -> 4x4 rigid transform."""
    rho, w = xi[:3], xi[3:]
    T = np.eye(4)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = _so3_left_jacobian(w) @ rho
    return T


# ------------------------------------------------------------- camera state
class CameraState:
    def __init__(
        self, w2c: np.ndarray, K: np.ndarray, width: int, height: int,
        sh_cap: int | None = None,
    ) -> None:
        self.w2c = w2c  # OpenCV convention (X right, Y down, Z forward)
        self.K = K
        self.width = width
        self.height = height
        # interactive-degradation hint: cap the evaluated SH degree for
        # this frame (the viewer drops view-dependence while the camera
        # moves; None = full fidelity)
        self.sh_cap = sh_cap

    def fov(self) -> Tuple[float, float]:
        return (
            focal2fov(self.K[0, 0], self.width),
            focal2fov(self.K[1, 1], self.height),
        )

    def distance_to(self, other: "CameraState") -> float:
        a = np.linalg.inv(self.w2c)[:3, 3]
        b = np.linalg.inv(other.w2c)[:3, 3]
        return float(np.linalg.norm(a - b))

    def copy(self) -> "CameraState":
        return CameraState(
            self.w2c.copy(), self.K.copy(), self.width, self.height,
            self.sh_cap,
        )


class DelayRender:
    """Single-slot render mailbox for training mode.

    While training, viewer threads never drive the card: each
    ``get_render_image`` call only posts the requested camera (replacing an
    older request not yet served, since only the newest view matters) and
    at once returns the last frame the loop rendered. The loop calls
    ``update_render_image`` once per iteration, between steps, and renders
    the posted camera if there is one."""

    def __init__(self, render_func: Callable[[CameraState], np.ndarray]):
        self._render = render_func
        self._slot_lock = threading.Lock()
        self._requested: CameraState | None = None
        self._last_frame: np.ndarray = np.ones((720, 1280, 3), np.float32)

    def get_render_image(self, camera_state: CameraState) -> np.ndarray:
        with self._slot_lock:
            self._requested = camera_state
        return self._last_frame

    def update_render_image(self) -> None:
        with self._slot_lock:
            request, self._requested = self._requested, None
        if request is not None:
            self._last_frame = self._render(request)


def _geodesic_w2cs(a_w2c: np.ndarray, b_w2c: np.ndarray, count: int):
    """Yield ``count`` w2c poses stepping along the SE3 geodesic from pose
    a to pose b (endpoint included, start excluded). A zero budget
    degenerates to a hard cut to the endpoint."""
    if count <= 0:
        yield b_w2c
        return
    # relative motion expressed in a's camera frame: a_w2c maps world ->
    # a-camera, inv(b_w2c) maps b-camera -> world
    twist = se3_log(a_w2c @ np.linalg.inv(b_w2c))
    a_c2w = np.linalg.inv(a_w2c)
    for frac in np.arange(1, count + 1, dtype=np.float64) / count:
        yield np.linalg.inv(a_c2w @ se3_exp(twist * frac))


def camera_interpolation(
    camera_states: List[CameraState], duration: float, fps: float
) -> List[CameraState]:
    """Expand keyframes into a smooth path of ``duration * fps`` frames.

    The frame budget is divided among segments in proportion to the
    straight-line distance between their endpoint cameras, so the
    played-back path moves at roughly constant speed; within a segment
    poses ride the SE3 geodesic. Degenerate inputs (budget smaller than
    the keyframe count, or all keyframes at one point) return the
    keyframes unchanged."""
    total_frames = int(duration * fps)
    if total_frames < len(camera_states):
        return camera_states

    segments = list(zip(camera_states, camera_states[1:]))
    gaps = np.array([a.distance_to(b) for a, b in segments])
    if gaps.sum() <= 0:
        return camera_states
    budgets = (gaps / gaps.sum() * total_frames).astype(int)

    proto = camera_states[0].copy()
    path: List[CameraState] = [camera_states[0]]
    for (a, b), budget in zip(segments, budgets):
        for w2c in _geodesic_w2cs(a.w2c, b.w2c, int(budget)):
            cam = proto.copy()
            cam.w2c = w2c
            path.append(cam)
    return path


class RecordManager:
    """Collects keyframe cameras and exports an interpolated-path video."""

    def __init__(
        self,
        render_func: Callable[[CameraState], np.ndarray],
        duration: float,
        fps: float,
        output_dir: Path,
    ) -> None:
        self.render_func = render_func
        self.duration = duration
        self.fps = fps
        self.output_dir = Path(output_dir)
        self.camera_states: List[CameraState] = []

    def export_video(self) -> Path | None:
        import imageio

        if len(self.camera_states) <= 1:
            logger.error("not enough camera states to export video")
            return None
        cams = camera_interpolation(
            self.camera_states, self.duration, self.fps
        )
        frames = []
        for cam in cams:
            img = self.render_func(cam) * 255.0
            frames.append(np.floor(img).astype(np.uint8))
        stamp = datetime.now().strftime(r"%m-%d_%H-%M-%S")
        self.output_dir.mkdir(parents=True, exist_ok=True)
        # mp4 needs an ffmpeg/pyav backend, which this environment may not
        # ship; fall back to GIF so export always works
        try:
            path = self.output_dir / f"{stamp}.mp4"
            imageio.mimsave(path, frames, fps=self.fps)
        except (ValueError, ImportError):
            path = self.output_dir / f"{stamp}.gif"
            imageio.mimsave(path, frames, duration=1.0 / self.fps)
        logger.info(f"exported video to {path}")
        return path
