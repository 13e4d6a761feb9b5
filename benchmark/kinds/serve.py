"""The ``serve`` kind: the viewer's render closure
(``viewer/integration.py::make_gs_render_func``) as ``launch_viewer``
builds it, one client in a closed loop on an orbit; on a CPU device (the
tests only) the closure renders eagerly, as the program does there."""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import cells, inputs
from ..cells import LEAVES
from ..reference import render as ref_render


class Cell(cells.Cell):
    """The viewer's render closure over the seed's scene, one client in a
    closed loop on an orbit."""

    kind = "serve"

    def setup(self) -> None:
        from easy_gaussian_splatting_torch.models.gaussians import compact_for_inference
        from easy_gaussian_splatting_torch.training.trainer import (
            get_render_fn, tune_inference_cfg)
        from easy_gaussian_splatting_torch.viewer.integration import make_gs_render_func

        sc, dev = self.scene, self.device
        if self.mix["width"] is None:  # frames at the capture's own size
            self.mix = dict(self.mix, width=sc["width"], height=sc["height"])
        mix = self.mix
        model, _ = self.state()
        # launch_viewer's load_run: the checkpoint compacted to its alive
        # population, the binning tuned on the first dataset camera
        state = compact_for_inference(model)
        w2cs, K = inputs.train_views(sc, self.seed)
        cfg = self.cfg = tune_inference_cfg(self.program_cfg(), state, w2cs[0], K,
                                            sc["height"], sc["width"])
        self.state_ = state
        self.render = make_gs_render_func(
            lambda: self.state_, lambda: mix["sh_degree"], self.background, get_render_fn(cfg),
            cfg=cfg, base_pixels=sc["width"] * sc["height"])
        self.i = 0
        self.failed = 0
        self.rerenders = 0
        self.samples: List = []  # (frame, image) reservoir
        self.rng = random.Random(self.seed)
        self.seen = 0
        for _ in range(mix["warmup_frames"]):
            self.call()

    def call(self):
        from easy_gaussian_splatting_torch.viewer.camera import CameraState

        w2c, K = inputs.orbit(self.scene, self.mix, self.seed, self.i)
        frame = self.i
        self.i += 1
        image = self.render(CameraState(w2c, K, self.mix["width"], self.mix["height"]))
        st = self.render.stats
        self.rerenders += st.get("rerenders", 0)
        if st.get("num_isects", 0) > st.get("isect_cap", math.inf):
            self.failed += 1
        return frame, image

    def describe(self) -> str:
        c = self.cfg
        return (f"capacity {self.state_.capacity}, {self.mix['width']}x{self.mix['height']}, "
                f"isect_mult {c.isect_mult} (at the capture's size), small_budget "
                f"{c.small_budget}, ov_frac {c.ov_frac}, {self.rerenders} re-renders, "
                f"last frame {self.render.stats}")

    def _keep(self, frame: int, image) -> None:
        """A seeded reservoir sample of the window's frames."""
        k = self.mix["check_frames"]
        self.seen += 1
        if len(self.samples) < k:
            self.samples.append((frame, image))
        else:
            j = self.rng.randrange(self.seen)
            if j < k:
                self.samples[j] = (frame, image)

    def window(self, seconds: float) -> dict:
        """Frames back to back for ``seconds``, each timed from its request
        to the image on the host."""
        times = []
        start = self.i
        self.failed = 0
        with record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                with record_function("serve.frame"):
                    t = time.perf_counter()
                    frame, image = self.call()
                    times.append(time.perf_counter() - t)
                self._keep(frame, image)
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
        n = self.i - start
        return dict(units=n, wall_s=wall, frame_ms=[x * 1e3 for x in times],
                    frame_ms_p95=cells.p95([x * 1e3 for x in times]))

    def traced_units(self, n: int) -> None:
        for _ in range(n):
            with record_function("serve.frame"):
                self.call()

    def unit_views(self, first: int, n: int) -> List[int]:
        return list(range(first, first + n))

    def work_counts(self, frames: List[int]) -> List[dict]:
        n = self.scene["gaussians"]
        params = {k: getattr(self.state_.params, k)[:n].detach() for k in LEAVES}
        out = []
        for f in frames:
            w2c, K = inputs.orbit(self.scene, self.mix, self.seed, f)
            _, c = ref_render.render(params, torch.as_tensor(w2c, device=self.device),
                                     torch.as_tensor(K, device=self.device),
                                     self.mix["width"], self.mix["height"], self.background,
                                     self.recipe["tile_size"], self.recipe["max_tiles"],
                                     counts=True)
            out.append(c)
        return out

    def captures(self) -> int:
        g = getattr(self.render, "graphed", None)
        return 0 if g is None else len(g.captures)

    def release(self) -> None:
        self.render = self.state_ = None

    def reference(self, tf32: bool = False) -> Dict[int, torch.Tensor]:
        """The reference's image of every sampled frame, from the seed's own
        Gaussians (float64 per Gaussian, float32 compositing)."""
        hi = torch.float32 if tf32 else torch.float64
        g = inputs.gaussians(self.scene, self.seed, self.device)
        params = {k: v.to(hi) for k, v in g.items()}
        out = {}
        for frame, _ in self.samples:
            w2c, K = inputs.orbit(self.scene, self.mix, self.seed, frame)
            out[frame] = ref_render.render(
                params, torch.as_tensor(w2c, device=self.device),
                torch.as_tensor(K, device=self.device), self.mix["width"], self.mix["height"],
                self.background, self.recipe["tile_size"], self.recipe["max_tiles"], tf32)[0]
        return out

    def compare(self, ref: Dict[int, torch.Tensor], got=None) -> Dict[str, float]:
        """The worst sampled frame's mean absolute difference from the
        reference's image, over its pixels and channels."""
        got = got if got is not None else self.samples
        worst = 0.0
        for frame, image in got:
            img = torch.as_tensor(np.asarray(image), device=self.device)
            want = ref[frame]
            if img.shape != want.shape or not bool(torch.isfinite(img).all()):
                return {"frame_error": math.inf}
            worst = max(worst, float((img.double() - want.double()).abs().mean()))
        return {"frame_error": worst}
