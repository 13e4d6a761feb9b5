"""What the kinds of cell share (``kinds/<kind>.py``, each a class ``Cell``
over this module's :class:`Cell`): the seed's inputs, the program's
config and state, the readback of a step's loss, the comparisons, and
:func:`kind`, which finds a kind's class by the name a traffic mix gives.

A kind's ``Cell`` sets up (``setup``), measures (``window``), runs the
traced steps or frames (``traced_units``, ``unit_views``, ``work_counts``)
and reads what decides ``correct`` (``reference``, ``compare``). The port
is imported inside the functions, after the command has set its cache
directories; on a CPU device (the tests only: the command refuses one)
the program runs eagerly, as it does there.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from . import inputs
from .reference import train as ref_train

LEAVES = ref_train.LEAVES


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel_gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / max(abs(want), scale, 1e-30)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or the median leaf's, whichever is larger."""
    med = float(np.median([want[k] for k in leaves]))
    return max(rel_gap(got[k], want[k], med) for k in leaves)


class Pending:
    """A step's loss dict copied to pinned host memory behind an event and
    read a few steps later, as ``train()`` reads it back."""

    def __init__(self, ld: Dict[str, torch.Tensor], device):
        self.keys = list(ld)
        vals = torch.stack([ld[k].to(torch.float32) for k in self.keys])
        self.event = None
        if device.type == "cuda":
            self.host = torch.empty(vals.shape, dtype=torch.float32, pin_memory=True)
            self.host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vals

    def get(self) -> Dict[str, float]:
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(self.keys, self.host.tolist()))


class Cell:
    """What both kinds share: the inputs of the seed, the program's config."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.scene, self.recipe = config["scene"], config["recipe"]
        self.background = torch.full((3,), 1.0 if self.recipe["white_background"] else 0.0,
                                     device=self.device)

    def program_cfg(self):
        from easy_gaussian_splatting_torch.training.config import config_from_dict

        return config_from_dict(dict(self.recipe))

    def state(self):
        """The program's model and Adam state of the seed's inputs, at the
        config's capacity (dead slots zero, identity quaternions, as the
        program pads them)."""
        from easy_gaussian_splatting_torch.models.gaussians import (
            GaussianModelState, GaussianParams, zero_stats)
        from easy_gaussian_splatting_torch.models.optimizer import AdamState

        cap, n, dev = self.scene["capacity"], self.scene["gaussians"], self.device
        g = inputs.gaussians(self.scene, self.seed, dev)
        mu, nu = inputs.moments(self.scene, self.config["adam"], self.seed, dev)

        def pad(x, fill=0.0):
            out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
            out[:n] = x
            return out

        params = {k: pad(v) for k, v in g.items()}
        params["quats"][n:, 0] = 1.0
        model = GaussianModelState(params=GaussianParams(**params),
                                   alive=torch.arange(cap, device=dev) < n,
                                   stats=zero_stats(cap, dev))
        steps = self.config["adam"]["steps"]
        adam = AdamState(mu=GaussianParams(**{k: pad(v) for k, v in mu.items()}),
                         nu=GaussianParams(**{k: pad(v) for k, v in nu.items()}),
                         steps={k: torch.tensor(steps[k], dtype=torch.int32, device=dev)
                                for k in LEAVES})
        return model, adam

    def launches(self):
        """The port's kernel launch counters (a replayed graph's included)."""
        from easy_gaussian_splatting_torch.training.graphs import launch_counts

        return launch_counts()


def p95(values: List[float]) -> float:
    """The 95th percentile of all ``values`` (linear interpolation between
    the two nearest ranks)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def kind(name: str):
    """The class ``Cell`` of ``kinds/<name>.py``."""
    return importlib.import_module(f"{__package__}.kinds.{name}").Cell
