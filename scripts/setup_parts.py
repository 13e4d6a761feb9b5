"""Time the parts of a train cell's set-up, on the clock ``benchmark/run.py``
gives ``setup_s`` (from the process's start), on an NVIDIA card.

    python3 <path to>/setup_parts.py CELL SEED

Run it from the root of the checkout whose set-up it times (the harness
and the port are imported from the working directory), so one copy of the
script times two checkouts alike. It prints one JSON line: ``setup_s`` as
the harness counts it (process start to the end of ``setup()``, the card
synchronized), ``torch_imported`` (process start to the end of ``import
torch``), ``imports_done`` (the harness and the port imported),
``setup_called`` (``setup()`` entered), and ``parts``: [name, start s,
seconds] for the scene's views and targets, the state, ``tuned_binning``,
the graphed step's check and capture (``check_steps``), and the first
load of each kernel library (``load:<name>``). The gap between the end of
``state`` and the start of ``tuned_binning`` is the intersection counter
over every view, the first kernel loads inside it.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

from benchmark import run as brun  # noqa: E402  (its T_START: the process's start)

import torch  # noqa: E402

T_TORCH = time.perf_counter() - brun.T_START

from benchmark import cells, inputs  # noqa: E402
from benchmark.kinds import train as ktrain  # noqa: E402

import easy_gaussian_splatting_torch.training.trainer as trainer  # noqa: E402
from easy_gaussian_splatting_torch.ops.kernels import _build  # noqa: E402

T_IMPORTS = time.perf_counter() - brun.T_START
PARTS = []


def timed(obj, name: str, label: str, sync: bool = True, first_of_each: bool = False) -> None:
    """Wrap ``obj.name`` so that each call (or, with ``first_of_each``, the
    first call for each first argument) appends [label, start, seconds]
    to ``PARTS``; ``sync`` synchronizes the card at both ends."""
    orig, seen = getattr(obj, name), set()

    def call(*a, **k):
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            if sync:
                torch.cuda.synchronize()
            key = a[0] if first_of_each and a else None
            if key not in seen or not first_of_each:
                seen.add(key)
                PARTS.append([f"{label}:{key}" if first_of_each else label,
                              round(t - brun.T_START, 4), round(time.perf_counter() - t, 4)])

    setattr(obj, name, call)


def main(argv) -> int:
    name, seed = argv[1], int(argv[2])
    timed(_build, "load", "load", sync=False, first_of_each=True)
    timed(cells.Cell, "state", "state")
    timed(inputs, "targets", "targets")
    timed(inputs, "train_views", "train_views")
    timed(trainer, "tuned_binning", "tuned_binning")
    timed(ktrain.Cell, "_check_steps", "check_steps")
    spec = brun.load_json(brun.ROOT / "BENCHMARK.json")
    _, config, mix, _ = brun.cell_files(spec, name)
    dev = torch.device("cuda")
    runner = cells.kind(mix["kind"])(config, mix, seed, dev)
    t_setup = time.perf_counter() - brun.T_START
    runner.setup()
    torch.cuda.synchronize(dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(dict(cell=name, seed=seed,
                          setup_s=round(time.perf_counter() - brun.T_START, 4),
                          torch_imported=round(T_TORCH, 4), imports_done=round(T_IMPORTS, 4),
                          setup_called=round(t_setup, 4), parts=PARTS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
