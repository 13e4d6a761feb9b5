"""The readings that set a cell's correctness limits (``limits/<cell>.json``):
sound runs of the program on many seeds (the lower reading), the control
on a few (the upper reading) and, for train cells, the planted fault of
half the batch left out. One process for all seeds, so that the kernels
build once; the benchmark's own runs never run this.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out FILE]

The control is the reference put in the program's place and computed in
the precision below the configured float32 without TF32: every matrix
product's operands rounded to TF32. Train cells: each seed's set-up steps
(the program) against the reference; the control's and the half-batch
fault's readings against the reference. Serve cells: the first
``check_frames`` frames after the warm-up (the program's, then the
control's) against the reference. Each reading is one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import cells, run


def readings(spec: dict, name: str, seed: int, control: bool, device="cuda",
             override=None) -> dict:
    """One seed's readings: the program's numbers and, with ``control``,
    the control's (and a train cell's half-batch fault's)."""
    _, config, mix, _ = run.cell_files(spec, name, override)
    dev = torch.device(device)
    t0 = time.perf_counter()
    c = cells.kind(mix["kind"])(config, mix, seed, dev)
    c.setup()
    if c.kind == "serve":
        for _ in range(mix["check_frames"]):
            c._keep(*c.call())
    c.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = c.reference()
    t2 = time.perf_counter()
    out = {"seed": seed, "program": c.compare(ref), "setup_s": t1 - t0, "reference_s": t2 - t1}
    if c.kind == "train":  # each leaf's reference gradient, root mean square over its values
        n = config["scene"]["gaussians"]
        out["ref_grad_rms"] = {k: v / (n * cells.inputs.LEAF_WIDTHS[k]) ** 0.5
                               for k, v in ref["grad"].items()}
    if control:
        if c.kind == "train":
            out["control"] = c.compare(ref, c.reference(tf32=True))
            out["half_batch"] = c.compare(ref, c.reference(loss_rows=c.h // 2))
        else:
            ctl = c.reference(tf32=True)
            out["control"] = c.compare(ref, [(f, ctl[f].cpu().numpy()) for f, _ in c.samples])
        if dev.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_reserved(dev)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control-seeds", default="", help="comma-separated")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            r = dict(readings(spec, args.workload, seed, seed in ctl), workload=args.workload)
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
