"""Runs cases of the port's multi-device path in a spawned world of gloo
ranks on the CPU, for the ``tests/test_torch_parallel*.py`` files.

``run_world(n, cases)`` starts n processes (``spawn``), joins them into
one world over ``tcp://localhost``, runs every case on every rank and
returns each rank's results (numpy). A rank that raises or outlives the
timeout fails the call with its traceback. The module imports only torch
and the port, so the ranks start without JAX.
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

TIMEOUT_S = 240.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(n: int, cases, timeout: float = TIMEOUT_S, env_join: bool = False) -> list:
    """Run ``cases`` ([(name, function name, kwargs)]) on each of ``n`` gloo
    ranks; returns [rank 0's {name: result}, rank 1's, ...]. With
    ``env_join`` the ranks join through ``maybe_initialize_from_env`` and the
    ``EGS_TORCH_*`` variables instead of ``initialize``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, n, port, cases, tmp, env_join))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = [Path(tmp, f"rank{r}.err").read_text() for r in range(n)
                  if Path(tmp, f"rank{r}.err").exists()]
        if errors or late:
            raise RuntimeError((f"ranks {late} timed out after {timeout} s\n" if late else "")
                               + "\n".join(errors))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
        return [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes()) for r in range(n)]


def _rank_main(rank, n, port, cases, tmp, env_join):
    import torch.distributed as dist

    from easy_gaussian_splatting_torch.parallel import distributed

    try:
        torch.set_num_threads(1)
        if env_join:
            os.environ.update(EGS_TORCH_COORDINATOR=f"localhost:{port}",
                              EGS_TORCH_NUM_PROCESSES=str(n), EGS_TORCH_PROCESS_ID=str(rank))
            assert distributed.maybe_initialize_from_env(device="cpu", timeout_s=60)
        else:
            distributed.initialize(f"tcp://localhost:{port}", n, rank, device="cpu",
                                   backend="gloo", timeout_s=60)
        results = {name: globals()[fn](**kw) for name, fn, kw in cases}
        dist.barrier()
        dist.destroy_process_group()
        Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    except BaseException:
        Path(tmp, f"rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


# ------------------------------------------------------------------ cases
def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _model(arrays, alive, stats=None):
    from easy_gaussian_splatting_torch.models import gaussians as tg

    st = tg.zero_stats(alive.shape[0], "cpu") if stats is None else tg.DensifyStats(
        **{k: torch.as_tensor(v) for k, v in stats.items()})
    return tg.GaussianModelState(params=tg.params_from_numpy(arrays, "cpu"),
                                 alive=torch.as_tensor(alive), stats=st)


def _adam(adam):
    from easy_gaussian_splatting_torch.models import gaussians as tg
    from easy_gaussian_splatting_torch.models import optimizer as to

    if adam is None:
        return None
    mu, nu, steps = adam
    return to.AdamState(mu=tg.params_from_numpy(mu, "cpu"), nu=tg.params_from_numpy(nu, "cpu"),
                        steps={k: torch.tensor(v, dtype=torch.int32) for k, v in steps.items()})


def _state_np(model, adam=None) -> dict:
    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES

    out = {n: _np(getattr(model.params, n)) for n in PARAM_NAMES}
    out["alive"] = _np(model.alive)
    out.update({f"stats.{k}": _np(getattr(model.stats, k))
                for k in ("grad_norm_accum", "collecting_counts", "max_radii")})
    if adam is not None:
        out.update({f"mu.{n}": _np(getattr(adam.mu, n)) for n in PARAM_NAMES})
        out.update({f"nu.{n}": _np(getattr(adam.nu, n)) for n in PARAM_NAMES})
        out.update({f"steps.{n}": int(adam.steps[n]) for n in PARAM_NAMES})
    return out


def _cam(cam):
    return [torch.as_tensor(cam[k]) for k in ("w2c", "K", "image", "mask")]


def _setup(shape, cfg_kw):
    from easy_gaussian_splatting_torch.parallel.mesh import GAUSS_AXIS, mesh_from_shape
    from easy_gaussian_splatting_torch.training.config import config_from_dict
    from easy_gaussian_splatting_torch.training.trainer import get_render_fn

    mesh = mesh_from_shape(shape, "cpu")
    cfg = config_from_dict(cfg_kw)
    return mesh, cfg, get_render_fn(cfg), GAUSS_AXIS in mesh.axis_names


def grads(shape, cfg_kw, arrays, alive, cam, sh_degree):
    """Pre-Adam gradients of the sharded step (gathered to full arrays)."""
    from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES
    from easy_gaussian_splatting_torch.parallel import gauss_shard, shard

    mesh, cfg, rf, gauss = _setup(shape, cfg_kw)
    w2c, K, image, mask = _cam(cam)
    model = _model(arrays, alive)
    h, w = image.shape[:2]
    if gauss:
        fn = gauss_shard.make_gauss_sharded_grad_fn(cfg, mesh, rf, h, w)
        model = gauss_shard.shard_state(model, mesh)
    else:
        fn = shard.make_sharded_grad_fn(cfg, mesh, rf, h, w)
    g, a, ld, r = fn(model, w2c, K, image, mask, sh_degree=sh_degree)
    return dict(grads={n: _np(getattr(g, n)) for n in PARAM_NAMES}, absgrad=_np(a),
                ld={k: float(v) for k, v in ld.items()}, radii=_np(r))


def train_step(shape, cfg_kw, arrays, alive, cam, sh_degree, lr_means):
    """One sharded train step from a fresh Adam state (stats on, no event);
    the whole state after it."""
    from easy_gaussian_splatting_torch.models.optimizer import init_adam_state
    from easy_gaussian_splatting_torch.parallel import gauss_shard, shard

    mesh, cfg, rf, gauss = _setup(shape, cfg_kw)
    w2c, K, image, mask = _cam(cam)
    model = _model(arrays, alive)
    adam = init_adam_state(model.params)
    h, w = image.shape[:2]
    if gauss:
        model, adam = gauss_shard.shard_state(model, mesh), gauss_shard.shard_state(adam, mesh)
        step = gauss_shard.make_gauss_sharded_train_step(cfg, mesh, rf, h, w)
    else:
        step = shard.make_sharded_train_step(cfg, mesh, rf, h, w)
    model, adam, ld = step(model, adam, w2c, K, image, mask, lr_means, True, False, False,
                           sh_degree=sh_degree)
    if gauss:
        model, adam = gauss_shard.gather_state(model, mesh), gauss_shard.gather_state(adam, mesh)
    return dict(state=_state_np(model, adam), ld={k: float(v) for k, v in ld.items()})


def counter(shape, cfg_kw, arrays, alive, cam, reduce):
    """The striped intersection counter (``reduce`` "max" or "none")."""
    from easy_gaussian_splatting_torch.parallel import shard

    mesh, cfg, _, _ = _setup(shape, cfg_kw)
    w2c, K, image, _ = _cam(cam)
    count = shard.make_striped_isect_counter(
        mesh, cfg.tile_size, cfg.max_tiles, cfg.max_tiles, ov_frac=cfg.ov_frac, reduce=reduce,
        interleave=cfg.stripe_interleave, partition=cfg.stripe_partition)
    model = _model(arrays, alive)
    return _np(count(model.params, model.alive, w2c, K, height=image.shape[0],
                     width=image.shape[1]))


def densify(shape, dcfg_kw, arrays, alive, stats, adam, noise):
    """One sharded densify event fed each shard's noise (``noise[g]``);
    the gathered state, the info and the overflow flag."""
    from easy_gaussian_splatting_torch.models.density import DensifyConfig
    from easy_gaussian_splatting_torch.parallel import gauss_shard
    from easy_gaussian_splatting_torch.parallel.mesh import GAUSS_AXIS, mesh_from_shape

    mesh = mesh_from_shape(shape, "cpu")
    g = mesh.axis_index(GAUSS_AXIS)
    step = gauss_shard.make_sharded_densify_step(DensifyConfig(**dcfg_kw), mesh)
    model = gauss_shard.shard_state(_model(arrays, alive, stats), mesh)
    adam_s = gauss_shard.shard_state(_adam(adam), mesh)
    model, adam_s, info, overflow = step(model, adam_s, noise=torch.as_tensor(noise[g]))
    model = gauss_shard.gather_state(model, mesh)
    adam_s = gauss_shard.gather_state(adam_s, mesh)
    return dict(state=_state_np(model, adam_s), info={k: int(v) for k, v in info.items()},
                overflow=bool(overflow))


def grow(shape, arrays, alive, stats, adam, new_capacity):
    """``grow_state_sharded`` to ``new_capacity``; the gathered state."""
    from easy_gaussian_splatting_torch.parallel import gauss_shard
    from easy_gaussian_splatting_torch.parallel.mesh import mesh_from_shape

    mesh = mesh_from_shape(shape, "cpu")
    model = gauss_shard.shard_state(_model(arrays, alive, stats), mesh)
    adam_s = gauss_shard.shard_state(_adam(adam), mesh)
    model, adam_s = gauss_shard.grow_state_sharded(model, adam_s, new_capacity, mesh)
    return _state_np(gauss_shard.gather_state(model, mesh),
                     gauss_shard.gather_state(adam_s, mesh))


def train_losses(cfg_kw, seed):
    """``train(cfg)`` on this rank, seeded as every rank is: each step's
    loss, the final state and whether this rank served the training viewer
    (on a free port)."""
    from easy_gaussian_splatting_torch.parallel import gauss_shard, shard
    from easy_gaussian_splatting_torch.training import trainer
    from easy_gaussian_splatting_torch.training.config import config_from_dict
    from easy_gaussian_splatting_torch.viewer import integration

    viewers = []
    construct = integration.construct_training_viewer

    def on_free_port(loop, cfg, out):
        viewers.append(construct(loop, cfg, out, port=0))
        return viewers[-1]

    losses = []

    def recording(make):
        def made(*a, **k):
            step = make(*a, **k)

            def run(*a, **k):
                out = step(*a, **k)
                losses.append(float(out[2]["total"]))
                return out

            return run

        return made

    orig = shard.make_sharded_train_step, gauss_shard.make_gauss_sharded_train_step
    shard.make_sharded_train_step = recording(orig[0])
    gauss_shard.make_gauss_sharded_train_step = recording(orig[1])
    integration.construct_training_viewer = on_free_port
    try:
        random.seed(seed)
        np.random.seed(seed)
        loop = trainer.train(config_from_dict(cfg_kw), device="cpu")
    finally:
        shard.make_sharded_train_step, gauss_shard.make_gauss_sharded_train_step = orig
        integration.construct_training_viewer = construct
    return dict(losses=losses, step=loop.step, state=_state_np(loop.model, loop.adam),
                viewers=len(viewers))


def join_sum(value):
    """An ``all_reduce`` of ``value + rank`` over the world the environment
    joined."""
    import torch.distributed as dist

    x = torch.tensor([float(value + dist.get_rank())])
    dist.all_reduce(x)
    return dict(sum=float(x[0]), world=dist.get_world_size(), rank=dist.get_rank(),
                backend=str(dist.get_backend()))


def flag_steps(shape, cfg_kw, arrays, alive, stats, adam, cam, sh_degree, lr_means, flags):
    """The sharded step (``trainer.make_mesh_train_step``) from one state for
    each (do_stats, skip_all, skip_opac) in ``flags``, three ways: host
    flags and learning rate returning new tensors (``host``), 0-d tensors
    (``tensor``), 0-d tensors with ``in_place`` (``in_place``); each run's
    gathered state and loss dict, and whether the in-place step returned the
    tensors it was given."""
    from easy_gaussian_splatting_torch.parallel import gauss_shard
    from easy_gaussian_splatting_torch.training.graphs import state_leaves
    from easy_gaussian_splatting_torch.training.trainer import make_mesh_train_step

    mesh, cfg, rf, gauss = _setup(shape, cfg_kw)
    w2c, K, image, mask = _cam(cam)
    h, w = image.shape[:2]
    step = make_mesh_train_step(cfg, mesh, rf)
    out = []
    for fl in flags:
        runs = {}
        for mode in ("host", "tensor", "in_place"):
            # copies: a state may share memory with the arrays it came from
            model = _model({k: v.copy() for k, v in arrays.items()}, alive.copy(),
                           {k: v.copy() for k, v in stats.items()})
            mu, nu, steps = adam
            adam_s = _adam(({k: v.copy() for k, v in mu.items()},
                            {k: v.copy() for k, v in nu.items()}, steps))
            if gauss:
                model = gauss_shard.shard_state(model, mesh)
                adam_s = gauss_shard.shard_state(adam_s, mesh)
            scalars = ((lr_means,) + tuple(fl) if mode == "host"
                       else (torch.tensor(lr_means),) + tuple(torch.tensor(f) for f in fl))
            given = state_leaves(model, adam_s)
            m, a, ld = step(model, adam_s, w2c, K, image, mask, *scalars, height=h, width=w,
                            sh_degree=sh_degree, in_place=mode == "in_place")
            same = all(x is y for x, y in zip(state_leaves(m, a), given))
            if gauss:
                m, a = gauss_shard.gather_state(m, mesh), gauss_shard.gather_state(a, mesh)
            runs[mode] = dict(state=_state_np(m, a), ld={k: _np(v) for k, v in ld.items()},
                              same_tensors=same)
        out.append(runs)
    return out


def train_eager_log(shape, arrays, frame, seed):
    """``train()`` for two steps under ``shape`` on the CPU, from a
    one-camera scene: the trainer's log lines (rank 0 alone logs) and
    whether a ``GraphedTrainStep`` was built."""
    import logging
    from types import SimpleNamespace

    from easy_gaussian_splatting_torch.training import trainer
    from easy_gaussian_splatting_torch.training.config import config_from_dict

    class OneCamera:
        pc = SimpleNamespace(xyzs=arrays["xyzs"], rgbs=arrays["rgbs"],
                             nbr_points=arrays["xyzs"].shape[0])

        def nbr_data(self, split):
            return 2 if split == "train" else 0

        def get_data(self, split, index):
            return dict(frame)

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    built = []
    graphed = trainer.GraphedTrainStep

    def refuse(*a, **k):
        built.append(k)
        return graphed(*a, **k)

    lines = Lines()
    log = logging.getLogger("easy_gaussian_splatting_torch")
    log.addHandler(lines)
    log.setLevel(logging.INFO)
    trainer.GraphedTrainStep = refuse
    try:
        random.seed(seed)
        np.random.seed(seed)
        cfg = config_from_dict(dict(renderer="tiled", tile_size=16, total_iterations=2,
                                    refine_start=1000, sh_degree_interval=0,
                                    data_device_cache=False, dataloader_workers=0,
                                    mesh_shape=shape, initial_capacity=64))
        loop = trainer.train(cfg, scene=OneCamera(), device="cpu")
    finally:
        trainer.GraphedTrainStep = graphed
        log.removeHandler(lines)
    return dict(lines=lines.lines, built=len(built), step=loop.step)
