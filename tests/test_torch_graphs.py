"""The compiled step (``training/graphs.py``) and the graphed served render
(``viewer/integration.py::GraphedRender``): the train step with its
learning rate and flags as 0-d tensors equals the step with host values
bit for bit, the program key, the refusal of the CPU, the loop's timing
buckets, and on the card (``cuda`` marker; skipped elsewhere) the graphed
step and frame against the eager ones and the launch counters. The
comparison with the JAX package's jitted step is in
``tests/test_torch_training.py``.

Nothing here imports JAX, so on the card the file runs without the suite's
conftest:

    python -m pytest tests/test_torch_graphs.py -m cuda --noconftest -q
"""

import dataclasses
import inspect
import logging
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.models import optimizer as to
from easy_gaussian_splatting_torch.ops import rasterize_tiled
from easy_gaussian_splatting_torch.training import graphs
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.training.config import config_from_dict

H, W = 32, 48
CAP, N = 64, 60
NAMES = tg.PARAM_NAMES
CFG = dict(
    renderer="tiled", tile_size=16, white_background=True, lambda_ssim=0.2,
    sh_degree=3, sh_degree_interval=0, data_device_cache=False, dataloader_workers=0,
)
# (do_stats, skip_all, skip_opac): the four inside the refine window, and
# a step outside it
FLAGS = [(True, False, False), (True, True, False), (True, False, True), (True, True, True),
         (False, False, False)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def scene_arrays(rng, cap=CAP, n=N, h=H, w=W):
    """An SH-3 model of ``n`` Gaussians in a ``cap``-slot buffer, a camera
    looking at it and a target image (numpy)."""
    arrays = dict(
        means=rng.uniform(-0.8, 0.8, size=(cap, 3)).astype(np.float32),
        log_scales=rng.uniform(-3.0, -1.8, size=(cap, 3)).astype(np.float32),
        quats=rng.normal(size=(cap, 4)).astype(np.float32),
        sh_0=rng.normal(0.0, 0.8, size=(cap, 1, 3)).astype(np.float32),
        sh_rest=rng.normal(0.0, 0.2, size=(cap, 15, 3)).astype(np.float32),
        logit_opacities=rng.normal(0.0, 1.5, size=(cap,)).astype(np.float32),
    )
    alive = np.arange(cap) < n
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.05, -0.1, 4.0]
    K = np.array([[45.0 * w / W, 0, w / 2], [0, 45.0 * w / W, h / 2], [0, 0, 1]], np.float32)
    image = rng.uniform(size=(h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    return arrays, alive, w2c, K, image, mask


def torch_state(arrays, alive, device, adam_rng=None):
    """Model and Adam state on ``device``; Adam moments from ``adam_rng``
    (three steps taken) or zeros."""
    cap = alive.shape[0]
    model = tg.GaussianModelState(
        params=tg.params_from_numpy(arrays, device),
        alive=torch.as_tensor(alive, device=device),
        stats=tg.DensifyStats(*(torch.as_tensor(np.random.default_rng(i).uniform(
            0, 2, size=cap).astype(np.float32), device=device) for i in range(3))),
    )
    if adam_rng is None:
        return model, to.init_adam_state(model.params)
    mu = {k: adam_rng.normal(0, 1e-3, size=v.shape).astype(np.float32) for k, v in arrays.items()}
    nu = {k: adam_rng.uniform(0, 1e-5, size=v.shape).astype(np.float32) for k, v in arrays.items()}
    adam = to.AdamState(
        mu=tg.params_from_numpy(mu, device), nu=tg.params_from_numpy(nu, device),
        steps={k: torch.tensor(3, dtype=torch.int32, device=device) for k in NAMES},
    )
    return model, adam


def leaves(model, adam, ld=None):
    out = {f"param.{k}": getattr(model.params, k) for k in NAMES}
    out["alive"] = model.alive
    out.update({f"stats.{f.name}": getattr(model.stats, f.name)
                for f in dataclasses.fields(tg.DensifyStats)})
    out.update({f"mu.{k}": getattr(adam.mu, k) for k in NAMES})
    out.update({f"nu.{k}": getattr(adam.nu, k) for k in NAMES})
    out.update({f"steps.{k}": adam.steps[k] for k in NAMES})
    out.update({f"loss.{k}": v for k, v in (ld or {}).items()})
    return out


def assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


# ---------------------------------------------------------- tensor flags
@pytest.mark.parametrize("flags", FLAGS)
def test_tensor_flags_equal_host_flags_bit_for_bit(rng, flags):
    """The step with ``lr_means`` and the flags as 0-d tensors (the captured
    step's inputs) gives the bits of the step with host values: ``where``
    picks one of two values exactly."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    step = ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg))
    frame = [torch.as_tensor(x) for x in (w2c, K, image, mask)]
    kw = dict(height=H, width=W, sh_degree=3)
    host = step(*torch_state(arrays, alive, "cpu", np.random.default_rng(1)), *frame,
                1e-3, *flags, **kw)
    dev = step(*torch_state(arrays, alive, "cpu", np.random.default_rng(1)), *frame,
               torch.tensor(1e-3), *(torch.tensor(f) for f in flags), **kw)
    assert_bitwise(leaves(*dev), leaves(*host))
    # a skipped group keeps its parameter, moments and step count
    model0, adam0 = torch_state(arrays, alive, "cpu", np.random.default_rng(1))
    do_stats, skip_all, skip_opac = flags
    for k in NAMES:
        skipped = skip_all or (skip_opac and k == "logit_opacities")
        assert torch.equal(getattr(dev[0].params, k), getattr(model0.params, k)) == skipped, k
        assert int(dev[1].steps[k]) == (3 if skipped else 4), k
    assert torch.equal(dev[0].stats.collecting_counts, model0.stats.collecting_counts) != do_stats


@pytest.mark.parametrize("flags", FLAGS)
def test_in_place_step_equals_new_tensors_bit_for_bit(rng, flags):
    """The step with ``in_place`` (the captured program's: it writes into
    its donated buffers) gives the bits of the step that returns new
    tensors, and the state it returns is the tensors it was given."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    step = ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg))
    frame = [torch.as_tensor(x) for x in (w2c, K, image, mask)]
    scalars = [torch.tensor(1e-3)] + [torch.tensor(f) for f in flags]
    kw = dict(height=H, width=W, sh_degree=3)
    want = step(*torch_state(arrays, alive, "cpu", np.random.default_rng(1)), *frame,
                *scalars, **kw)
    model, adam = torch_state(arrays, alive, "cpu", np.random.default_rng(1))
    given = leaves(model, adam)
    got = step(model, adam, *frame, *scalars, **kw, in_place=True)
    assert_bitwise(leaves(*got), leaves(*want))
    for k, t in leaves(got[0], got[1]).items():
        assert t is given[k], k


def test_in_place_step_with_every_update_skipped_keeps_the_state(rng):
    """The graphed step's warm-up: the in-place step with every group's
    update skipped and no statistics taken writes each tensor of the state
    with its own bits."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    step = ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg))
    frame = [torch.as_tensor(x) for x in (w2c, K, image, mask)]
    model, adam = torch_state(arrays, alive, "cpu", np.random.default_rng(1))
    want = {k: v.clone() for k, v in leaves(model, adam).items()}
    step(model, adam, *frame, torch.tensor(1e-3), torch.tensor(False), torch.tensor(True),
         torch.tensor(True), height=H, width=W, sh_degree=3, in_place=True)
    assert_bitwise(leaves(model, adam), want)


# ----------------------------------------------------------- the program key
SIGNATURE_FIELDS = {
    "capacity": 1, "height": 1, "width": 1, "sh_degree": 1,
    "isect_mult": 0.5, "ov_frac": 0.125, "small_budget": 2, "tile_size": 16,
    "max_tiles": 2, "renderer": None, "BWD_REDUCE": None, "BINNING_IMPL": None,
}


@pytest.mark.parametrize("field", list(SIGNATURE_FIELDS))
def test_step_signature_changes_with_each_field(field, monkeypatch):
    cfg = config_from_dict(CFG)
    args = dict(capacity=1024, height=H, width=W, sh_degree=3)
    base = graphs.step_signature(cfg, **args)
    assert base == graphs.step_signature(config_from_dict(CFG), **args)
    if field in args:
        args[field] += SIGNATURE_FIELDS[field]
    elif field == "renderer":
        cfg.renderer = "ref"
    elif field == "BWD_REDUCE":
        monkeypatch.setattr(rasterize_tiled, "BWD_REDUCE", "pallas")
    elif field == "BINNING_IMPL":
        monkeypatch.setattr(rasterize_tiled, "BINNING_IMPL", "xla")
    else:
        setattr(cfg, field, getattr(cfg, field) + SIGNATURE_FIELDS[field])
    assert graphs.step_signature(cfg, **args) != base


def test_step_signature_ignores_the_learning_rates_and_flags():
    """The learning rates, flags and the rest of the schedule are the
    program's inputs or the host loop's: no field of the key."""
    assert list(inspect.signature(graphs.step_signature).parameters) == [
        "cfg", "capacity", "height", "width", "sh_degree"]
    cfg = config_from_dict(CFG)
    base = graphs.step_signature(cfg, 1024, H, W, 3)
    for name in ("means_lr_init", "means_lr_final", "log_scales_lr", "quats_lr", "sh_0_lr",
                 "sh_rest_lr", "logit_opacities_lr", "refine_start", "refine_every",
                 "reset_opacities_every"):
        changed = dataclasses.replace(cfg, **{name: getattr(cfg, name) * 2 + 1})
        assert graphs.step_signature(changed, 1024, H, W, 3) == base, name


def _mesh(shape, backend="nccl"):
    """A stand-in for a ``parallel.mesh.Mesh``: its axes, shape and backend."""
    from easy_gaussian_splatting_torch.parallel.mesh import parse_mesh_shape

    sizes = parse_mesh_shape(shape)
    return SimpleNamespace(axis_names=tuple(sizes), shape=tuple(sizes.values()), backend=backend)


def test_graph_signature_changes_with_the_batch_and_the_mesh():
    """A graphed step's key is ``step_signature``'s plus the batch size and
    the mesh (its axes and shape, the stripe partition and interleave): each
    changes the key, and the same values give the same key."""
    cfg = config_from_dict(CFG)
    args = (cfg, 1024, H, W, 3)
    single = graphs.graph_signature(*args)
    assert single[:-2] == graphs.step_signature(*args) and single[-2:] == (0, None)
    keys = [single, graphs.graph_signature(*args, batch=4), graphs.graph_signature(*args, batch=2)]
    for shape in ("tiles:1", "tiles:2", "gauss:2", "gauss:1,tiles:2", "gauss:2,tiles:1"):
        key = graphs.graph_signature(*args, mesh=_mesh(shape))
        assert key == graphs.graph_signature(*args, mesh=_mesh(shape)), shape
        keys.append(key)
    for name, value in (("stripe_partition", "uniform"), ("stripe_interleave", 2)):
        assert getattr(cfg, name) != value
        keys.append(graphs.graph_signature(dataclasses.replace(cfg, **{name: value}), 1024, H, W,
                                           3, mesh=_mesh("tiles:2")))
    assert len(set(keys)) == len(keys), keys


def test_graphed_programs_refuse_the_cpu_and_gloo():
    """The batched and sharded graphed steps and ``Programs`` run on the card
    only, and a gloo mesh is refused wherever it runs (its collectives wait
    on the host)."""
    cfg = config_from_dict(CFG)
    render_fn = ttrainer.get_render_fn(cfg)
    batched = ttrainer.make_batched_train_step(cfg, render_fn)
    sharded = ttrainer.make_mesh_train_step(cfg, _mesh("tiles:2"), render_fn)
    with pytest.raises(ValueError, match="CUDA device only"):
        graphs.GraphedTrainStep(cfg, batched, "cpu")
    with pytest.raises(ValueError, match="CUDA device only"):
        graphs.GraphedTrainStep(cfg, sharded, "cpu", mesh=_mesh("tiles:2"))
    with pytest.raises(ValueError, match="CUDA device only"):
        graphs.Programs("cpu", 2, "the eval's frame program")
    with pytest.raises(ValueError, match="a gloo world cannot be captured"):
        graphs.GraphedTrainStep(cfg, sharded, "cuda", mesh=_mesh("gauss:2", "gloo"))


# ------------------------------------------------------------- the CPU
def test_graphed_step_and_render_refuse_the_cpu():
    """A graph runs on the card only: on the CPU both raise, never falling
    back to the eager function in silence."""
    from easy_gaussian_splatting_torch.viewer.integration import GraphedRender, make_gs_render_func

    cfg = config_from_dict(CFG)
    render_fn = ttrainer.get_render_fn(cfg)
    with pytest.raises(ValueError, match="CUDA device only"):
        graphs.GraphedTrainStep(cfg, ttrainer.make_train_step(cfg, render_fn), "cpu")
    with pytest.raises(ValueError, match="CUDA device only"):
        GraphedRender(lambda mult: render_fn, torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA device only"):
        graphs.Captured(lambda: None, "cpu")
    # the closure on the CPU is the eager one
    closure = make_gs_render_func(lambda: None, lambda: 0, torch.zeros(3), render_fn)
    assert closure.graphed is None


def test_train_on_the_cpu_runs_the_eager_step(rng, monkeypatch):
    """``train()`` on the CPU never builds a graphed step."""
    def refuse(*a, **k):
        raise AssertionError("GraphedTrainStep built on the CPU")

    monkeypatch.setattr(ttrainer, "GraphedTrainStep", refuse)
    loop = _train_tiny(rng, total_iterations=2)
    assert loop.step == 2


class _OneCameraScene:
    def __init__(self, xyzs, rgbs, frame, n_train):
        self.pc = SimpleNamespace(xyzs=xyzs, rgbs=rgbs, nbr_points=xyzs.shape[0])
        self.frame, self.n = frame, n_train

    def nbr_data(self, split):
        return self.n if split == "train" else 0

    def get_data(self, split, index):
        return dict(self.frame)


def _train_tiny(rng, **sched):
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    xyzs = rng.uniform(-0.6, 0.6, size=(N, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(N, 3)).astype(np.uint8)
    frame = dict(K=K, height=H, width=W, w2c=w2c, image=image, mask=mask)
    cfg = config_from_dict(dict(CFG, refine_start=0, refine_every=1000,
                                reset_opacities_every=1000, initial_capacity=CAP, **sched))
    random.seed(0)
    return ttrainer.train(cfg, scene=_OneCameraScene(xyzs, rgbs, frame, cfg.total_iterations),
                          device="cpu")


def test_loop_timing_logs_the_buckets(rng, monkeypatch, caplog):
    """``EGS_TORCH_LOOP_TIMING=1`` logs the JAX trainer's wall-time buckets
    every 100 steps, per step."""
    monkeypatch.setenv("EGS_TORCH_LOOP_TIMING", "1")
    with caplog.at_level(logging.INFO, logger="easy_gaussian_splatting_torch"):
        _train_tiny(rng, total_iterations=100, renderer="ref")
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("loop timing (per step over last 100): ")]
    assert len(lines) == 1, lines
    for name in ("data", "dispatch", "loss_sync", "ckpt", "eval", "densify", "other", "total"):
        assert f" {name}=" in lines[0], (name, lines[0])


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph captures and replays only there")
    return torch.device("cuda")


def _five_steps(step_fn, model, adam, frame, cfg, device):
    """Five steps in the refine window, a densify event after step 3 (whose
    growth changes the capacity) and an opacity reset after step 4; each
    step's state and loss dict, copied."""
    from easy_gaussian_splatting_torch.models.density import reset_opacities

    loop = ttrainer.TrainLoopState(model=model, adam=adam, active_sh_degree=3)
    gen = torch.Generator(device=device).manual_seed(0)
    densify = ttrainer.make_densify_step(cfg)
    out = []
    for i in range(1, 6):
        loop.model, loop.adam, ld = step_fn(
            loop.model, loop.adam, *frame, 1e-3 / i, True, i == 4, i == 5,
            height=H, width=W, sh_degree=3)
        out.append({k: v.clone() for k, v in leaves(loop.model, loop.adam, ld).items()})
        if i == 3:
            ttrainer.run_densify_with_growth(loop, densify, gen, cfg)
        if i == 4:
            loop.model, loop.adam = reset_opacities(loop.model, loop.adam, cfg.min_opacity)
    return out


@pytest.mark.cuda
def test_graphed_step_equals_eager(cuda, rng):
    """Five steps with a densify event that grows the capacity (a second
    capture) and an opacity reset: every step's state and loss dict bit for
    bit equal to the eager step's, and two captures logged."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(dict(CFG, densify_grad_thresh=0.0, max_capacity=4 * CAP))
    render_fn = ttrainer.get_render_fn(cfg)
    frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
    want = _five_steps(ttrainer.make_train_step(cfg, render_fn),
                       *torch_state(arrays, alive, cuda), frame, cfg, cuda)
    graphed = graphs.GraphedTrainStep(cfg, ttrainer.make_train_step(cfg, render_fn), cuda)
    got = _five_steps(graphed, *torch_state(arrays, alive, cuda), frame, cfg, cuda)
    assert got[-1]["param.means"].shape[0] > CAP, "the densify event did not grow the capacity"
    for i, (g, w) in enumerate(zip(got, want)):
        assert_bitwise(g, w)
    assert [c["key"][0] for c in graphed.captures] == [CAP, got[-1]["param.means"].shape[0]]
    assert all(c["capture_ms"] > 0 and c["pool_bytes"] >= 0 for c in graphed.captures)


@pytest.mark.cuda
def test_replay_adds_the_recorded_launches(cuda, rng):
    """A replay runs no wrapper, so the step adds the launches its capture
    recorded: one of each main-path kernel a step, as an eager step."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
    graphed = graphs.GraphedTrainStep(
        cfg, ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg)), cuda)
    model, adam = torch_state(arrays, alive, cuda)
    kw = dict(height=H, width=W, sh_degree=3)
    before = graphs.launch_counts()
    model, adam, _ = graphed(model, adam, *frame, 1e-3, True, False, False, **kw)
    first = [a - b for a, b in zip(graphs.launch_counts(), before)]
    # the capture's call: the warm-up calls' launches and the replay's
    assert first[:4] == [graphs.WARMUP_CALLS + 1] * 4, first
    before = graphs.launch_counts()
    graphed(model, adam, *frame, 1e-3, True, False, False, **kw)
    delta = [a - b for a, b in zip(graphs.launch_counts(), before)]
    assert delta == list(graphed.program.launches) and delta[:4] == [1, 1, 1, 1], delta


@pytest.mark.cuda
def test_graphed_frame_equals_eager(cuda, rng):
    """The served closure on the card replays a captured render per size:
    its image equals the eager render's bit for bit, also after the model
    is swapped for another of its capacity (copied into the programs'
    model) and for one of another capacity (a new capture)."""
    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.viewer.camera import CameraState
    from easy_gaussian_splatting_torch.viewer.integration import make_gs_render_func

    cfg = config_from_dict(CFG)
    render_fn = ttrainer.get_render_fn(cfg)
    bg = torch.ones(3, device=cuda)
    holder = {}
    closure = make_gs_render_func(lambda: holder["state"], lambda: 3, bg, render_fn)
    assert closure.graphed is not None
    for cap, seed in ((CAP, 0), (CAP, 1), (2 * CAP, 2)):
        arrays, alive, w2c, K, _, _ = scene_arrays(np.random.default_rng(seed), cap=cap)
        holder["state"], _ = torch_state(arrays, alive, cuda)
        for h, w in ((H, W), (2 * H, 2 * W)):
            Ks = K.copy()
            Ks[:2] *= h / H
            got = closure(CameraState(w2c, Ks, w, h))
            cam = CameraView(w2c=torch.as_tensor(w2c, device=cuda),
                             K=torch.as_tensor(Ks, device=cuda), width=w, height=h)
            st = holder["state"]
            want = render_fn(st.params, st.alive, cam, 3, bg).image.cpu().numpy()
            assert got.shape == (h, w, 3) and np.array_equal(got, want), (cap, seed, h)
    assert len(closure.graphed.captures) == 4  # two sizes at each capacity


def _frame_at(w2c, K, rng, h, w, device):
    """The camera at an ``h`` x ``w`` frame (focal scaled with the size) and
    a target image of that size, on ``device``."""
    Ks = K.copy()
    Ks[:2] *= h / H
    image = rng.uniform(size=(h, w, 3)).astype(np.float32)
    return [torch.as_tensor(x, device=device)
            for x in (w2c, Ks, image, np.zeros((h, w), np.float32))]


@pytest.mark.cuda
def test_graphed_step_keeps_a_program_per_frame_size(cuda, rng):
    """Frames of two sizes in turn: one capture for each size, kept over the
    same state buffers (no capture again when a size comes back), and every
    step bit for bit the eager step's."""
    arrays, alive, w2c, K, _, _ = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    render_fn = ttrainer.get_render_fn(cfg)
    sizes = [(H, W), (2 * H, 2 * W)]
    frames = [_frame_at(w2c, K, np.random.default_rng(i), h, w, cuda)
              for i, (h, w) in enumerate(sizes)]

    def run(step_fn):
        model, adam = torch_state(arrays, alive, cuda)
        out = []
        for i in range(6):
            h, w = sizes[i % 2]
            model, adam, ld = step_fn(model, adam, *frames[i % 2], 1e-3, True, False, False,
                                      height=h, width=w, sh_degree=3)
            out.append({k: v.clone() for k, v in leaves(model, adam, ld).items()})
        return out

    want = run(ttrainer.make_train_step(cfg, render_fn))
    graphed = graphs.GraphedTrainStep(cfg, ttrainer.make_train_step(cfg, render_fn), cuda)
    got = run(graphed)
    for g, w in zip(got, want):
        assert_bitwise(g, w)
    assert [c["key"][1:3] for c in graphed.captures] == sizes


@pytest.mark.cuda
def test_graphed_frame_leaves_the_caller_state_alone(cuda, rng):
    """Two states of one capacity served in turn: each frame equals the
    eager render of its state, and neither state's tensors change (the
    programs read a model set of their own). With ``donated`` the set is
    the first state's tensors, by reference."""
    from easy_gaussian_splatting_torch.models.render import CameraView
    from easy_gaussian_splatting_torch.viewer.camera import CameraState
    from easy_gaussian_splatting_torch.viewer.integration import make_gs_render_func

    cfg = config_from_dict(CFG)
    render_fn = ttrainer.get_render_fn(cfg)
    bg = torch.ones(3, device=cuda)
    states = []
    for seed in (0, 1):
        arrays, alive, w2c, K, _, _ = scene_arrays(np.random.default_rng(seed))
        states.append(torch_state(arrays, alive, cuda)[0])
    copies = [{k: v.clone() for k, v in leaves(st, to.init_adam_state(st.params)).items()}
              for st in states]
    cam = CameraView(w2c=torch.as_tensor(w2c, device=cuda), K=torch.as_tensor(K, device=cuda),
                     width=W, height=H)
    holder = {}
    closure = make_gs_render_func(lambda: holder["state"], lambda: 3, bg, render_fn)
    for i in (0, 1, 0, 1):
        holder["state"] = states[i]
        got = closure(CameraState(w2c, K, W, H))
        want = render_fn(states[i].params, states[i].alive, cam, 3, bg).image.cpu().numpy()
        assert np.array_equal(got, want), i
    for st, copy in zip(states, copies):
        assert_bitwise(leaves(st, to.init_adam_state(st.params)), copy)
    assert closure.graphed.model[0].data_ptr() != states[0].params.means.data_ptr()
    donated = make_gs_render_func(lambda: states[0], lambda: 3, bg, render_fn, donated=True)
    donated(CameraState(w2c, K, W, H))
    assert donated.graphed.model[0] is states[0].params.means
