"""The refine-event programs over the live state (``training/graphs.py``'s
``GraphedTrainStep.replay``, ``training/trainer.py``'s ``densify_event``,
``reset_event`` and ``counted_isects``, ``parallel/gauss_shard.py``'s
graphed sharded densify) and the capture ahead of need
(``training/precompile.py``).

On the CPU: the precompiler's trigger rule against the JAX trainer's
(``easy_gaussian_splatting_tpu/training/trainer.py:1128-1170``), case by
case; ``StepPrecompiler`` refusing the CPU; the split noise drawn into a
buffer equal to the generator's path; the densify and reset programs'
bodies over buffers equal to the eager functions, bit for bit, and their
warm-up calls leaving the state's bits; the growth into given buffers. On
the card (``cuda`` marker; skipped elsewhere), each graphed against eager,
bit for bit: the densify program at two capacities with an overflow
retry, the reset program, both counters, the sharded densify in an NCCL
world of one rank, a signature captured ahead against one captured at
first use, a retune's programs dropped at the next step and not before,
and ``train()``'s eval peak memory below the copy the evaluator used to
keep.

Nothing here imports JAX, so on the card the file runs without the suite's
conftest:

    python -m pytest tests/test_torch_graphs_refine.py -m cuda --noconftest -q
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_graphs import CFG, NAMES, H, W, assert_bitwise, leaves, scene_arrays, torch_state

from easy_gaussian_splatting_torch.models import density as td
from easy_gaussian_splatting_torch.models import gaussians as tg
from easy_gaussian_splatting_torch.training import graphs, precompile
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.training.config import config_from_dict

CAP = 64


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ------------------------------------------------------ the trigger rule
# (nbr_gaussians, capacity, active SH, sh_degree_interval, refine_every,
# max_capacity, sh_degree) -> what the JAX trainer warms after a densify
# event (trainer.py:1128-1157): the next doubling when nbr > 0.55 capacity
# and capacity < max, at min(2 capacity, max); the active degree, and the
# next one when interval != 0, active < sh_degree and interval <= 2 *
# refine_every
GROWTH_CASES = [
    # at 0.55 exactly: not above it, nothing
    ((550, 1000, 0, 1000, 100, 4000, 3), []),
    # above it: the doubling at the active degree (interval 1000 > 200)
    ((551, 1000, 0, 1000, 100, 4000, 3), [(2000, 0)]),
    # interval <= 2 refine_every: the next degree too
    ((900, 1000, 1, 200, 100, 4000, 3), [(2000, 1), (2000, 2)]),
    ((900, 1000, 1, 201, 100, 4000, 3), [(2000, 1)]),
    # the top degree: no next one
    ((900, 1000, 3, 200, 100, 4000, 3), [(2000, 3)]),
    # no SH schedule (interval 0): the active degree only
    ((900, 1000, 3, 0, 100, 4000, 3), [(2000, 3)]),
    # the doubling clamped to max_capacity
    ((2000, 3000, 0, 1000, 100, 4000, 3), [(4000, 0)]),
    # at max_capacity: nothing
    ((3999, 4000, 0, 100, 100, 4000, 3), []),
]


@pytest.mark.parametrize("case,want", GROWTH_CASES)
def test_growth_targets_follow_the_jax_rule(case, want):
    n, cap, active, interval, every, max_cap, degree = case
    cfg = config_from_dict(dict(CFG, sh_degree_interval=interval, refine_every=every,
                                max_capacity=max_cap, sh_degree=degree))
    assert precompile.growth_targets(cfg, n, cap, active) == want


# (step, active SH, sh_degree_interval, sh_degree) -> whether the JAX
# trainer warms the next degree at the state's capacity (trainer.py:
# 1159-1169): interval != 0, active < sh_degree and step % interval ==
# max(1, interval - 60)
SH_CASES = [
    ((940, 0, 1000, 3), True),  # 1000 - 60
    ((1940, 2, 1000, 3), True),
    ((941, 0, 1000, 3), False),
    ((1000, 0, 1000, 3), False),  # the bump itself
    ((940, 3, 1000, 3), False),  # at the top degree
    ((1, 0, 50, 3), True),  # a short interval: step % 50 == 1
    ((51, 1, 50, 3), True),
    ((50, 1, 50, 3), False),
    ((1, 0, 0, 3), False),  # no SH schedule
]


@pytest.mark.parametrize("case,want", SH_CASES)
def test_sh_bump_due_follows_the_jax_rule(case, want):
    step, active, interval, degree = case
    cfg = config_from_dict(dict(CFG, sh_degree_interval=interval, sh_degree=degree))
    assert precompile.sh_bump_due(cfg, step, active) is want


# (population after the event before, after this one, capacity) -> whether
# the next event is expected to grow the capacity: this one's population
# plus its net gain (none for a loss) above 0.85 of the capacity, where
# the trainer's event grows it; train() allocates the grown state and
# captures its program only then
NEAR_CASES = [
    ((1000, 1100, 2000), False),  # 1200
    ((1000, 1350, 2000), False),  # 1700: at 0.85, not above it
    ((1000, 1351, 2000), True),  # 1702
    ((1200, 1100, 1500), False),  # a net loss: 1100 against 1275
    ((1300, 1280, 1500), True),  # past 0.85 already
    ((1000, 1000, 1200), False),  # no gain: 1000 against 1020
]


@pytest.mark.parametrize("case,want", NEAR_CASES)
def test_growth_near_predicts_the_next_events_growth(case, want):
    before, after, cap = case
    assert precompile.growth_near(before, after, cap) is want


def test_step_precompiler_refuses_the_cpu():
    """The capture ahead runs on the card only: on the CPU the precompiler
    raises, as the graphed step it serves does."""
    with pytest.raises(ValueError, match="CUDA device only"):
        precompile.StepPrecompiler(SimpleNamespace(device=torch.device("cpu")))


# ------------------------------------------- the programs' bodies (CPU)
DCFG = td.DensifyConfig(densify_grad_thresh=0.0015, densify_scale_thresh=0.5, num_splits=2,
                        prune_radii_ratio_thresh=0.15, prune_scale_thresh=1.0, min_opacity=0.005)


def _event_state(rng, overflows: bool):
    """A state at capacity ``CAP`` whose refine event splits four, clones
    four and prunes three (with ``overflows`` every slot alive and
    densified)."""
    arrays, alive, *_ = scene_arrays(rng)
    arrays["log_scales"][:20] = np.log(0.8)  # big: these split
    arrays["logit_opacities"][40:43] = -8.0  # low opacity: pruned
    alive = np.ones(CAP, bool) if overflows else np.arange(CAP) < 50
    model, adam = torch_state(arrays, alive, "cpu", np.random.default_rng(1))
    grads = model.stats.grad_norm_accum
    if overflows:
        grads.fill_(1.0)
    else:
        grads.zero_()
        grads[0:4] = grads[30:34] = 1.0
    return model, adam


def test_noise_drawn_into_a_buffer_equals_the_generator_path(rng):
    """The graphed event's split noise, drawn eagerly from the run's
    generator into a buffer, gives the event the generator gives it
    itself, bit for bit (so ``test_densify_and_prune_matches_jax`` holds
    the graphed event too)."""
    model, adam = _event_state(rng, False)
    want = td.densify_and_prune(model, adam, torch.Generator().manual_seed(5), DCFG)
    buf = torch.empty((CAP, 3))
    buf.copy_(torch.randn((CAP, 3), generator=torch.Generator().manual_seed(5),
                          dtype=torch.float32))
    got = td.densify_and_prune(model, adam, None, DCFG, noise=buf)
    assert_bitwise(leaves(*got[:2]), leaves(*want[:2]))
    assert {k: int(v) for k, v in got[2].items()} == {k: int(v) for k, v in want[2].items()}
    assert bool(got[3]) == bool(want[3])


@pytest.mark.parametrize("overflows,keep", [(False, False), (True, False), (True, True)])
def test_densify_event_over_buffers_equals_eager(rng, overflows, keep):
    """The refine program's body run on buffers (write true): it returns the
    overflow flag and the counts of the eager event and leaves in the
    buffers the eager event's state, bit for bit, or, on an overflow below
    the largest capacity (``keep`` false), the pre-event state."""
    model, adam = _event_state(rng, overflows)
    noise = torch.randn((CAP, 3), generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in leaves(model, adam).items()}
    new_model, new_adam, info, overflow = td.densify_and_prune(model, adam, None, DCFG,
                                                               noise=noise)
    assert bool(overflow) == overflows
    bufs = [noise] + graphs.state_leaves(model, adam)
    vals = ttrainer.densify_event(DCFG, keep)(bufs, torch.tensor(True))
    assert vals.tolist() == [int(overflow)] + [int(info[k]) for k in ttrainer.INFO_KEYS]
    want = leaves(new_model, new_adam) if (not overflows or keep) else before
    assert_bitwise(leaves(model, adam), want)


def test_densify_and_reset_warmups_leave_the_state(rng):
    """A program's warm-up calls (write false) run on the live state: each
    buffer keeps its bits."""
    model, adam = _event_state(rng, False)
    before = {k: v.clone() for k, v in leaves(model, adam).items()}
    noise = torch.randn((CAP, 3), generator=torch.Generator().manual_seed(2))
    ttrainer.densify_event(DCFG, False)([noise] + graphs.state_leaves(model, adam),
                                        torch.tensor(False))
    ttrainer.reset_event(0.005)(graphs.state_leaves(model, adam), torch.tensor(False))
    assert_bitwise(leaves(model, adam), before)


def test_reset_event_over_buffers_equals_eager(rng):
    """The reset program's body writes the eager reset's opacities and
    opacity moments into the buffers, bit for bit, and nothing else."""
    model, adam = _event_state(rng, False)
    want_model, want_adam = td.reset_opacities(model, adam, 0.005)
    want = {k: v.clone() for k, v in leaves(want_model, want_adam).items()}
    ttrainer.reset_event(0.005)(graphs.state_leaves(model, adam), torch.tensor(True))
    assert_bitwise(leaves(model, adam), want)


def test_grow_into_buffers_equals_grow(rng):
    """``grow_state`` into given buffers (the state prepared ahead) gives the
    bits of the growth into new tensors, step counts included, and fills
    every row of the buffers."""
    model, adam = torch_state(*scene_arrays(rng)[:2], "cpu", np.random.default_rng(1))
    want = graphs.grow_state(model, adam, 2 * CAP)
    out = graphs.state_from([torch.full_like(t, 7) for t in graphs.state_leaves(*want)])
    got = graphs.grow_state(model, adam, 2 * CAP, out)
    assert all(a is b for a, b in zip(graphs.state_leaves(*got), graphs.state_leaves(*out)))
    assert_bitwise(leaves(*got), leaves(*want))
    assert torch.equal(got[0].params.quats[CAP:], torch.tensor([[1.0, 0, 0, 0]]).expand(CAP, 4))


def test_scatter_set_drops_out_of_range_entries():
    """The capture-safe scatter: in-range entries set, out-of-range ones
    (negative or past the end) dropped, the base untouched."""
    base = torch.arange(6)
    idx = torch.tensor([4, -1, 6, 0, 9])
    got = td._scatter_set(base, idx, torch.tensor([40, 41, 42, 43, 44]))
    assert got.tolist() == [43, 1, 2, 3, 40, 5] and base.tolist() == [0, 1, 2, 3, 4, 5]
    assert td._scatter_set(torch.zeros(3, dtype=torch.bool), torch.tensor([2, 3]),
                           True).tolist() == [False, False, True]


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph captures and replays only there")
    return torch.device("cuda")


def _step(cfg, device, mesh=None):
    render_fn = ttrainer.get_render_fn(cfg)
    step = (ttrainer.make_train_step(cfg, render_fn) if mesh is None
            else ttrainer.make_mesh_train_step(cfg, mesh, render_fn))
    return graphs.GraphedTrainStep(cfg, step, device, mesh=mesh)


def _events(densify_step, model, adam, cfg, device, grow, events=3):
    """``events`` refine events in a row from the same generator; each
    event's counts and state, copied."""
    loop = ttrainer.TrainLoopState(model=model, adam=adam, active_sh_degree=3)
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for _ in range(events):
        info = ttrainer.run_densify_with_growth(loop, densify_step, gen, cfg, grow)
        out.append((info, {k: v.clone() for k, v in leaves(loop.model, loop.adam).items()}))
    return out


@pytest.mark.cuda
def test_graphed_densify_equals_eager_with_an_overflow_retry(cuda, rng):
    """Three refine events from every slot densified: the first overflows at
    capacity 64 and retries at 128 (two capacities, two captures), the
    later ones overflow at the largest capacity, keep their state and
    replay; counts and states bit for bit the eager events'."""
    arrays, alive, *_ = scene_arrays(rng)
    cfg = config_from_dict(dict(CFG, densify_grad_thresh=0.0, max_capacity=2 * CAP))
    want = _events(ttrainer.make_densify_step(cfg), *torch_state(arrays, alive, cuda), cfg,
                   cuda, graphs.grow_state)
    graphed = _step(cfg, cuda)
    got = _events(ttrainer.make_densify_step(cfg, graphed), *torch_state(arrays, alive, cuda),
                  cfg, cuda, graphed.grown)
    for (gi, g), (wi, w) in zip(got, want):
        assert gi == wi
        assert_bitwise(g, w)
    caps = [c["key"][1] for c in graphed.programs.captures if c["key"][0] == "densify"]
    assert caps == [CAP, 2 * CAP], caps
    assert graphed.state[0].shape[0] == got[-1][1]["param.means"].shape[0]


@pytest.mark.cuda
def test_a_retune_drops_the_programs_at_the_next_step(cuda, rng):
    """After ``use`` (a binning retune) the refine event of the same
    iteration replays the program it has; the next step drops every program
    and captures first, into a fresh pool, and the event after it captures
    again."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(dict(CFG, densify_grad_thresh=1e9))  # no growth
    frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
    graphed = _step(cfg, cuda)
    densify_step = ttrainer.make_densify_step(cfg, graphed)
    gen = torch.Generator(device=cuda).manual_seed(0)
    loop = ttrainer.TrainLoopState(*torch_state(arrays, alive, cuda), active_sh_degree=3)

    def step():
        loop.model, loop.adam, _ = graphed(loop.model, loop.adam, *frame, 1e-3, True, False,
                                           False, height=H, width=W, sh_degree=3)

    def kinds():
        return [graphs._kind(c["key"]) for c in graphed.programs.captures]

    step()
    ttrainer.run_densify_with_growth(loop, densify_step, gen, cfg, graphed.grown)
    assert kinds() == [None, "densify"]
    pool = graphed.programs.pool
    graphed.use(ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg)))
    ttrainer.run_densify_with_growth(loop, densify_step, gen, cfg, graphed.grown)
    assert kinds() == [None, "densify"] and graphed.programs.pool is pool
    step()
    assert kinds() == [None, "densify", None] and list(graphed.programs.entries) == [
        graphed.signature]
    assert graphed.programs.pool is not pool
    ttrainer.run_densify_with_growth(loop, densify_step, gen, cfg, graphed.grown)
    assert kinds() == [None, "densify", None, "densify"]


@pytest.mark.cuda
def test_graphed_reset_equals_eager(cuda, rng):
    """The opacity reset twice (a capture, then a replay) over the step's
    buffers, in place: bit for bit the eager reset's state."""
    arrays, alive, *_ = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    model, adam = torch_state(arrays, alive, cuda, np.random.default_rng(1))
    eager = ttrainer.make_reset_step(cfg)
    want = eager(*eager(model, adam))
    graphed = _step(cfg, cuda)
    reset = ttrainer.make_reset_step(cfg, graphed)
    model, adam = torch_state(arrays, alive, cuda, np.random.default_rng(1))
    given = graphs.state_leaves(*graphed.own(model, adam))
    got = reset(*reset(model, adam))
    assert_bitwise(leaves(*got), leaves(*want))
    assert all(a is b for a, b in zip(graphs.state_leaves(*got), given))


@pytest.mark.cuda
def test_graphed_counter_equals_eager(cuda, rng):
    """The intersection counter as a program over the step's state, read
    twice (a capture, then a replay on another camera): the eager
    counter's counts."""
    from easy_gaussian_splatting_torch.ops.rasterize_tiled import make_isect_counter

    arrays, alive, w2c, K, *_ = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    counter = make_isect_counter(cfg.tile_size, cfg.max_tiles, cfg.max_tiles, ov_frac=cfg.ov_frac,
                                 small_budget=cfg.small_budget)
    model, adam = torch_state(arrays, alive, cuda)
    graphed = _step(cfg, cuda)
    graphed.own(model, adam)
    for shift in (0.0, 0.1):
        cam = torch.as_tensor(w2c, device=cuda).clone()
        cam[0, 3] += shift
        k = torch.as_tensor(K, device=cuda)
        want = counter(model.params, model.alive, cam, k, height=H, width=W)
        got = ttrainer.counted_isects(graphed, counter, cfg, cam, k, height=H, width=W)
        assert torch.equal(got, want), (got, want)
    assert len([c for c in graphed.programs.captures if c["key"][0] == "isects"]) == 1


@pytest.mark.cuda
def test_nccl_world_of_one_graphed_sharded_densify_and_striped_counter(cuda, rng):
    """An NCCL world of one rank: the sharded densify (an overflow retry, then
    replays) and the striped counter as programs over the graphed sharded
    step's state, bit for bit the eager ones."""
    import torch.distributed as dist
    from torch_parallel_worker import free_port

    from easy_gaussian_splatting_torch.parallel import distributed
    from easy_gaussian_splatting_torch.parallel.gauss_shard import make_sharded_densify_step
    from easy_gaussian_splatting_torch.parallel.mesh import mesh_from_shape
    from easy_gaussian_splatting_torch.parallel.shard import make_striped_isect_counter

    distributed.initialize(f"tcp://localhost:{free_port()}", 1, 0, device=cuda,
                           backend="nccl", timeout_s=120)
    try:
        mesh = mesh_from_shape("gauss:1", cuda)
        arrays, alive, w2c, K, *_ = scene_arrays(rng)
        cfg = config_from_dict(dict(CFG, densify_grad_thresh=0.0, max_capacity=2 * CAP,
                                    mesh_shape="gauss:1"))
        dcfg = ttrainer._dcfg(cfg)

        def run(graphed):
            model, adam = torch_state(arrays, alive, cuda)
            loop = ttrainer.TrainLoopState(model=model, adam=adam, active_sh_degree=3)
            step = make_sharded_densify_step(dcfg, mesh, graphed, cfg.max_capacity)
            gen = torch.Generator(device=cuda).manual_seed(0)
            out = []
            for _ in range(3):
                info = ttrainer.run_sharded_densify_with_growth(loop, step, gen, cfg, mesh)
                out.append((info, {k: v.clone() for k, v in leaves(loop.model, loop.adam).items()}))
            return out, loop

        want, loop_e = run(None)
        graphed = _step(cfg, cuda, mesh)
        got, loop_g = run(graphed)
        for (gi, g), (wi, w) in zip(got, want):
            assert gi == wi
            assert_bitwise(g, w)
        counter = make_striped_isect_counter(mesh, cfg.tile_size, cfg.max_tiles, cfg.max_tiles,
                                             ov_frac=cfg.ov_frac, small_budget=cfg.small_budget,
                                             interleave=cfg.stripe_interleave,
                                             partition=cfg.stripe_partition)
        cam, k = (torch.as_tensor(x, device=cuda) for x in (w2c, K))
        want_n = counter(loop_e.model.params, loop_e.model.alive, cam, k, height=H, width=W)
        graphed.own(loop_g.model, loop_g.adam)
        got_n = ttrainer.counted_isects(graphed, counter, cfg, cam, k, height=H, width=W,
                                        mesh=mesh)
        assert torch.equal(got_n, want_n), (got_n, want_n)
        densify = [p for key, p in graphed.programs.entries.items() if key[0] == "densify"]
        assert densify and all(sum(p.collectives.values()) == 2 for p in densify)
        graphed.reset()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_signature_captured_ahead_equals_capture_at_first_use(cuda, rng):
    """A step program of the next capacity captured ahead over buffers
    prepared for it (``prepare``), the growth written into them
    (``grown``): the step after the growth replays it, capturing nothing,
    and its state is bit for bit that of a step that captured at first
    use."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
    kw = dict(height=H, width=W, sh_degree=3)
    out = {}
    for ahead in (True, False):
        graphed = _step(cfg, cuda)
        model, adam = torch_state(arrays, alive, cuda, np.random.default_rng(1))
        model, adam, _ = graphed(model, adam, *frame, 1e-3, True, False, False, **kw)
        if ahead:
            assert graphed.prepare(model, adam, *frame, capacity=2 * CAP, **kw)
            assert graphed.prepared() and not graphed.prepare(model, adam, *frame,
                                                              capacity=2 * CAP, **kw)
        model, adam = graphed.grown(model, adam, 2 * CAP)
        n = len(graphed.captures)
        model, adam, ld = graphed(model, adam, *frame, 1e-3, True, False, False, **kw)
        captured = len(graphed.captures) - n
        out[ahead] = (leaves(model, adam, ld), captured, graphed.captures)
    assert_bitwise(out[True][0], out[False][0])
    assert out[True][1] == 0 and out[False][1] == 1
    assert [c["ahead"] for c in out[True][2]] == [False, True]


class _Frames:
    """An eval split of three frames at the test size."""

    def __init__(self, rng):
        arrays, alive, w2c, K, image, mask = scene_arrays(rng)
        self.frame = dict(K=K, height=H, width=W, w2c=w2c, image=image, mask=mask)

    def nbr_data(self, split):
        return 3

    def get_data(self, split, index):
        return dict(self.frame)


@pytest.mark.cuda
def test_train_eval_keeps_no_copy_of_the_model(cuda, rng, monkeypatch):
    """``train()``'s eval with the programs sharing the step's and reading
    the model by reference: its peak device memory (above what was
    allocated before ``train()``) is below the same eval through an
    evaluator that copies the model into a set of its own (the port
    before) by at least the copy, 236 B a slot, at each of three evals."""
    from easy_gaussian_splatting_torch.evaluation import evaluator as tev

    cap = 65536
    n = 60
    xyzs = rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    frames = _Frames(rng)

    class Scene:
        pc = SimpleNamespace(xyzs=xyzs, rgbs=rgbs, nbr_points=n)

        def nbr_data(self, split):
            return 4 if split == "train" else 3

        def get_data(self, split, index):
            return dict(frames.frame)

    cfg_kw = dict(CFG, total_iterations=4, refine_start=1000, eval_every=2, eval_render_num=1,
                  initial_capacity=cap)
    evaluate = tev.Evaluator.evaluate
    peaks = {}
    for mode in ("copy", "shared"):
        seen = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()

        def measured(self, *a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = evaluate(self, *a, **k)
            torch.cuda.synchronize()
            seen.append(torch.cuda.max_memory_allocated() - base)
            return out

        monkeypatch.setattr(tev.Evaluator, "evaluate", measured)
        if mode == "copy":
            init = tev.Evaluator.__init__
            monkeypatch.setattr(tev.Evaluator, "__init__",
                                lambda self, num, fn, programs=None: init(self, num, fn))
        random.seed(0)
        ttrainer.train(config_from_dict(cfg_kw), scene=Scene(), device=cuda)
        monkeypatch.undo()
        peaks[mode] = seen
    clone = 236 * cap
    assert len(peaks["copy"]) == len(peaks["shared"]) == 3, peaks
    for copy, shared in zip(peaks["copy"], peaks["shared"]):
        assert copy - shared >= clone, (peaks, clone)
