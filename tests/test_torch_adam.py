"""Grouped Adam as one kernel (``ops/kernels/adam.py``, ``csrc/adam.cu``):
on the CPU ``adam_update``'s results against the bits it gave before the
kernel (a stored digest), the wrapper's checks, its block table, the C
descriptor's layout, the build flags and the launch counters' order; on
the card (``cuda`` marker; skipped elsewhere) the kernel against
``adam_plain`` bit for bit, its bias corrections at every step count
below 65,536 among them, and its launches in a captured step.

Nothing here imports JAX, so on the card the file runs without the suite's
conftest:

    python -m pytest tests/test_torch_adam.py -m cuda --noconftest -q
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch
from test_torch_graphs import CFG, H, W, scene_arrays, torch_state

from easy_gaussian_splatting_torch.models import optimizer as to
from easy_gaussian_splatting_torch.models.gaussians import PARAM_NAMES, GaussianParams
from easy_gaussian_splatting_torch.ops.kernels import _build
from easy_gaussian_splatting_torch.ops.kernels import adam as ka
from easy_gaussian_splatting_torch.training import graphs
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.training.config import config_from_dict

# the train cells' step counts (tandt_db_densify's, the others') and a few
# early ones, one a group
STEPS = (0, 1, 9, 999, 12_636, 14_927)
# trailing shapes of the six groups at SH degree 3
SHAPES = {"means": (3,), "log_scales": (3,), "quats": (4,), "sh_0": (1, 3), "sh_rest": (15, 3),
          "logit_opacities": ()}
# one skip a group: a device flag on and off, a host bool on and off, none
SKIP_KINDS = {
    "mixed": ("dev_on", "dev_off", "host_on", "host_off", "none", "dev_on"),
    "none": ("none",) * 6,
    "device_on": ("dev_on",) * 6,
    "host_on": ("host_on",) * 6,
}


# sha256 of the leaves (by sorted name) of an update none of whose groups
# is skipped, from ``_state(37, "cpu", seed=1)`` at any ``_lrs`` kind, as
# ``adam_update`` gave them before the kernel (a float learning rate and a
# 0-d one give the same bits)
CPU_UPDATE_SHA256 = "5e0e13980383858ab2930fb74856dff6af6f408607878a886df54ed668170e6e"


def _state(slots: int, device, seed: int = 0, offset: int = 0):
    """Parameters, gradients and an Adam state of ``slots`` slots at SH
    degree 3 on ``device``, seeded; step counts ``STEPS``. With ``offset``
    every buffer starts that many floats into its storage (contiguous, not
    16-byte aligned)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(scale, shape, positive=False):
        n = int(np.prod((slots,) + shape))
        x = torch.rand if positive else torch.randn
        flat = x(n + offset, generator=gen, device=device) * scale
        return flat[offset:].view((slots,) + shape)

    params = GaussianParams(**{k: draw(1.0, s) for k, s in SHAPES.items()})
    grads = GaussianParams(**{k: draw(1e-2, s) for k, s in SHAPES.items()})
    mu = GaussianParams(**{k: draw(1e-3, s) for k, s in SHAPES.items()})
    nu = GaussianParams(**{k: draw(1e-5, s, positive=True) for k, s in SHAPES.items()})
    steps = {k: torch.tensor(s, dtype=torch.int32, device=device)
             for k, s in zip(PARAM_NAMES, STEPS)}
    return params, grads, to.AdamState(mu=mu, nu=nu, steps=steps)


def _skips(kind: str, device):
    out = {}
    for name, k in zip(PARAM_NAMES, SKIP_KINDS[kind]):
        if k == "none":
            continue
        on = k.endswith("_on")
        out[name] = torch.tensor(on, device=device) if k.startswith("dev") else on
    return out


def _lrs(kind: str, device):
    lrs = {name: 1e-3 * (i + 1) for i, name in enumerate(PARAM_NAMES)}
    if kind == "tensor":
        lrs = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in lrs.items()}
    elif kind == "means_tensor":  # the train step's: the schedule's 0-d tensor for the means
        lrs["means"] = torch.tensor(lrs["means"], dtype=torch.float32, device=device)
    return lrs


def _clone(params, grads, state):
    c = lambda t: t.map(torch.clone)  # noqa: E731
    return c(params), c(grads), to.AdamState(
        mu=c(state.mu), nu=c(state.nu), steps={k: v.clone() for k, v in state.steps.items()})


def _leaves(params, state):
    out = {f"param.{k}": getattr(params, k) for k in PARAM_NAMES}
    out.update({f"mu.{k}": getattr(state.mu, k) for k in PARAM_NAMES})
    out.update({f"nu.{k}": getattr(state.nu, k) for k in PARAM_NAMES})
    out.update({f"steps.{k}": state.steps[k] for k in PARAM_NAMES})
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _digest(leaves: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(leaves):
        h.update(k.encode())
        h.update(leaves[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("skips", list(SKIP_KINDS))
@pytest.mark.parametrize("lrs", ["float", "tensor", "means_tensor"])
def test_adam_update_on_the_cpu_is_unchanged(in_place, skips, lrs):
    """On the CPU ``adam_update`` takes ``adam_plain``: with no group
    skipped its results are the bits it gave before the kernel (the stored
    digest); with skips, each group skipped keeps its inputs' bits and each
    other group has those results, in place or not, for each learning rate
    kind; the launch counter stays put; a group a host bool skips returns
    its own tensors, and in place every result is the buffer it was
    written into."""
    params, grads, state = _state(37, "cpu", seed=1)
    skip, lr = _skips(skips, "cpu"), _lrs(lrs, "cpu")
    before = ka.launches
    full = _leaves(*to.adam_update(*_clone(params, grads, state), lr))
    assert _digest(full) == CPU_UPDATE_SHA256
    inputs = _leaves(params, state)
    kept = {k: v.clone() for k, v in inputs.items()}
    got_params, got_state = to.adam_update(params, grads, state, lr, skip, in_place)
    assert ka.launches == before
    got = _leaves(got_params, got_state)
    skipped = {name for name, k in zip(PARAM_NAMES, SKIP_KINDS[skips]) if k.endswith("_on")}
    assert_bitwise(got, {k: kept[k] if k.split(".")[1] in skipped else full[k] for k in full})
    for key, x in got.items():
        name = key.split(".")[1]
        host_skip = skip.get(name) is True
        if in_place or host_skip:
            assert x is inputs[key], key


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_adam_update_makes_view_gradients_contiguous(device):
    """The sharded steps' gradients are column views of one buffer: the
    update takes them as their values, bit for bit ``adam_plain`` on the
    views (on the card the kernel, which takes contiguous buffers only)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Adam kernel runs only there")
    params, grads, state = _state(29, device, seed=2)
    width = sum(int(np.prod(s)) for s in SHAPES.values())
    packed = torch.randn(29, width, generator=torch.Generator().manual_seed(3)).to(device)
    views, col = {}, 0
    for name, shape in SHAPES.items():
        w = int(np.prod(shape))
        views[name] = packed[:, col:col + w].reshape((29,) + shape)
        col += w
    grads = GaussianParams(**views)
    assert not grads.means.is_contiguous()
    lr = _lrs("means_tensor", device)
    want = _leaves(*ka.adam_plain(*_clone(params, grads, state), lr))
    assert_bitwise(_leaves(*to.adam_update(params, grads, state, lr)), want)


@pytest.mark.parametrize("case", ["dtype", "device", "shape", "contiguous", "step", "lr", "skip"])
def test_wrapper_checks_its_inputs(case):
    """What the kernel does not take raises before a launch."""
    params, grads, state = _state(11, "cpu")
    p, g, mu, nu = params.means, grads.means, state.mu.means, state.nu.means
    step, lr, skip, device = state.steps["means"], 1e-3, False, torch.device("cpu")
    if case == "dtype":
        g = g.double()
    elif case == "device":
        device = torch.device("cuda", 0)  # CPU tensors on a card's call
    elif case == "shape":
        mu = mu[:10]
    elif case == "contiguous":
        nu = torch.zeros(3, 11).t()
    elif case == "step":
        step = step.to(torch.int64)
    elif case == "lr":
        lr = torch.tensor(1e-3, dtype=torch.float64)
    else:
        skip = torch.tensor(0, dtype=torch.uint8)
    with pytest.raises(ValueError, match="adam"):
        ka._check("means", device, p, g, mu, nu, step, lr, skip)


@pytest.mark.parametrize("lengths", [
    [393_216 * 3, 393_216 * 3, 393_216 * 4, 393_216 * 3, 393_216 * 45, 393_216],
    [3003, 0, 5, 4096, 4097, 1],
    [0, 0, 8191, 3, 12_289, 0],
])
def test_block_table_covers_every_value_once(lengths):
    """The wrapper's block offsets give a group of n values ceil(n / 4096)
    blocks, in order; walked as the kernel walks them (a block's group the
    last whose first block is at or before it, its float4s, then the
    group's ragged end) every value of every group is updated once."""
    starts, total = ka.block_table(lengths)
    blocks = [-(-n // ka.BLOCK_VALUES) for n in lengths]
    assert total == sum(blocks)
    assert starts == [sum(blocks[:i]) for i in range(len(lengths))]
    if total > 2000:
        return
    threads, items = 256, 4
    assert threads * items * 4 == ka.BLOCK_VALUES
    seen = [np.zeros(n, np.int64) for n in lengths]
    tid = np.arange(threads)
    for b in range(total):
        k = max(i for i in range(len(lengths)) if starts[i] <= b)
        n = lengths[k]
        first = (b - starts[k]) * ka.BLOCK_VALUES
        end = min(first + ka.BLOCK_VALUES, n)
        n4 = n >> 2
        for item in range(items):
            j = (first >> 2) + item * threads + tid
            j = j[j < n4]
            for lane in range(4):
                np.add.at(seen[k], 4 * j + lane, 1)
        tail = max(n4 << 2, first)
        for i in range(tail, end):
            seen[k][i] += 1
    assert all((s == 1).all() for s in seen)


def test_group_descriptor_mirrors_the_c_struct():
    """``_Group`` is ``EgsAdamGroup`` of ``csrc/adam.cu``: ten pointers, two
    64-bit counts, a float and its pad, in that order (104 bytes)."""
    fields = [name for name, _ in ka._Group._fields_]
    assert fields == ["p", "g", "mu", "nu", "p_out", "mu_out", "nu_out", "lr", "skip", "step",
                      "n", "block0", "lr_value", "pad"]
    assert ctypes.sizeof(ka._Group) == 104
    assert ka._Group.n.offset == 80 and ka._Group.lr_value.offset == 96
    src = (_build.SRC_DIR / "adam.cu").read_text()
    body = src[src.index("struct EgsAdamGroup {"):]
    body = body[:body.index("};")]
    order = [line.split(";")[0].split()[-1].lstrip("*") for line in body.splitlines()[1:]
             if ";" in line]
    assert order == fields


def test_adam_builds_through_build_py():
    """The kernel builds like the others, without FMA contraction (its
    results are the plain version's bits)."""
    assert _build.EXTRA_FLAGS["adam"] == ("--fmad=false",)
    assert (_build.SRC_DIR / "adam.cu").exists()
    assert _build._lib_path("adam").name.startswith("libadam-")


def test_adam_counter_follows_the_main_path_counters():
    """Readers zip the first seven counters with their kernels' names, so
    the Adam kernel's counter comes after them (and after the SH colour's)."""
    names = [(mod.__name__.rsplit(".", 1)[-1], attr) for mod, attr in graphs._counters()]
    assert names[:7] == [
        ("binkeys", "launches"), ("tile_raster", "launches"), ("tile_raster", "backward_launches"),
        ("segments", "launches"), ("segments", "compact_launches"),
        ("segments", "expand_launches"), ("group_reduce", "launches"),
    ]
    assert names[-1] == ("adam", "launches")
    assert len(graphs.launch_counts()) == len(names)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Adam kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("slots,offset", [(393_216, 0), (3_145_728, 0), (1001, 0), (1001, 1)])
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("skips", list(SKIP_KINDS))
@pytest.mark.parametrize("lrs", ["float", "means_tensor", "tensor"])
def test_kernel_matches_plain(cuda, slots, offset, in_place, skips, lrs):
    """One launch against ``adam_plain`` on the same CUDA tensors, bit for
    bit: parameters, moments and step counts, at the train cells' slot
    counts and an odd one (ragged ends; with ``offset`` 1 no buffer is
    16-byte aligned), the groups at step counts 0 to 14,927, each skip
    kind, in place and not, the learning rates floats or 0-d tensors. A
    group skipped in place keeps its buffers' bits; one launch a call,
    none when a host bool skips every group."""
    params, grads, state = _state(slots, cuda, seed=slots + offset, offset=offset)
    skip, lr = _skips(skips, cuda), _lrs(lrs, cuda)
    want = _leaves(*ka.adam_plain(*_clone(params, grads, state), lr, skip, in_place))
    kept = {k: v.clone() for k, v in _leaves(params, state).items()}
    before = ka.launches
    got_params, got_state = ka.adam_step(params, grads, state, lr, skip, in_place)
    torch.cuda.synchronize()
    assert ka.launches == before + (0 if skips == "host_on" else 1)
    got = _leaves(got_params, got_state)
    assert_bitwise(got, want)
    if not in_place:  # the inputs are left as they were
        assert_bitwise(_leaves(params, state), kept)
    for name, k in zip(PARAM_NAMES, SKIP_KINDS[skips]):
        if in_place and k.endswith("_on"):
            for key in (f"param.{name}", f"mu.{name}", f"nu.{name}", f"steps.{name}"):
                assert torch.equal(_bits(got[key]), _bits(kept[key])), key


@pytest.mark.cuda
def test_kernel_bias_corrections_at_every_step_count(cuda):
    """The kernel's ``1 - beta^t`` comes from ``powf``, the plain
    version's from ``torch.pow``: one slot's groups, six step counts a
    launch, through every step count below 65,536 (past it both are 1 in
    float32), every parameter, moment and step count bit for bit
    ``adam_plain``'s."""
    params, grads, state = _state(1, cuda, seed=5)
    lr = _lrs("means_tensor", cuda)
    got, want = [], []
    for first in range(0, 65_536, len(PARAM_NAMES)):
        steps = {k: torch.tensor(min(first + i, 65_535), dtype=torch.int32, device=cuda)
                 for i, k in enumerate(PARAM_NAMES)}
        start = to.AdamState(mu=state.mu, nu=state.nu, steps=steps)
        got.append(torch.cat([x.reshape(-1).view(torch.int32) for x in
                              _leaves(*ka.adam_step(params, grads, start, lr)).values()]))
        want.append(torch.cat([x.reshape(-1).view(torch.int32) for x in
                               _leaves(*ka.adam_plain(params, grads, start, lr)).values()]))
    assert torch.equal(torch.stack(got), torch.stack(want))


@pytest.mark.cuda
def test_captured_step_launches_once_a_replay(cuda):
    """A captured train step holds one Adam launch: its capture's call
    counts the warm-up calls' and the replay's, each later replay one."""
    rng = np.random.default_rng(0)
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
    graphed = graphs.GraphedTrainStep(
        cfg, ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg)), cuda)
    model, adam = torch_state(arrays, alive, cuda, adam_rng=rng)
    kw = dict(height=H, width=W, sh_degree=3)
    before = ka.launches
    model, adam, _ = graphed(model, adam, *frame, 1e-3, True, False, False, **kw)
    assert ka.launches == before + graphs.WARMUP_CALLS + 1
    for skip_all in (False, True, False):
        before = ka.launches
        model, adam, _ = graphed(model, adam, *frame, 1e-3, True, skip_all, False, **kw)
        assert ka.launches == before + 1
    assert len(graphed.captures) == 1
