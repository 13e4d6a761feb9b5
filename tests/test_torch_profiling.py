"""Profiling and the port's spans (``utils/profiling.py``): ``trace(logdir)``
writes a Chrome trace of the enclosed work; ``span()`` enters no
``record_function`` with no profiler running and records one inside a
profiler window; the viewer's render closure and ``train()``'s loop write
their spans into the trace; ``time_spans`` sums them on the host clock.
On the card (``cuda`` marker; skipped elsewhere) the graphed step's and
frame's spans nest as the benchmark reads them, and the launch counters
still equal the profiler's kernels.

Nothing here imports JAX, so on the card the file runs without the suite's
conftest:

    python -m pytest tests/test_torch_profiling.py -m cuda --noconftest -q
"""

import json

import numpy as np
import pytest
import torch
from test_torch_graphs import CFG, CAP, H, W, _train_tiny, scene_arrays, torch_state

from easy_gaussian_splatting_torch.training import graphs
from easy_gaussian_splatting_torch.training import trainer as ttrainer
from easy_gaussian_splatting_torch.training.config import config_from_dict
from easy_gaussian_splatting_torch.utils import profiling as tprof
from easy_gaussian_splatting_torch.viewer.camera import CameraState
from easy_gaussian_splatting_torch.viewer.integration import make_gs_render_func

LOOP_SPANS = ["train.loop." + k for k in ("data", "dispatch", "loss_sync", "ckpt", "eval",
                                          "densify", "other")]
# the launch counters (graphs.launch_counts) and their kernels' symbols, in order
KERNEL_SYMBOLS = ("binkeys_kernel", "tile_forward_kernel", "tile_backward_kernel",
                  "segsum_band_kernel", "segsum_compact_kernel", "monotone_expand_kernel",
                  "group_reduce_kernel")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _profiled(fn, path, cuda=False):
    """``fn()`` under ``torch.profiler`` (CPU activity, and the card's with
    ``cuda``); the Chrome trace's complete events, written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _spans(events, prefix):
    """(name, start, end) of the ``user_annotation`` events named from
    ``prefix``, in time order."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _closure(device, rng):
    """The served render closure over a tiny SH-3 state on ``device``, as
    ``launch_viewer`` builds it (the binning sized per frame size), and a
    camera of the state's frame size."""
    arrays, alive, w2c, K, _, _ = scene_arrays(rng)
    state, _ = torch_state(arrays, alive, device)
    cfg = config_from_dict(CFG)
    bg = torch.ones(3, device=device)
    closure = make_gs_render_func(lambda: state, lambda: 3, bg, ttrainer.get_render_fn(cfg),
                                  cfg=cfg, base_pixels=H * W)
    return closure, CameraState(w2c, K, W, H)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "profile") as window:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert window.path == tmp_path / "profile" / "trace.json"
    events = json.loads(window.path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)


def test_span_enters_no_record_function_without_a_profiler(monkeypatch, rng):
    """With no profiler running a span is the one shared null context, and
    the render closure's spans run without ``record_function``."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(tprof, "record_function", refuse)
    assert tprof.span("serve.render") is tprof.span("train.step")
    with tprof.span("train.step"):
        pass
    closure, cam = _closure("cpu", rng)
    assert closure(cam).shape == (H, W, 3)


def test_span_records_under_the_profiler_and_times_into_the_totals(tmp_path):
    """Inside a profiler window a span is a ``user_annotation`` of its name;
    while ``time_spans`` is on, its host-clock duration adds to its name's
    total, with or without a profiler, and off again the totals are None."""
    totals = tprof.time_spans(True)
    try:
        with tprof.span("train.loop.data"):
            pass

        def work():
            with tprof.span("train.loop.data"):
                torch.ones(8) + 1
            with tprof.span("serve.render"):
                pass

        events = _profiled(work, tmp_path / "trace.json")
        assert set(totals) == {"train.loop.data", "serve.render"}
        assert totals["train.loop.data"] > 0 and totals["serve.render"] >= 0
    finally:
        assert tprof.time_spans(False) is None
    assert [s[0] for s in _spans(events, ("train.", "serve."))] == ["train.loop.data",
                                                                     "serve.render"]
    with tprof.span("train.loop.data"):
        pass
    assert set(totals) == {"train.loop.data", "serve.render"}  # off: nothing added


def test_cpu_render_closure_records_its_spans(tmp_path, rng):
    """The eager closure on the CPU under the profiler: ``serve.to_host``
    (the image read back) inside ``serve.render``, one of each a frame."""
    closure, cam = _closure("cpu", rng)
    events = _profiled(lambda: [closure(cam) for _ in range(2)], tmp_path / "trace.json")
    spans = _spans(events, "serve.")
    renders = [s for s in spans if s[0] == "serve.render"]
    to_host = [s for s in spans if s[0] == "serve.to_host"]
    assert len(renders) == 2 and len(to_host) == 2, spans
    assert all(_inside(t, r) for t, r in zip(to_host, renders))


def test_train_profile_window_holds_the_loop_spans(tmp_path, rng):
    """A tiny CPU ``train()`` with ``profile_steps`` and ``output`` writes
    ``profile/trace.json``, in which step 11, inside the window, shows the
    loop's spans one after another in the loop's order."""
    _train_tiny(rng, total_iterations=12, profile_steps=2, output=str(tmp_path),
                renderer="ref")
    path = tmp_path / "profile" / "trace.json"
    assert path.exists()
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    names = [s[0] for s in _spans(events, "train.loop.")]
    assert set(names) == set(LOOP_SPANS), names
    first = names.index("train.loop.data")
    assert names[first:first + len(LOOP_SPANS)] == LOOP_SPANS, names
    loop = _spans(events, "train.loop.")
    assert all(a[2] <= b[1] for a, b in zip(loop, loop[1:])), "the loop's spans overlap"


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph captures and replays only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_step_and_frame_spans_nest(cuda, rng, tmp_path):
    """A replayed ``GraphedTrainStep`` call and a graphed frame under the
    profiler: ``train.step`` holds ``train.copy_in`` and ``train.replay``;
    ``serve.render`` holds ``serve.take``, ``serve.copy_in``,
    ``serve.replay``, ``serve.wait`` and ``serve.to_host``, in that order;
    and the port's kernels the profiler saw equal the launch counters'
    increments (the profiler loses records in a few windows in a hundred:
    at most three windows)."""
    arrays, alive, w2c, K, image, mask = scene_arrays(rng)
    cfg = config_from_dict(CFG)
    frame = [torch.as_tensor(x, device=cuda) for x in (w2c, K, image, mask)]
    step = graphs.GraphedTrainStep(
        cfg, ttrainer.make_train_step(cfg, ttrainer.get_render_fn(cfg)), cuda)
    holder = {}
    holder["model"], holder["adam"] = torch_state(arrays, alive, cuda)

    def train_step():
        holder["model"], holder["adam"], _ = step(
            holder["model"], holder["adam"], *frame, 1e-3, False, False, False,
            height=H, width=W, sh_degree=3)

    closure, cam = _closure(cuda, np.random.default_rng(1))

    def work():
        train_step()
        closure(cam)
        torch.cuda.synchronize()

    work()  # the captures
    for attempt in range(3):
        before = graphs.launch_counts()
        events = _profiled(work, tmp_path / f"trace{attempt}.json", cuda=True)
        counted = [a - b for a, b in zip(graphs.launch_counts(), before)]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        seen = [sum(sym in k for k in kernels) for sym in KERNEL_SYMBOLS]
        if seen == counted:
            break
    assert seen == counted and counted[:4] == [2, 2, 1, 1], (seen, counted)
    assert len(step.captures) == 1 and step.captures[0]["key"][0] == CAP
    spans = _spans(events, ("train.", "serve."))
    outer = {s[0]: s for s in spans if s[0] in ("train.step", "serve.render")}
    assert set(outer) == {"train.step", "serve.render"}, spans
    inner = {name: [s[0] for s in spans if s is not outer[name] and _inside(s, outer[name])]
             for name in outer}
    assert inner["train.step"] == ["train.copy_in", "train.replay"], spans
    assert inner["serve.render"] == ["serve.take", "serve.copy_in", "serve.replay",
                                     "serve.wait", "serve.to_host"], spans
