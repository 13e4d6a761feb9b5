"""The readers of the program's spans (``metrics/render_idle_ms.serve.py``,
``to_host_ms.serve.py``, ``step_idle_ms.train.py``,
``step_host_ms.train.py``) on hand-made traced windows: what each counts,
and None where the window holds nothing for it.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest

from benchmark import run, trace

SPAN_METRICS = ("render_idle_ms.serve", "to_host_ms.serve", "step_idle_ms.train",
                "step_host_ms.train")


def _read(name: str, window) -> float | None:
    return run.metric_reader(name)(run.Context("cell", "kind", {}, window, []))


def _train_window(complete: bool = True) -> trace.Window:
    """Two traced steps, seconds 0.5-3.5: the device busy 1.0-1.5 and
    2.5-2.75, nothing before 1.0; each step a ``train.step`` inside the
    benchmark's ``train.dispatch``, holding a ``train.copy_in`` and a
    ``train.replay``; one ``train.replay`` outside any step."""
    dev = [("k1", 1.0, 0.5, "kernel"), ("copy", 2.5, 0.25, "gpu_memcpy")]
    spans = [("bench.window", 0.5, 3.0),
             ("train.dispatch", 0.6, 0.9), ("train.step", 0.7, 0.7),
             ("train.copy_in", 0.75, 0.1), ("train.replay", 0.9, 0.3),
             ("train.dispatch", 2.0, 0.8), ("train.step", 2.1, 0.6),
             ("train.copy_in", 2.12, 0.05), ("train.replay", 2.2, 0.2),
             ("train.replay", 3.0, 0.1)]
    return trace.Window(dev, spans, 0.5, 3.5, 2, complete)


def _serve_window(device: bool = True) -> trace.Window:
    """Two traced frames, seconds 0-2: the device busy 0.2-0.5 and 1.2-1.6;
    each frame a ``serve.render`` inside the benchmark's ``serve.frame``,
    holding a ``serve.wait`` and a ``serve.to_host``."""
    dev = [("k1", 0.2, 0.3, "kernel"), ("k2", 1.2, 0.4, "kernel")] if device else []
    spans = [("bench.window", 0.0, 2.0),
             ("serve.frame", 0.0, 0.9), ("serve.render", 0.1, 0.7),
             ("serve.wait", 0.5, 0.1), ("serve.to_host", 0.6, 0.15),
             ("serve.frame", 1.0, 0.9), ("serve.render", 1.1, 0.7),
             ("serve.wait", 1.55, 0.1), ("serve.to_host", 1.65, 0.1)]
    return trace.Window(dev, spans, 0.0, 2.0, 2, True)


def test_step_readers_count_by_hand():
    w = _train_window()
    # idle inside the steps from the first device operation (1.0) on: step
    # one 1.0-1.4 all busy, step two 2.1-2.7 busy 2.5-2.7: 0.4 s over 2 steps
    assert _read("step_idle_ms.train", w) == pytest.approx(200.0)
    # the steps (0.7 + 0.6 s) less the replays nested in them (0.3 + 0.2),
    # not the one outside: 0.8 s over 2 steps
    assert _read("step_host_ms.train", w) == pytest.approx(400.0)
    # the gap before the first device operation goes to the program's
    # innermost span there
    assert w._span_at(0.8) == "train.copy_in" and w._span_at(0.95) == "train.replay"


def test_serve_readers_count_by_hand():
    w = _serve_window()
    # render 0.1-0.8 busy 0.2-0.5 (idle 0.4), render 1.1-1.8 busy 1.2-1.6
    # (idle 0.3): 0.7 s over 2 frames
    assert _read("render_idle_ms.serve", w) == pytest.approx(350.0)
    assert _read("to_host_ms.serve", w) == pytest.approx(125.0)
    # the gap at the first render's start goes to the program's span there,
    # those between renders to the benchmark's
    gaps = [(n, round(g, 6)) for n, g in w.breakdown()["idle_gaps"]]
    assert gaps == [("serve.frame", 0.7), ("serve.frame", 0.4), ("serve.render", 0.2)], gaps


def test_span_readers_find_nothing_to_read():
    """No window, an incomplete one or one with no program span: None from
    every reader; a window with no device operation (the CPU): None from
    the idle readers, the host's spans still read."""
    bench_only = trace.Window([("k1", 1.0, 0.5, "kernel")],
                              [("bench.window", 0.5, 3.0), ("train.dispatch", 0.6, 0.9),
                               ("serve.frame", 1.6, 0.5)], 0.5, 3.5, 2, True)
    for name in SPAN_METRICS:
        assert _read(name, None) is None
        assert _read(name, bench_only) is None, name
    assert all(_read(n, _train_window(complete=False)) is None for n in SPAN_METRICS)
    cpu = _serve_window(device=False)
    assert _read("render_idle_ms.serve", cpu) is None
    assert _read("to_host_ms.serve", cpu) == pytest.approx(125.0)
    no_device = trace.Window([], _train_window().spans, 0.5, 3.5, 2, True)
    assert _read("step_idle_ms.train", no_device) is None
    assert _read("step_host_ms.train", no_device) == pytest.approx(400.0)
