"""The readers of the program's spans (metrics/_spans.py and the six
metrics on it): the window's requests taken from the end of the log, each
reader's arithmetic on a log built by hand, nothing read from a program that
keeps no spans, and a traced run of each cell reporting its span metrics."""
import math

import pytest

from benchmark import harness
from nnc_tpu_torch.utils import profiling
import _tiny

BENCH = harness.benchmark_json()
SPAN_METRICS = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
                if m["source"] == "program_span"}
MS = 1_000_000


def build(items):
    """Spans from (name, start ms, end ms, position of the parent or None,
    counts, is a request), in the order they opened."""
    out = []
    for i, (name, a, b, parent, counts, is_request) in enumerate(items):
        par = None if parent is None else out[parent]
        request = i if is_request else (par.request if par else None)
        out.append(profiling.Span(name, i, par.index if par else None,
                                  request, int(a * MS), int(b * MS),
                                  dict(counts)))
    return out


def lsa_call(items, t0, steps, host_ms, shuffle_ms=0.0):
    """One nnc.lsa.call at ``t0`` ms whose steps start ``host_ms`` in, with
    a reshuffle of ``shuffle_ms`` inside its batches; 10 ms of steps and
    1 ms of readback."""
    c = len(items)
    items.append(("nnc.lsa.call", t0, t0 + host_ms + 11, None,
                  {"steps": steps, "rays": 1024 * steps}, True))
    items.append(("nnc.lsa.batches", t0, t0 + shuffle_ms + 1, c, {}, False))
    if shuffle_ms:
        items.append(("nnc.rays.shuffle", t0 + 0.5, t0 + 0.5 + shuffle_ms,
                      c + 1, {"rays": 4096}, False))
    for name in ("nnc.lsa.pack", "nnc.lsa.draws", "nnc.lsa.upload"):
        items.append((name, t0 + host_ms - 1, t0 + host_ms - 0.5, c, {},
                      False))
    items.append(("nnc.lsa.steps", t0 + host_ms, t0 + host_ms + 10, c, {},
                  False))
    items.append(("nnc.lsa.readback", t0 + host_ms + 10, t0 + host_ms + 11,
                  c, {}, False))


def lsa_log():
    """Step 1 and a call of 8 compared, then a window of three calls of 8
    (host 4, 6 and 9 ms; the last holds a 50 ms reshuffle)."""
    items = [("nnc.rays.shuffle", 0, 40, None, {"rays": 4096}, False)]
    lsa_call(items, 100, 1, 30)
    lsa_call(items, 200, 8, 3)
    lsa_call(items, 300, 8, 4)
    lsa_call(items, 400, 8, 6)
    lsa_call(items, 500, 8, 9 + 50, shuffle_ms=50)
    return build(items)


def frame_log(n):
    """n frames: frame i at 100 i ms, launched in 3 + i ms, waiting 30 ms,
    copying 2 + i ms; a stray frame-path span outside any request first."""
    items = [("nnc.frame.select", 0, 1, None, {}, False)]
    for i in range(n):
        t, f = 100 * i, len(items)
        launch, copy = 3 + i, 2 + i
        items.append(("nnc.frame", t, t + launch + 30 + copy, None,
                      {"rays": 160_000}, True))
        for j, name in enumerate(("nnc.frame.select", "nnc.frame.sort",
                                  "nnc.frame.kb2", "nnc.frame.unpack")):
            items.append((name, t + j * launch / 4, t + (j + 1) * launch / 4,
                          f, {}, False))
        items.append(("nnc.frame.wait", t + launch, t + launch + 30, f, {},
                      False))
        items.append(("nnc.frame.copy", t + launch + 30,
                      t + launch + 30 + copy, f, {}, False))
    return build(items)


def view_log(durations):
    items = []
    for i, d in enumerate(durations):
        v = len(items)
        items.append(("nnc.render.view", 400 * i, 400 * i + d, None,
                      {"rays": 160_000}, True))
        for j in range(5):
            items.append(("nnc.render.chunk", 400 * i + j * d / 5,
                          400 * i + (j + 1) * d / 5, v, {"rays": 32_768},
                          False))
    return build(items)


@pytest.fixture
def spans(monkeypatch):
    """Hand the readers a log built by hand."""
    def use(records):
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return use


def read(metric, requests):
    return harness.module("metrics", metric).read(
        {"trace": None, "counts": {"requests": requests}, "peak": {}})


def test_window_takes_the_trailing_requests(spans):
    from benchmark.metrics import _spans
    log = lsa_log()
    spans(log)
    ctx = lambda n: {"counts": {"requests": n}}
    calls, children = _spans.window(ctx(24), "nnc.lsa.call", by_steps=True)
    assert [c.start_ns // MS for c in calls] == [300, 400, 500]
    assert [s.name for s in children[calls[0].index]][-1] == \
        "nnc.lsa.readback"
    assert [c.start_ns // MS for c in _spans.window(
        ctx(33), "nnc.lsa.call", by_steps=True)[0]] == [100, 200, 300, 400,
                                                        500]
    for n in (20, 34, 0):       # no trailing calls sum to it; too few
        assert _spans.window(ctx(n), "nnc.lsa.call", by_steps=True) is None
    spans(frame_log(4))
    frames, _children = _spans.window(ctx(3), "nnc.frame")
    assert [f.start_ns // MS for f in frames] == [100, 200, 300]
    assert _spans.window(ctx(5), "nnc.frame") is None
    spans([])
    assert _spans.window(ctx(1), "nnc.frame") is None


def test_readers_on_a_log_built_by_hand(spans):
    spans(lsa_log())
    # the window's calls reach their steps after 4, 6 and 59 ms
    assert read("lsa_host_ms", 24) == pytest.approx(6.0, abs=1e-6)
    assert read("lsa_host_ms.pool", 24) == pytest.approx(6.0, abs=1e-6)
    # 50 ms of reshuffle in the window's 300 to 570 ms; the 40 ms at the
    # pool's build lies outside every call
    assert read("reshuffle_share.lsa_pool", 24) == \
        pytest.approx(100 * 50 / 270, rel=1e-9)
    assert read("reshuffle_share.lsa_pool", 16) == \
        pytest.approx(100 * 50 / 170, rel=1e-9)
    spans(frame_log(5))
    # the last 3 frames launch in 5, 6, 7 ms and copy in 4, 5, 6 ms
    assert read("frame_launch_ms", 3) == pytest.approx(6.0, abs=1e-6)
    assert read("frame_copy_ms", 3) == pytest.approx(5.0, abs=1e-6)
    spans(view_log([9.0, 3.0, 5.0, 4.0]))
    assert read("render_launch_ms", 3) == pytest.approx(4.0, abs=1e-6)
    assert read("render_launch_ms", 4) == pytest.approx(4.5, abs=1e-6)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_readers_read_nothing_without_spans(monkeypatch, metric):
    """A program from before the span log, or with an empty one: None, no
    exception."""
    monkeypatch.delattr(profiling, "spans")
    assert read(metric, 8) is None
    monkeypatch.setattr(profiling, "spans", lambda: [], raising=False)
    assert read(metric, 8) is None


@pytest.mark.parametrize("cell", sorted(_tiny.SIZES))
def test_traced_runs_report_the_span_metrics(cell):
    line = _tiny.line(cell, trace=True)
    assert line["correct"]
    wanted = {m for m, cells in SPAN_METRICS.items() if cell in cells}
    assert wanted
    for m in wanted:
        value = line["metrics"][m]["value"]
        assert math.isfinite(value) and value >= 0, (m, value)
    if cell == "lego.lsa":
        assert "lsa_call_ms_p95" in line["metrics"]
