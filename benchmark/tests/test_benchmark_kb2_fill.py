"""kb2_fill.frame's reader on span logs built by hand: the window's frames'
filled slots over the points their K-B2 spans computed, every K-B2 span of
a frame counted (a frame of two row chunks has two); None where a span
carries no counts (the render pass before the packed one) or no point was
computed."""
import pytest

from benchmark import harness
from nnc_tpu_torch.utils import profiling
from test_benchmark_spans import build


def frames(counts):
    """One frame a 100 ms for each entry of ``counts``: a list of the
    counts of its K-B2 spans (one a row chunk); a stray K-B2 span outside
    any frame first."""
    items = [("nnc.frame.kb2", 0, 1, None, {"slots": 1, "points": 1000},
              False)]
    for i, chunks in enumerate(counts):
        t, f = 100 * i, len(items)
        items.append(("nnc.frame", t, t + 40, None, {"rays": 160_000},
                      True))
        for j, c in enumerate(chunks):
            items.append(("nnc.frame.kb2", t + 2 * j, t + 2 * j + 1, f, c,
                          False))
        items.append(("nnc.frame.wait", t + 10, t + 30, f, {}, False))
    return build(items)


def read(monkeypatch, records, requests):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return harness.module("metrics", "kb2_fill.frame").read(
        {"trace": None, "counts": {"requests": requests}, "peak": {}})


def test_kb2_fill_reads_the_windows_slots_over_points(monkeypatch):
    log = frames([[{"slots": 10, "points": 640}],
                  [{"slots": 600, "points": 640}],
                  [{"slots": 300, "points": 320},
                   {"slots": 40, "points": 64}]])
    assert read(monkeypatch, log, 2) == pytest.approx(
        100 * 940 / 1024, rel=1e-12)
    assert read(monkeypatch, log, 3) == pytest.approx(
        100 * 950 / 1664, rel=1e-12)
    assert read(monkeypatch, log, 4) is None   # more frames than the log


def test_kb2_fill_reads_none_without_the_counts(monkeypatch):
    plain = frames([[{}], [{}]])
    assert read(monkeypatch, plain, 2) is None
    half = frames([[{"slots": 5, "points": 64}], [{"slots": 5}]])
    assert read(monkeypatch, half, 2) is None
    empty = frames([[{"slots": 0, "points": 0}]])
    assert read(monkeypatch, empty, 1) is None
