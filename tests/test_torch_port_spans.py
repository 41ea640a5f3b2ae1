"""The port's span facility (utils/profiling: span, request, spans) and the
spans at its layer boundaries, on the CPU at tiny sizes: nothing recorded
with the profiler off; nesting, request ids, counts and the bounded log with
it on; each record inside its record_function event on the profiler's own
clock; and the spans of tune_lsa_scales, RayBatcher's pool, render_image
and render_image_fast against what those calls count themselves."""
import collections
import math

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from nnc_tpu_torch.data import rays as trays
from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.render import occupancy, renderer
from nnc_tpu_torch.render.rays import get_rays_np
from nnc_tpu_torch.train import lsa
from nnc_tpu_torch.utils import profiling

MLP = nerf.NeRFConfig(W=32)
LSA_CALL = ["nnc.lsa.batches", "nnc.lsa.pack", "nnc.lsa.draws",
            "nnc.lsa.upload", "nnc.lsa.steps", "nnc.lsa.readback"]
FRAME_CHUNK = ["nnc.frame.select", "nnc.frame.sort", "nnc.frame.kb2",
               "nnc.frame.unpack"]


@pytest.fixture(autouse=True)
def log(monkeypatch):
    """A fresh span log for each test, one intra-op thread (tiny sizes)."""
    fresh = collections.deque(maxlen=profiling.SPAN_LOG)
    monkeypatch.setattr(profiling, "_LOG", fresh)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield fresh
    torch.set_num_threads(n)


def _children(records, parent):
    return [s for s in records if s.parent == parent.index]


def _ms(s):
    return (s.end_ns - s.start_ns) / 1e6


# -- the facility -----------------------------------------------------------
def test_profiler_off_records_nothing():
    """Off: the flag read is torch.autograd.profiler._is_profiler_enabled,
    False as torch's own state says; span and request yield None and leave
    the log empty."""
    assert autograd_profiler._is_profiler_enabled is False
    assert torch._C._autograd._profiler_enabled() is False
    with profiling.request("nnc.test.request", rays=4) as req:
        with profiling.span("nnc.test.child") as child:
            torch.ones(4).sum()
    assert req is None and child is None
    assert profiling.spans() == []


@pytest.mark.parametrize("recorder", ["trace_if", "torch.profiler"])
def test_spans_nest_with_parents_requests_and_counts(recorder):
    """On under either way of starting the profiler: the flag is True while
    it records; parents, request ids and counts as opened; spans outside a
    request carry none."""
    ctx = profiling.trace_if(None) if recorder == "trace_if" else \
        profile(activities=[ProfilerActivity.CPU])
    with ctx:
        assert autograd_profiler._is_profiler_enabled is True
        assert torch._C._autograd._profiler_enabled() is True
        with profiling.span("nnc.test.outside"):
            pass
        for n in (2, 3):
            with profiling.request("nnc.test.request", rays=n):
                with profiling.span("nnc.test.a", size=n) as a:
                    with profiling.span("nnc.test.b"):
                        pass
                    a.counts["more"] = 1
                with profiling.span("nnc.test.c"):
                    pass
    assert autograd_profiler._is_profiler_enabled is False
    got = profiling.spans()
    assert [s.name for s in got] == ["nnc.test.outside"] + [
        "nnc.test.request", "nnc.test.a", "nnc.test.b", "nnc.test.c"] * 2
    outside, r1, a1, b1, c1, r2, a2, b2, c2 = got
    assert outside.parent is None and outside.request is None
    for r, a, b, c, n in ((r1, a1, b1, c1, 2), (r2, a2, b2, c2, 3)):
        assert r.parent is None and r.request == r.index
        assert (a.parent, b.parent, c.parent) == (r.index, a.index, r.index)
        assert a.request == b.request == c.request == r.index
        assert r.counts == {"rays": n} and a.counts == {"size": n,
                                                        "more": 1}
        assert r.start_ns <= a.start_ns <= b.start_ns <= b.end_ns \
            <= a.end_ns <= c.start_ns <= c.end_ns <= r.end_ns
    assert r1.request != r2.request
    assert len({s.index for s in got}) == len(got)


def test_log_keeps_the_last_65536_spans():
    assert profiling.SPAN_LOG == 65_536
    n = profiling.SPAN_LOG + 10
    with profiling.trace_if(None):
        for i in range(n):
            with profiling.span("nnc.test.many", i=i):
                pass
    got = profiling.spans()
    assert len(got) == profiling.SPAN_LOG
    assert got[0].counts["i"] == 10 and got[-1].counts["i"] == n - 1


def test_records_lie_within_their_record_function_events():
    """start_ns / end_ns are time.time_ns(), the clock of the profile's
    Kineto events: each record lies within its range, give or take
    100 us."""
    with profiling.trace_if(None) as prof:
        for i in range(5):
            with profiling.request(f"nnc.test.clock{i}"):
                with profiling.span(f"nnc.test.clock{i}.child"):
                    torch.ones(256, 256) @ torch.ones(256, 256)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU}
    records = profiling.spans()
    assert len(records) == 10
    slack = 100_000
    for s in records:
        e = events[s.name]
        start = e.start_ns()
        assert start - slack <= s.start_ns <= s.end_ns \
            <= start + e.duration_ns() + slack, s.name


# -- the layer boundaries ---------------------------------------------------
def _lsa_run(steps_per_call, n_iters):
    scene, _ = synthetic.make_scene(n_images=2, H=8, W=8, mlp=MLP, seed=3)
    rc = renderer.RenderConfig(mlp=MLP, n_samples=8, n_importance=8)
    models = [nerf.NeRF(MLP) for _ in range(2)]
    for m in models:
        nerf.init_lsa_scales(m)
    batcher = trays.RayBatcher(scene["images"], scene["poses"], scene["K"],
                               scene["i_train"], 16, seed=5)
    stats = {}
    with profiling.trace_if(None):
        lsa.tune_lsa_scales(*models, batcher, rc, scene["near"],
                            scene["far"], epochs=1, n_iters=n_iters,
                            verbose=False, steps_per_call=steps_per_call,
                            stats=stats)
    return stats


def test_tune_lsa_scales_spans_match_its_calls():
    """One nnc.lsa.call request per entry of stats["calls"], with its steps
    and rays, lasting as long within 1 ms, its phases in order."""
    stats = _lsa_run(steps_per_call=4, n_iters=9)
    got = profiling.spans()
    calls = [s for s in got if s.name == "nnc.lsa.call"]
    assert [c for c, _s, _cap in stats["calls"]] == [4, 4, 1]
    assert len(calls) == len(stats["calls"])
    for call, (k, seconds, _captured) in zip(calls, stats["calls"]):
        assert call.request == call.index
        assert call.counts == {"steps": k, "rays": 16 * k}
        assert abs(_ms(call) - 1e3 * seconds) < 1.0
        assert [s.name for s in _children(got, call)] == LSA_CALL
        assert all(s.request == call.index for s in got
                   if call.start_ns <= s.start_ns <= call.end_ns)


def test_pool_batcher_shuffles_are_spans():
    """One nnc.rays.shuffle (rays = the pool) at the pool's build and at
    every reshuffle; under a call, a child of its nnc.lsa.batches."""
    images = np.random.default_rng(0).uniform(size=(2, 4, 4, 3)) \
        .astype(np.float32)
    poses = synthetic.look_at_poses(2, seed=0)
    K = np.array([[3.2, 0, 2], [0, 3.2, 2], [0, 0, 1]], np.float32)
    with profiling.trace_if(None):
        batcher = trays.RayBatcher(images, poses, K, np.arange(2), 10,
                                   mode="pool", seed=1)
        for _ in range(7):      # 32 rays: 3 batches a pass
            batcher.next_batch()
    got = profiling.spans()
    assert [s.name for s in got] == ["nnc.rays.shuffle"] * 3
    assert all(s.counts == {"rays": 32} for s in got)

    scene, _ = synthetic.make_scene(n_images=2, H=4, W=4, mlp=MLP, seed=3)
    rc = renderer.RenderConfig(mlp=MLP, n_samples=8, n_importance=8)
    models = [nerf.NeRF(MLP) for _ in range(2)]
    for m in models:
        nerf.init_lsa_scales(m)
    with profiling.trace_if(None):
        batcher = trays.RayBatcher(scene["images"], scene["poses"],
                                   scene["K"], np.arange(2), 12,
                                   mode="pool", seed=1)
        lsa.tune_lsa_scales(*models, batcher, rc, scene["near"],
                            scene["far"], epochs=1, n_iters=9,
                            verbose=False, steps_per_call=4)
    got = profiling.spans()[3:]
    shuffles = [s for s in got if s.name == "nnc.rays.shuffle"]
    # 32 rays, 12 a batch: the build, then batches 3, 5, 7 and 9
    assert len(shuffles) == 5
    by_index = {s.index: s for s in got}
    assert shuffles[0].parent is None
    for s in shuffles[1:]:
        assert by_index[s.parent].name == "nnc.lsa.batches"
        assert by_index[by_index[s.parent].parent].name == "nnc.lsa.call"


def test_render_image_spans_a_view_and_its_chunks():
    torch.manual_seed(0)
    model = nerf.NeRF(MLP)
    rc = renderer.RenderConfig(mlp=MLP, n_samples=8, n_importance=8,
                               chunk=40)
    K = np.array([[8.0, 0, 5], [0, 8.0, 5], [0, 0, 1]], np.float32)
    ro, rd = get_rays_np(10, 10, K, synthetic.look_at_poses(1)[0, :3, :4])
    plain = renderer.render_image(model, model, ro, rd, 2.0, 6.0, rc)
    with profiling.trace_if(None):
        for _ in range(2):
            traced = renderer.render_image(model, model, ro, rd, 2.0, 6.0,
                                           rc)
    for k in plain:
        torch.testing.assert_close(traced[k], plain[k], rtol=0, atol=0)
    got = profiling.spans()
    views = [s for s in got if s.name == "nnc.render.view"]
    assert len(views) == 2
    for view in views:
        assert view.request == view.index and view.counts == {"rays": 100}
        chunks = _children(got, view)
        assert [s.name for s in chunks] == ["nnc.render.chunk"] * 3
        assert [s.counts["rays"] for s in chunks] == [40, 40, 20]
        assert all(view.start_ns <= c.start_ns <= c.end_ns <= view.end_ns
                   for c in chunks)


@pytest.mark.parametrize("row_chunk", [16, 8])
def test_render_image_fast_spans_a_frame_and_its_phases(row_chunk):
    """A frame's request holds each row chunk's select, sort, kb2 and
    unpack, then one wait and one copy; the maps are the untraced ones."""
    model = synthetic.make_solid_mlp(radius=1.0)   # K-B2's widths
    grid = occupancy.build_occupancy_grid(model, res=16)
    rc = renderer.RenderConfig(mlp=model.config)
    K = np.array([[12.8, 0, 8], [0, 12.8, 8], [0, 0, 1]], np.float32)
    ro, rd = get_rays_np(16, 16, K, synthetic.look_at_poses(1)[0, :3, :4])
    kw = dict(n_candidates=32, budget=8, subsample=4, row_chunk=row_chunk)
    plain = occupancy.render_image_fast(model, ro, rd, 2.0, 6.0, rc, grid,
                                        **kw)
    with profiling.trace_if(None):
        traced = occupancy.render_image_fast(model, ro, rd, 2.0, 6.0, rc,
                                             grid, **kw)
    assert set(traced) == set(plain)
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k])
    got = profiling.spans()
    assert got[0].name == "nnc.frame" and got[0].counts == {"rays": 256}
    frame = got[0]
    phases = _children(got, frame)
    n_chunks = math.ceil(16 / row_chunk)
    assert [s.name for s in phases] == FRAME_CHUNK * n_chunks + [
        "nnc.frame.wait", "nnc.frame.copy"]
    assert all(s.request == frame.index for s in got)
    ends = [s.end_ns for s in phases]
    assert ends == sorted(ends) and ends[-1] <= frame.end_ns
