"""The port's redesigned kernels on the card: digests of what they compute and
their times, in a form that runs unchanged in an earlier checkout of the port.

    python -m nnc_tpu_torch.tools.kernel_compare
        [--kernels kb1_bf16,kb1_dw,kb2_bf16,kb2_occ,kb3_bf16,kb4,kb5,kb5_bf16,
                   kb6]
        [--iters 5]
        [--repeats 2] [--profile] [--out FILE]

Each name in ``--kernels`` (all nine by default) adds its part:

- ``kb1_bf16``: K-B1's bf16 forward (``mlp_train_fwd_bf16``) on chip_smoke.py
  phase 16's inputs (full-width weights with LSA scales of std 0.05 and
  points from seed 16, at 65,536 and 196,608 points) with its workspace of
  u, and its backward (``mlp_train_bwd_bf16``) on that workspace: the
  SHA-256 of raw, of the whole workspace, of the backward's dls and db
  without dW, and of its gradient and its du workspace with dW (zeroed
  first) at both sizes, whether a rerun gave the same bytes, and at the
  larger size the forward's time with and without the workspace and the
  backward's without and with dW.
- ``kb1_dw``: K-B1's backward with and without dW, float32 and bf16, at
  196,608 points (weights and points from seed 4, the forward's workspace
  made once by the kernels), and the backward with dW's two passes alone
  (the backward writing a du workspace, then the GEMM over the points).
  ``--profile`` builds ``ops/csrc/mlp_train_dw.cu`` once more with clock
  marks (``-DNNC_MMA_PROFILE``, under ``build/nnc_tpu_torch/dw_probe/``) and
  prints the share of a CTA's clocks in each part of the GEMM's loop, and
  times a build whose chunks all read the first chunk's rows, which stay in
  L2 (``-DNNC_DW_PROBE_HOT``; its sums are wrong), beside the GEMM.
- ``kb2_bf16``: K-B2 bf16 (``render_pass_bf16``) on 4,096 rays of a solid
  full-width model (seed 14) at S = 64 with weights and S = 192 without,
  early termination off and at 1e-4: the SHA-256 of its maps and weights,
  whether a rerun gave the same bytes, and its time at S = 192, 1e-4. Its
  chain (``nerf_mlp_bf16.cuh``, shared with K-B5 bf16) untouched gives the
  parent's bytes.
- ``kb2_occ``: K-B2 float32 on occupancy mode's compacted rays (16 samples
  a ray, zero-dist tails; the inputs of the card test
  ``test_cuda_occupancy_render_matches_plain``), per-ray and tiled: where
  the kernel parts from its plain version and why, from K-B3's raw on the
  launch's points against the plain MLP's (see :func:`kb2_occ`); the launch
  is the packed render pass, whose inputs run through ``render_pass`` here,
  and whether its maps equal ``render_pass``'s.
- ``kb3_bf16``: K-B3 bf16 (``mlp_from_points_bf16``) on phase 14's inputs
  (phase 2's net and points) and at ``RAGGED`` sizes (points from seed 14):
  the error of raw against the plain bf16 version as [rms, max], each over
  the same statistic of the bf16-to-float32 distance, the SHA-256 of raw at
  each size, whether a rerun gave the same bytes, and its time at 262,144
  points (the wgmma slabs made once where the wrapper takes them).
- ``kb4``: K-B4 (``mlp_int8_from_points``) on phase 9's inputs (phase 2's
  net and 262,144 points from seed 0): the SHA-256 of raw, whether a rerun
  gave the same bytes, and its time.
- ``kb5``: K-B5 float32 (``mlp_embedded``) on phase 8's inputs (phase 2's
  net and points, embedded by ``positional_encoding``): the SHA-256 of
  raw, whether a rerun gave the same bytes, its max |d raw| from the exact
  float32 plain version, and its time.
- ``kb5_bf16``: K-B5 bf16 (``mlp_embedded_bf16``) on phase 18's inputs (the
  same net and points, the weights by ``pack_weights_bf16``) and at
  ``RAGGED`` sizes whose last tile is partial (points from seed 18): the
  SHA-256 of raw at each size, whether a rerun gave the same bytes, and its
  time at 262,144 points.
- ``kb6``: K-B6 float32 (``mlp_tp_pair``) at chip_smoke.py phase 11's seven
  pair shapes and draws (seed 7, 262,144 points): at each, the max |d| from
  the exact plain version (``fused_pair_plain``: ``torch.addmm``, ``relu``,
  ``torch.mm`` in cuBLAS float32) and, where the checkout has it, from the
  plain model of the 3xTF32 arithmetic (``fused_pair_3xtf32_plain``), each
  over max |ref|, whether a rerun gave the same bytes, and the kernel's and
  cuBLAS's times in turns.

A time is CUDA events over ``--iters`` launches after a warm-up, taken
``--repeats`` times, the parts' runs in turns. The card's name and power
limit come first; the last line is one JSON object of all of it, which
``--out`` also writes to a file.

Its calls take the same arguments in earlier checkouts of the port, so a
copy of this file in an earlier checkout's ``nnc_tpu_torch/tools/`` (unpacked
under ``build/`` by ``git archive``) runs that checkout's kernels on the same
inputs: run the two in one call, in turns (parent, change, change, parent),
and compare the digests and the times.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import os
import subprocess

import numpy as np
import torch

from ..data import synthetic
from ..models import nerf
from ..ops import _build, mlp_fused
from ..ops import mlp_train_fused as M
from ..ops.posenc import positional_encoding
from ..utils.device import require_cuda
from ..utils.platform import card_line

N_TRAIN = (65_536, 196_608)
N_POINTS = 262_144
RAGGED = (33, 10_001, 3_414_016)
KERNELS = ("kb1_bf16", "kb1_dw", "kb2_bf16", "kb2_occ", "kb3_bf16", "kb4",
           "kb5", "kb5_bf16", "kb6")
# phase 11's pairs: (M, K, O2, relu_mid), S = 256 / M
PAIRS = ((4, 63, 256, True), (4, 256, 256, True), (4, 256, 128, False),
         (1, 63, 256, True), (1, 256, 256, True), (8, 63, 256, True),
         (8, 256, 256, True))


def digest(t: torch.Tensor) -> str:
    """SHA-256 of the tensor's bytes in row-major order (any dtype, bf16
    included)."""
    a = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(a).hexdigest()


def events_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(runs: dict, iters: int, repeats: int) -> dict:
    """{name: [ms of each repeat]}, the runs taken in turns."""
    out = {key: [] for key in runs}
    for _ in range(repeats):
        for key, fn in runs.items():
            out[key].append(events_ms(fn, iters))
    return out


def _model(device, g):
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    return nerf.init_lsa_scales(model, std=0.05, generator=g).to(device)


def _points(n, g, device):
    """Points, unit view directions and a cotangent, in this order."""
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(device)
    vd = torch.randn(n, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(device)
    cot = (1e-3 * torch.randn(n, 4, generator=g)).to(device)
    return pts, vd, cot


def _train_packs(model):
    t = M._layer_tensors(model)
    params, params_t, ls = M.pack_train(t[0::3], t[1::3], t[2::3])
    return t[0::3], params, params_t, ls, M.gather_biases(params)


def kb1_bf16(device, args):
    """Phase 16's inputs and draws, in its order."""
    g = torch.Generator().manual_seed(16)
    weights, params, params_t, ls, biases = _train_packs(_model(device, g))
    fwd_b, bwd_b = M.pack_train_bf16(weights)
    out = {}
    for n in N_TRAIN:
        pts, vd, cot = _points(n, g, device)
        fwd = lambda save=True: M.mlp_train_fwd_bf16(
            params, ls, pts, vd, save, fwd_b, biases)
        raw, ws = fwd()
        torch.cuda.synchronize()
        out[f"kb1_bf16 raw {n}"] = digest(raw)
        out[f"kb1_bf16 ws {n}"] = digest(ws)
        raw2, ws2 = fwd()
        out[f"kb1_bf16 rerun equal {n}"] = bool(
            torch.equal(raw, raw2) and torch.equal(ws, ws2))
        del raw2, ws2
        # the backward without and with dW; its du workspace zeroed first,
        # so that its columns past the gradient's have known bytes
        bwd = lambda dw=False, du=None: M.mlp_train_bwd_bf16(
            params, params_t, ls, pts, vd, cot, ws, dw, bwd_b, biases,
            **({"du": du} if dw else {}))
        zeros_du = lambda: torch.zeros((ws.shape[0], M.DU_COLS_BF16),
                                       dtype=torch.bfloat16, device=device)
        flat, du = bwd(), zeros_du()
        flat_dw = bwd(True, du)
        torch.cuda.synchronize()
        out[f"kb1_bf16 bwd dls db {n}"] = digest(flat)
        out[f"kb1_bf16 bwd dW {n}"] = digest(flat_dw)
        out[f"kb1_bf16 bwd du {n}"] = digest(du)
        du2 = zeros_du()
        out[f"kb1_bf16 bwd rerun equal {n}"] = bool(
            torch.equal(bwd(), flat) and torch.equal(bwd(True, du2), flat_dw)
            and torch.equal(du2, du))
        del du, du2
        if n == N_TRAIN[-1]:
            out.update(timed({
                "kb1_bf16 fwd ms": fwd,
                "kb1_bf16 fwd without ws ms": lambda: fwd(False),
                "kb1_bf16 bwd ms": bwd,
                "kb1_bf16 bwd with dW ms": lambda: bwd(True)},
                args.iters, args.repeats))
        del ws
    return out


def _du(ws, bf16: bool):
    """A du workspace for the backward with dW on ``ws``."""
    cols = M.DU_COLS_BF16 if bf16 else M.U_SIZE
    return torch.empty((ws.shape[0], cols), device=ws.device,
                       dtype=torch.bfloat16 if bf16 else torch.float32)


def _passes(dtype, ws, ls, biases, pts, vd, cot, packed_t):
    """The two passes of the backward with dW, each alone, where the
    library has them: {name: fn}."""
    lib = _build.lib()
    bf16 = dtype == "bfloat16"
    name = "nnc_mlp_train_dw" + ("_bf16" if bf16 else "")
    if not hasattr(lib, name):
        return {}
    n = pts.shape[0]
    du = _du(ws, bf16)
    sms = torch.cuda.get_device_properties(ws.device).multi_processor_count
    grid = min(-(-n // M.TILE), sms)
    partials = torch.empty(max(grid * 2 * M.U_SIZE,
                               -(-n // M.DW_CHUNK) * M.WT_SIZE),
                           device=ws.device)
    out = torch.empty(M.grad_size(True), device=ws.device)
    stream = torch.cuda.current_stream().cuda_stream
    first = getattr(lib, "nnc_mlp_train_bwd_" + ("bf16" if bf16 else "mma"))
    gemm = getattr(lib, name)

    def pass1():
        _build.check(first(packed_t.data_ptr(), ls.data_ptr(),
                           biases.data_ptr(), cot.data_ptr(), ws.data_ptr(),
                           du.data_ptr(), partials.data_ptr(),
                           out[M.WT_SIZE:].data_ptr(), n, grid, stream),
                     "first pass")

    def pass2():
        _build.check(gemm(ws.data_ptr(), du.data_ptr(), ls.data_ptr(),
                          biases.data_ptr(), pts.data_ptr(), vd.data_ptr(),
                          partials.data_ptr(), out.data_ptr(), n, M.DW_CHUNK,
                          stream), "GEMM")

    pass1()
    return {f"kb1_dw {dtype} first pass with du ms": pass1,
            f"kb1_dw {dtype} GEMM ms": pass2}


DW_PROFILE_SLOTS = ("prologue", "wait for the copies", "barrier",
                    "issue the next copies", "rebuild the next X", "products")


def _dw_probe_lib(flag):
    """mlp_train_dw.cu built with ``flag``, loaded."""
    out_dir = os.path.join(_build.BUILD_DIR, "dw_probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libdw{flag.lower()}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, flag, "-shared",
                    "-o", so, os.path.join(_build.SRC_DIR, "mlp_train_dw.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("nnc_mlp_train_dw", "nnc_mlp_train_dw_bf16"):
        getattr(lib, name).argtypes = [vp] * 8 + [ci, ci, vp]
        getattr(lib, name).restype = ci
    return lib


def dw_profile(ws, du, ls, biases, pts, vd, bf16: bool, iters: int):
    """The GEMM built with clock marks, run on these workspaces: ({part:
    share of the clocks of thread 0 of every CTA}, ms of the build that
    reads the first chunk's rows in every chunk)."""
    n = pts.shape[0]
    rows = -(-n // M.TILE) * M.TILE
    partials = torch.empty(-(-rows // M.DW_CHUNK) * M.WT_SIZE,
                           device=ws.device)
    out = torch.empty(M.WT_SIZE, device=ws.device)
    name = "nnc_mlp_train_dw" + ("_bf16" if bf16 else "")
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        _build.check(getattr(lib, name)(
            ws.data_ptr(), du.data_ptr(), ls.data_ptr(), biases.data_ptr(),
            pts.data_ptr(), vd.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n, M.DW_CHUNK, stream), "GEMM")

    lib = _dw_probe_lib("-DNNC_MMA_PROFILE")
    clocks = (ctypes.c_ulonglong * 9)()
    lib.nnc_dw_profile(clocks)
    run(lib)
    torch.cuda.synchronize()
    lib.nnc_dw_profile(clocks)
    total = sum(clocks[:len(DW_PROFILE_SLOTS)])
    hot = _dw_probe_lib("-DNNC_DW_PROBE_HOT")
    return ({part: clocks[i] / total
             for i, part in enumerate(DW_PROFILE_SLOTS)},
            events_ms(lambda: run(hot), iters))


def kb1_dw(device, args):
    """K-B1's backward with and without dW at the LSA step's fine pass."""
    g = torch.Generator().manual_seed(4)
    weights, params, params_t, ls, biases = _train_packs(_model(device, g))
    n = N_TRAIN[-1]
    pts, vd, cot = _points(n, g, device)
    out = {}
    for dtype, fwd, bwd, pack in (
            ("float32", M.mlp_train_fwd, M.mlp_train_bwd, M.pack_train_wgmma),
            ("bfloat16", M.mlp_train_fwd_bf16, M.mlp_train_bwd_bf16,
             M.pack_train_bf16)):
        packed, packed_t = pack(weights)
        _raw, ws = fwd(params, ls, pts, vd, True, packed, biases)
        runs = {f"kb1_dw {dtype} {'with' if dw else 'without'} dW ms":
                (lambda dw=dw: bwd(params, params_t, ls, pts, vd, cot, ws,
                                   dw, packed_t, biases)) for dw in (True, False)}
        runs.update(_passes(dtype, ws, ls, biases, pts, vd, cot, packed_t))
        out.update(timed(runs, args.iters, args.repeats))
        if args.profile:
            bf16 = dtype == "bfloat16"
            du = _du(ws, bf16)
            bwd(None, None, ls, pts, vd, cot, ws, True, packed_t, biases,
                du=du)
            shares, hot_ms = dw_profile(ws, du, ls, biases, pts, vd, bf16,
                                        args.iters)
            out[f"kb1_dw {dtype} GEMM clocks"] = shares
            out[f"kb1_dw {dtype} GEMM, the rows in L2 ms"] = hot_ms
            del du
        del ws
    return out


def kb4(device, args):
    """Phase 9's inputs: phase 2's net and points."""
    g = torch.Generator().manual_seed(0)
    model = _model(device, g)
    pts, vd, _cot = _points(N_POINTS, g, device)
    packed = mlp_fused.pack_weights_int8(model)
    call = (*packed, pts, vd)
    # the kernel's own buffer, made once, where the wrapper takes one
    kw = {"packed_s8": mlp_fused.repack_int8_mma(*packed)} \
        if hasattr(mlp_fused, "repack_int8_mma") else {}
    run = lambda: mlp_fused.mlp_int8_from_points(*call, **kw)
    raw = run()
    torch.cuda.synchronize()
    return {"kb4 raw": digest(raw),
            "kb4 rerun equal": bool(torch.equal(run(), raw)),
            **timed({"kb4 ms": run}, args.iters, args.repeats)}


def kb5(device, args):
    """Phase 8's inputs: phase 2's net and points, embedded by torch."""
    g = torch.Generator().manual_seed(0)
    model = _model(device, g)
    pts, vd, _cot = _points(N_POINTS, g, device)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    packed = mlp_fused.pack_weights(model)
    # the kernel's own buffer, made once, where the wrapper takes one
    kw = {"packed_mma": mlp_fused.repack_mma(packed)} \
        if "packed_mma" in inspect.signature(
            mlp_fused.mlp_embedded).parameters else {}
    run = lambda: mlp_fused.mlp_embedded(packed, pe, ve, **kw)
    raw = run()
    torch.cuda.synchronize()
    plain = mlp_fused.fused_nerf_mlp_plain(packed, pe, ve)
    return {"kb5 raw": digest(raw),
            "kb5 rerun equal": bool(torch.equal(run(), raw)),
            "kb5 max abs err": float((raw - plain).abs().max()),
            **timed({"kb5 ms": run}, args.iters, args.repeats)}


def _to_distance(got, plain16, plain32):
    """[rms, max] of got's error from the plain bf16 version, each over the
    same statistic of the distance between the plain bf16 and the plain
    float32 version on the same inputs."""
    rms = lambda t: float(t.double().pow(2).mean().sqrt())
    err, dist = got - plain16, plain16 - plain32
    return [rms(err) / rms(dist),
            float(err.abs().max()) / float(dist.abs().max())]


def kb3_bf16(device, args):
    """Phase 14's inputs: phase 2's net and points, and RAGGED sizes (points
    from seed 14)."""
    g = torch.Generator().manual_seed(0)
    model = _model(device, g)
    pts, vd, _cot = _points(N_POINTS, g, device)
    packed = mlp_fused.pack_weights(model)
    buf = mlp_fused.repack_bf16(packed)
    # the kernel's own slabs, made once, where the wrapper takes them
    kw = {"packed_wg": mlp_fused.repack_bf16_wgmma(buf)} \
        if "packed_wg" in inspect.signature(
            mlp_fused.mlp_from_points_bf16).parameters else {}
    run = lambda p=pts, v=vd: mlp_fused.mlp_from_points_bf16(buf, p, v, **kw)
    raw = run()
    torch.cuda.synchronize()

    def distance(got, p, v):
        return _to_distance(
            got, mlp_fused.fused_nerf_mlp_from_points_bf16_plain(buf, p, v),
            mlp_fused.fused_nerf_mlp_from_points_plain(packed, p, v))

    out = {f"kb3_bf16 raw {N_POINTS}": digest(raw),
           "kb3_bf16 rerun equal": bool(torch.equal(run(), raw)),
           f"kb3_bf16 err / distance {N_POINTS}": distance(raw, pts, vd)}
    g = torch.Generator().manual_seed(14)
    for n in RAGGED:
        p, v, _c = _points(n, g, device)
        got = run(p, v)
        out[f"kb3_bf16 raw {n}"] = digest(got)
        out[f"kb3_bf16 err / distance {n}"] = distance(got, p, v)
        del p, v, got
    out.update(timed({"kb3_bf16 ms": run}, args.iters, args.repeats))
    return out


def kb2_bf16(device, args):
    """K-B2 bf16 on 4,096 rays of a solid full-width model (seed 14): rays
    from a sphere of radius 4 towards the centre, a quarter in dead culling
    groups, sorted samples in [2, 6]; S = 64 with weights and S = 192
    without, early termination off and at 1e-4."""
    from ..ops import render_fused
    g = torch.Generator().manual_seed(14)
    model = synthetic.make_solid_mlp(noise_std=1e-2, generator=g,
                                     device=device)
    buf = mlp_fused.pack_weights_bf16(model)
    R = 4096
    ro = torch.randn(R, 3, generator=g)
    ro = 4 * ro / torch.linalg.norm(ro, dim=-1, keepdim=True)
    rd = -ro / 4 + 0.1 * torch.randn(R, 3, generator=g)
    ro, rd = ro.to(device), rd.to(device)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    live = ((torch.arange(R, device=device) // 64) % 4 != 3).to(torch.int32)
    out = {}
    for S, want_w in ((64, True), (192, False)):
        z, _ = torch.sort(2 + 4 * torch.rand(R, S, generator=g), dim=-1)
        z = z.to(device)
        dists = torch.cat([z[:, 1:] - z[:, :-1],
                           torch.full_like(z[:, :1], 1e10)], -1) \
            * torch.linalg.norm(rd, dim=-1, keepdim=True)
        for eps in (0.0, 1e-4):
            term = -float(np.log(eps)) if eps > 0 else float("inf")
            call = (buf, ro, rd, vd, z, dists, live, term, want_w)
            maps, w = render_fused.render_pass_bf16(*call)
            torch.cuda.synchronize()
            key = f"kb2_bf16 S={S} eps={eps}"
            out[f"{key} maps"] = digest(maps)
            if want_w:
                out[f"{key} weights"] = digest(w)
            again = render_fused.render_pass_bf16(*call)
            out[f"{key} rerun equal"] = bool(torch.equal(again[0], maps))
            if S == 192 and eps > 0:
                out.update(timed({"kb2_bf16 ms": lambda: render_fused
                                  .render_pass_bf16(*call)},
                                 args.iters, args.repeats))
    return out


def kb2_occ(device, args):
    """K-B2 float32 on occupancy mode's compacted rays, the inputs of
    tests/test_torch_port_cuda.py's test_cuda_occupancy_render_matches_plain:
    a solid teacher with N(0, 1e-3) on every weight (seed 7) rendered
    through the noise-free solid teacher's grid at res 64, a 64x64 frame
    (focal 51.2, the first ``look_at_poses`` pose), 48 candidates, budget
    16, subsample 4, early termination at 1e-4, per-ray and tiled
    selection. For each: max |d| of rgb / acc / depth against the plain
    version; the rays whose rgb or acc differ by more than 1e-5; the blocks
    whose termination decision differs between K-B3's and the plain MLP's
    optical depths; max |d| against the plain compositing of K-B3's raw on
    the same points (K-B2's chain is K-B3's); and, per ray, E = sum of
    dist * |d sigma| between K-B3 and the plain MLP, with the largest
    |d rgb| / E, |d acc| / E and |d depth| / E over the rays above 1e-5."""
    from ..ops import render_fused
    from ..render import occupancy, renderer
    from ..render.rays import get_rays_np
    from . import render_work
    model = synthetic.make_solid_mlp(
        noise_std=1e-3, device=device,
        generator=torch.Generator().manual_seed(7))
    grid = occupancy.build_occupancy_grid(
        synthetic.make_solid_mlp(device=device), res=64)
    K = np.array([[51.2, 0, 32], [0, 51.2, 32], [0, 0, 1]], np.float32)
    ro, rd = (torch.as_tensor(a.reshape(-1, 3), device=device)
              for a in get_rays_np(64, 64, K, synthetic.look_at_poses(1)[0]
                                   [:3, :4]))
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rc = renderer.RenderConfig(mlp=model.config, white_bkgd=True)
    out = {}
    for label, layout in (("per_ray", None), ("tiled", (64, 64))):
        calls = []
        with render_work.kb2_launches(calls):
            occupancy.render_rays_fast(model, ro, rd, vd, 2.0, 6.0, grid, rc,
                                       layout=layout)
        (name, call, kw), = calls
        call = call[:8]
        packed, r_o, r_d, v_d, z, dists, live, term = call
        pm = kw["packed_mma"]
        maps = render_fused.render_pass(*call, packed_mma=pm)[0]
        plain = render_fused.fused_render_pass_plain(*call)[0]
        kb3 = lambda p, pts, d: mlp_fused.mlp_from_points(p, pts, d, pm)
        mixed = render_fused.fused_render_pass_plain(*call,
                                                     mlp_plain=kb3)[0]
        R, S = z.shape
        pts = (r_o[:, None] + r_d[:, None] * z[..., None]).reshape(-1, 3)
        dirs = v_d[:, None].expand(R, S, 3).reshape(-1, 3).contiguous()
        raw_k = kb3(packed, pts, dirs).reshape(R, S, 4)
        raw_p = mlp_fused.fused_nerf_mlp_from_points_plain(
            packed, pts, dirs).reshape(R, S, 4)
        sig_k, sig_p = (torch.relu(r[..., 3]) for r in (raw_k, raw_p))
        E = (dists * (sig_k - sig_p).abs()).sum(dim=-1)
        sb = render_fused.SAMPLE_BLOCK
        starts = [torch.cat([torch.zeros_like(s[:, :1]),
                             torch.cumsum(s * dists, -1)[:, :-1]], -1)[:, ::sb]
                  for s in (sig_k, sig_p)]
        tile = render_fused.RAY_TILE
        stop = [st.reshape(-1, tile, st.shape[1]).amin(dim=1) < term
                for st in starts]
        d = (maps - plain).abs()
        big = (d[:, :4] > 1e-5).any(dim=1)
        key = f"kb2_occ {label}"
        out[f"{key} rays x samples"] = [R, S]
        if name == "render_pass_packed":
            out[f"{key} the packed pass equal to render_pass"] = torch.equal(
                render_fused.render_pass_packed(*call, packed_mma=pm), maps)
        out[f"{key} max|d| rgb, acc, depth"] = [
            float(d[:, :3].max()), float(d[:, 3].max()), float(d[:, 4].max())]
        out[f"{key} rays above 1e-5"] = int(big.sum())
        out[f"{key} termination decisions apart"] = int(
            (stop[0] != stop[1]).sum())
        out[f"{key} max|d| against plain compositing of K-B3's raw"] = float(
            (maps - mixed).abs().max())
        out[f"{key} max|d sigma|, max sigma"] = [
            float((sig_k - sig_p).abs().max()), float(sig_p.max())]
        out[f"{key} max sigma * dist"] = float((sig_p * dists).max())
        out[f"{key} max E"] = float(E.max())
        if big.any():
            e = E[big].clamp_min(1e-30)
            out[f"{key} above 1e-5: max |d rgb| / E, |d acc| / E, "
                f"|d depth| / E"] = [
                float((d[big, :3].amax(dim=1) / e).max()),
                float((d[big, 3] / e).max()), float((d[big, 4] / e).max())]
            out[f"{key} above 1e-5: min E"] = float(E[big].min())
    return out


def kb5_bf16(device, args):
    """Phase 18's inputs: phase 2's net and points, embedded by torch, and
    ragged sizes."""
    g = torch.Generator().manual_seed(0)
    model = _model(device, g)
    pts, vd, _cot = _points(N_POINTS, g, device)
    buf = mlp_fused.pack_weights_bf16(model)
    embed = lambda p, v: (positional_encoding(p, 10).contiguous(),
                          positional_encoding(v, 4).contiguous())
    pe, ve = embed(pts, vd)
    run = lambda p=pe, v=ve: mlp_fused.mlp_embedded_bf16(buf, p, v)
    raw = run()
    torch.cuda.synchronize()
    out = {f"kb5_bf16 raw {N_POINTS}": digest(raw),
           "kb5_bf16 rerun equal": bool(torch.equal(run(), raw))}
    g = torch.Generator().manual_seed(18)
    for n in RAGGED:
        p, v, _c = _points(n, g, device)
        e, f = embed(p, v)
        out[f"kb5_bf16 raw {n}"] = digest(run(e, f))
        del e, f
    out.update(timed({"kb5_bf16 ms": run}, args.iters, args.repeats))
    return out


def kb6(device, args):
    """Phase 11's pairs and draws; times of the kernel and of cuBLAS."""
    from ..ops import mlp_tp_fused as T
    model = getattr(T, "fused_pair_3xtf32_plain", None)
    g = torch.Generator().manual_seed(7)
    out = {}
    for m, k, o2, relu_mid in PAIRS:
        s = 256 // m
        x = torch.randn(N_POINTS, k, generator=g).to(device)
        wa = (torch.randn(k, s, generator=g) / k ** 0.5).to(device)
        ba = torch.randn(s, generator=g).to(device)
        wb = (torch.randn(s, o2, generator=g) / s ** 0.5).to(device)
        call = (x, wa, ba, wb, relu_mid)
        key = f"kb6 M={m} K={k} O2={o2}"
        got = T.fused_pair(*call)
        torch.cuda.synchronize()
        want = T.fused_pair_plain(*call)
        scale = float(want.abs().max())
        out[f"{key} err / max|ref|"] = float((got - want).abs().max()) / scale
        if model is not None:
            out[f"{key} err model / max|ref|"] = \
                float((got - model(*call)).abs().max()) / scale
        out[f"{key} rerun equal"] = bool(torch.equal(T.fused_pair(*call),
                                                     got))
        out.update(timed({f"{key} ms": lambda: T.fused_pair(*call),
                          f"{key} cuBLAS ms": lambda: T.fused_pair_plain(
                              *call)}, args.iters, args.repeats))
        del x, got, want
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated, of " + ", ".join(KERNELS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="kb1_dw: the GEMM's clock shares and its L2 build")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    device = require_cuda()
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = {"kb1_bf16": kb1_bf16, "kb1_dw": kb1_dw, "kb2_bf16": kb2_bf16,
             "kb2_occ": kb2_occ, "kb3_bf16": kb3_bf16, "kb4": kb4, "kb5": kb5,
             "kb5_bf16": kb5_bf16, "kb6": kb6}
    out = {"card": card}
    for name in kernels:
        out.update(parts[name](device, args))
    for key, value in out.items():
        if key != "card":
            print(f"{key}: {value}")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
