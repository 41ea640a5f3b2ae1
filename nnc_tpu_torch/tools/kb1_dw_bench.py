"""K-B1's backward with dW on the card, float32 and bf16.

    python -m nnc_tpu_torch.tools.kb1_dw_bench [--n 196608] [--iters 3]
        [--repeats 2] [--profile]

Times ``mlp_train_bwd`` and ``mlp_train_bwd_bf16`` with dW (CUDA events
over ``--iters`` launches after a warm-up, ``--repeats`` times) at the LSA
step's fine pass, on full-width weights with LSA scales (std 0.05) and
points made from a seed, the forward's workspace made once by the kernels;
the backward without dW is timed beside them. It prints the card's name and
power limit and, as its last line, one JSON object of the times in ms;
where the backward with dW is two passes (the backward writing a du
workspace, then the GEMM over the points) it times each pass alone too.
``--profile`` builds ``ops/csrc/mlp_train_dw.cu`` once more with clock
marks (``-DNNC_MMA_PROFILE``, under ``build/nnc_tpu_torch/dw_probe/``) and
prints the share of a CTA's clocks in each part of the GEMM's loop, and
times a build whose chunks all read the first chunk's rows, which stay in
L2 (``-DNNC_DW_PROBE_HOT``; its sums are wrong), beside the GEMM.

Its calls take the same arguments in earlier checkouts of the port (the
backward with dW read ``params`` and ``params_t`` there, and ignores the
fragment-ordered buffer), so a copy of this file in an earlier checkout's
``nnc_tpu_torch/tools/`` times that checkout's kernels on the same inputs:
run the two in one call, in turns, to compare them on one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from ..data import synthetic
from ..models import nerf
from ..ops import _build
from ..ops import mlp_train_fused as M
from ..utils.device import require_cuda


def inputs(n: int, device):
    """Packed weights and the points, view directions and cotangent."""
    g = torch.Generator().manual_seed(4)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(device)
    t = M._layer_tensors(model)
    params, params_t, ls = M.pack_train(t[0::3], t[1::3], t[2::3])
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(device)
    vd = torch.randn(n, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(device)
    cot = (1e-3 * torch.randn(n, 4, generator=g)).to(device)
    return t[0::3], params, params_t, ls, pts, vd, cot


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
    return {f"{dtype} first pass with du": pass1,
            f"{dtype} dW GEMM": pass2}


PROFILE_SLOTS = ("prologue", "wait for the copies", "barrier",
                 "issue the next copies", "rebuild the next X", "products")


def _probe_lib(flag):
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


def profile(ws, du, ls, biases, pts, vd, bf16: bool, iters: int):
    """The GEMM built with clock marks, run on these workspaces: ({part:
    share of the clocks of thread 0 of every CTA}, ms of the build that
    reads the first chunk's rows in every chunk)."""
    n = pts.shape[0]
    partials = torch.empty(-(-_padded_rows(n) // M.DW_CHUNK) * M.WT_SIZE,
                           device=ws.device)
    out = torch.empty(M.WT_SIZE, device=ws.device)
    name = "nnc_mlp_train_dw" + ("_bf16" if bf16 else "")
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        _build.check(getattr(lib, name)(
            ws.data_ptr(), du.data_ptr(), ls.data_ptr(), biases.data_ptr(),
            pts.data_ptr(), vd.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n, M.DW_CHUNK, stream), "GEMM")

    lib = _probe_lib("-DNNC_MMA_PROFILE")
    clocks = (ctypes.c_ulonglong * 9)()
    lib.nnc_dw_profile(clocks)
    run(lib)
    torch.cuda.synchronize()
    lib.nnc_dw_profile(clocks)
    total = sum(clocks[:len(PROFILE_SLOTS)])
    hot = _probe_lib("-DNNC_DW_PROBE_HOT")
    return ({part: clocks[i] / total for i, part in enumerate(PROFILE_SLOTS)},
            events_ms(lambda: run(hot), iters))


def _padded_rows(n):
    return -(-n // M.TILE) * M.TILE


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=196_608)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    device = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    weights, params, params_t, ls, pts, vd, cot = inputs(args.n, device)
    biases = M.gather_biases(params)
    out = {}
    for dtype, fwd, bwd, pack in (
            ("float32", M.mlp_train_fwd, M.mlp_train_bwd, M.pack_train_mma),
            ("bfloat16", M.mlp_train_fwd_bf16, M.mlp_train_bwd_bf16,
             M.pack_train_bf16)):
        packed, packed_t = pack(weights)
        _raw, ws = fwd(params, ls, pts, vd, True, packed, biases)
        runs = {f"{dtype} {'with' if dw else 'without'} dW":
                (lambda dw=dw: bwd(params, params_t, ls, pts, vd, cot, ws,
                                   dw, packed_t, biases)) for dw in (True, False)}
        runs.update(_passes(dtype, ws, ls, biases, pts, vd, cot, packed_t))
        for key, run in runs.items():
            out[key] = [events_ms(run, args.iters)
                        for _ in range(args.repeats)]
            print(f"{key}: {', '.join(f'{t:.3f}' for t in out[key])} ms "
                  f"at {args.n} points")
        if args.profile:
            bf16 = dtype == "bfloat16"
            du = _du(ws, bf16)
            bwd(None, None, ls, pts, vd, cot, ws, True, packed_t, biases,
                du=du)
            shares, hot_ms = profile(ws, du, ls, biases, pts, vd, bf16,
                                     args.iters)
            out[f"{dtype} GEMM clocks"] = shares
            out[f"{dtype} GEMM, the rows in L2"] = hot_ms
            print(f"{dtype} GEMM, share of a CTA's clocks: "
                  + ", ".join(f"{k} {100 * v:.1f}%" for k, v in shares.items())
                  + f"; every chunk on the first chunk's rows {hot_ms:.3f} ms")
            del du
        del ws
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
