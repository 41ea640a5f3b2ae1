"""Encoder/decoder phase breakdown on the flagship 4.77 MB NeRFWrapper.

Counterpart of ``tools/profile_codec.py``, with its flags and printed
lines. An API-level phase split:

  quant   — dc_enc_quant_layer (fused single-pass 8-state DQ trellis)
  est     — the 4-profile estimation walk, isolated as
            encodeLayer(param_opt=1) - encodeLayer(param_opt=0)
  emit    — encodeLayer(param_opt=0): syntax derivation + range-coder emit
  decode  — decodeLayer
  dequant — dequantLayer (two-pass vectorized)

``dequantLayer`` takes (qp_density, qp, scan_order) in that order; the
original passes 1 for qp_density and qp_density for scan_order. The codec
is host code: this tool needs no device (random full-width weights from a
CPU generator). Host noise is large across process runs: run it several
times and trust the min per phase; in-process it reports min-of-N too.

Usage: python -m nnc_tpu_torch.tools.profile_codec [--qp -20] [--reps 3]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

QP_DENSITY = 2
CULM1 = 9   # cabac_unary_length_minus1
SCAN_ORDER = 0


def flagship_state_dict():
    """model. / model_fine. of two random full-width NeRFs, float32."""
    import torch

    from nnc_tpu_torch.models import nerf

    mlp = nerf.NeRFConfig()
    sd = {}
    for seed, prefix in ((0, "model."), (1, "model_fine.")):
        sd.update(nerf.params_to_state_dict(
            nerf.init_params(mlp, torch.Generator().manual_seed(seed)),
            prefix))
    return {k: np.ascontiguousarray(np.asarray(v, np.float32))
            for k, v in sd.items()}


def _rows(a, v):
    return a.reshape(v.shape[0], -1) if v.ndim > 1 else a


def profile_once(sd, qp):
    """One pass over every tensor. Returns (seconds per phase, bitstream
    bytes, {name: (bitstream, dequantized values)})."""
    from nnc_tpu_torch.coder import cabac

    t = {"quant": 0.0, "enc_opt": 0.0, "enc_noopt": 0.0,
         "decode": 0.0, "dequant": 0.0}
    nbytes = 0
    coded = {}
    for name, v in sd.items():
        q = np.zeros(v.size, np.int32)
        enc = cabac.Encoder()
        enc.initCtxModels(CULM1, 1)
        t0 = time.perf_counter()
        enc.quantLayer(_rows(v, v), q, 1, QP_DENSITY, qp, 0.0, CULM1, 0)
        t["quant"] += time.perf_counter() - t0
        qv = _rows(q, v)

        # emit with the 4-profile estimation walk (production path)
        t0 = time.perf_counter()
        enc.encodeLayer(qv, 1, SCAN_ORDER)
        enc.terminate_segment()
        t["enc_opt"] += time.perf_counter() - t0
        bs = enc.finish()
        nbytes += bs.nbytes

        # emit without it (param_opt=0): pure syntax + range coder
        enc2 = cabac.Encoder()
        enc2.initCtxModels(CULM1, 0)
        t0 = time.perf_counter()
        enc2.encodeLayer(qv, 1, SCAN_ORDER)
        enc2.terminate_segment()
        t["enc_noopt"] += time.perf_counter() - t0
        enc2.finish()

        dec = cabac.Decoder()
        dec.setStream(bs)
        dec.initCtxModels(CULM1)
        out = np.zeros(v.size, np.int32)
        t0 = time.perf_counter()
        dec.decodeLayer(_rows(out, v), 1, SCAN_ORDER)
        t["decode"] += time.perf_counter() - t0
        dec.terminate_segment()
        f = np.zeros(v.size, np.float32)
        t0 = time.perf_counter()
        dec.dequantLayer(_rows(f, v), _rows(out, v), QP_DENSITY, qp,
                         SCAN_ORDER)
        t["dequant"] += time.perf_counter() - t0
        if not (out == q).all():
            raise AssertionError(f"{name}: decoded values differ from the "
                                 f"quantized ones")
        coded[name] = (bs, f.reshape(v.shape))
    return t, nbytes, coded


def profile(sd, qp, reps):
    """Min of ``reps`` passes per phase. Returns (best seconds per phase,
    the estimation walk's seconds, bitstream bytes, the last pass's coded
    tensors)."""
    best = None
    for _ in range(reps):
        t, nbytes, coded = profile_once(sd, qp)
        best = t if best is None else {k: min(best[k], t[k]) for k in t}
    return best, best["enc_opt"] - best["enc_noopt"], nbytes, coded


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qp", type=int, default=-20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    sd = flagship_state_dict()
    raw = sum(v.nbytes for v in sd.values())
    best, est, nbytes, _coded = profile(sd, args.qp, args.reps)
    enc_total = best["quant"] + best["enc_opt"]
    dec_total = best["decode"] + best["dequant"]
    print(f"model {raw/1e6:.2f} MB -> bitstream {nbytes/1e6:.2f} MB "
          f"(qp={args.qp}, dq on, scan 0, min of {args.reps} reps)")
    for k, label in (("quant", "DQ trellis quant"),
                     ("enc_noopt", "syntax+range emit"),
                     (None, "4-profile estimation (enc_opt - enc_noopt)"),
                     ("decode", "decode walk"),
                     ("dequant", "dequant (two-pass)")):
        v = est if k is None else best[k]
        print(f"  {label:44s} {v*1e3:7.1f} ms  "
              f"({raw/1e6/v if v > 0 else float('inf'):6.1f} MB/s)")
    print(f"encode total {enc_total*1e3:.1f} ms = {raw/1e6/enc_total:.1f} "
          f"MB/s | decode total {dec_total*1e3:.1f} ms = "
          f"{raw/1e6/dec_total:.1f} MB/s")
    return {"raw_bytes": raw, "bitstream_bytes": nbytes,
            "encode_mb_s": raw / 1e6 / enc_total,
            "decode_mb_s": raw / 1e6 / dec_total}


if __name__ == "__main__":
    main()
