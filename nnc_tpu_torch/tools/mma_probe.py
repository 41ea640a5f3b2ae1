"""What holds the tensor-core chains of K-B3 / K-B2
(ops/csrc/nerf_mlp_mma.cuh, float32 as 3xTF32), K-B1 float32
(ops/csrc/mlp_train_wgmma.cuh, 3xTF32 on warpgroup products),
ops/csrc/nerf_mlp_bf16.cuh (bf16), ops/csrc/nerf_mlp_wgmma.cuh (K-B3 bf16's
warpgroup products) and K-B4's int8 products on the card they run on. Needs
a CUDA device and nvcc:

    python -m nnc_tpu_torch.tools.mma_probe

Prints, after the card's name and power limit:
  1. the rate at which one SM sub-partition issues
     ``mma.sync.m16n8k8 .tf32`` (clocks per instruction with 1, 2 and 4
     warps a sub-partition and 8, 16 or 32 independent accumulators a warp,
     and the TF32 TFLOP/s that makes over the card): the ceiling of any chain
     built on that instruction, a third of it for 3xTF32;
  2. K-B3 at 262,144 points built three ways from the sources in this
     checkout: as shipped, with ``cvt.rna.tf32.f32`` in place of the integer
     rounding (``-DNNC_SPLIT_CVT``; the outputs must be bit-equal), and with
     clock marks (``-DNNC_MMA_PROFILE``): the two times in turns, and the
     share of a tile's clocks spent in each part of the chain;
  3. the SASS opcode counts of the shipped build (how many instructions ride
     along with each HMMA);
  4. K-B1 (``mlp_train.cu``, warpgroup ``wgmma`` on
     ``mlp_train_wgmma.cuh``) at 196,608 and 32,768 points (the LSA step's
     fine pass, the occupancy loss's), as shipped and with clock marks
     (outputs, workspace and gradients bit-equal): the forward's time with
     and without the workspace, the backward's without dW, and the share of
     a tile's clocks in each part of the forward and of the backward, by
     thread 0 (warpgroup 0);
  5. the bf16 chains: the rate at which a sub-partition issues
     ``mma.sync.m16n8k16 .bf16`` (as in 1; K-B2 bf16 and K-B5 bf16's
     chain), then K-B3 bf16 (``mlp_from_points_bf16.cu``, the ``wgmma``
     chain of ``nerf_mlp_wgmma.cuh``) at 262,144 points as shipped and with
     clock marks (raw bit-equal): its time in turns beside the float32
     kernel's, the weight bytes a point reads from L2, and the share of a
     128-point tile's clocks in each part, by warpgroup 0's first thread;
  6. the int8 path: the rate at which a sub-partition issues
     ``mma.sync.m16n8k32 .s8`` (as in 1, in TOP/s), the SASS opcode counts
     of K-B4 (``mlp_int8_from_points.cu``) as shipped, and K-B4 at 262,144
     points as shipped and with clock marks (the outputs bit-equal): its
     time and the share of a tile's clocks in each part, as group 0's first
     thread sees them;
  7. K-B1 in bf16 (``mlp_train_bf16.cu``) at 196,608 points: the
     forward's time as shipped in turns with its time without the workspace
     of u (``ws`` null, which launches the build without stores of u), the
     backward's without dW on that workspace, and, built with clock marks,
     the share of a tile's clocks in each part of the forward (group 0's
     first thread) and of the backward (thread 0; its dls and db bit-equal
     to the shipped build's);
  8. K-B5 in bf16 (``mlp_embedded_bf16.cu``) at 262,144 points embedded by
     ``positional_encoding``, as shipped and with clock marks: its time and
     the share of a 128-point tile's clocks in each part (raw bit-equal);
  9. K-B6 float32 (``mlp_tp_pair.cu``) at the forward's three pair shapes
     at M = 4 shards (S = 64), 262,144 points, as shipped and with clock
     marks: its time and the share of a 64-point tile's clocks in each part
     (outputs bit-equal);
 10. ``wgmma`` (ops/csrc/nerf_mlp_wgmma.cuh): one warpgroup's layer
     m64n256k16 and m64n128k16, K 256, A and B from shared memory through the
     128-byte swizzle and hand-built descriptors, against ``torch.mm`` of the
     same bf16 values in float32; then a chain of them on resident operands,
     one and two warpgroups a CTA: clocks per product an SM.
 11. whether L2 bounds K-B3 bf16: the kernel as shipped in turns with a
     build whose slab ring stops copying after its first stages (each
     stage's barrier re-armed without a copy, so every tile reuses the
     first four slabs and raw is wrong), with clock marks: if the bytes from
     L2 held the kernel back, the second would be faster and wait less on
     the full barriers.
``--sections 6,7`` runs only those sections (and builds only what they
need). Everything is built under ``build/nnc_tpu_torch/mma_probe/``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from ..data import synthetic
from ..models import nerf
from ..ops import _build, mlp_fused, mlp_train_fused
from ..ops.posenc import positional_encoding
from ..utils.platform import card_line

OUT = os.path.join(_build.BUILD_DIR, "mma_probe")
N_POINTS = 262_144
PROFILE_SLOTS = ("stage the points in", "embedding", "product loops",
                 "barrier after the products", "epilogue stores",
                 "barrier after the stores", "alpha head",
                 "rgb head and barrier", "store the logits")

N_TRAIN = 196_608
N_OCC = 32_768   # the occupancy loss's points a step
TRAIN_SLOTS = ("tile start: points in, embedding (backward: cotangent, "
               "heads' sums)",
               "A loaded and split, waiting for the slabs (backward: also "
               "the rgb head's dv)",
               "issuing a group's twelve products",
               "wgmma.wait_group: the products",
               "the group's join, the slabs released",
               "barrier after the products",
               "epilogue (forward: u staged, workspace rows, activations; "
               "backward: mask, du, row sums)",
               "barrier after the epilogue (backward: and the warps' sums)",
               "heads (forward); the last sums (backward)")
TRAIN_BF16_FWD_SLOTS = ("stage the points in", "embedding", "product loops",
                        "barrier after the products",
                        "epilogue: u to the workspace, activations",
                        "barrier after the stores", "alpha head",
                        "rgb head and barrier", "store the logits")
INT8_SLOTS = ("stage the points in", "embedding and its quantization",
              "waiting for the group's turn", "product loops",
              "epilogue: float values, block maximum",
              "the group's barrier for the maximum",
              "quantize, store, heads", "the group's barrier after the stores",
              "the logits, end of the tile")
TRAIN_BF16_BWD_SLOTS = ("cotangent in, the heads (sums, rgb head's dv)",
                        "u: box to registers, next box asked, ls and b",
                        "product loops (and the alpha term)",
                        "u: waiting for the box (view layer: its loads)",
                        "barrier after the products",
                        "epilogue: mask, du, dpre * u",
                        "epilogue: column sums, du to shared memory",
                        "barrier after the stores", "end of the tile")
KB3_BF16_SLOTS = ("embedding: coordinates, sincosf, swizzled stores",
                  "waiting for a slab (full barrier)",
                  "issuing a slab's products", "wgmma.wait_group, release",
                  "epilogue: relu, bf16, swizzled stores (alpha head)",
                  "the warpgroup's named barriers", "heads' logits out",
                  "bias into the accumulators (a layer's start)", "(unused)")

KB5_BF16_SLOTS = ("next tile: wait, round pts stage, load views",
                  "barrier, pts copy issued, barrier before layer 0",
                  "product loops", "barrier after the products",
                  "epilogue stores", "barrier after the stores", "alpha head",
                  "rgb head and barrier", "store the logits")

KB6_SLOTS = ("issue the tile's copies (x, Wa[0]); zero padding",
             "wait for x and Wa[c], barrier; x split (chunk 0)",
             "first product",
             "epilogue: activation, split, hidden chunk stored",
             "wait for Wb[c], barrier", "second product (Wa[c + 1] issued)",
             "barrier after the second product", "store the partial sums")

MMA_RATE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NACC>
__global__ void issue_rate(float* out, long long* clk, int iters) {
  uint32_t a[4], b[2];
  for (int j = 0; j < 4; ++j) a[j] = 0x3f800000u + (threadIdx.x + j << 13);
  for (int j = 0; j < 2; ++j) b[j] = 0x3f000000u + (threadIdx.x + j << 13);
  float c[NACC][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < NACC; ++i) for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}
template <int NACC>
__global__ void issue_rate_bf16(float* out, long long* clk, int iters) {
  uint32_t a[4], b[2];
  for (int j = 0; j < 4; ++j) a[j] = 0x3f803f80u + (threadIdx.x + j << 16);
  for (int j = 0; j < 2; ++j) b[j] = 0x3f003f00u + (threadIdx.x + j << 16);
  float c[NACC][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < NACC; ++i) for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}
template <int NACC>
__global__ void issue_rate_s8(float* out, long long* clk, int iters) {
  uint32_t a[4], b[2];
  for (int j = 0; j < 4; ++j) a[j] = 0x01020304u * (threadIdx.x + j + 1);
  for (int j = 0; j < 2; ++j) b[j] = 0x04030201u * (threadIdx.x + j + 1);
  int c[NACC][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __syncthreads();
  const long long t1 = clock64();
  int s = 0;
  for (int i = 0; i < NACC; ++i) for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(s);
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}
// kind: 0 TF32 m16n8k8, 1 bf16 m16n8k16, 2 s8 m16n8k32
extern "C" int nnc_issue_rate(int nacc, int threads, int blocks, int iters,
                              float* out, long long* clk, int kind) {
  if (kind == 2) {
    if (nacc == 8) issue_rate_s8<8><<<blocks, threads>>>(out, clk, iters);
    else if (nacc == 16) issue_rate_s8<16><<<blocks, threads>>>(out, clk, iters);
    else issue_rate_s8<32><<<blocks, threads>>>(out, clk, iters);
  } else if (kind == 1) {
    if (nacc == 8) issue_rate_bf16<8><<<blocks, threads>>>(out, clk, iters);
    else if (nacc == 16) issue_rate_bf16<16><<<blocks, threads>>>(out, clk, iters);
    else issue_rate_bf16<32><<<blocks, threads>>>(out, clk, iters);
  } else {
    if (nacc == 8) issue_rate<8><<<blocks, threads>>>(out, clk, iters);
    else if (nacc == 16) issue_rate<16><<<blocks, threads>>>(out, clk, iters);
    else issue_rate<32><<<blocks, threads>>>(out, clk, iters);
  }
  cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}
"""

# Section 10: one layer of wgmma products against torch.mm, then their issue
# rate. Built with -I ops/csrc: the probe reads the operands through the
# same swizzle map and descriptors as K-B3 bf16 (nerf_mlp_wgmma.cuh).
WGMMA_PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "nerf_mlp_wgmma.cuh"
namespace wg = nerf::wg;

// One warpgroup: d (64 x N) = a (64 x K, row-major) @ w, w given as the
// shared-memory image of its K / 64 blocks (mlp_fused.wgmma_image). a is
// stored into shared memory through wg::swz, as the kernel's epilogues do.
template <int N>
__global__ void __launch_bounds__(128) layer_probe(
    const __nv_bfloat16* a, const uint4* b_img, float* d, int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sa = smem;
  unsigned char* sb = smem + 64 * K * 2;
  if (wg::smem_u32(smem) % 1024) __trap();
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * K / 2; i += 128) {
    const int r = 2 * i / K, c = 2 * i % K;
    *reinterpret_cast<uint32_t*>(sa + wg::swz(r, c, 64)) =
        *reinterpret_cast<const uint32_t*>(a + r * K + c);
  }
  for (int i = tid; i < K * N / 8; i += 128)
    reinterpret_cast<uint4*>(sb)[i] = b_img[i];
  wg::fence_async_smem();
  __syncthreads();
  float acc[128];   // N = 128: the first 64
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  wg::fence_operands(acc);
  wg::fence();
  const uint32_t a0 = wg::smem_u32(sa), b0 = wg::smem_u32(sb);
#pragma unroll 1
  for (int ks = 0; ks < K / 16; ++ks)
    wg::product<N>(acc, wg::desc_k(a0, ks, 64), wg::desc_k(b0, ks, N));
  wg::commit();
  wg::wait<0>();
  wg::fence_operands(acc);
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float* o = d + (16 * w + g) * N + 8 * j + 2 * t;
    o[0] = acc[4 * j];
    o[1] = acc[4 * j + 1];
    o[8 * N] = acc[4 * j + 2];
    o[8 * N + 1] = acc[4 * j + 3];
  }
}

// `groups` warpgroups a CTA each issue iters x 4 products m64nNk16 on
// operands resident in shared memory (A 32 KB a group, one 32 KB slab), a
// group of four committed at a time, one group kept in flight.
template <int N>
__global__ void __launch_bounds__(256, 1) chain_probe(
    float* out, long long* clk, int iters, int groups) {
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int i = threadIdx.x; i < 3 * 32768 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem)[i] = 0x3c003c00u ^ (i & 0x00ff00ff);
  wg::fence_async_smem();
  __syncthreads();
  const int group = threadIdx.x >> 7;
  if (group >= groups) return;
  float acc[128];   // N = 128: the first 64
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  wg::fence_operands(acc);
  wg::fence();
  const uint32_t a0 = wg::smem_u32(smem + group * 32768);
  const uint32_t b0 = wg::smem_u32(smem + 65536);
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg::product<N>(acc, wg::desc_k(a0, ks, 64), wg::desc_k(b0, ks, N));
    wg::commit();
    wg::wait<1>();
  }
  wg::wait<0>();
  const long long t1 = clock64();
  wg::fence_operands(acc);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if ((threadIdx.x & 127) == 0) clk[2 * blockIdx.x + group] = t1 - t0;
}

extern "C" int nnc_wgmma_layer(const void* a, const void* b_img, float* d,
                               int K, int N) {
  const int smem = 64 * K * 2 + K * N * 2;
  cudaError_t err;
  if (N == 256) {
    err = cudaFuncSetAttribute(layer_probe<256>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      layer_probe<256><<<1, 128, smem>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const uint4*>(b_img), d, K);
  } else {
    err = cudaFuncSetAttribute(layer_probe<128>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      layer_probe<128><<<1, 128, smem>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const uint4*>(b_img), d, K);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}

extern "C" int nnc_wgmma_chain(float* out, long long* clk, int blocks,
                               int iters, int groups, int N) {
  const int smem = 3 * 32768;
  cudaError_t err;
  if (N == 256) {
    err = cudaFuncSetAttribute(chain_probe<256>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      chain_probe<256><<<blocks, 256, smem>>>(out, clk, iters, groups);
  } else {
    err = cudaFuncSetAttribute(chain_probe<128>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      chain_probe<128><<<blocks, 256, smem>>>(out, clk, iters, groups);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}
"""


def build_wgmma_probe():
    """Compiles section 10's probe (``WGMMA_PROBE_CU`` against this
    checkout's ``nerf_mlp_wgmma.cuh``) and loads it."""
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "wgmma_probe.cu")
    with open(src, "w") as f:
        f.write(WGMMA_PROBE_CU)
    so = os.path.join(OUT, "wgmma_probe.so")
    proc = _compile(src, so, "-I", _build.SRC_DIR)
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the wgmma probe:\n{log}")
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nnc_wgmma_layer.argtypes = [vp, vp, vp, ci, ci]
    lib.nnc_wgmma_chain.argtypes = [vp, vp, ci, ci, ci, ci]
    return lib, log


def wgmma_layer_errors(lib, dev, seed=10):
    """One warpgroup's layer a (64 x 256) @ w (256 x N) for N = 256 and 128,
    bf16 operands from a seed, against ``torch.mm`` of the same values in
    float32: {N: (max |d|, max |ref|)}. A wrong descriptor or swizzle reads
    other values and misses by the size of the result itself."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for n_out in (256, 128):
        k = 256
        a = torch.randn(64, k, generator=g).to(torch.bfloat16)
        w = torch.randn(k, n_out, generator=g).to(torch.bfloat16)
        d = torch.full((64, n_out), float("nan"), device=dev)
        a_d = a.to(dev)
        img = mlp_fused.wgmma_image(w).to(dev)
        rc = lib.nnc_wgmma_layer(a_d.data_ptr(), img.data_ptr(),
                                 d.data_ptr(), k, n_out)
        assert rc == 0, rc
        want = torch.mm(a.float(), w.float())
        out[n_out] = (float((d.cpu() - want).abs().max()),
                      float(want.abs().max()))
    return out


def wgmma_probe(lib, dev):
    """Section 10: the layer against torch.mm, then the chain's clocks per
    product with one and two warpgroups a CTA, one CTA an SM."""
    errs = wgmma_layer_errors(lib, dev)
    for n_out, (err, top) in errs.items():
        print(f"[10] wgmma m64n{n_out}k16, K 256, A and B from shared memory "
              f"(128-byte swizzle, descriptors of nerf_mlp_wgmma.cuh) "
              f"against torch.mm in float32: max |d| {err:.3e} of max "
              f"|ref| {top:.3e}")
        assert err <= 1e-4 * top, "the wgmma probe disagrees with torch.mm"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 256, device=dev)
    clk = torch.zeros(2 * sms, dtype=torch.int64, device=dev)
    iters = 2000
    for n_out in (256, 128):
        for groups in (1, 2):
            args = (out.data_ptr(), clk.data_ptr(), sms, iters, groups, n_out)
            assert lib.nnc_wgmma_chain(*args) == 0
            ms = _ms(lambda: lib.nnc_wgmma_chain(*args), iters=3, warmup=1)
            per = clk.view(sms, 2)[:, :groups].double().max(1).values.mean()
            products = iters * 4 * groups
            flop = sms * products * 2 * 64 * n_out * 16
            print(f"[10] wgmma m64n{n_out}k16 chain, {groups} warpgroup(s) "
                  f"a CTA, one CTA an SM: {per.item() / products:.1f} clocks "
                  f"per product an SM ({2 * 64 * n_out * 16 * products / per.item():.0f} "
                  f"FLOP a clock), {flop / ms / 1e9:.1f} TFLOP/s over the "
                  f"card (launch included)")


# Section 11's build: slab_ring.cuh's issue() re-arms a stage's barrier
# without a copy once the first stages are in.
NO_COPY = ("""  __device__ __forceinline__ void issue(int slab_j) const {
    const int st = slab_j % STAGES;
    const uint32_t bar = smem_u32(&s->full[st]);
""", """  __device__ __forceinline__ void issue(int slab_j) const {
    const int st = slab_j % STAGES;
    const uint32_t bar = smem_u32(&s->full[st]);
    if (slab_j >= STAGES) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                   : "memory");
      return;
    }
""")


def no_copy_source():
    """A copy of ops/csrc under the probe's build directory with NO_COPY
    applied; returns K-B3 bf16's source in it."""
    import shutil
    dst = os.path.join(OUT, "no_copy_src")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.SRC_DIR, dst)
    ring = os.path.join(dst, "slab_ring.cuh")
    with open(ring) as f:
        text = f.read()
    assert NO_COPY[0] in text, "slab_ring.cuh's issue() changed"
    with open(ring, "w") as f:
        f.write(text.replace(NO_COPY[0], NO_COPY[1]))
    return os.path.join(dst, "mlp_from_points_bf16.cu")

def _compile(src, so, *flags):
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _ms(fn, iters=10, warmup=3):
    for _ in range(warmup):
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


MMA_KINDS = {"tf32": (0, 1, "TF32 TFLOP/s", 8),
               "bf16": (1, 5, "BF16 TFLOP/s", 16),
               "s8": (2, 6, "int8 TOP/s", 32)}


def issue_rate(lib, dev, kind="tf32"):
    """Section 1 (TF32 m16n8k8), the first part of section 5 (bf16
    m16n8k16, twice the depth a product) or of section 6 (s8 m16n8k32, four
    times the depth)."""
    code, section, what, depth = MMA_KINDS[kind]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 512, device=dev)
    clk = torch.zeros(sms, dtype=torch.int64, device=dev)
    iters = 2000
    for nacc in (8, 16, 32):
        for warps in (4, 8, 16):
            if nacc * warps > 256:    # more registers than an SM has
                continue
            args = (nacc, 32 * warps, sms, iters, out.data_ptr(),
                    clk.data_ptr(), code)
            assert lib.nnc_issue_rate(*args) == 0
            ms = _ms(lambda: lib.nnc_issue_rate(*args), iters=3, warmup=1)
            per_part = iters * nacc * warps / 4
            flop = sms * iters * nacc * warps * 2 * 16 * 8 * depth
            print(f"[{section}] {warps // 4} warps a sub-partition, {nacc} "
                  f"accumulators a warp: {clk.double().mean().item() / per_part:.2f} "
                  f"clocks per mma.sync a sub-partition, "
                  f"{flop / ms / 1e9:.1f} {what} over the card")


def chain(libs, dev):
    g = torch.Generator().manual_seed(0)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    packed_mma = mlp_fused.pack_weights_mma(model)
    pts = (4 * torch.rand(N_POINTS, 3, generator=g) - 2).to(dev)
    vd = torch.randn(N_POINTS, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
    outs = {}

    def launch(name):
        out = outs.setdefault(name, torch.empty(N_POINTS, 4, device=dev))
        rc = libs[name].nnc_mlp_from_points(
            packed_mma.data_ptr(), pts.data_ptr(), vd.data_ptr(),
            out.data_ptr(), N_POINTS,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (name, rc)

    times = [{name: _ms(lambda: launch(name)) for name in ("shipped", "cvt")}
             for _ in range(2)]
    assert torch.equal(outs["shipped"], outs["cvt"]), \
        "the integer rounding and cvt.rna.tf32.f32 disagree"
    shown = {name: [f"{t[name]:.3f}" for t in times] for name in times[0]}
    print(f"[2] K-B3 {N_POINTS} points in turns, ms: integer rounding "
          f"{shown['shipped']}, cvt.rna.tf32.f32 {shown['cvt']}; outputs "
          f"bit-equal")
    sums = (ctypes.c_ulonglong * len(PROFILE_SLOTS))()
    launch("profile")
    torch.cuda.synchronize()
    assert libs["profile"].nnc_mma_profile(sums) == 0   # warm-up, discarded
    launch("profile")
    torch.cuda.synchronize()
    assert libs["profile"].nnc_mma_profile(sums) == 0
    tiles = -(-N_POINTS // 64)
    total = sum(sums)
    print(f"[2] clocks of a tile of 64 points by thread 0's marks, "
          f"{total / tiles:.0f} in all:")
    for slot, what in enumerate(PROFILE_SLOTS):
        print(f"      {what:28s} {sums[slot] / tiles:9.0f}  "
              f"{100 * sums[slot] / total:5.1f}%")


def _show_clocks(lib_fn, slots, tiles, what, section=4, points=64):
    """Reads (and zeroes) a build's clock sums by ``lib_fn`` and prints each
    part's share of a tile's clocks."""
    sums = (ctypes.c_ulonglong * len(slots))()
    assert lib_fn(sums) == 0
    total = sum(sums)
    print(f"[{section}] {what}: clocks of a tile of {points} points by "
          f"thread 0's marks, {total / tiles:.0f} in all:")
    for slot, name in enumerate(slots):
        print(f"      {name:48s} {sums[slot] / tiles:9.0f}  "
              f"{100 * sums[slot] / total:5.1f}%")


def train_pair(libs, dev):
    """Section 4: K-B1 float32 as shipped and with clock marks, at the LSA
    step's fine pass and at the occupancy loss's points."""
    g = torch.Generator().manual_seed(4)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    t = mlp_train_fused._layer_tensors(model)
    params, _params_t, ls = mlp_train_fused.pack_train(t[0::3], t[1::3],
                                                       t[2::3])
    fw, bw = mlp_train_fused.pack_train_wgmma(t[0::3])
    bi = mlp_train_fused.gather_biases(params)
    stream = torch.cuda.current_stream().cuda_stream
    size = mlp_train_fused.grad_size(False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (N_TRAIN, N_OCC):
        pts = (4 * torch.rand(n, 3, generator=g) - 2).to(dev)
        vd = torch.randn(n, 3, generator=g)
        vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
        cot = (1e-3 * torch.randn(n, 4, generator=g)).to(dev)
        tiles = -(-n // 64)
        grid = min(tiles, sms)
        partials = torch.empty(grid, size, device=dev)
        raws = {k: torch.empty(n, 4, device=dev) for k in libs}
        wss = {k: torch.empty(tiles * 64, mlp_train_fused.U_SIZE, device=dev)
               for k in libs}
        flats = {k: torch.empty(size, device=dev) for k in libs}

        def fwd(name, save=True):
            rc = libs[name].nnc_mlp_train_fwd(
                fw.data_ptr(), ls.data_ptr(), bi.data_ptr(), pts.data_ptr(),
                vd.data_ptr(), raws[name].data_ptr(),
                wss[name].data_ptr() if save else None, n, stream)
            assert rc == 0, (name, rc)

        def bwd(name):
            rc = libs[name].nnc_mlp_train_bwd_mma(
                bw.data_ptr(), ls.data_ptr(), bi.data_ptr(), cot.data_ptr(),
                wss[name].data_ptr(), None, partials.data_ptr(),
                flats[name].data_ptr(), n, grid, stream)
            assert rc == 0, (name, rc)

        t_fwd = [_ms(lambda: fwd("train")) for _ in range(2)]
        no_ws = _ms(lambda: fwd("train", save=False))
        t_bwd = [_ms(lambda: bwd("train")) for _ in range(2)]
        print(f"[4] K-B1 {n} points, {grid} CTAs, ms: forward "
              f"{[f'{x:.3f}' for x in t_fwd]}, without the workspace "
              f"{no_ws:.3f}; backward without dW "
              f"{[f'{x:.3f}' for x in t_bwd]}")
        prof = libs["train_profile"]
        sums = (ctypes.c_ulonglong * len(TRAIN_SLOTS))()
        fwd("train_profile")
        torch.cuda.synchronize()
        assert prof.nnc_train_profile(sums) == 0   # warm-up, discarded
        fwd("train_profile")
        torch.cuda.synchronize()
        _show_clocks(prof.nnc_train_profile, TRAIN_SLOTS, tiles,
                     f"forward, {n} points")
        bwd("train_profile")
        torch.cuda.synchronize()
        assert prof.nnc_train_profile(sums) == 0
        bwd("train_profile")
        torch.cuda.synchronize()
        _show_clocks(prof.nnc_train_profile, TRAIN_SLOTS, tiles,
                     f"backward without dW, {n} points")
        assert torch.equal(raws["train"], raws["train_profile"]) and \
            torch.equal(wss["train"], wss["train_profile"]) and \
            torch.equal(flats["train"], flats["train_profile"]), \
            "the build with clock marks computes other values"


def train_bf16(libs, dev):
    """Section 7: K-B1's bf16 forward as shipped, without its workspace, and
    with clock marks; then its backward without dW as shipped and with clock
    marks."""
    g = torch.Generator().manual_seed(4)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    t = mlp_train_fused._layer_tensors(model)
    params, _params_t, ls = mlp_train_fused.pack_train(t[0::3], t[1::3],
                                                       t[2::3])
    fw, bw = mlp_train_fused.pack_train_bf16(t[0::3])
    bi = mlp_train_fused.gather_biases(params)
    n = N_TRAIN
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(dev)
    vd = torch.randn(n, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
    tile = mlp_train_fused.TILE_BF16
    ws = torch.empty(-(-n // tile) * tile, mlp_train_fused.U_SIZE, device=dev)
    raws = {k: torch.empty(n, 4, device=dev) for k in ("ws", "no_ws", "prof")}
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(lib, raw, save=True):
        rc = lib.nnc_mlp_train_fwd_bf16(
            fw.data_ptr(), ls.data_ptr(), bi.data_ptr(), pts.data_ptr(),
            vd.data_ptr(), raw.data_ptr(), ws.data_ptr() if save else None, n,
            stream)
        assert rc == 0, rc

    shipped = libs["train_bf16"]
    runs = {"with the workspace (shipped)": lambda: fwd(shipped, raws["ws"]),
            "without it": lambda: fwd(shipped, raws["no_ws"], save=False)}
    times = [{k: _ms(fn) for k, fn in runs.items()} for _ in range(2)]
    assert torch.equal(raws["ws"], raws["no_ws"]), \
        "the forward's raw depends on whether it saves u"
    print(f"[7] K-B1 bf16 forward {n} points in turns, ms: "
          + "; ".join(f"{k} {[f'{x[k]:.3f}' for x in times]}" for k in runs)
          + " (raw bit-equal)")
    prof = libs["train_bf16_profile"]
    sums = (ctypes.c_ulonglong * len(TRAIN_BF16_FWD_SLOTS))()
    fwd(prof, raws["prof"])   # a warm-up, its clocks discarded
    torch.cuda.synchronize()
    assert prof.nnc_train_bf16_profile(sums) == 0
    fwd(prof, raws["prof"])
    torch.cuda.synchronize()
    assert torch.equal(raws["prof"], raws["ws"]), \
        "the build with clock marks computes another raw"
    _show_clocks(prof.nnc_train_bf16_profile, TRAIN_BF16_FWD_SLOTS,
                 -(-n // tile), "forward (group 0)", 7, tile)

    # the backward without dW on the shipped forward's workspace
    fwd(shipped, raws["ws"])
    cot = (1e-3 * torch.randn(n, 4, generator=g)).to(dev)
    tiles = -(-n // 64)
    grid = min(tiles, torch.cuda.get_device_properties(dev)
               .multi_processor_count)
    size = mlp_train_fused.grad_size(False)
    partials = torch.empty(grid, size, device=dev)
    flats = {k: torch.empty(size, device=dev) for k in ("shipped", "prof")}

    def bwd(lib, flat):
        rc = lib.nnc_mlp_train_bwd_bf16(
            bw.data_ptr(), ls.data_ptr(), bi.data_ptr(), cot.data_ptr(),
            ws.data_ptr(), None, partials.data_ptr(), flat.data_ptr(), n,
            grid, stream)
        assert rc == 0, rc

    t_bwd = [_ms(lambda: bwd(shipped, flats["shipped"])) for _ in range(2)]
    print(f"[7] K-B1 bf16 backward without dW {n} points, ms: "
          f"{[f'{x:.3f}' for x in t_bwd]}")
    bwd(prof, flats["prof"])   # a warm-up, its clocks discarded
    torch.cuda.synchronize()
    assert prof.nnc_train_bf16_profile(sums) == 0
    bwd(prof, flats["prof"])
    torch.cuda.synchronize()
    assert torch.equal(flats["prof"], flats["shipped"]), \
        "the build with clock marks computes other gradients"
    _show_clocks(prof.nnc_train_bf16_profile, TRAIN_BF16_BWD_SLOTS, tiles,
                 "backward without dW", 7)


def bf16_chain(libs, dev):
    """Section 5: K-B3 bf16 (the wgmma chain) as shipped and with clock
    marks, beside the float32 kernel."""
    g = torch.Generator().manual_seed(0)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    packed = mlp_fused.pack_weights(model)
    packed_mma = mlp_fused.repack_mma(packed)
    buf = mlp_fused.repack_bf16(packed)
    wg = mlp_fused.repack_bf16_wgmma(buf)
    pts = (4 * torch.rand(N_POINTS, 3, generator=g) - 2).to(dev)
    vd = torch.randn(N_POINTS, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
    outs = {}

    def launch(name):
        out = outs.setdefault(name, torch.empty(N_POINTS, 4, device=dev))
        stream = torch.cuda.current_stream().cuda_stream
        if name == "shipped":
            rc = libs[name].nnc_mlp_from_points(
                packed_mma.data_ptr(), pts.data_ptr(), vd.data_ptr(),
                out.data_ptr(), N_POINTS, stream)
        else:
            rc = libs[name].nnc_mlp_from_points_bf16(
                buf.data_ptr(), wg.data_ptr(), pts.data_ptr(), vd.data_ptr(),
                out.data_ptr(), N_POINTS, stream)
        assert rc == 0, (name, rc)

    names = ("bf16", "shipped")
    times = [{name: _ms(lambda: launch(name)) for name in names}
             for _ in range(2)]
    shown = {name: [f"{t[name]:.3f}" for t in times] for name in names}
    slab_bytes = 4 * mlp_fused.WG_SIZE
    print(f"[5] K-B3 bf16 {N_POINTS} points in turns, ms: wgmma chain "
          f"{shown['bf16']}, the float32 kernel {shown['shipped']}; weight "
          f"bytes a point reads from L2: {slab_bytes / 128:.0f} "
          f"({slab_bytes * N_POINTS / 128 / 1e9:.2f} GB a launch)")
    prof = libs["bf16_profile"]
    sums = (ctypes.c_ulonglong * len(KB3_BF16_SLOTS))()
    for _ in range(2):   # the first is a warm-up, discarded
        launch("bf16_profile")
        torch.cuda.synchronize()
        assert prof.nnc_mma_profile(sums) == 0
    assert torch.equal(outs["bf16"], outs["bf16_profile"]), \
        "the build with clock marks computes another raw"
    n_tiles = -(-N_POINTS // 128)
    total = sum(sums)
    print(f"[5] clocks of a bf16 tile of 128 points by warpgroup 0's first "
          f"thread's marks, {total / n_tiles:.0f} in all "
          f"({total / N_POINTS:.1f} a point; raw bit-equal to the shipped "
          f"build's):")
    for slot, what in enumerate(KB3_BF16_SLOTS):
        print(f"      {what:48s} {sums[slot] / n_tiles:9.0f}  "
              f"{100 * sums[slot] / total:5.1f}%")


def l2_question(libs, dev):
    """Section 11: K-B3 bf16 as shipped in turns with the build that copies
    no slab after the first stages, each with clock marks."""
    g = torch.Generator().manual_seed(0)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    buf = mlp_fused.repack_bf16(mlp_fused.pack_weights(model))
    wg = mlp_fused.repack_bf16_wgmma(buf)
    pts = (4 * torch.rand(N_POINTS, 3, generator=g) - 2).to(dev)
    vd = torch.randn(N_POINTS, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
    out = torch.empty(N_POINTS, 4, device=dev)

    def launch(name):
        rc = libs[name].nnc_mlp_from_points_bf16(
            buf.data_ptr(), wg.data_ptr(), pts.data_ptr(), vd.data_ptr(),
            out.data_ptr(), N_POINTS, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (name, rc)

    names = {"bf16": "as shipped", "no_copy": "no copies after the first "
             "stages (raw wrong)"}
    times = [{k: _ms(lambda: launch(k), iters=20) for k in names}
             for _ in range(3)]
    print("[11] K-B3 bf16 262144 points in turns, ms: " + "; ".join(
        f"{what} {[f'{t[k]:.4f}' for t in times]}"
        for k, what in names.items()))
    for k, what in names.items():
        prof = libs[k + "_profile"]
        sums = (ctypes.c_ulonglong * len(KB3_BF16_SLOTS))()
        for _ in range(2):   # the first is a warm-up, discarded
            launch(k + "_profile")
            torch.cuda.synchronize()
            assert prof.nnc_mma_profile(sums) == 0
        tiles = -(-N_POINTS // 128)
        total = sum(sums)
        print(f"[11] {what}: clocks of a tile {total / tiles:.0f}, waiting "
              f"for a slab {sums[1] / tiles:.0f} "
              f"({100 * sums[1] / total:.1f}%)")

def sass_counts(so):
    print(f"[3] SASS opcodes of the shipped K-B3: "
          f"{_build.opcodes(so).most_common(16)}")


def int8_sass(so):
    """Section 6, second part: K-B4's opcodes, its products' instructions
    first."""
    ops = _build.opcodes(so, "mlp_int8_from_points_kernel")
    print(f"[6] SASS of K-B4: IMMA {ops['IMMA']}, IDP.4A {ops['IDP']}, "
          f"HMMA {ops['HMMA']}; most common {ops.most_common(12)}")


def int8_kernel(libs, dev):
    """Section 6, third part: K-B4 at 262,144 points as shipped and with
    clock marks (outputs bit-equal), the share of a tile's clocks in each
    part."""
    g = torch.Generator().manual_seed(0)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    buf = mlp_fused.pack_weights_int8_mma(model)
    pts = (4 * torch.rand(N_POINTS, 3, generator=g) - 2).to(dev)
    vd = torch.randn(N_POINTS, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
    names = [k for k in libs if k.startswith("int8")]
    outs = {k: torch.empty(N_POINTS, 4, device=dev) for k in names}

    def launch(name):
        rc = libs[name].nnc_mlp_int8_from_points(
            buf.data_ptr(), pts.data_ptr(), vd.data_ptr(),
            outs[name].data_ptr(), N_POINTS,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (name, rc)

    timed = [k for k in names if k != "int8_profile"]
    times = [{k: _ms(lambda: launch(k)) for k in timed} for _ in range(2)]
    sums = (ctypes.c_ulonglong * len(INT8_SLOTS))()
    for _ in range(2):   # the first is a warm-up, discarded
        launch("int8_profile")
        torch.cuda.synchronize()
        assert libs["int8_profile"].nnc_int8_profile(sums) == 0
    for k in names:
        assert torch.equal(outs[k], outs["int8"]), f"{k} computes another raw"
    print(f"[6] K-B4 {N_POINTS} points in turns, ms: "
          + "; ".join(f"{k} {[f'{x[k]:.3f}' for x in times]}" for k in timed)
          + " (outputs bit-equal)")
    tiles = -(-N_POINTS // 128)
    total = sum(sums)
    print(f"[6] clocks of a K-B4 tile of 128 points by thread 0's marks "
          f"(group 0), "
          f"{total / tiles:.0f} in all:")
    for slot, what in enumerate(INT8_SLOTS):
        print(f"      {what:40s} {sums[slot] / tiles:9.0f}  "
              f"{100 * sums[slot] / total:5.1f}%")


def kb5_bf16(libs, dev):
    """Section 8: K-B5 bf16 as shipped and with clock marks."""
    g = torch.Generator().manual_seed(0)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    buf = mlp_fused.pack_weights_bf16(model)
    pts = (4 * torch.rand(N_POINTS, 3, generator=g) - 2).to(dev)
    vd = torch.randn(N_POINTS, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    outs = {k: torch.empty(N_POINTS, 4, device=dev) for k in libs}

    def launch(name):
        rc = libs[name].nnc_mlp_embedded_bf16(
            buf.data_ptr(), pe.data_ptr(), ve.data_ptr(),
            outs[name].data_ptr(), N_POINTS,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (name, rc)

    times = [_ms(lambda: launch("kb5_bf16")) for _ in range(2)]
    sums = (ctypes.c_ulonglong * len(KB5_BF16_SLOTS))()
    launch("kb5_bf16_profile")   # a warm-up, its clocks discarded
    torch.cuda.synchronize()
    assert libs["kb5_bf16_profile"].nnc_mma_profile(sums) == 0
    launch("kb5_bf16_profile")
    torch.cuda.synchronize()
    assert torch.equal(outs["kb5_bf16"], outs["kb5_bf16_profile"]), \
        "the build with clock marks computes another raw"
    print(f"[8] K-B5 bf16 {N_POINTS} points, ms: "
          f"{[f'{t:.3f}' for t in times]}")
    _show_clocks(libs["kb5_bf16_profile"].nnc_mma_profile, KB5_BF16_SLOTS,
                 -(-N_POINTS // 128), "K-B5 bf16", 8, 128)


def kb6(libs, dev):
    """Section 9: K-B6 at M = 4 as shipped and with clock marks."""
    g = torch.Generator().manual_seed(7)
    n, s = N_POINTS, 64
    stream = torch.cuda.current_stream().cuda_stream
    for k, o2, relu in ((63, 256, True), (256, 256, True), (256, 128, False)):
        x = torch.randn(n, k, generator=g).to(dev)
        wa = (torch.randn(k, s, generator=g) / k ** 0.5).to(dev)
        ba = torch.randn(s, generator=g).to(dev)
        wb = (torch.randn(s, o2, generator=g) / s ** 0.5).to(dev)
        outs = {name: torch.empty(n, o2, device=dev) for name in libs}

        def launch(name):
            rc = libs[name].nnc_mlp_tp_pair(
                x.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(),
                outs[name].data_ptr(), n, k, s, o2, int(relu), stream)
            assert rc == 0, (name, rc)

        times = [_ms(lambda: launch("kb6")) for _ in range(2)]
        sums = (ctypes.c_ulonglong * len(PROFILE_SLOTS))()
        launch("kb6_profile")   # a warm-up, its clocks discarded
        torch.cuda.synchronize()
        assert libs["kb6_profile"].nnc_mma_profile(sums) == 0
        launch("kb6_profile")
        torch.cuda.synchronize()
        assert torch.equal(outs["kb6"], outs["kb6_profile"]), \
            "the build with clock marks computes another result"
        print(f"[9] K-B6 {n} points K={k} S={s} O2={o2}, ms: "
              f"{[f'{t:.3f}' for t in times]}")
        _show_clocks(libs["kb6_profile"].nnc_mma_profile,
                     KB6_SLOTS + ("(unused)",), -(-n // 64), "K-B6", 9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="1,2,3,4,5,6,7,8,9,10,11",
                    help="comma-separated section numbers to run")
    sections = {int(x) for x in ap.parse_args(argv).sections.split(",")}
    dev = torch.device("cuda", 0)
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    rate_cu = os.path.join(OUT, "issue_rate.cu")
    with open(rate_cu, "w") as f:
        f.write(MMA_RATE_CU)
    kb3 = os.path.join(_build.SRC_DIR, "mlp_from_points.cu")
    kb1 = os.path.join(_build.SRC_DIR, "mlp_train.cu")
    kb3_bf16 = os.path.join(_build.SRC_DIR, "mlp_from_points_bf16.cu")
    kb1_bf16 = os.path.join(_build.SRC_DIR, "mlp_train_bf16.cu")
    kb4 = os.path.join(_build.SRC_DIR, "mlp_int8_from_points.cu")
    kb5_bf16_src = os.path.join(_build.SRC_DIR, "mlp_embedded_bf16.cu")
    kb6_src = os.path.join(_build.SRC_DIR, "mlp_tp_pair.cu")
    # (section numbers that need it, source, flags)
    builds = {"issue_rate": ({1, 5, 6}, rate_cu),
              "shipped": ({2, 3, 5}, kb3),
              "cvt": ({2}, kb3, "-DNNC_SPLIT_CVT"),
              "profile": ({2}, kb3, "-DNNC_MMA_PROFILE"),
              "train": ({4}, kb1),
              "train_profile": ({4}, kb1, "-DNNC_MMA_PROFILE"),
              "bf16": ({5, 11}, kb3_bf16),
              "bf16_profile": ({5, 11}, kb3_bf16, "-DNNC_MMA_PROFILE"),
              "int8": ({6}, kb4),
              "int8_profile": ({6}, kb4, "-DNNC_MMA_PROFILE"),
              "train_bf16": ({7}, kb1_bf16),
              "train_bf16_profile": ({7}, kb1_bf16, "-DNNC_MMA_PROFILE"),
              "kb5_bf16": ({8}, kb5_bf16_src),
              "kb5_bf16_profile": ({8}, kb5_bf16_src, "-DNNC_MMA_PROFILE"),
              "kb6": ({9}, kb6_src),
              "kb6_profile": ({9}, kb6_src, "-DNNC_MMA_PROFILE")}
    if 11 in sections:
        no_copy = no_copy_source()
        builds["no_copy"] = ({11}, no_copy)
        builds["no_copy_profile"] = ({11}, no_copy, "-DNNC_MMA_PROFILE")
    procs = {name: _compile(args[1], os.path.join(OUT, name + ".so"),
                            *args[2:]) for name, args in builds.items()
             if args[0] & sections}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if name != "issue_rate" and "registers" in line:
                print(f"    ptxas, {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, name + ".so"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if "issue_rate" in libs:
        libs["issue_rate"].nnc_issue_rate.argtypes = [ci, ci, ci, ci, vp, vp,
                                                      ci]
    for name in ("shipped", "cvt", "profile"):
        if name in libs:
            libs[name].nnc_mlp_from_points.argtypes = [vp, vp, vp, vp, ci,
                                                       vp]
    for name in (n for n in libs if n.startswith(("bf16", "no_copy"))):
        libs[name].nnc_mlp_from_points_bf16.argtypes = [vp] * 5 + [ci, vp]
    for name in ("train", "train_profile"):
        if name in libs:
            libs[name].nnc_mlp_train_fwd.argtypes = [vp] * 7 + [ci, vp]
            libs[name].nnc_mlp_train_bwd_mma.argtypes = [vp] * 8 + [ci, ci,
                                                                   vp]
    for name in (n for n in libs if n.startswith("int8")):
        libs[name].nnc_mlp_int8_from_points.argtypes = [vp, vp, vp, vp, ci,
                                                        vp]
    for name in (n for n in libs if n.startswith("kb5_bf16")):
        libs[name].nnc_mlp_embedded_bf16.argtypes = [vp, vp, vp, vp, ci, vp]
    for name in (n for n in libs if n.startswith("kb6")):
        libs[name].nnc_mlp_tp_pair.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    for name in (n for n in libs if n.startswith("train_bf16")):
        libs[name].nnc_mlp_train_fwd_bf16.argtypes = [vp] * 7 + [ci, vp]
        libs[name].nnc_mlp_train_bwd_bf16.argtypes = [vp] * 8 + [ci, ci, vp]
    if 1 in sections:
        issue_rate(libs["issue_rate"], dev)
    if 2 in sections:
        chain(libs, dev)
    if 3 in sections:
        sass_counts(os.path.join(OUT, "shipped.so"))
    if 4 in sections:
        train_pair({k: v for k, v in libs.items()
                    if k in ("train", "train_profile")}, dev)
    if 5 in sections:
        issue_rate(libs["issue_rate"], dev, "bf16")
        bf16_chain({k: v for k, v in libs.items()
                    if k.startswith("bf16") or k == "shipped"}, dev)
    if 6 in sections:
        issue_rate(libs["issue_rate"], dev, "s8")
        int8_sass(os.path.join(OUT, "int8.so"))
        int8_kernel({k: v for k, v in libs.items() if k.startswith("int8")},
                    dev)
    if 7 in sections:
        train_bf16(libs, dev)
    if 8 in sections:
        kb5_bf16({k: v for k, v in libs.items() if k.startswith("kb5_bf16")},
                 dev)
    if 9 in sections:
        kb6({k: v for k, v in libs.items() if k.startswith("kb6")}, dev)
    if 10 in sections:
        lib, log = build_wgmma_probe()
        for line in log.splitlines():
            if "registers" in line or "wgmma" in line.lower():
                print(f"    ptxas, wgmma probe: {line.strip()}")
        wgmma_probe(lib, dev)
    if 11 in sections:
        l2_question({k: v for k, v in libs.items()
                     if k.startswith(("bf16", "no_copy"))}, dev)


if __name__ == "__main__":
    main()
