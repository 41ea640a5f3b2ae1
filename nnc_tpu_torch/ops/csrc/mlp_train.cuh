// What K-B1's kernels share, in float32 (mlp_train.cu) and in bf16
// (mlp_train_bf16.cu), and its weight gradient's GEMM (mlp_train_dw.cu): the
// layout of the per-point workspaces of u and du and of the gradients, the
// loads of u and of a layer's scales and biases onto the accumulator
// fragments of a 64-point tile, and the fixed-order sum of the CTAs'
// partial gradients.
//
// Layouts (nnc_tpu_torch/ops/mlp_train_fused.py): a workspace row, the
// scale and bias vectors and the dls / db parts of the gradient hold every
// layer's outputs one after the other (u_offset, 2,436 in all); the dW part
// every layer's (out, in) weight one after the other (wt_offset).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "nerf_mlp.cuh"

namespace nerf {
namespace train {

__host__ __device__ constexpr int u_offset(int i) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += layer_out(j);
  return off;
}
__host__ __device__ constexpr int wt_offset(int i) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += layer_in(j) * layer_out(j);
  return off;
}
constexpr int kU = u_offset(kLayers);     // 2,436 outputs of the 12 layers
// row stride of the bf16 du workspace (the backward with dW): kU rounded up
// to 8 values, so that every row starts 16-byte aligned
constexpr int kDuLdBf16 = (kU + 7) / 8 * 8;
constexpr int kWt = wt_offset(kLayers);   // 593,408 weights
constexpr int kLayerFeature = 8, kLayerAlpha = 9, kLayerViews = 10,
              kLayerRgb = 11;

// Asks L2 for the tile's 64 workspace rows at one layer's columns (p: row 0
// at the layer's first column, `bytes` wide), one 128-byte line a request,
// four threads a row. Issued before the layer's product loop, so that the
// epilogue's loads find u in L2 instead of waiting for device memory once
// per n-tile.
__device__ __forceinline__ void prefetch_u(const float* __restrict__ p,
                                           int bytes) {
  const char* row = reinterpret_cast<const char*>(
      p + static_cast<size_t>(threadIdx.x >> 2) * kU);
  for (int off = (threadIdx.x & 3) * 128; off < bytes; off += 512)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + off));
  // rows start 16 bytes off a line's start or more: the last bytes may lie
  // in one more line
  if ((threadIdx.x & 3) == 3)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + bytes - 4));
}

// This thread's scales and biases of a layer: lb[nt] = {ls, ls, b, b} of
// columns c, c + 1 at c = col0 + 8 nt.
template <int NT>
__device__ __forceinline__ void load_lb(float (&lb)[NT][4],
                                        const float* __restrict__ ls,
                                        const float* __restrict__ b,
                                        int col0) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    lb[nt][0] = __ldg(ls + col0 + nt * 8);
    lb[nt][1] = __ldg(ls + col0 + nt * 8 + 1);
    lb[nt][2] = __ldg(b + col0 + nt * 8);
    lb[nt][3] = __ldg(b + col0 + nt * 8 + 1);
  }
}

// This thread's u of a layer, from the workspace (U: the tile's first row
// at the layer's columns): u[nt][mt][half] holds rows mt * 16 + g + 8 half,
// columns c, c + 1 at c = col0 + 8 nt. U2: the columns start at an even
// offset, so the two are one 8-byte load.
template <int NT, bool U2>
__device__ __forceinline__ void load_u(float (&u)[NT][4][2][2],
                                       const float* __restrict__ U, int g,
                                       int col0) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* up = U +
            static_cast<size_t>(mt * 16 + g + 8 * half) * kU + col0 + nt * 8;
        if (U2) {
          const float2 u2 = __ldcs(reinterpret_cast<const float2*>(up));
          u[nt][mt][half][0] = u2.x;
          u[nt][mt][half][1] = u2.y;
        } else {
          u[nt][mt][half][0] = __ldcs(up);
          u[nt][mt][half][1] = __ldcs(up + 1);
        }
      }
}

// x rounded to bf16 (to nearest even) and widened again.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace train
}  // namespace nerf

// (in the file's own unnamed namespace: nvcc's host stubs cannot name a
// kernel in an unnamed namespace nested in a named one beside it)
namespace {

// out[col] = sum over the G partial rows, in row order; the first
// round_cols columns rounded to bf16 (the bf16 form's dW, which the
// reference rounds on its way out: mlp_train_pallas.py:358).
__global__ void reduce_rows_kernel(const float* __restrict__ partials, int G,
                                   int stride, int round_cols,
                                   float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= stride) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g)
    acc += partials[static_cast<size_t>(g) * stride + col];
  out[col] = col < round_cols ? nerf::train::bf16_round(acc) : acc;
}

int reduce_rows(const float* partials, int G, int stride, float* out,
                cudaStream_t stream, int round_cols = 0) {
  reduce_rows_kernel<<<(stride + 255) / 256, 256, 0, stream>>>(
      partials, G, stride, round_cols, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
