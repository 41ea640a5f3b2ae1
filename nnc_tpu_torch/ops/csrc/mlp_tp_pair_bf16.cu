// K-B6 in bf16: one shard's column + row pair of the tensor-parallel NeRF
// MLP, out = bf16(act(bf16(x) @ Wa + ba)) @ Wb, Wa and Wb in bf16, every sum
// and the result float32.
//
// Replaces the Pallas kernel _pair_kernel / fused_pair
// (nnc_tpu/ops/mlp_tp_pallas.py:64, :82) as it runs when config.compute_dtype
// is bfloat16: _tp_forward rounds each pair's input (x.astype(cdt), :118),
// the products accumulate in float32 (preferred_element_type), and the hidden
// tile is rounded to the weights' type after the activation (:73), or
// without one for the wf -> wva pair. Wa (K, S) is a column shard of an even
// layer (w0, w2, w4, w6, wf), Wb (S, O2) the matching row shard of the odd
// layer behind it (w1, w3, w5b, w7, wva), S = 256 / M for M shards. The
// result is a partial sum; the sum over the shards, the odd layer's bias and
// its activation happen outside (nnc_tpu_torch/ops/mlp_tp_fused.py).
//
// Bound on the H100: bytes. 2 S (K + O2) operations a point at the dense
// bf16 peak of 989 TFLOP/s against 4 (K + O2) bytes (x read as float32, the
// float32 partial sums written) at 3.35 TB/s: S / 2 operations a byte
// against the card's 295. At M = 4 (K 256, S 64, O2 256) and 262,144
// points: 0.160 ms by bytes, 0.017 ms by operations.
//
// Design: a CTA of 256 threads takes a tile of 64 points; two CTAs fit on an
// SM, so one loads while the other computes.
//  * x: the tile's rows read once from device memory (float4 loads for K =
//    256, coalesced 4-byte loads for K = 63, whose rows of 252 bytes are not
//    16-byte aligned), every load issued before the first store, rounded to
//    bf16 (nearest even) into shared memory, point-major. K = 63 is padded
//    to 64 by a zero column of x and a zero row of Wa, both written once.
//  * The hidden width in chunks of SC = 64 channels (32 at S = 32):
//    act(x Wa + ba) Wb = sum over chunks c of act(x Wa[:, c] + ba[c]) Wb[c, :],
//    and the rounding of the hidden tile is elementwise, so the chunks give
//    the same bits as one pass over S. A chunk's Wa columns (K x SC) and Wb
//    rows (SC x O2) are staged in shared memory by cp.async (at S = 256 the
//    whole of Wa and Wb, 128 KB each in bf16, would not fit beside a tile);
//    the hidden chunk (64 x SC) stays in shared memory as bf16 and never goes
//    to device memory.
//  * Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (the
//    chain's, nerf_mlp_bf16.cuh). A by ldmatrix from the point-major bf16
//    buffers; B by ldmatrix .trans straight from the row-major staged
//    weights (so the weights need no packing on the host). Row strides of
//    (width + 8) bf16 values are odd multiples of 16 bytes: conflict-free.
//  * The first product: warps across the chunk's columns (8 warps x 8 at
//    SC = 64; 4 x 8 columns by 2 x 32 points at SC = 32), accumulators
//    started from the bias. The second: each warp owns O2 / 8 output columns
//    of all 64 points (64 float32 accumulators a thread at O2 = 256), summed
//    over the chunks in registers, and stored straight from the fragments as
//    8-byte stores, a warp filling whole 32-byte sectors.
//  * Reruns are bit-equal: no atomics, a fixed order of accumulation.
// The ragged last tile is masked here; N is not padded on the host. wgmma
// and TMA are for a later redesign.
#include "nerf_mlp_bf16.cuh"

namespace {

using nerf::kThreads;
using nerf::bf16::ldmatrix_x4;
using nerf::bf16::mma_bf16;

// 16 bytes (8 bf16) global -> shared by cp.async (nerf_mlp_mma.cuh's copy)
__device__ __forceinline__ void cp_async16(__nv_bfloat16* smem,
                                           const __nv_bfloat16* gmem) {
  nerf::mma::cp_async16(reinterpret_cast<float*>(smem),
                        reinterpret_cast<const float*>(gmem));
}

constexpr int kTile = 64;   // points a CTA

// b (two 16 x 8 B fragments of row-major k x n bf16 in shared memory): lane l
// passes the address of row (l & 15), column 8 (l >> 4) of the 16 x 16
// block; b[0], b[1] are the fragment of columns 0-7, b[2], b[3] of 8-15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}
// One 16 x 8 B fragment; lanes 0-15 pass the addresses of rows 0-15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int K, int SC, int O2>
struct Layout {
  static constexpr int kKp = (K + 15) / 16 * 16;   // depth in whole k steps
  static constexpr int kLdX = kKp + 8;             // row strides, in bf16
  static constexpr int kLdWa = SC + 8;
  static constexpr int kLdH = SC + 8;
  static constexpr int kLdWb = O2 + 8;
  static constexpr int kX = 0;                     // offsets, in bf16
  static constexpr int kWa = kX + kTile * kLdX;
  static constexpr int kH = kWa + kKp * kLdWa;
  static constexpr int kWb = kH + kTile * kLdH;
  static constexpr int kBytes = 2 * (kWb + SC * kLdWb);
};

// The tile's rows of x (n, K) float32 into xs, rounded to bf16; rows past
// `rows` become zeros.
template <int K, int LD>
__device__ __forceinline__ void load_x(__nv_bfloat16* __restrict__ xs,
                                       const float* __restrict__ x,
                                       int rows) {
  if constexpr (K % 4 == 0) {
    constexpr int kV = K / 4;                        // float4 a row
    constexpr int kIters = kTile * kV / kThreads;
    static_assert(kTile * kV % kThreads == 0, "whole float4 rounds");
    const float4* src = reinterpret_cast<const float4*>(x);
    float4 v[kIters];
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = threadIdx.x + j * kThreads;
      v[j] = i / kV < rows ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = threadIdx.x + j * kThreads;
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(
          xs + (i / kV) * LD + 4 * (i % kV));
      d[0] = __floats2bfloat162_rn(v[j].x, v[j].y);
      d[1] = __floats2bfloat162_rn(v[j].z, v[j].w);
    }
  } else {
    constexpr int kTotal = kTile * K;
    constexpr int kIters = (kTotal + kThreads - 1) / kThreads;
    float v[kIters];
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = threadIdx.x + j * kThreads;
      v[j] = i < kTotal && i / K < rows ? __ldg(x + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < kTotal) xs[(i / K) * LD + i % K] = __float2bfloat16_rn(v[j]);
    }
  }
}

template <int K, int SC, int O2, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
mlp_tp_pair_bf16_kernel(const float* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wa,
                        const float* __restrict__ ba,
                        const __nv_bfloat16* __restrict__ wb,
                        float* __restrict__ out, int n, int S) {
  using L = Layout<K, SC, O2>;
  constexpr int NT2 = O2 / 64;          // second product: n-tiles a warp
  constexpr int WN1 = SC / 8;           // first product: warps across columns
  constexpr int MT1 = 4 / (8 / WN1);    // and m-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw) + L::kX;
  __nv_bfloat16* wsa = xs + L::kWa;
  __nv_bfloat16* hs = xs + L::kH;
  __nv_bfloat16* wsb = xs + L::kWb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = n - base < kTile ? static_cast<int>(n - base) : kTile;

  // Wa's columns of chunk c and Wb's rows of it into shared memory
  auto stage = [&](int c) {
    constexpr int kPa = SC / 8;         // 16-byte pieces of a staged row
    for (int i = tid; i < K * kPa; i += kThreads) {
      const int r = i / kPa;
      const int q = i - r * kPa;
      cp_async16(wsa + r * L::kLdWa + 8 * q,
                 wa + static_cast<size_t>(r) * S + c * SC + 8 * q);
    }
    constexpr int kPb = O2 / 8;
    for (int i = tid; i < SC * kPb; i += kThreads) {
      const int r = i / kPb;
      const int q = i - r * kPb;
      cp_async16(wsb + r * L::kLdWb + 8 * q,
                 wb + static_cast<size_t>(c * SC + r) * O2 + 8 * q);
    }
    nerf::mma::cp_async_commit();
  };

  stage(0);
  if constexpr (K < L::kKp) {   // the zero padding of the depth, once
    constexpr int kPad = L::kKp - K;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < kTile * kPad; i += kThreads)
      xs[(i / kPad) * L::kLdX + K + i % kPad] = zero;
    for (int i = tid; i < kPad * SC; i += kThreads)
      wsa[(K + i / SC) * L::kLdWa + i % SC] = zero;
  }
  load_x<K, L::kLdX>(xs, x + base * K, rows);

  float acc[4][NT2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int n1 = 8 * (warp % WN1);      // first product: this warp's columns
  const int m1 = (warp / WN1) * MT1;    // and first m-tile
  const int n2 = warp * 8 * NT2;        // second product: its columns
  const uint32_t a1_addr =
      smem_addr(xs + (16 * m1 + (lane & 15)) * L::kLdX + 8 * (lane >> 4));
  const uint32_t b1_addr = smem_addr(wsa + (lane & 15) * L::kLdWa + n1);
  const uint32_t a2_addr =
      smem_addr(hs + (lane & 15) * L::kLdH + 8 * (lane >> 4));
  const uint32_t b2_addr =
      smem_addr(wsb + (lane & 15) * L::kLdWb + n2 + 8 * (lane >> 4));

  for (int c = 0; c < S / SC; ++c) {
    if (c > 0) stage(c);
    nerf::mma::cp_async_wait<0>();
    __syncthreads();

    // h = bf16(act(x Wa[:, c] + ba[c])) -> hs
    {
      float h[MT1][4];
      const float b0 = __ldg(ba + c * SC + n1 + 2 * t);
      const float b1 = __ldg(ba + c * SC + n1 + 2 * t + 1);
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) {
        h[mt][0] = b0;
        h[mt][1] = b1;
        h[mt][2] = b0;
        h[mt][3] = b1;
      }
#pragma unroll 4
      for (int ks = 0; ks < L::kKp / 16; ++ks) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, b1_addr + ks * 16 * L::kLdWa * 2);
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, a1_addr + mt * 16 * L::kLdX * 2 + ks * 32);
          mma_bf16(h[mt], a, b);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = RELU ? fmaxf(h[mt][i], 0.f) : h[mt][i];
        __nv_bfloat16* o = hs + (16 * (m1 + mt) + g) * L::kLdH + n1 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * L::kLdH) =
            __floats2bfloat162_rn(v[2], v[3]);
      }
    }
    __syncthreads();

    // acc += h Wb[c, :]
#pragma unroll
    for (int ks = 0; ks < SC / 16; ++ks) {
      uint32_t b[NT2][2];
#pragma unroll
      for (int q = 0; q < NT2 / 2; ++q) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, b2_addr + ks * 16 * L::kLdWb * 2 + q * 16 * 2);
        b[2 * q][0] = r[0];
        b[2 * q][1] = r[1];
        b[2 * q + 1][0] = r[2];
        b[2 * q + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, a2_addr + mt * 16 * L::kLdH * 2 + ks * 32);
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r = 16 * mt + g;
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt) {
      const int col = n2 + 8 * nt + 2 * t;
      if (r < rows)
        *reinterpret_cast<float2*>(out + (base + r) * O2 + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < rows)
        *reinterpret_cast<float2*>(out + (base + r + 8) * O2 + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int K, int SC, int O2, bool RELU>
int launch(const float* x, const __nv_bfloat16* wa, const float* ba,
           const __nv_bfloat16* wb, float* out, int n, int s,
           cudaStream_t stream) {
  constexpr int smem = Layout<K, SC, O2>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tp_pair_bf16_kernel<K, SC, O2, RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int grid = (n + kTile - 1) / kTile;
    mlp_tp_pair_bf16_kernel<K, SC, O2, RELU><<<grid, kThreads, smem, stream>>>(
        x, wa, ba, wb, out, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int K, int O2, bool RELU>
int launch_s(int s, const float* x, const __nv_bfloat16* wa, const float* ba,
             const __nv_bfloat16* wb, float* out, int n, cudaStream_t stream) {
  switch (s) {
    case 32: return launch<K, 32, O2, RELU>(x, wa, ba, wb, out, n, s, stream);
    case 64:
    case 128:
    case 256: return launch<K, 64, O2, RELU>(x, wa, ba, wb, out, n, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int O2, bool RELU>
int launch_k(int k, int s, const float* x, const __nv_bfloat16* wa,
             const float* ba, const __nv_bfloat16* wb, float* out, int n,
             cudaStream_t stream) {
  switch (k) {
    case 63: return launch_s<63, O2, RELU>(s, x, wa, ba, wb, out, n, stream);
    case 256: return launch_s<256, O2, RELU>(s, x, wa, ba, wb, out, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (n, k) float32; wa: (k, s) bf16; ba: (s,) float32; wb: (s, o2) bf16;
// out: (n, o2) float32; all contiguous, x, wa and wb 16-byte aligned.
// Compiled shapes: k in {63, 256}; s in {32, 64, 128, 256}; (o2, relu_mid) =
// (256, 1) or (128, 0). Any other returns cudaErrorInvalidValue.
extern "C" int nnc_mlp_tp_pair_bf16(const float* x, const void* wa,
                                    const float* ba, const void* wb,
                                    float* out, int n, int k, int s, int o2,
                                    int relu_mid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const __nv_bfloat16*>(wa);
  const auto* b = static_cast<const __nv_bfloat16*>(wb);
  if (o2 == 256 && relu_mid)
    return launch_k<256, true>(k, s, x, a, ba, b, out, n, st);
  if (o2 == 128 && !relu_mid)
    return launch_k<128, false>(k, s, x, a, ba, b, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
