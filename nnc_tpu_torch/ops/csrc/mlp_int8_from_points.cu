// K-B4: positional encoding + the NeRF MLP from raw points with every matrix
// product as int8 x int8 -> int32.
//
// Replaces the Pallas kernel _kernel_pts_int8 / _fused_call_pts_int8
// (nnc_tpu/ops/mlp_pallas.py:310, :323; body _mlp_body_int8, :127), reached
// through fused_nerf_mlp_int8_from_points (mlp_pallas.py:356): deterministic
// renders with use_int8_mlp (renderer.py:89-92).
//
// What it computes. Weights are int8 with one float32 scale s_o per output
// column (pack_weights_int8, nnc_tpu_torch/ops/mlp_fused.py). The input x of
// every product is quantized at run time with one scale per tile,
// m = max|x| + 1e-12 over the tile's valid points and all features,
// xq = clip(rint(x * (127 / m)), +-127); the product is summed exactly in
// int32 and leaves as u * (s_o * (m / 127)) in float32. Bias, relu, the skip
// and the view concatenation (two products each, summed in float32 before the
// bias) stay in float32. The TPU kernel takes m over its half tile of 1,024
// points, padding rows included; here the block is this kernel's tile,
// kM = 64 points (INT8_ACT_BLOCK in mlp_fused.py), and rows past n do not
// enter m. Rounding is to nearest even (jnp.round), and every float32 step is
// a single rounded operation (no fused multiply-add), in the plain version's
// order, so that kernel and plain version round the same ties the same way.
//
// Bound on the H100: operations. ~0.6M int8 multiply-adds per point against
// 24 bytes in and 16 out. This kernel issues them as __dp4a on the SIMT
// cores (four multiply-adds per lane and issue), not on the tensor
// cores, whose dense int8 peak is 1,979 TOP/s (H100 SXM data sheet, 700 W).
//
// Design: K-B3's CTA: 256 threads per tile of 64 points, each thread an
// 8 point x (NOUT / 32) column register tile. Activations live in shared
// memory as int8, four consecutive channels of one point per 32-bit word
// (act[(channel / 4) * kLdq + point]), so one k step of four channels costs
// two broadcast 16-byte loads of activations and NOUT / 32 coalesced 32-bit
// weight loads for 8 x NOUT / 32 __dp4a. A layer's float32 results stay in
// registers while the CTA reduces their maximum, then each thread quantizes
// its own and stores them as bytes for the next layer.
#include <cstdint>

#include "nerf_mlp.cuh"

namespace {

using nerf::kInPts;
using nerf::kInViews;
using nerf::kM;
using nerf::kThreads;
using nerf::kW;

constexpr int kLdq = kM + 4;               // words per row of four channels
constexpr int kPtsK4 = (kInPts + 3) / 4;   // 16 rows: channels 0..62, one pad
constexpr int kViewsK4 = (kInViews + 3) / 4;   // 7 rows: 27 channels, one pad
constexpr int kHK4 = kW / 4;

// The 14 weight blocks, in the order of INT8_BLOCKS (mlp_fused.py).
enum { W0, W1, W2, W3, W4, W5A, W5B, W6, W7, WF, WA, WVA, WVB, WR, kBlocks };
// The 12 bias rows, in the order of INT8_BIASES.
enum { B0, B1, B2, B3, B4, B5, B6, B7, BF, BA, BV, BR, kBiases };

__host__ __device__ constexpr int block_rows(int b) {
  return (b == W0 || b == W5A) ? kInPts : b == WVB ? kInViews
         : b == WR ? kW / 2 : kW;
}
__host__ __device__ constexpr int block_out(int b) {
  return b == WA ? 1 : (b == WVA || b == WVB) ? kW / 2 : b == WR ? 3 : kW;
}
__host__ __device__ constexpr int block_word_offset(int b) {
  int off = 0;
  for (int i = 0; i < b; ++i) off += (block_rows(i) + 3) / 4 * block_out(i);
  return off;
}
__host__ __device__ constexpr int scale_offset(int b) {
  int off = 0;
  for (int i = 0; i < b; ++i) off += block_out(i);
  return off;
}
__host__ __device__ constexpr int bias_size(int i) {
  return i == BA ? 1 : i == BV ? kW / 2 : i == BR ? 3 : kW;
}
__host__ __device__ constexpr int bias_offset(int b) {
  int off = 0;
  for (int i = 0; i < b; ++i) off += bias_size(i);
  return off;
}

struct Weights {
  const uint32_t* wq;
  const float* scales;
  const float* biases;
  template <int B>
  __device__ __forceinline__ const uint32_t* w() const {
    return wq + block_word_offset(B);
  }
  template <int B>
  __device__ __forceinline__ const float* s() const {
    return scales + scale_offset(B);
  }
  template <int B>
  __device__ __forceinline__ const float* b() const {
    return biases + bias_offset(B);
  }
};

struct Smem {
  float emb[nerf::kEmb * nerf::kLd];        // float posenc (embed_tile)
  uint32_t embq[(kPtsK4 + kViewsK4) * kLdq];  // rows 0..15 pts, 16..22 views
  uint32_t a[kHK4 * kLdq];                  // ping
  uint32_t b[kHK4 * kLdq];                  // pong
  float xs[kM * 3];
  float ds[kM * 3];
  float raw[kM * 4];
  int redi[4 * kM];                         // alpha-head partial sums
  float red[kThreads / 32];                 // block_max partials
};

// Maximum of v over the CTA. The first barrier also orders every thread's
// reads of the layer's input before any write of the next quantized output.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

__device__ __forceinline__ int quantize(float x, float q) {
  const int v = __float2int_rn(__fmul_rn(x, q));
  return max(-127, min(127, v));
}

// acc[r][j] += sum_k xq[k][r0 + r] * wq[k][lane + 32 j], four k per __dp4a
template <int NOUT, int NC>
__device__ __forceinline__ void accumulate(int (&acc)[8][NC],
                                           const uint32_t* __restrict__ x,
                                           int K4,
                                           const uint32_t* __restrict__ w,
                                           int r0, int lane) {
#pragma unroll 2
  for (int k = 0; k < K4; ++k) {
    const uint4 xa = *reinterpret_cast<const uint4*>(x + k * kLdq + r0);
    const uint4 xb = *reinterpret_cast<const uint4*>(x + k * kLdq + r0 + 4);
    const int xr[8] = {static_cast<int>(xa.x), static_cast<int>(xa.y),
                       static_cast<int>(xa.z), static_cast<int>(xa.w),
                       static_cast<int>(xb.x), static_cast<int>(xb.y),
                       static_cast<int>(xb.z), static_cast<int>(xb.w)};
    int wv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      wv[j] = static_cast<int>(__ldg(w + k * NOUT + lane + 32 * j));
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = __dp4a(xr[r], wv[j], acc[r][j]);
  }
}

// y = act(u1 * (s1 * (m1 / 127)) [+ u2 * (s2 * (m2 / 127))] + bias) for the
// tile, then its quantization into outq. Returns the output's scale m.
template <int NOUT, bool RELU>
__device__ __forceinline__ float layer(
    uint32_t* __restrict__ outq,
    const uint32_t* __restrict__ x1, int K4_1, const uint32_t* __restrict__ w1,
    const float* __restrict__ s1, float m1,
    const uint32_t* __restrict__ x2, int K4_2, const uint32_t* __restrict__ w2,
    const float* __restrict__ s2, float m2,
    const float* __restrict__ bias, int rows, float* red) {
  constexpr int NC = NOUT / 32;
  static_assert(NOUT % 32 == 0 && kM == 64 && kThreads == 256, "tiling");
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float f[8][NC];
  {
    int acc[8][NC];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = 0;
    accumulate<NOUT, NC>(acc, x1, K4_1, w1, r0, lane);
    const float d1 = __fdiv_rn(m1, 127.f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float sc = __fmul_rn(__ldg(s1 + lane + 32 * j), d1);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        f[r][j] = __fmul_rn(static_cast<float>(acc[r][j]), sc);
    }
  }
  if (K4_2 > 0) {
    int acc[8][NC];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = 0;
    accumulate<NOUT, NC>(acc, x2, K4_2, w2, r0, lane);
    const float d2 = __fdiv_rn(m2, 127.f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float sc = __fmul_rn(__ldg(s2 + lane + 32 * j), d2);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        f[r][j] = __fadd_rn(f[r][j],
                            __fmul_rn(static_cast<float>(acc[r][j]), sc));
    }
  }
  float local = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float bj = __ldg(bias + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v = __fadd_rn(f[r][j], bj);
      if (RELU) v = fmaxf(v, 0.f);
      f[r][j] = v;
      if (r0 + r < rows) local = fmaxf(local, fabsf(v));
    }
  }
  const float m = __fadd_rn(block_max(local, red), 1e-12f);
  const float q = __fdiv_rn(127.f, m);
  int8_t* out8 = reinterpret_cast<int8_t*>(outq);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = lane + 32 * j;
    int8_t* o = out8 + ((col >> 2) * kLdq + r0) * 4 + (col & 3);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      o[r * 4] = static_cast<int8_t>(quantize(f[r][j], q));
  }
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_int8_from_points_kernel(Weights P, const float* __restrict__ pts,
                            const float* __restrict__ dirs,
                            float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kM;
  const int rows = n - base < kM ? static_cast<int>(n - base) : kM;
  if (tid < kM * 3) {
    const bool valid = tid / 3 < rows;
    s.xs[tid] = valid ? pts[base * 3 + tid] : 0.f;
    s.ds[tid] = valid ? dirs[base * 3 + tid] : 0.f;
  }
  __syncthreads();
  nerf::embed_tile(s.emb, s.xs, s.ds);
  __syncthreads();

  // one scale for the whole embedding (points and view directions), which
  // enters three products: layer 0, the skip and the view layer
  float local = 0.f;
  for (int i = tid; i < nerf::kEmb * kM; i += kThreads) {
    const int m = i % kM;
    if (m < rows) local = fmaxf(local, fabsf(s.emb[i / kM * nerf::kLd + m]));
  }
  const float m_e = __fadd_rn(block_max(local, s.red), 1e-12f);
  {
    const float q = __fdiv_rn(127.f, m_e);
    for (int i = tid; i < (kPtsK4 + kViewsK4) * kM; i += kThreads) {
      const int m = i % kM;
      const int k4 = i / kM;
      const bool view = k4 >= kPtsK4;
      const int c0 = view ? 4 * (k4 - kPtsK4) : 4 * k4;
      const int width = view ? kInViews : kInPts;
      const int row0 = view ? kInPts : 0;
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = c0 + t;
        const int v = c < width
            ? quantize(s.emb[(row0 + c) * nerf::kLd + m], q) : 0;
        word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * t);
      }
      s.embq[k4 * kLdq + m] = word;
    }
  }
  __syncthreads();

  uint32_t* A = s.a;
  uint32_t* B = s.b;
  const uint32_t* E = s.embq;
  const uint32_t* EV = s.embq + kPtsK4 * kLdq;
  float* red = s.red;
  float m;
  m = layer<kW, true>(A, E, kPtsK4, P.w<W0>(), P.s<W0>(), m_e,
                      nullptr, 0, nullptr, nullptr, 0.f, P.b<B0>(), rows, red);
  m = layer<kW, true>(B, A, kHK4, P.w<W1>(), P.s<W1>(), m,
                      nullptr, 0, nullptr, nullptr, 0.f, P.b<B1>(), rows, red);
  m = layer<kW, true>(A, B, kHK4, P.w<W2>(), P.s<W2>(), m,
                      nullptr, 0, nullptr, nullptr, 0.f, P.b<B2>(), rows, red);
  m = layer<kW, true>(B, A, kHK4, P.w<W3>(), P.s<W3>(), m,
                      nullptr, 0, nullptr, nullptr, 0.f, P.b<B3>(), rows, red);
  m = layer<kW, true>(A, B, kHK4, P.w<W4>(), P.s<W4>(), m,
                      nullptr, 0, nullptr, nullptr, 0.f, P.b<B4>(), rows, red);
  // skip: emb @ w5a + h @ w5b, each with its own activation scale
  m = layer<kW, true>(B, E, kPtsK4, P.w<W5A>(), P.s<W5A>(), m_e,
                      A, kHK4, P.w<W5B>(), P.s<W5B>(), m, P.b<B5>(), rows,
                      red);
  m = layer<kW, true>(A, B, kHK4, P.w<W6>(), P.s<W6>(), m,
                      nullptr, 0, nullptr, nullptr, 0.f, P.b<B6>(), rows, red);
  const float m_h = layer<kW, true>(B, A, kHK4, P.w<W7>(), P.s<W7>(), m,
                                    nullptr, 0, nullptr, nullptr, 0.f,
                                    P.b<B7>(), rows, red);

  // alpha head (256 -> 1) on h = B: 4 partial integer sums per point
  {
    const int p = tid & (kM - 1);
    const int part = tid / kM;
    const uint32_t* wa = P.w<WA>();
    int acc = 0;
    for (int k = part * (kHK4 / 4); k < (part + 1) * (kHK4 / 4); ++k)
      acc = __dp4a(static_cast<int>(B[k * kLdq + p]),
                   static_cast<int>(__ldg(wa + k)), acc);
    s.redi[part * kM + p] = acc;
  }
  // feature (no activation) on h = B
  const float m_f = layer<kW, false>(A, B, kHK4, P.w<WF>(), P.s<WF>(), m_h,
                                     nullptr, 0, nullptr, nullptr, 0.f,
                                     P.b<BF>(), rows, red);
  if (tid < kM) {
    const int u = (s.redi[tid] + s.redi[kM + tid]) +
                  (s.redi[2 * kM + tid] + s.redi[3 * kM + tid]);
    const float sc = __fmul_rn(__ldg(P.s<WA>()), __fdiv_rn(m_h, 127.f));
    s.raw[tid * 4 + 3] = __fadd_rn(__fmul_rn(static_cast<float>(u), sc),
                                   __ldg(P.b<BA>()));
  }
  // views: relu(feature @ wva + view emb @ wvb + bv) -> B rows 0..31
  const float m_v = layer<kW / 2, true>(
      B, A, kHK4, P.w<WVA>(), P.s<WVA>(), m_f,
      EV, kViewsK4, P.w<WVB>(), P.s<WVB>(), m_e, P.b<BV>(), rows, red);
  // rgb head (128 -> 3)
  if (tid < 3 * kM) {
    const int p = tid & (kM - 1);
    const int c = tid / kM;
    const uint32_t* wr = P.w<WR>();
    int acc = 0;
    for (int k = 0; k < kHK4 / 2; ++k)
      acc = __dp4a(static_cast<int>(B[k * kLdq + p]),
                   static_cast<int>(__ldg(wr + k * 3 + c)), acc);
    const float sc = __fmul_rn(__ldg(P.s<WR>() + c), __fdiv_rn(m_v, 127.f));
    s.raw[p * 4 + c] = __fadd_rn(__fmul_rn(static_cast<float>(acc), sc),
                                 __ldg(P.b<BR>() + c));
  }
  __syncthreads();
  static_assert(kM * 4 == kThreads, "one output per thread");
  if (tid / 4 < rows) out[base * 4 + tid] = s.raw[tid];
}

}  // namespace

// Sizes of the three weight buffers (int8 bytes, floats, floats), for the
// host to hold against its own layout.
extern "C" int nnc_int8_sizes(int* wq_bytes, int* n_scales, int* n_biases) {
  *wq_bytes = 4 * block_word_offset(kBlocks);
  *n_scales = scale_offset(kBlocks);
  *n_biases = bias_offset(kBiases);
  return 0;
}

// wq: packed int8 weights; scales, biases: float32; pts, dirs: (n, 3);
// out: (n, 4) [rgb logits, sigma].
extern "C" int nnc_mlp_int8_from_points(const void* wq, const float* scales,
                                        const float* biases, const float* pts,
                                        const float* dirs, float* out, int n,
                                        void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_int8_from_points_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const Weights P{static_cast<const uint32_t*>(wq), scales, biases};
    const int grid = (n + kM - 1) / kM;
    mlp_int8_from_points_kernel<<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        P, pts, dirs, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
