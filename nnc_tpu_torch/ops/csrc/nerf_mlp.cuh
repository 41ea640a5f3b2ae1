// The flagship NeRF MLP (D=8, W=256, skip at layer 4, view head; posenc
// 10/4 frequencies) on a tile of kM points, in float32, for one CTA of
// kThreads threads. Shared by mlp_from_points.cu (K-B3), mlp_embedded.cu
// (K-B5) and render_pass.cu (K-B2). The tile's embedding comes either from
// embed_tile (posenc computed here) or from load_embedded_tile (read from
// device memory).
//
// Layout. Activations live in shared memory transposed, channel-major
// (act[channel * kLd + point]), so that one thread reads eight consecutive
// points of a channel as two float4 loads that its whole warp shares, and a
// warp stores 32 consecutive channels without bank conflicts (kLd = kM + 4).
// Weights (~0.6M floats, 2.4 MB per network) do not fit in a CTA's shared
// memory; they stream from global memory through L1/L2 (both networks fit in
// the 50 MB L2), one row of W per k step, read by every warp of the CTA.
//
// Packed weights: one float32 buffer, layers in nerf.layer_names order
// (pts_linears.0..7, feature_linear, alpha_linear, views_linears.0,
// rgb_linear). Each layer is W in (in, out) row-major, then its bias, padded
// to a multiple of 64 floats; LSA scales are folded in by the host
// (nnc_tpu_torch/ops/mlp_fused.py pack_weights, the same layout).
#pragma once

#include <cuda_runtime.h>

namespace nerf {

constexpr int kW = 256;        // hidden width
constexpr int kInPts = 63;     // posenc(xyz, 10)
constexpr int kInViews = 27;   // posenc(viewdir, 4)
constexpr int kEmb = kInPts + kInViews;
constexpr int kM = 64;         // points per tile
constexpr int kLd = kM + 4;    // row stride of the activation buffers
constexpr int kThreads = 256;
constexpr int kLayers = 12;

__host__ __device__ constexpr int layer_in(int i) {
  return i == 0 ? kInPts : i == 5 ? kInPts + kW : i == 10 ? kW + kInViews
         : i == 11 ? kW / 2 : kW;
}
__host__ __device__ constexpr int layer_out(int i) {
  return i == 9 ? 1 : i == 10 ? kW / 2 : i == 11 ? 3 : kW;
}
__host__ __device__ constexpr int layer_size(int i) {
  return (layer_in(i) * layer_out(i) + layer_out(i) + 63) / 64 * 64;
}
__host__ __device__ constexpr int layer_offset(int i) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += layer_size(j);
  return off;
}
constexpr int kParamsSize = layer_offset(kLayers);

template <int L>
__device__ __forceinline__ const float* weight(const float* P) {
  return P + layer_offset(L);
}
template <int L>
__device__ __forceinline__ const float* bias(const float* P) {
  return P + layer_offset(L) + layer_in(L) * layer_out(L);
}

struct MlpSmem {
  float emb[kEmb * kLd];   // posenc of the tile: rows 0..62 pts, 63..89 dirs
  float a[kW * kLd];       // ping
  float b[kW * kLd];       // pong
  float raw[kM * 4];       // (point, [r, g, b, sigma]) logits
  float red[4 * kM];       // alpha-head partial sums
};

// acc[r][j] += sum_k x[k][r0 + r] * w[k][lane + 32 j]
template <int NOUT, int NC>
__device__ __forceinline__ void accumulate(float (&acc)[8][NC],
                                           const float* __restrict__ x, int K,
                                           const float* __restrict__ w,
                                           int r0, int lane) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 xa = *reinterpret_cast<const float4*>(x + k * kLd + r0);
    const float4 xb = *reinterpret_cast<const float4*>(x + k * kLd + r0 + 4);
    const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    float wv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) wv[j] = __ldg(w + k * NOUT + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(xr[r], wv[j], acc[r][j]);
  }
}

// out = act(bias + x @ w (+ x2 @ w2)) for the kM points of the tile; each of
// the 256 threads owns 8 points x NOUT/32 channels.
template <int NOUT, bool RELU>
__device__ __forceinline__ void dense(float* __restrict__ out,
                                      const float* __restrict__ x, int K,
                                      const float* __restrict__ w,
                                      const float* __restrict__ x2, int K2,
                                      const float* __restrict__ w2,
                                      const float* __restrict__ b) {
  constexpr int NC = NOUT / 32;
  static_assert(NOUT % 32 == 0 && kM == 64 && kThreads == 256, "tiling");
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float acc[8][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float bj = __ldg(b + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][j] = bj;
  }
  accumulate<NOUT, NC>(acc, x, K, w, r0, lane);
  if (K2 > 0) accumulate<NOUT, NC>(acc, x2, K2, w2, r0, lane);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = RELU ? fmaxf(acc[r][j], 0.f) : acc[r][j];
    float4* o = reinterpret_cast<float4*>(out + (lane + 32 * j) * kLd + r0);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Positional encoding of the tile into s.emb. xs/ds: (kM, 3) points and
// view directions in shared memory (zeros for rows past the data). The
// argument x * 2^f is exact in float32; sin and cos come from the precise
// sincosf (arguments reach ~2^9 * |x|, where fast-math intrinsics lose
// several digits).
__device__ __forceinline__ void embed_tile(float* __restrict__ emb,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ ds) {
  // f = 0: raw xyz, 1..10: xyz freqs, 11: raw dir, 12..15: dir freqs
  for (int i = threadIdx.x; i < kM * 3 * 16; i += kThreads) {
    const int m = i % kM;
    const int rest = i / kM;
    const int d = rest % 3;
    const int f = rest / 3;
    const bool view = f >= 11;
    const float x = view ? ds[m * 3 + d] : xs[m * 3 + d];
    const int base = view ? kInPts : 0;
    const int fr = view ? f - 12 : f - 1;
    if (fr < 0) {
      emb[(base + d) * kLd + m] = x;
    } else {
      float sn, cs;
      sincosf(x * static_cast<float>(1 << fr), &sn, &cs);
      emb[(base + 3 + 6 * fr + d) * kLd + m] = sn;
      emb[(base + 6 + 6 * fr + d) * kLd + m] = cs;
    }
  }
}

// The second way in: the tile's embeddings, computed by the caller, from
// device memory into the layout embed_tile writes. pts_emb: (n, kInPts),
// views_emb: (n, kInViews), contiguous float32; rows past n become zeros.
// Consecutive threads read consecutive floats; the transposed store costs a
// 4-way bank conflict (row stride kLd = 68), small against the MLP.
__device__ __forceinline__ void load_embedded_tile(
    float* __restrict__ emb, const float* __restrict__ pts_emb,
    const float* __restrict__ views_emb, long long base, int n) {
  const long long rows = n - base < kM ? n - base : kM;
  for (int i = threadIdx.x; i < kM * kInPts; i += kThreads) {
    const int m = i / kInPts;
    const int c = i - m * kInPts;
    emb[c * kLd + m] = m < rows ? __ldg(pts_emb + base * kInPts + i) : 0.f;
  }
  for (int i = threadIdx.x; i < kM * kInViews; i += kThreads) {
    const int m = i / kInViews;
    const int c = i - m * kInViews;
    emb[(kInPts + c) * kLd + m] =
        m < rows ? __ldg(views_emb + base * kInViews + i) : 0.f;
  }
}

// The MLP on the embedded tile in s.emb; leaves raw logits in s.raw. Must be
// entered by all threads after a __syncthreads; ends with one.
__device__ __forceinline__ void mlp_tile(MlpSmem& s,
                                         const float* __restrict__ P) {
  float* A = s.a;
  float* B = s.b;
  const float* E = s.emb;
  dense<kW, true>(A, E, kInPts, weight<0>(P), nullptr, 0, nullptr, bias<0>(P));
  __syncthreads();
  dense<kW, true>(B, A, kW, weight<1>(P), nullptr, 0, nullptr, bias<1>(P));
  __syncthreads();
  dense<kW, true>(A, B, kW, weight<2>(P), nullptr, 0, nullptr, bias<2>(P));
  __syncthreads();
  dense<kW, true>(B, A, kW, weight<3>(P), nullptr, 0, nullptr, bias<3>(P));
  __syncthreads();
  dense<kW, true>(A, B, kW, weight<4>(P), nullptr, 0, nullptr, bias<4>(P));
  __syncthreads();
  // skip: [emb, h] @ w5 — rows 0..62 of w5 act on emb, rows 63.. on h
  dense<kW, true>(B, E, kInPts, weight<5>(P), A, kW,
                  weight<5>(P) + kInPts * kW, bias<5>(P));
  __syncthreads();
  dense<kW, true>(A, B, kW, weight<6>(P), nullptr, 0, nullptr, bias<6>(P));
  __syncthreads();
  dense<kW, true>(B, A, kW, weight<7>(P), nullptr, 0, nullptr, bias<7>(P));
  __syncthreads();

  // alpha head (layer 9, 256 -> 1) on h = B: 4 partial sums per point
  {
    const int m = threadIdx.x & (kM - 1);
    const int part = threadIdx.x / kM;
    const float* wa = weight<9>(P);
    float acc = 0.f;
    for (int k = part * (kW / 4); k < (part + 1) * (kW / 4); ++k)
      acc = fmaf(B[k * kLd + m], __ldg(wa + k), acc);
    s.red[part * kM + m] = acc;
  }
  // feature (layer 8, no activation) on h = B
  dense<kW, false>(A, B, kW, weight<8>(P), nullptr, 0, nullptr, bias<8>(P));
  __syncthreads();
  if (threadIdx.x < kM) {
    const int m = threadIdx.x;
    s.raw[m * 4 + 3] = __ldg(bias<9>(P)) + ((s.red[m] + s.red[kM + m]) +
                                            (s.red[2 * kM + m] + s.red[3 * kM + m]));
  }
  // views (layer 10): relu([feature, view emb] @ wv + bv) -> B rows 0..127
  dense<kW / 2, true>(B, A, kW, weight<10>(P), E + kInPts * kLd, kInViews,
                      weight<10>(P) + kW * (kW / 2), bias<10>(P));
  __syncthreads();
  // rgb head (layer 11, 128 -> 3)
  if (threadIdx.x < 3 * kM) {
    const int m = threadIdx.x & (kM - 1);
    const int c = threadIdx.x / kM;
    const float* wr = weight<11>(P);
    float acc = __ldg(bias<11>(P) + c);
    for (int k = 0; k < kW / 2; ++k) acc = fmaf(B[k * kLd + m], __ldg(wr + k * 3 + c), acc);
    s.raw[m * 4 + c] = acc;
  }
  __syncthreads();
}

}  // namespace nerf
