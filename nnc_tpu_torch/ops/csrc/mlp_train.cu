// K-B1: the NeRF MLP's training pass, forward and backward, float32.
//
// Replaces the Pallas pair _fwd_call / _bwd_call
// (nnc_tpu/ops/mlp_train_pallas.py:275, :300) under the custom_vjp _train_op
// (:337-362): every LSA / fine-tune step renders its coarse and fine passes
// through it (renderer.py _query_mlp with use_fused_train).
//
// What it computes. Forward: posenc (10/4 frequencies) and the flagship MLP
// with the LSA scales applied as output scaling, u = x @ W, y = u * ls + b
// (relu on the hidden and view layers), from unscaled weights and a separate
// scale vector. Backward, for the raw-output cotangent g: the reverse chain,
// with dls = colsum(dy_pre * u), db = colsum(dy_pre) over every point, and
// dW = x^T du only with_dw; the inputs get no gradient.
//
// Bound on the H100: SIMT float32 FMAs, as K-B3. The forward costs ~1.19
// MFLOP per point; the backward ~1.2 MFLOP more without dW (the dx products)
// and ~1.2 more with it (the x^T du products). Device memory traffic is small
// beside that (below).
//
// Design.
// - The reverse chain needs, per point, every layer's u (2,436 floats):
//   far beyond 227 KB of shared memory for a tile. The TPU kernel recomputes
//   the forward in VMEM. Here the forward writes u per point to a workspace
//   in device memory instead (9.7 KB per point: 1.9 GB at 196,608 points,
//   ~1.2 ms of HBM traffic written once and read once), and the backward
//   rebuilds every activation it needs, h = relu(fmaf(u, ls, b)), bit for
//   bit as the forward computed it. The relu mask is fmaf(u, ls, b) > 0,
//   which is h > 0 for that same h. The workspace is written and read with
//   evict-first cache hints (__stcs / __ldcs): streamed through L2 like any
//   other data, it evicted the weights that every tile reads from L2, and
//   the forward took 19.0 ms instead of 11.7 (196,608 points, H100).
// - The backward's dx = du @ W^T reads W along its output axis; it reads a
//   second copy of the weights packed in torch's (out, in) layout, so that a
//   warp's loads of one row are contiguous, as the forward's are in (in, out).
// - dls/db (and dW) are sums over all points. One persistent CTA per SM walks
//   tiles blockIdx.x, blockIdx.x + gridDim.x, ... and adds each tile's sums
//   into its own row of a partial buffer (no other CTA touches it); a second
//   kernel sums the rows in a fixed order. The result is deterministic run to
//   run; it differs from a one-pass sum only by float32 reassociation.
// - Rows past n: the forward reads zero points there and writes their u (so
//   the workspace is finite); the backward loads a zero cotangent for them,
//   so they add exactly zero.
//
// Packed inputs (nnc_tpu_torch/ops/mlp_train_fused.py): P, the forward layout
// of nerf_mlp.cuh (each layer W (in, out) and its bias, unscaled); PT, each
// layer's W in (out, in), concatenated in layer order (offset wt_offset);
// LS, the scales of every layer's outputs, concatenated (offset u_offset).
// The workspace row of a point and the gradient rows use the u_offset
// layout too.
#include "nerf_mlp.cuh"

#include <cstddef>

namespace {

using namespace nerf;

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
constexpr int kWt = wt_offset(kLayers);   // 593,408 weights

// ---------------------------------------------------------------- forward

// out = act(ls * u + b) with u = x @ w (+ x2 @ w2), for the kM points of the
// tile; u goes to U (row stride kU) when U is not null.
template <int NOUT, bool RELU>
__device__ __forceinline__ void dense_train(float* __restrict__ out,
                                            const float* __restrict__ x, int K,
                                            const float* __restrict__ w,
                                            const float* __restrict__ x2, int K2,
                                            const float* __restrict__ w2,
                                            const float* __restrict__ b,
                                            const float* __restrict__ ls,
                                            float* __restrict__ U) {
  constexpr int NC = NOUT / 32;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  accumulate<NOUT, NC>(acc, x, K, w, r0, lane);
  if (K2 > 0) accumulate<NOUT, NC>(acc, x2, K2, w2, r0, lane);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    const float bj = __ldg(b + c);
    const float lj = __ldg(ls + c);
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (U != nullptr)
        __stcs(U + static_cast<size_t>(r0 + r) * kU + c, acc[r][j]);
      const float p = fmaf(acc[r][j], lj, bj);
      v[r] = RELU ? fmaxf(p, 0.f) : p;
    }
    float4* o = reinterpret_cast<float4*>(out + c * kLd + r0);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// The training MLP on the embedded tile in s.emb; raw logits to s.raw, u of
// every layer to U (the tile's first workspace row) unless U is null.
__device__ __forceinline__ void mlp_tile_train(MlpSmem& s,
                                               const float* __restrict__ P,
                                               const float* __restrict__ LS,
                                               float* __restrict__ U) {
  float* A = s.a;
  float* B = s.b;
  const float* E = s.emb;
#define NNC_UO(i) (U != nullptr ? U + u_offset(i) : nullptr)
  dense_train<kW, true>(A, E, kInPts, weight<0>(P), nullptr, 0, nullptr,
                        bias<0>(P), LS + u_offset(0), NNC_UO(0));
  __syncthreads();
  dense_train<kW, true>(B, A, kW, weight<1>(P), nullptr, 0, nullptr,
                        bias<1>(P), LS + u_offset(1), NNC_UO(1));
  __syncthreads();
  dense_train<kW, true>(A, B, kW, weight<2>(P), nullptr, 0, nullptr,
                        bias<2>(P), LS + u_offset(2), NNC_UO(2));
  __syncthreads();
  dense_train<kW, true>(B, A, kW, weight<3>(P), nullptr, 0, nullptr,
                        bias<3>(P), LS + u_offset(3), NNC_UO(3));
  __syncthreads();
  dense_train<kW, true>(A, B, kW, weight<4>(P), nullptr, 0, nullptr,
                        bias<4>(P), LS + u_offset(4), NNC_UO(4));
  __syncthreads();
  // skip: [emb, h] @ w5 — rows 0..62 of w5 act on emb, rows 63.. on h
  dense_train<kW, true>(B, E, kInPts, weight<5>(P), A, kW,
                        weight<5>(P) + kInPts * kW, bias<5>(P),
                        LS + u_offset(5), NNC_UO(5));
  __syncthreads();
  dense_train<kW, true>(A, B, kW, weight<6>(P), nullptr, 0, nullptr,
                        bias<6>(P), LS + u_offset(6), NNC_UO(6));
  __syncthreads();
  dense_train<kW, true>(B, A, kW, weight<7>(P), nullptr, 0, nullptr,
                        bias<7>(P), LS + u_offset(7), NNC_UO(7));
  __syncthreads();

  // alpha head (layer 9, 256 -> 1) on h7 = B: 4 partial sums per point
  {
    const int m = threadIdx.x & (kM - 1);
    const int part = threadIdx.x / kM;
    const float* wa = weight<9>(P);
    float acc = 0.f;
    for (int k = part * (kW / 4); k < (part + 1) * (kW / 4); ++k)
      acc = fmaf(B[k * kLd + m], __ldg(wa + k), acc);
    s.red[part * kM + m] = acc;
  }
  // feature (layer 8, no activation) on h7 = B
  dense_train<kW, false>(A, B, kW, weight<8>(P), nullptr, 0, nullptr,
                         bias<8>(P), LS + u_offset(8), NNC_UO(8));
  __syncthreads();
  if (threadIdx.x < kM) {
    const int m = threadIdx.x;
    const float ua = (s.red[m] + s.red[kM + m]) +
                     (s.red[2 * kM + m] + s.red[3 * kM + m]);
    if (U != nullptr) __stcs(U + static_cast<size_t>(m) * kU + u_offset(9), ua);
    s.raw[m * 4 + 3] = fmaf(ua, __ldg(LS + u_offset(9)), __ldg(bias<9>(P)));
  }
  // views (layer 10): relu(ls * ([feature, view emb] @ wv) + bv) -> B 0..127
  dense_train<kW / 2, true>(B, A, kW, weight<10>(P), E + kInPts * kLd,
                            kInViews, weight<10>(P) + kW * (kW / 2),
                            bias<10>(P), LS + u_offset(10), NNC_UO(10));
  __syncthreads();
  // rgb head (layer 11, 128 -> 3)
  if (threadIdx.x < 3 * kM) {
    const int m = threadIdx.x & (kM - 1);
    const int c = threadIdx.x / kM;
    const float* wr = weight<11>(P);
    float acc = 0.f;
    for (int k = 0; k < kW / 2; ++k)
      acc = fmaf(B[k * kLd + m], __ldg(wr + k * 3 + c), acc);
    if (U != nullptr)
      __stcs(U + static_cast<size_t>(m) * kU + u_offset(11) + c, acc);
    s.raw[m * 4 + c] = fmaf(acc, __ldg(LS + u_offset(11) + c),
                            __ldg(bias<11>(P) + c));
  }
#undef NNC_UO
  __syncthreads();
}

struct FwdSmem {
  MlpSmem mlp;
  float xs[kM * 3];
  float ds[kM * 3];
};

__global__ void __launch_bounds__(kThreads, 1)
mlp_train_fwd_kernel(const float* __restrict__ P, const float* __restrict__ LS,
                     const float* __restrict__ pts,
                     const float* __restrict__ dirs, float* __restrict__ out,
                     float* __restrict__ ws, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kM;
  if (tid < kM * 3) {
    const bool valid = base + tid / 3 < n;
    s.xs[tid] = valid ? pts[base * 3 + tid] : 0.f;
    s.ds[tid] = valid ? dirs[base * 3 + tid] : 0.f;
  }
  __syncthreads();
  embed_tile(s.mlp.emb, s.xs, s.ds);
  __syncthreads();
  mlp_tile_train(s.mlp, P, LS,
                 ws != nullptr ? ws + static_cast<size_t>(base) * kU : nullptr);
  static_assert(kM * 4 == kThreads, "one output per thread");
  if (base + tid / 4 < n) out[base * 4 + tid] = s.mlp.raw[tid];
}

// ---------------------------------------------------------------- backward

// acc[r][j] += sum_c x[c][r0 + r] * w[c * ldw + lane + 32 j]: dense's product
// with a row stride, for the (out, in) weights of the backward.
template <int NC>
__device__ __forceinline__ void accumulate_ld(float (&acc)[8][NC],
                                              const float* __restrict__ x,
                                              int K,
                                              const float* __restrict__ w,
                                              int ldw, int r0, int lane) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 xa = *reinterpret_cast<const float4*>(x + k * kLd + r0);
    const float4 xb = *reinterpret_cast<const float4*>(x + k * kLd + r0 + 4);
    const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    float wv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) wv[j] = __ldg(w + k * ldw + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(xr[r], wv[j], acc[r][j]);
  }
}

// out[k][m] = sum_c du[c][m] wt[c][k] (+ the same for du2, wt2), k < NOUT:
// the input gradient of a layer, from its (out, in) weights (row stride ldw).
template <int NOUT>
__device__ __forceinline__ void dense_t(float* __restrict__ out,
                                        const float* __restrict__ du, int K,
                                        const float* __restrict__ wt, int ldw,
                                        const float* __restrict__ du2, int K2,
                                        const float* __restrict__ wt2,
                                        int ldw2) {
  constexpr int NC = NOUT / 32;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  accumulate_ld<NC>(acc, du, K, wt, ldw, r0, lane);
  if (K2 > 0) accumulate_ld<NC>(acc, du2, K2, wt2, ldw2, r0, lane);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float4* o = reinterpret_cast<float4*>(out + (lane + 32 * j) * kLd + r0);
    o[0] = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    o[1] = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// One output channel of a layer over the tile's kM points, called by one
// thread: the incoming gradient (row, in shared memory) becomes du = dpre * l
// in place, with dpre = dy masked by the relu (RELU); dpre * u and dpre are
// summed into the CTA's partial dls and db of the channel. u points at the
// channel's u of the tile's first point (stride kU).
template <bool RELU>
__device__ __forceinline__ void channel_grad(float* __restrict__ row,
                                             const float* __restrict__ u,
                                             float l, float b,
                                             float* __restrict__ dls,
                                             float* __restrict__ db) {
  float sl = 0.f, sb = 0.f;
#pragma unroll 4
  for (int m = 0; m < kM; m += 4) {
    float4* p = reinterpret_cast<float4*>(row + m);
    const float4 d4 = *p;
    float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float uq = __ldcs(u + static_cast<size_t>(m + q) * kU);
      if (RELU && !(fmaf(uq, l, b) > 0.f)) d[q] = 0.f;
      sl = fmaf(d[q], uq, sl);
      sb += d[q];
      d[q] *= l;
    }
    *p = make_float4(d[0], d[1], d[2], d[3]);
  }
  *dls += sl;
  *db += sb;
}

// Every output channel of layer L (kThreads >= its width): channel_grad.
template <int L, bool RELU>
__device__ __forceinline__ void layer_grad(float* __restrict__ g,
                                           const float* __restrict__ U,
                                           const float* __restrict__ P,
                                           const float* __restrict__ LS,
                                           float* __restrict__ part_ls,
                                           float* __restrict__ part_b) {
  const int c = threadIdx.x;
  if (c < layer_out(L)) {
    channel_grad<RELU>(g + c * kLd, U + u_offset(L) + c,
                       __ldg(LS + u_offset(L) + c), __ldg(bias<L>(P) + c),
                       part_ls + u_offset(L) + c, part_b + u_offset(L) + c);
  }
}

// X[k][m] = act(fmaf(u, ls, b)) of layer L for its K outputs: the forward's
// activation, rebuilt from the workspace.
template <int L, bool RELU>
__device__ __forceinline__ void rebuild(float* __restrict__ X,
                                        const float* __restrict__ U,
                                        const float* __restrict__ P,
                                        const float* __restrict__ LS) {
  constexpr int K = layer_out(L);
  for (int i = threadIdx.x; i < K * kM; i += kThreads) {
    const int k = i % K;
    const int m = i / K;
    const float p =
        fmaf(__ldcs(U + static_cast<size_t>(m) * kU + u_offset(L) + k),
             __ldg(LS + u_offset(L) + k), __ldg(bias<L>(P) + k));
    X[k * kLd + m] = RELU ? fmaxf(p, 0.f) : p;
  }
}

// dWt[c][koff + k] += sum_m du[c][m] x[k][m] for c < N, k < K, into the CTA's
// partial dW of one layer (row stride ldp). A warp owns 8 channels and 256
// consecutive k (lane + 32 a), so its loads of x rows are conflict-free and
// its stores coalesced.
__device__ __forceinline__ void outer_acc(float* __restrict__ dwt, int ldp,
                                          const float* __restrict__ du, int N,
                                          const float* __restrict__ x, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int cb = warp * 8; cb < N; cb += 8 * (kThreads / 32)) {
    for (int kb = 0; kb < K; kb += 256) {
      float acc[8][8];
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int a = 0; a < 8; ++a) acc[b][a] = 0.f;
      for (int m = 0; m < kM; m += 4) {
        float4 xv[8], dv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int k = kb + lane + 32 * a;
          xv[a] = k < K ? *reinterpret_cast<const float4*>(x + k * kLd + m)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          dv[b] = cb + b < N
                      ? *reinterpret_cast<const float4*>(du + (cb + b) * kLd
                                                         + m)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int b = 0; b < 8; ++b)
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            float t = acc[b][a];
            t = fmaf(dv[b].x, xv[a].x, t);
            t = fmaf(dv[b].y, xv[a].y, t);
            t = fmaf(dv[b].z, xv[a].z, t);
            t = fmaf(dv[b].w, xv[a].w, t);
            acc[b][a] = t;
          }
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (cb + b >= N) continue;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int k = kb + lane + 32 * a;
          if (k < K) dwt[(cb + b) * ldp + k] += acc[b][a];
        }
      }
    }
  }
}

struct BwdSmem {
  float g1[kW * kLd];     // gradient ping
  float g2[kW * kLd];     // gradient pong
  float gr[4 * kLd];      // the tile's raw cotangent; rows 0..2 rgb, 3 sigma
  float xs[kM * 3];
  float ds[kM * 3];
};
// WITH_DW: a third activation buffer X[kW * kLd] follows, for the layer
// inputs of x^T du (rebuilt from the workspace, or the tile's posenc).

template <bool WITH_DW>
__global__ void __launch_bounds__(kThreads, 1)
mlp_train_bwd_kernel(const float* __restrict__ P, const float* __restrict__ PT,
                     const float* __restrict__ LS,
                     const float* __restrict__ pts,
                     const float* __restrict__ dirs,
                     const float* __restrict__ gout,
                     const float* __restrict__ ws, float* __restrict__ partials,
                     int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  float* X = WITH_DW ? reinterpret_cast<float*>(smem_raw + sizeof(BwdSmem))
                     : nullptr;
  const int tid = threadIdx.x;
  constexpr int kDw = WITH_DW ? kWt : 0;
  constexpr int kStride = kDw + 2 * kU;
  float* part = partials + static_cast<size_t>(blockIdx.x) * kStride;
  float* part_ls = part + kDw;
  float* part_b = part + kDw + kU;
  for (int i = tid; i < kStride; i += kThreads) part[i] = 0.f;

  const int n_tiles = (n + kM - 1) / kM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kM;
    const float* U = ws + static_cast<size_t>(base) * kU;
    __syncthreads();  // the previous tile is done with every buffer
    {
      static_assert(kM * 4 == kThreads, "one cotangent per thread");
      const int m = tid / 4, ch = tid % 4;
      s.gr[ch * kLd + m] = base + m < n ? gout[base * 4 + tid] : 0.f;
    }
    if (WITH_DW && tid < kM * 3) {
      const bool valid = base + tid / 3 < n;
      s.xs[tid] = valid ? pts[base * 3 + tid] : 0.f;
      s.ds[tid] = valid ? dirs[base * 3 + tid] : 0.f;
    }
    __syncthreads();

    // heads without activation: rgb (layer 11) rows 0..2, alpha (9) row 3
    if (tid < 3) {
      channel_grad<false>(s.gr + tid * kLd, U + u_offset(11) + tid,
                          __ldg(LS + u_offset(11) + tid),
                          __ldg(bias<11>(P) + tid),
                          part_ls + u_offset(11) + tid,
                          part_b + u_offset(11) + tid);
    } else if (tid == 32) {
      channel_grad<false>(s.gr + 3 * kLd, U + u_offset(9),
                          __ldg(LS + u_offset(9)), __ldg(bias<9>(P)),
                          part_ls + u_offset(9), part_b + u_offset(9));
    }
    if (WITH_DW) rebuild<10, true>(X, U, P, LS);  // v, the rgb head's input
    __syncthreads();
    // dv = du_r @ Wr (128 wide) -> g1
    dense_t<kW / 2>(s.g1, s.gr, 3, PT + wt_offset(11), kW / 2, nullptr, 0,
                    nullptr, 0);
    if (WITH_DW) outer_acc(part + wt_offset(11), kW / 2, s.gr, 3, X, kW / 2);
    __syncthreads();
    // views (layer 10, relu) -> du_v in g1 rows 0..127
    layer_grad<10, true>(s.g1, U, P, LS, part_ls, part_b);
    if (WITH_DW) rebuild<8, false>(X, U, P, LS);  // feature, the view input
    __syncthreads();
    // dfeature = du_v @ Wv[:, :256] -> g2
    dense_t<kW>(s.g2, s.g1, kW / 2, PT + wt_offset(10), kW + kInViews,
                nullptr, 0, nullptr, 0);
    if (WITH_DW) {
      outer_acc(part + wt_offset(10), kW + kInViews, s.g1, kW / 2, X, kW);
      __syncthreads();
      embed_tile(X, s.xs, s.ds);
      __syncthreads();
      outer_acc(part + wt_offset(10) + kW, kW + kInViews, s.g1, kW / 2,
                X + kInPts * kLd, kInViews);
    }
    __syncthreads();
    // feature head (layer 8, no activation) -> du_f in g2
    layer_grad<8, false>(s.g2, U, P, LS, part_ls, part_b);
    if (WITH_DW) rebuild<7, true>(X, U, P, LS);  // h7, the heads' input
    __syncthreads();
    // dh7 = du_f @ Wf + du_a @ Wa -> g1
    dense_t<kW>(s.g1, s.g2, kW, PT + wt_offset(8), kW, s.gr + 3 * kLd, 1,
                PT + wt_offset(9), kW);
    if (WITH_DW) {
      outer_acc(part + wt_offset(8), kW, s.g2, kW, X, kW);
      outer_acc(part + wt_offset(9), kW, s.gr + 3 * kLd, 1, X, kW);
    }
    __syncthreads();

    // pts layers 7..0; the gradient of h_i is in cur
    float* cur = s.g1;
    float* nxt = s.g2;
#define NNC_PTS_LAYER(I)                                                      \
    layer_grad<I, true>(cur, U, P, LS, part_ls, part_b);                      \
    if (WITH_DW && I > 0) rebuild<(I > 0 ? I - 1 : 0), true>(X, U, P, LS);     \
    if (WITH_DW && (I == 0)) embed_tile(X, s.xs, s.ds);                       \
    __syncthreads();                                                          \
    if (I > 0)                                                                \
      dense_t<kW>(nxt, cur, kW, PT + wt_offset(I) + (I == 5 ? kInPts : 0),    \
                  layer_in(I), nullptr, 0, nullptr, 0);                       \
    if (WITH_DW) {                                                            \
      outer_acc(part + wt_offset(I) + (I == 5 ? kInPts : 0), layer_in(I),     \
                cur, kW, X, I == 0 ? kInPts : kW);                            \
      if (I == 5) {                                                           \
        __syncthreads();                                                      \
        embed_tile(X, s.xs, s.ds);                                            \
        __syncthreads();                                                      \
        outer_acc(part + wt_offset(5), layer_in(5), cur, kW, X, kInPts);      \
      }                                                                       \
    }                                                                         \
    __syncthreads();                                                          \
    { float* t = cur; cur = nxt; nxt = t; }
    NNC_PTS_LAYER(7)
    NNC_PTS_LAYER(6)
    NNC_PTS_LAYER(5)
    NNC_PTS_LAYER(4)
    NNC_PTS_LAYER(3)
    NNC_PTS_LAYER(2)
    NNC_PTS_LAYER(1)
    NNC_PTS_LAYER(0)
#undef NNC_PTS_LAYER
  }
}

// out[col] = sum over the G partial rows, in row order.
__global__ void reduce_rows_kernel(const float* __restrict__ partials, int G,
                                   int stride, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= stride) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g)
    acc += partials[static_cast<size_t>(g) * stride + col];
  out[col] = acc;
}

template <bool WITH_DW>
int launch_bwd(const float* P, const float* PT, const float* LS,
               const float* pts, const float* dirs, const float* g,
               const float* ws, float* partials, float* out, int n, int G,
               cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(BwdSmem)) +
                   (WITH_DW ? kW * kLd * static_cast<int>(sizeof(float)) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_bwd_kernel<WITH_DW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stride = (WITH_DW ? kWt : 0) + 2 * kU;
  if (n > 0) {
    mlp_train_bwd_kernel<WITH_DW><<<G, kThreads, smem, stream>>>(
        P, PT, LS, pts, dirs, g, ws, partials, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    G = 0;
  }
  reduce_rows_kernel<<<(stride + 255) / 256, 256, 0, stream>>>(partials, G,
                                                               stride, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nnc_train_sizes(int* u_size, int* wt_size) {
  *u_size = kU;
  *wt_size = kWt;
  return 0;
}

// pts, dirs: (n, 3); out: (n, 4) [rgb logits, sigma]; ws: null, or
// (ceil(n / 64) * 64, 2,436) for the backward's u.
extern "C" int nnc_mlp_train_fwd(const float* params, const float* ls,
                                 const float* pts, const float* dirs,
                                 float* out, float* ws, int n, void* stream) {
  const int smem = static_cast<int>(sizeof(FwdSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int grid = (n + kM - 1) / kM;
    mlp_train_fwd_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        params, ls, pts, dirs, out, ws, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (n, 4) cotangent of out; ws from nnc_mlp_train_fwd; partials:
// (G, stride) scratch; out: (stride,) = [dW (593,408, each layer (out, in),
// with_dw only), dls (2,436), db (2,436)].
extern "C" int nnc_mlp_train_bwd(const float* params, const float* params_t,
                                 const float* ls, const float* pts,
                                 const float* dirs, const float* g,
                                 const float* ws, float* partials, float* out,
                                 int n, int G, int with_dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dw ? launch_bwd<true>(params, params_t, ls, pts, dirs, g, ws,
                                    partials, out, n, G, st)
                 : launch_bwd<false>(params, params_t, ls, pts, dirs, g, ws,
                                     partials, out, n, G, st);
}
