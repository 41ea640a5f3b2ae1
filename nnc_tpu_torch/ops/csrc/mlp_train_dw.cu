// K-B1's backward with dW, SIMT, float32 and bf16.
//
// Replaces the with-dW form of the Pallas _bwd_call
// (nnc_tpu/ops/mlp_train_pallas.py:300): dW = x^T du beside dls and db, on
// the workspace of u that mlp_train.cu's forward (float32) or
// mlp_train_bf16.cu's forward (bf16) wrote. What it computes, its bound and
// the rest of K-B1's design: mlp_train.cu's opening comment. It is a
// translation unit of its own, beside mlp_train.cu's tensor-core kernels,
// only so that nvcc compiles the two at the same time: together they were
// the build's longest compile by far.
#include "mlp_train.cuh"

namespace {

using namespace nerf;
using namespace nerf::train;

// ------------------------------------------- backward with dW, SIMT float32
// mlp_train_bwd_kernel<true, false>: the chain of nerf_mlp.cuh (channel-major
// activations, weights through L1/L2), reading the workspace mlp_train.cu's
// forward wrote. mlp_train_bwd_kernel<true, true> is K-B1's bf16 backward with
// dW, on the workspace of mlp_train_bf16.cu's forward: the reference's
// rounding points (mlp_train_pallas.py:181-192, 358) on the same chain,
// every weight rounded to bf16 as it is loaded, every du rounded where
// channel_grad writes it (the input of both the dx and the dW products),
// the rebuilt activations and the embedding rounded, the relu mask taken
// from the rounded activation, dW rounded once summed (reduce_rows); dls and
// db stay float32 sums. Products of bf16 values are exact in float32, so
// the sums are the float32 chain's.


// acc[r][j] += sum_c x[c][r0 + r] * w[c * ldw + lane + 32 j]: dense's product
// with a row stride, for the (out, in) weights of the backward.
template <int NC, bool BF16>
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
    for (int j = 0; j < NC; ++j) {
      wv[j] = __ldg(w + k * ldw + lane + 32 * j);
      if (BF16) wv[j] = bf16_round(wv[j]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(xr[r], wv[j], acc[r][j]);
  }
}

// out[k][m] = sum_c du[c][m] wt[c][k] (+ the same for du2, wt2), k < NOUT:
// the input gradient of a layer, from its (out, in) weights (row stride ldw),
// rounded to bf16 as they are loaded when BF16.
template <int NOUT, bool BF16>
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
  accumulate_ld<NC, BF16>(acc, du, K, wt, ldw, r0, lane);
  if (K2 > 0) accumulate_ld<NC, BF16>(acc, du2, K2, wt2, ldw2, r0, lane);
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
// channel's u of the tile's first point (stride kU). BF16: the mask is the
// rounded activation's, du is rounded.
template <bool RELU, bool BF16>
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
      const float p = fmaf(uq, l, b);
      if (RELU && !((BF16 ? bf16_round(p) : p) > 0.f)) d[q] = 0.f;
      sl = fmaf(d[q], uq, sl);
      sb += d[q];
      d[q] = BF16 ? bf16_round(d[q] * l) : d[q] * l;
    }
    *p = make_float4(d[0], d[1], d[2], d[3]);
  }
  *dls += sl;
  *db += sb;
}

// Every output channel of layer L (kThreads >= its width): channel_grad.
template <int L, bool RELU, bool BF16>
__device__ __forceinline__ void layer_grad(float* __restrict__ g,
                                           const float* __restrict__ U,
                                           const float* __restrict__ P,
                                           const float* __restrict__ LS,
                                           float* __restrict__ part_ls,
                                           float* __restrict__ part_b) {
  const int c = threadIdx.x;
  if (c < layer_out(L)) {
    channel_grad<RELU, BF16>(g + c * kLd, U + u_offset(L) + c,
                       __ldg(LS + u_offset(L) + c), __ldg(bias<L>(P) + c),
                       part_ls + u_offset(L) + c, part_b + u_offset(L) + c);
  }
}

// X[k][m] = act(fmaf(u, ls, b)) of layer L for its K outputs: the forward's
// activation, rebuilt from the workspace (rounded to bf16 when BF16).
template <int L, bool RELU, bool BF16>
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
    const float h = RELU ? fmaxf(p, 0.f) : p;
    X[k * kLd + m] = BF16 ? bf16_round(h) : h;
  }
}

// The tile's positional encoding into X (channel-major, embed_tile of
// nerf_mlp.cuh), rounded to bf16 when BF16. Every thread enters; ends with
// a barrier when BF16.
template <bool BF16>
__device__ __forceinline__ void embed_x(float* __restrict__ X,
                                        const float* __restrict__ xs,
                                        const float* __restrict__ ds) {
  embed_tile(X, xs, ds);
  if (BF16) {
    __syncthreads();
    for (int i = threadIdx.x; i < kEmb * kLd; i += kThreads)
      X[i] = bf16_round(X[i]);
    __syncthreads();
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

template <bool WITH_DW, bool BF16>
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
      channel_grad<false, BF16>(s.gr + tid * kLd, U + u_offset(11) + tid,
                          __ldg(LS + u_offset(11) + tid),
                          __ldg(bias<11>(P) + tid),
                          part_ls + u_offset(11) + tid,
                          part_b + u_offset(11) + tid);
    } else if (tid == 32) {
      channel_grad<false, BF16>(s.gr + 3 * kLd, U + u_offset(9),
                          __ldg(LS + u_offset(9)), __ldg(bias<9>(P)),
                          part_ls + u_offset(9), part_b + u_offset(9));
    }
    if (WITH_DW) rebuild<10, true, BF16>(X, U, P, LS);  // v, the rgb head's input
    __syncthreads();
    // dv = du_r @ Wr (128 wide) -> g1
    dense_t<kW / 2, BF16>(s.g1, s.gr, 3, PT + wt_offset(11), kW / 2, nullptr, 0,
                    nullptr, 0);
    if (WITH_DW) outer_acc(part + wt_offset(11), kW / 2, s.gr, 3, X, kW / 2);
    __syncthreads();
    // views (layer 10, relu) -> du_v in g1 rows 0..127
    layer_grad<10, true, BF16>(s.g1, U, P, LS, part_ls, part_b);
    if (WITH_DW) rebuild<8, false, BF16>(X, U, P, LS);  // feature, the view input
    __syncthreads();
    // dfeature = du_v @ Wv[:, :256] -> g2
    dense_t<kW, BF16>(s.g2, s.g1, kW / 2, PT + wt_offset(10), kW + kInViews,
                nullptr, 0, nullptr, 0);
    if (WITH_DW) {
      outer_acc(part + wt_offset(10), kW + kInViews, s.g1, kW / 2, X, kW);
      __syncthreads();
      embed_x<BF16>(X, s.xs, s.ds);
      __syncthreads();
      outer_acc(part + wt_offset(10) + kW, kW + kInViews, s.g1, kW / 2,
                X + kInPts * kLd, kInViews);
    }
    __syncthreads();
    // feature head (layer 8, no activation) -> du_f in g2
    layer_grad<8, false, BF16>(s.g2, U, P, LS, part_ls, part_b);
    if (WITH_DW) rebuild<7, true, BF16>(X, U, P, LS);  // h7, the heads' input
    __syncthreads();
    // dh7 = du_f @ Wf + du_a @ Wa -> g1
    dense_t<kW, BF16>(s.g1, s.g2, kW, PT + wt_offset(8), kW, s.gr + 3 * kLd, 1,
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
    layer_grad<I, true, BF16>(cur, U, P, LS, part_ls, part_b);                \
    if (WITH_DW && I > 0)                                                     \
      rebuild<(I > 0 ? I - 1 : 0), true, BF16>(X, U, P, LS);                  \
    if (WITH_DW && (I == 0)) embed_x<BF16>(X, s.xs, s.ds);                    \
    __syncthreads();                                                          \
    if (I > 0)                                                                \
      dense_t<kW, BF16>(nxt, cur, kW,                                         \
                        PT + wt_offset(I) + (I == 5 ? kInPts : 0),            \
                  layer_in(I), nullptr, 0, nullptr, 0);                       \
    if (WITH_DW) {                                                            \
      outer_acc(part + wt_offset(I) + (I == 5 ? kInPts : 0), layer_in(I),     \
                cur, kW, X, I == 0 ? kInPts : kW);                            \
      if (I == 5) {                                                           \
        __syncthreads();                                                      \
        embed_x<BF16>(X, s.xs, s.ds);                                         \
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

template <bool BF16>
int launch_bwd_dw(const float* params, const float* params_t,
                  const float* ls, const float* pts, const float* dirs,
                  const float* g, const float* ws, float* partials,
                  float* out, int n, int G, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(BwdSmem)) +
                   kW * kLd * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_bwd_kernel<true, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    mlp_train_bwd_kernel<true, BF16><<<G, kThreads, smem, st>>>(
        params, params_t, ls, pts, dirs, g, ws, partials, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    G = 0;
  }
  return reduce_rows(partials, G, kWt + 2 * kU, out, st, BF16 ? kWt : 0);
}

}  // namespace

// The backward with dW (launch_bwd_dw<false>). params, params_t: the buffers
// of pack_train; the rest as nnc_mlp_train_bwd_mma's (mlp_train.cu), with
// partials (G, stride) and out
// (stride,) = [dW (593,408, each layer (out, in)), dls (2,436), db (2,436)].
extern "C" int nnc_mlp_train_bwd_dw(const float* params,
                                    const float* params_t, const float* ls,
                                    const float* pts, const float* dirs,
                                    const float* g, const float* ws,
                                    float* partials, float* out, int n, int G,
                                    void* stream) {
  return launch_bwd_dw<false>(params, params_t, ls, pts, dirs, g, ws,
                              partials, out, n, G,
                              static_cast<cudaStream_t>(stream));
}

// K-B1's bf16 backward with dW: the arguments of nnc_mlp_train_bwd_dw, the
// workspace from nnc_mlp_train_fwd_bf16 (mlp_train_bf16.cu); params and
// params_t unrounded float32 (the kernel rounds the weights it loads).
extern "C" int nnc_mlp_train_bwd_dw_bf16(const float* params,
                                         const float* params_t,
                                         const float* ls, const float* pts,
                                         const float* dirs, const float* g,
                                         const float* ws, float* partials,
                                         float* out, int n, int G,
                                         void* stream) {
  return launch_bwd_dw<true>(params, params_t, ls, pts, dirs, g, ws,
                             partials, out, n, G,
                             static_cast<cudaStream_t>(stream));
}
