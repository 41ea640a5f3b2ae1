// K-B1: the NeRF MLP's training pass, forward and backward, float32.
//
// Replaces the Pallas pair _fwd_call / _bwd_call
// (nnc_tpu/ops/mlp_train_pallas.py:275, :300) under the custom_vjp _train_op
// (:337-362): every LSA / fine-tune step renders its coarse and fine passes
// through it (renderer.py _query_mlp with use_fused_train).
//
// What it computes. Forward: posenc (10/4 frequencies) and the flagship MLP
// with the LSA scales applied as output scaling, u = x @ W, y = u * ls + b
// (relu on the hidden and view layers), from unscaled weights and separate
// scale and bias vectors. Backward, for the raw-output cotangent g: the
// reverse chain, with dls = colsum(dy_pre * u), db = colsum(dy_pre) over
// every point, and dW = x^T du only with_dw; the inputs get no gradient.
//
// Bound on the H100: operations. A point costs 1.19 MFLOP forward and 1.12
// MFLOP backward without dW (the dx products) against 9.7 KB of workspace
// written by the one and read by the other. The forward and the backward
// without dW run their products on the tensor cores as three TF32 products
// each (nerf_mlp_mma.cuh), so the peak that bounds them is 495 / 3 = 165
// TFLOP/s float32-equivalent (H100 SXM data sheet, dense TF32, at 700 W):
// 196,608 points cannot take less than 1.42 ms forward and 1.33 ms backward;
// the workspace is 0.57 ms of device memory traffic each way. The backward
// with dW (RenderConfig.train_with_dw, fine-tuning) is two passes: this
// backward, writing every layer's du to a second workspace of the same
// layout, and mlp_train_dw.cu's GEMM of X^T dU over the points; its dW
// products, every weight once more, make it 1,151,104 multiply-adds a
// point: 196,608 points cannot take less than 2.74 ms at 165 TFLOP/s.
//
// Design.
// - The reverse chain needs, per point, every layer's u (2,436 floats): far
//   beyond 227 KB of shared memory for a tile. The TPU kernel recomputes the
//   forward in VMEM. Here the forward writes u per point to a workspace in
//   device memory instead (1.9 GB at 196,608 points), and the backward
//   rebuilds what it needs of the activations, the relu mask
//   fmaf(u, ls, b) > 0, bit for bit as the forward computed it. The workspace
//   is written and read with evict-first cache hints (__stcs / __ldcs):
//   streamed through L2 like any other data it evicts the weight slabs that
//   every tile reads from L2.
// - Forward (train_layer, mlp_tile_train). The chain of nerf_mlp_mma.cuh:
//   one persistent CTA per SM, eight warps that each own all 64 points x 32
//   (16) output channels of a layer, 3xTF32 products with two-level sums,
//   the same 73 slabs in the same fragment order through the same
//   three-stage cp.async ring. The inference chain folds ls into the weights
//   and starts its accumulators at the bias; training cannot (dls needs the
//   unscaled u), so a layer streams the unscaled weights, starts at zero,
//   and its epilogue stores u to the workspace and act(fmaf(u, ls, b)) to
//   the activation buffer. A fragment holds (row g, columns 2t, 2t + 1):
//   straight from the registers u would go out as 8-byte stores, four lanes
//   filling one 32-byte sector per row and n-tile. Instead the fragments go
//   to the activation buffer first (it is free: every warp has read its
//   input), and after a barrier every thread takes four consecutive
//   channels of 16 rows: u out as 16-byte stores, a warp writing 512
//   contiguous bytes of a row (scalar stores for the view layer, whose
//   workspace columns start at the odd offset 2,305), the activation back
//   in place. -DNNC_TRAIN_DIRECT_U builds the stores from the registers,
//   for nnc_tpu_torch/tools/mma_probe.py to time: 0.3 ms slower at 196,608
//   points (NVIDIA H100 80GB HBM3, 700 W).
// - Backward without dW (bwd_layer, grad_epilogue). dx = du @ W^T has the
//   forward's shapes, so it runs on the same products from a second slab
//   stream: torch's (out, in) weights are the row-major B of that product,
//   packed in fragment order (68 slabs: 4 for the view layer's 128 x 256, 8
//   for the feature layer and each of pts layers 7..1; layer 5 only its 256
//   rows for h, layer 0 none). What channel_grad did in a pass of its own,
//   one thread a channel, happens in the epilogue on the accumulator
//   fragments: load the matching u (__ldcs), mask, form dpre, sum dpre * u
//   and dpre over the thread's eight rows and then over g by three shuffles,
//   write du = dpre * ls as the next product's input. The rank-1 alpha term
//   and the rgb head's 3 x 128 are FMAs on the fragments. The epilogue's u
//   comes from device memory, 64 KB a layer and tile: the CTA asks L2 for
//   it before the layer's product loop (prefetch_u), and every thread
//   starts all its loads of the layer, with its scales and biases, before
//   the barrier that follows the products, so that one trip to L2 is waited
//   for, under the barrier, and not one per n-tile.
// - dls / db are sums over all points. One persistent CTA per SM walks
//   tiles blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its sums in
//   shared memory, every column owned by one thread; at its end it writes
//   them to its own row of a partial buffer, and a second kernel sums the
//   rows in a fixed order. No atomics: reruns are bit-equal; the result
//   differs from a one-pass sum only by float32 reassociation.
// - Rows past n: the forward reads zero points there and writes their u (so
//   the workspace is finite); the backward loads a zero cotangent for them,
//   so they add exactly zero.
//
// Where the time goes at 196,608 points (NVIDIA H100 80GB HBM3, 700 W;
// nnc_tpu_torch/tools/mma_probe.py, times and thread 0's clock marks).
// Forward 3.7 ms (the SIMT kernel before it 11.4; 3.3 ms without the
// workspace; 3.9-4.0 ms with u stored from the fragments): 80% of a tile's
// clocks in the product loops, 12% in the epilogue (staging u, the workspace
// rows, the activations), 4% at barriers, 2% in the heads, 2% embedding and
// staging. Backward without dW 3.5 ms (11.6 before): 86% in the product
// loops, where the wait for u now falls, 8% in the epilogue (mask, du, the
// column sums), 3% at barriers. It took 3.9 ms with u loaded n-tile by
// n-tile in the epilogue, 3.7 with the L2 prefetch, 3.6 with scales and
// biases loaded before the barrier. Both run the product loops at K-B3's
// rate (8.4 clocks a product and sub-partition against the instruction's
// 6.0), which is what holds them at 38-40% of their bounds.
//
// Packed inputs (nnc_tpu_torch/ops/mlp_train_fused.py). The tensor-core
// kernels: FW, the unscaled weights in pack_weights_mma's order (slabs, an
// unused bias block, the heads' weights); BW, the transposed slabs and the
// heads' weights (pack_train_mma); LS and BI, every layer's scales and
// biases concatenated (offset u_offset). The workspace row of a point, the
// du workspace's and the gradient rows use the u_offset layout too.
#include "mlp_train.cuh"
#include "nerf_mlp_mma.cuh"

namespace {

using namespace nerf;
using namespace nerf::train;

// ------------------------------------------- forward, on the tensor cores

// This thread's fragment (rows mt * 16 + g and + 8, columns c and c + 1 of
// n-tile nt at c = col0 + 8 nt) as float2 accesses of a point-major buffer.
template <int NT>
__device__ __forceinline__ void store_fragments(float* __restrict__ out,
                                                const float (&v)[4][NT][4],
                                                int g, int col0) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* o = out + (mt * 16 + g) * mma::kLdA + col0 + nt * 8;
      *reinterpret_cast<float2*>(o) = make_float2(v[mt][nt][0], v[mt][nt][1]);
      *reinterpret_cast<float2*>(o + 8 * mma::kLdA) =
          make_float2(v[mt][nt][2], v[mt][nt][3]);
    }
}

// How a layer's u reaches the workspace: staged through the activation
// buffer and written as 16-byte coalesced rows, or (-DNNC_TRAIN_DIRECT_U,
// for nnc_tpu_torch/tools/mma_probe.py to time) straight from the fragments.
#ifdef NNC_TRAIN_DIRECT_U
constexpr bool kStageU = false;
#else
constexpr bool kStageU = true;
#endif

// out[:, 0..64 NT) = act(fmaf(u, ls, b)) with u = x1 @ w (+ x2 @ w2) for the
// tile's 64 points, the unscaled weights from the pipe; u goes to U (the
// tile's first workspace row at the layer's columns, row stride kU) when
// SAVE. U2: the layer's workspace columns start at an even offset, so a
// fragment's two columns are one 8-byte store. out may be x1 or x2, as in
// mma_layer. Ends with a barrier.
template <int NT, bool RELU, bool SAVE, bool U2>
__device__ __forceinline__ void train_layer(mma::Pipe& pipe, float* out,
                                            const float* x1, int ld1, int K1,
                                            const float* x2, int ld2, int K2,
                                            const float* __restrict__ ls,
                                            const float* __restrict__ b,
                                            float* __restrict__ U) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int col0 = warp * 8 * NT + 2 * (lane & 3);
  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  mma::mma_segment<NT>(pipe, acc, x1, ld1, K1);
  if (K2 > 0) mma::mma_segment<NT>(pipe, acc, x2, ld2, K2);
  NNC_PROF(2);
  __syncthreads();
  NNC_PROF(3);
  if constexpr (SAVE && kStageU) {
    // u through the activation buffer: every thread then takes four
    // consecutive channels of 16 (8) rows, so a warp writes 512 contiguous
    // bytes of a workspace row
    constexpr int kQuads = 16 * NT;   // float4s in a row
    const int c = 4 * (threadIdx.x % kQuads);
    const float4 l4 = make_float4(__ldg(ls + c), __ldg(ls + c + 1),
                                  __ldg(ls + c + 2), __ldg(ls + c + 3));
    const float4 b4 = make_float4(__ldg(b + c), __ldg(b + c + 1),
                                  __ldg(b + c + 2), __ldg(b + c + 3));
    store_fragments<NT>(out, acc, g, col0);
    __syncthreads();
#pragma unroll 4
    for (int r = threadIdx.x / kQuads; r < kM; r += kThreads / kQuads) {
      float4* o = reinterpret_cast<float4*>(out + r * mma::kLdA + c);
      const float4 u4 = *o;
      float* w = U + static_cast<size_t>(r) * kU + c;
      if (U2) {
        __stcs(reinterpret_cast<float4*>(w), u4);
      } else {
        __stcs(w, u4.x);
        __stcs(w + 1, u4.y);
        __stcs(w + 2, u4.z);
        __stcs(w + 3, u4.w);
      }
      float4 h = make_float4(fmaf(u4.x, l4.x, b4.x), fmaf(u4.y, l4.y, b4.y),
                             fmaf(u4.z, l4.z, b4.z), fmaf(u4.w, l4.w, b4.w));
      if (RELU)
        h = make_float4(fmaxf(h.x, 0.f), fmaxf(h.y, 0.f), fmaxf(h.z, 0.f),
                        fmaxf(h.w, 0.f));
      *o = h;
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + nt * 8;
      const float l0 = __ldg(ls + c), l1 = __ldg(ls + c + 1);
      const float b0 = __ldg(b + c), b1 = __ldg(b + c + 1);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (SAVE) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* w = U + static_cast<size_t>(mt * 16 + g + 8 * half) * kU + c;
            if (U2) {
              __stcs(reinterpret_cast<float2*>(w),
                     make_float2(acc[mt][nt][2 * half],
                                 acc[mt][nt][2 * half + 1]));
            } else {
              __stcs(w, acc[mt][nt][2 * half]);
              __stcs(w + 1, acc[mt][nt][2 * half + 1]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = fmaf(acc[mt][nt][i], i & 1 ? l1 : l0, i & 1 ? b1 : b0);
          acc[mt][nt][i] = RELU ? fmaxf(p, 0.f) : p;
        }
      }
    }
    store_fragments<NT>(out, acc, g, col0);
  }
  NNC_PROF(4);
  __syncthreads();
  NNC_PROF(5);
}

// The training MLP on the embedded tile in s.emb; raw logits to s.raw, u of
// every layer to U (the tile's first workspace row) when SAVE. FW: the
// buffer of pack_train_mma's forward half, whose slabs `pipe` streams. All
// threads enter; starts (after the embedding's stores) and ends with a
// barrier.
template <bool SAVE>
__device__ __forceinline__ void mlp_tile_train(mma::MlpSmem& s,
                                               mma::Pipe& pipe,
                                               const float* __restrict__ FW,
                                               const float* __restrict__ LS,
                                               const float* __restrict__ BI,
                                               float* __restrict__ U) {
  float* A = s.act;
  const float* E = s.emb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __syncthreads();
  NNC_PROF(1);
  train_layer<4, true, SAVE, true>(pipe, A, E, mma::kLdE, mma::kPtsPad,
                                   nullptr, 0, 0, LS, BI, U);
#pragma unroll 1
  for (int i = 1; i <= 4; ++i)
    train_layer<4, true, SAVE, true>(pipe, A, A, mma::kLdA, kW, nullptr, 0, 0,
                                     LS + i * kW, BI + i * kW, U + i * kW);
  // skip: [emb, h] @ w5 — rows 0..62 of w5 act on emb, rows 63.. on h
  train_layer<4, true, SAVE, true>(pipe, A, E, mma::kLdE, mma::kPtsPad, A,
                                   mma::kLdA, kW, LS + 5 * kW, BI + 5 * kW,
                                   U + 5 * kW);
#pragma unroll 1
  for (int i = 6; i <= 7; ++i)
    train_layer<4, true, SAVE, true>(pipe, A, A, mma::kLdA, kW, nullptr, 0, 0,
                                     LS + i * kW, BI + i * kW, U + i * kW);

  // alpha head (256 -> 1) on h = A: warp w takes points 8 w .. 8 w + 7
  {
    constexpr int o = u_offset(kLayerAlpha);
    float wa[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wa[j] = __ldg(FW + mma::kOffAlphaW + lane + 32 * j);
    const float la = __ldg(LS + o), ba = __ldg(BI + o);
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int m = warp * 8 + i;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fmaf(A[m * mma::kLdA + lane + 32 * j], wa[j], acc);
      acc = mma::warp_sum_all(acc);
      if (lane == 0) {
        if (SAVE) __stcs(U + static_cast<size_t>(m) * kU + o, acc);
        s.raw[m * 4 + 3] = fmaf(acc, la, ba);
      }
    }
  }
  NNC_PROF(6);
  // feature (no activation) on h = A, in place
  train_layer<4, false, SAVE, true>(
      pipe, A, A, mma::kLdA, kW, nullptr, 0, 0, LS + u_offset(kLayerFeature),
      BI + u_offset(kLayerFeature), U + u_offset(kLayerFeature));
  // views: relu(ls * ([feature, view emb] @ wv) + bv) -> A cols 0..127
  train_layer<2, true, SAVE, false>(
      pipe, A, A, mma::kLdA, kW, E + mma::kPtsPad, mma::kLdE, mma::kViewsPad,
      LS + u_offset(kLayerViews), BI + u_offset(kLayerViews),
      U + u_offset(kLayerViews));
  // rgb head (128 -> 3)
  {
    constexpr int o = u_offset(kLayerRgb);
    float wr[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wr[j][c] = __ldg(FW + mma::kOffRgbW + (lane + 32 * j) * 3 + c);
    float lr = 0.f, br = 0.f;
    if (lane < 3) {
      lr = __ldg(LS + o + lane);
      br = __ldg(BI + o + lane);
    }
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int m = warp * 8 + i;
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = A[m * mma::kLdA + lane + 32 * j];
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = fmaf(h, wr[j][c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = mma::warp_sum_all(acc[c]);
      if (lane < 3) {
        const float u = lane == 0 ? acc[0] : lane == 1 ? acc[1] : acc[2];
        if (SAVE) __stcs(U + static_cast<size_t>(m) * kU + o + lane, u);
        s.raw[m * 4 + lane] = fmaf(u, lr, br);
      }
    }
  }
  __syncthreads();
  NNC_PROF(7);
}

struct FwdSmem {
  mma::MlpSmem mlp;
  float xs[kM * 3];
  float ds[kM * 3];
};

template <bool SAVE>
__global__ void __launch_bounds__(kThreads, 1)
mlp_train_fwd_kernel(const float* __restrict__ FW,
                     const float* __restrict__ LS,
                     const float* __restrict__ BI,
                     const float* __restrict__ pts,
                     const float* __restrict__ dirs, float* __restrict__ out,
                     float* __restrict__ ws, int n, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x;
  mma::prof_begin();
  mma::Pipe pipe;
  pipe.start(FW, s.mlp.ring);
  mma::zero_embedding_pad(s.mlp.emb);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kM;
    if (tid < kM * 3) {
      const bool valid = base + tid / 3 < n;
      s.xs[tid] = valid ? pts[base * 3 + tid] : 0.f;
      s.ds[tid] = valid ? dirs[base * 3 + tid] : 0.f;
    }
    __syncthreads();
    NNC_PROF(0);
    mma::embed_tile(s.mlp.emb, s.xs, s.ds);
    mlp_tile_train<SAVE>(s.mlp, pipe, FW, LS, BI,
                         SAVE ? ws + static_cast<size_t>(base) * kU : nullptr);
    static_assert(kM * 4 == kThreads, "one output per thread");
    if (base + tid / 4 < n) out[base * 4 + tid] = s.mlp.raw[tid];
    NNC_PROF(8);
  }
  pipe.drain();
  mma::prof_end();
}

// ------------------------------ backward without dW, on the tensor cores

// The transposed slab stream in the order the reverse chain consumes it:
// the view layer's feature rows (4 slabs), the feature layer (8), pts
// layers 7..1 (8 each); then the heads' weights.
constexpr int kBwdSlabs = 4 + 8 + 7 * 8;
static_assert(kBwdSlabs == 68, "transposed slab schedule");
using BwdPipe = mma::PipeT<kBwdSlabs>;
constexpr int kOffAlphaWT = kBwdSlabs * mma::kSlab;   // 256 weights
constexpr int kOffRgbWT = kOffAlphaWT + kW;           // (3, 128) row-major
constexpr int kBwdParamsSize = (kOffRgbWT + 3 * (kW / 2) + 63) / 64 * 64;

struct BwdMmaSmem {
  float ring[mma::kStages * mma::kSlab];  // transposed slabs in flight
  float g[kM * mma::kLdA];  // du of the layer above, then this layer's
  float gr[kM * 4];         // the tile's raw cotangent, then the heads' du
  float part[2 * kU];       // this CTA's sums: dls, then db
};

// This thread's du fragments (rows mt * 16 + g and + 8, columns c and
// c + 1 of n-tile nt at c = col0 + 8 nt) to the du workspace (DU: the
// tile's first row at the layer's columns, row stride kU), evict-first. U2:
// the columns start at an even offset, so the two are one 8-byte store.
template <int NT, bool U2>
__device__ __forceinline__ void store_du(float* __restrict__ DU,
                                         const float (&acc)[4][NT][4], int g,
                                         int col0) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* w = DU + static_cast<size_t>(mt * 16 + g + 8 * half) * kU +
                   col0 + nt * 8;
        if (U2) {
          __stcs(reinterpret_cast<float2*>(w),
                 make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]));
        } else {
          __stcs(w, acc[mt][nt][2 * half]);
          __stcs(w + 1, acc[mt][nt][2 * half + 1]);
        }
      }
}

// The accumulators hold the gradient of a layer's output for the tile (the
// fragment layout of mma_layer). In place they become du = dpre * ls, with
// dpre the gradient masked by the layer's relu (RELU; the forward's
// fmaf(u, ls, b) > 0 from the workspace's u); dpre * u and dpre, summed over
// the tile's 64 rows, are added to the CTA's dls and db of the layer's
// columns. du goes to G, the next product's input, if `write`. part_ls,
// part_b: at the layer's columns; u, lb: load_u and load_lb of the layer,
// which the caller starts before its barrier, so that one trip to L2 is
// waited for and not one per n-tile. Every warp must be done reading G; ends
// with a barrier. DU: the tile's first row of the du workspace at the
// layer's columns (the backward with dW), or null: du goes there too, with
// evict-first stores like u's.
template <int NT, bool RELU>
__device__ __forceinline__ void grad_epilogue(float (&acc)[4][NT][4],
                                              const float (&u)[NT][4][2][2],
                                              const float (&lb)[NT][4],
                                              float* __restrict__ G,
                                              float* __restrict__ part_ls,
                                              float* __restrict__ part_b,
                                              bool write,
                                              float* __restrict__ DU) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int col0 = warp * 8 * NT + 2 * (lane & 3);
  float sl[NT][2], sb[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float l = lb[nt][j], bb = lb[nt][2 + j];
      float tl = 0.f, tb = 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float uj = u[nt][mt][half][j];
          float d = acc[mt][nt][2 * half + j];
          if (RELU && !(fmaf(uj, l, bb) > 0.f)) d = 0.f;
          tl = fmaf(d, uj, tl);
          tb += d;
          acc[mt][nt][2 * half + j] = d * l;
        }
      sl[nt][j] = tl;
      sb[nt][j] = tb;
    }
  NNC_PROF(4);
  // over g: the eight lanes that share t, in a fixed order; the 4 NT sums
  // of a step are independent of each other
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sl[nt][j] += __shfl_xor_sync(0xffffffffu, sl[nt][j], off);
        sb[nt][j] += __shfl_xor_sync(0xffffffffu, sb[nt][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        part_ls[col0 + nt * 8 + j] += sl[nt][j];
        part_b[col0 + nt * 8 + j] += sb[nt][j];
      }
  }
  NNC_PROF(5);
  if (write) store_fragments<NT>(G, acc, g, col0);
  // (the view layer, NT = 2, starts at the odd column 2,305)
  if (DU) store_du<NT, NT == 4>(DU, acc, g, col0);
  NNC_PROF(6);
  __syncthreads();
  NNC_PROF(7);
}

// One step of the reverse chain: the gradient of layer L's output,
// du_above (64 x K, in s.g) @ (the next K / 32 transposed slabs), plus
// du_alpha (x) w_alpha when ALPHA (layer 7 feeds the alpha head too), then
// grad_epilogue of layer L.
template <bool RELU, bool ALPHA>
__device__ __forceinline__ void bwd_layer(BwdMmaSmem& s, BwdPipe& pipe, int K,
                                          int L, bool write,
                                          const float* __restrict__ BW,
                                          const float* __restrict__ LS,
                                          const float* __restrict__ BI,
                                          const float* __restrict__ ws,
                                          float* __restrict__ du, int tile) {
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int o = L * kW;   // u_offset(L) for L <= 8
  const float* U = ws + static_cast<size_t>(tile) * (kM * kU) + o;
  prefetch_u(U, kW * static_cast<int>(sizeof(float)));
  mma::mma_segment<4>(pipe, acc, s.g, mma::kLdA, K);
  if (ALPHA) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int col0 = (threadIdx.x >> 5) * 32 + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float w0 = __ldg(BW + kOffAlphaWT + col0 + nt * 8);
      const float w1 = __ldg(BW + kOffAlphaWT + col0 + nt * 8 + 1);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float d0 = s.gr[(mt * 16 + g) * 4 + 3];
        const float d1 = s.gr[(mt * 16 + g + 8) * 4 + 3];
        acc[mt][nt][0] = fmaf(d0, w0, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(d0, w1, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(d1, w0, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(d1, w1, acc[mt][nt][3]);
      }
    }
  }
  const int col0 = (threadIdx.x >> 5) * 32 + 2 * (threadIdx.x & 3);
  float u[4][4][2][2], lb[4][4];
  load_u<4, true>(u, U, (threadIdx.x & 31) >> 2, col0);
  load_lb<4>(lb, LS + o, BI + o, col0);
  NNC_PROF(2);
  __syncthreads();
  NNC_PROF(3);
  grad_epilogue<4, RELU>(
      acc, u, lb, s.g, s.part + o, s.part + kU + o, write,
      du ? du + static_cast<size_t>(tile) * (kM * kU) + o : nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_train_bwd_mma_kernel(const float* __restrict__ BW,
                         const float* __restrict__ LS,
                         const float* __restrict__ BI,
                         const float* __restrict__ gout,
                         const float* __restrict__ ws,
                         float* __restrict__ du,
                         float* __restrict__ partials, int n, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdMmaSmem& s = *reinterpret_cast<BwdMmaSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  static_assert(u_offset(kLayerFeature) == kLayerFeature * kW, "u layout");
  mma::prof_begin();
  BwdPipe pipe;
  pipe.start(BW, s.ring);
  for (int i = tid; i < 2 * kU; i += kThreads) s.part[i] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kM;
    const float* U = ws + static_cast<size_t>(tile) * (kM * kU);
    float* DU = du ? du + static_cast<size_t>(tile) * (kM * kU) : nullptr;
    static_assert(kM * 4 == kThreads, "one cotangent per thread");
    // (the last barrier of the tile before: everyone is done with s.gr)
    s.gr[tid] = base + tid / 4 < n ? gout[base * 4 + tid] : 0.f;
    // the view layer's u (128 columns) and the rgb head's next to them
    prefetch_u(U + u_offset(kLayerViews),
               (kW / 2 + 3) * static_cast<int>(sizeof(float)));
    __syncthreads();
    // the heads, which have no activation: warp c < 3 takes rgb channel c,
    // warp 3 alpha; their sums, and du = g * ls in place (and to DU)
    if (warp < 4) {
      const int o = warp < 3 ? u_offset(kLayerRgb) + warp
                             : u_offset(kLayerAlpha);
      const float l = __ldg(LS + o);
      const float d0 = s.gr[lane * 4 + warp];
      const float d1 = s.gr[(lane + 32) * 4 + warp];
      const float u0 = __ldcs(U + static_cast<size_t>(lane) * kU + o);
      const float u1 = __ldcs(U + static_cast<size_t>(lane + 32) * kU + o);
      const float sl = mma::warp_sum_all(fmaf(d1, u1, d0 * u0));
      const float sb = mma::warp_sum_all(d0 + d1);
      if (lane == 0) {
        s.part[o] += sl;
        s.part[kU + o] += sb;
      }
      s.gr[lane * 4 + warp] = d0 * l;
      s.gr[(lane + 32) * 4 + warp] = d1 * l;
      if (DU) {
        __stcs(DU + static_cast<size_t>(lane) * kU + o, d0 * l);
        __stcs(DU + static_cast<size_t>(lane + 32) * kU + o, d1 * l);
      }
    }
    __syncthreads();
    NNC_PROF(0);
    // dv = du_rgb @ Wr^T (64 x 3 times 3 x 128) on the view layer's
    // fragments, then the view layer's epilogue -> du_v in s.g cols 0..127
    {
      const int g = lane >> 2;
      const int col0 = warp * 16 + 2 * (lane & 3);
      float acc[4][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float w[3][2];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            w[c][j] = __ldg(BW + kOffRgbWT + c * (kW / 2) + col0 + nt * 8 + j);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float4 d = *reinterpret_cast<const float4*>(
                s.gr + (mt * 16 + g + 8 * half) * 4);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              acc[mt][nt][2 * half + j] =
                  fmaf(d.z, w[2][j], fmaf(d.y, w[1][j], d.x * w[0][j]));
          }
      }
      NNC_PROF(1);
      constexpr int o = u_offset(kLayerViews);
      float u[2][4][2][2], lb[2][4];
      load_u<2, false>(u, U + o, g, col0);
      load_lb<2>(lb, LS + o, BI + o, col0);
      grad_epilogue<2, true>(acc, u, lb, s.g, s.part + o, s.part + kU + o,
                             true, DU ? DU + o : nullptr);
    }
    // dfeature = du_v @ Wv[:256]^T; the feature layer has no activation
    bwd_layer<false, false>(s, pipe, kW / 2, kLayerFeature, true, BW, LS, BI,
                            ws, du, tile);
    // dh7 = du_f @ Wf^T + du_alpha (x) w_alpha
    bwd_layer<true, true>(s, pipe, kW, 7, true, BW, LS, BI, ws, du, tile);
    // dh_{i} = du_{i+1} @ W_{i+1}^T (layer 5: its 256 rows for h), i = 6..0
    // (layer 0's du feeds no product; with dW it goes to the du workspace)
#pragma unroll 1
    for (int i = 6; i >= 0; --i)
      bwd_layer<true, false>(s, pipe, kW, i, i > 0, BW, LS, BI, ws, du, tile);
    NNC_PROF(8);
  }
  pipe.drain();
  __syncthreads();
  float* row = partials + static_cast<size_t>(blockIdx.x) * (2 * kU);
  for (int i = tid; i < 2 * kU; i += kThreads) row[i] = s.part[i];
  mma::prof_end();
}

template <bool SAVE>
int launch_fwd(const float* fw, const float* ls, const float* bi,
               const float* pts, const float* dirs, float* out, float* ws,
               int n, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(FwdSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_fwd_kernel<SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int tiles = (n + kM - 1) / kM;
    mlp_train_fwd_kernel<SAVE><<<tiles < sms ? tiles : sms, kThreads, smem,
                                 stream>>>(fw, ls, bi, pts, dirs, out, ws, n,
                                           tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nnc_train_sizes(int* u_size, int* wt_size) {
  *u_size = kU;
  *wt_size = kWt;
  return 0;
}

// Lengths of the two buffers of pack_train_mma.
extern "C" int nnc_train_mma_sizes(int* fwd_size, int* bwd_size) {
  *fwd_size = mma::kMmaParamsSize;
  *bwd_size = kBwdParamsSize;
  return 0;
}

#ifdef NNC_MMA_PROFILE
// Reads the clock sums of the launches so far into out[kProfSlots] and
// zeroes them (nerf_mlp_mma.cuh, NNC_PROF).
extern "C" int nnc_train_profile(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, mma::prof_total, sizeof(mma::prof_total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[mma::kProfSlots] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(mma::prof_total, zero, sizeof(zero)));
}
#endif

// fw: the forward half of pack_train_mma, 16-byte aligned; ls, bi: scales
// and biases (2,436 each); pts, dirs: (n, 3); out: (n, 4) [rgb logits,
// sigma]; ws: null, or (ceil(n / 64) * 64, 2,436) for the backward's u.
extern "C" int nnc_mlp_train_fwd(const float* fw, const float* ls,
                                 const float* bi, const float* pts,
                                 const float* dirs, float* out, float* ws,
                                 int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ws != nullptr
             ? launch_fwd<true>(fw, ls, bi, pts, dirs, out, ws, n, st)
             : launch_fwd<false>(fw, ls, bi, pts, dirs, out, ws, n, st);
}

// The backward without dW, and the first pass of the backward with dW. bw:
// the backward half of pack_train_mma, 16-byte aligned; g: (n, 4) cotangent
// of out; ws from nnc_mlp_train_fwd; du: null, or a workspace of ws's shape
// that takes every layer's du = dpre * ls per point (rows up to
// ceil(n / 64) * 64; nnc_mlp_train_dw, mlp_train_dw.cu, reads it);
// partials: (G, 4,872) scratch; out: (4,872,) = [dls (2,436), db (2,436)].
extern "C" int nnc_mlp_train_bwd_mma(const float* bw, const float* ls,
                                     const float* bi, const float* g,
                                     const float* ws, float* du,
                                     float* partials, float* out, int n,
                                     int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(sizeof(BwdMmaSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    mlp_train_bwd_mma_kernel<<<G, kThreads, smem, st>>>(
        bw, ls, bi, g, ws, du, partials, n, (n + kM - 1) / kM);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    G = 0;
  }
  return reduce_rows(partials, G, 2 * kU, out, st);
}
