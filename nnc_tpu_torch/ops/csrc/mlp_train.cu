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
// written by the one and read by the other. Every float32 product is three
// TF32 products on the tensor cores, so the peak that bounds them is
// 495 / 3 = 165 TFLOP/s float32-equivalent (H100 SXM data sheet, dense
// TF32, at 700 W): 196,608 points cannot take less than 1.42 ms forward and
// 1.33 ms backward; the workspace is 0.57 ms of device memory traffic each
// way. The backward with dW (RenderConfig.train_with_dw, fine-tuning) is
// two passes: this backward, writing every layer's du to a second workspace
// of the same layout, and mlp_train_dw.cu's GEMM of X^T dU over the points;
// its dW products, every weight once more, make it 1,151,104 multiply-adds
// a point: 196,608 points cannot take less than 2.74 ms at 165 TFLOP/s.
//
// Design (mlp_train_wgmma.cuh holds the products and the ring).
// - Products on warpgroup wgmma (m64n128k8 .tf32; the view layer
//   m64n64k8), which alone reaches the tensor cores' full rate: the
//   mma.sync m16n8k8 chain this kernel ran before issued once every 8.4
//   clocks a sub-partition against the instruction's 6.0 and held it at
//   37% of the bound. Each float32 product stays 3xTF32: A is split in
//   registers (hi = x rounded to TF32, lo = the rest), B comes split
//   already, and a group of 32 input channels sums lo * hi, hi * lo, hi *
//   hi k step by k step into a tile of its own started from zero, which
//   joins the layer's sum by rounded float32 adds once its products have
//   completed (the tensor core adds into its accumulator by cutting). The
//   join doubles the accumulators: a 64 x 128 sum and its group's tile are
//   128 registers a thread, so one CTA of 256 threads (all 255 registers a
//   thread) takes a tile of 64 points, its two warpgroups 128 output
//   channels each (the view layer 64), and both read every slab. The sum
//   and the tile trade places from group to group, so that the joins add
//   into the tile's registers and no sum is copied back.
// - The two warpgroups take turns at issuing a group's twelve products
//   (named barriers), so that one's products run while the other waits for
//   its own, joins them and loads and splits its next operands.
// - A from registers: both warpgroups load the layer's input from the
//   float32 activations in shared memory (point-major, row stride 272: the
//   16-byte loads conflict-free) and split it there. A layer's output goes
//   back into the same buffer after the CTA's barrier, as before.
// - B from shared memory: pack_train_wgmma splits the unscaled weights once
//   a pack (hi + lo == w) and lays each group's hi and lo out as the images
//   a descriptor reads (K-major, the 128-byte swizzle; the channel order
//   within a group matches the A registers'). 145 slabs of 32 KB a tile
//   forward, 136 backward (4.75 MB and 4.46 MB: the split doubles the
//   float32 weights), each one bulk copy into slab_ring.cuh's ring of four
//   stages (two groups; shared memory holds no more beside the activations
//   and the embedding); all eight warps acquire and release every slab, the
//   last to release a stage refills it.
// - The reverse chain needs, per point, every layer's u (2,436 floats): far
//   beyond 227 KB of shared memory for a tile. The TPU kernel recomputes the
//   forward in VMEM. Here the forward writes u per point to a workspace in
//   device memory instead (1.9 GB at 196,608 points), and the backward
//   rebuilds what it needs of the activations, the relu mask
//   fmaf(u, ls, b) > 0, bit for bit as the forward computed it. The workspace
//   is written and read with evict-first cache hints (__stcs / __ldcs).
//   The forward stages u through the activation buffer: after a barrier
//   every thread takes four consecutive channels of 16 (8) rows, so that u
//   goes out as 16-byte stores, a warp writing 512 contiguous bytes of a
//   row (scalar stores for the view layer, whose workspace columns start at
//   the odd offset 2,305), the activation back in place.
// - Backward without dW. dx = du @ W^T has the forward's shapes, so it runs
//   on the same products from a second slab stream (torch's (out, in)
//   weights are the K-major B of that product: the view layer's 128 x 256,
//   the feature layer and pts layers 7..1, layer 5 only its 256 rows for
//   h). The epilogue works on the fragments in two halves of the columns:
//   load the matching u (the first half's before the barrier that follows
//   the products, the second's after it), mask, dpre, du = dpre * ls as the
//   next product's input; dpre * u and dpre summed over the thread's two
//   rows, over g by a reduce-scatter of shuffles, then over the
//   warpgroup's four warps in warp order through shared memory. The rank-1
//   alpha term and the rgb head's 3 x 128 are FMAs on the fragments. (An
//   L2 prefetch of each layer's u before its products cost 9%.)
// - dls / db are sums over all points. Each CTA keeps its sums in shared
//   memory, every column added by one thread; at its end it writes them to
//   its own row of a partial buffer, and a second kernel sums the rows in a
//   fixed order. No atomics: reruns are bit-equal; the result differs from
//   a one-pass sum only by float32 reassociation.
// - Rows past n: the forward reads zero points there and writes their u (so
//   the workspace is finite); the backward loads a zero cotangent for them,
//   so they add exactly zero.
//
// Where the time goes at 196,608 points (NVIDIA H100 80GB HBM3, 700 W;
// nnc_tpu_torch/tools/mma_probe.py section 4, thread 0's clock marks, which
// slow the build by 5%). Forward 2.66 ms (3.69-3.82 on mma.sync; 2.20
// without the workspace), a tile 210,800 clocks: loading and splitting A
// and waiting for the slabs 22%, issuing the products 21%, waiting for
// them 15%, the joins and releases 14%, the epilogue 18%, barriers 4%,
// heads 3%, embedding 2%. Backward without dW 2.91 ms (3.55-3.66), a tile
// 235,700 clocks: A and slabs 20%, issue 16%, wait 13%, joins 11%, the
// epilogue 32% (u from device memory, its sums), barriers 7%. Against the
// bound (1.42 / 1.33 ms) that is 53% / 46%. What holds the products back
// is each warpgroup's own serial work a group (several hundred
// instructions a warp: the 64 adds of the join, the split, the slabs'
// bookkeeping) and slabs
// that land late (a build whose ring stops refilling, results wrong, runs
// 7% / 11% faster).
//
// Packed inputs (nnc_tpu_torch/ops/mlp_train_fused.py, pack_train_wgmma).
// FW: the forward's 145 slabs, then alpha's 256 weights and rgb's (128, 3)
// row-major; BW: the backward's 136 slabs, then alpha's 256 weights and
// rgb's (3, 128) row-major; LS and BI, every layer's scales and biases
// concatenated (offset u_offset). The workspace row of a point, the du
// workspace's and the gradient rows use the u_offset layout too.
#include "mlp_train.cuh"
#include "mlp_train_wgmma.cuh"

namespace {

using namespace nerf;
using namespace nerf::train;

// slabs of a tile: forward pts_linears.0 (2 groups), .1-.4 (8 each), .5
// (2 + 8), .6-.7 (8 each), feature (8), two slabs a group; views 9 groups,
// one slab each
constexpr int kFwdSlabs = 2 * (2 + 4 * 8 + 10 + 2 * 8 + 8) + 9;
static_assert(kFwdSlabs == 145, "forward slab schedule");
constexpr int kFwdAlphaW = kFwdSlabs * twg::kSlabFloats;   // 256 weights
constexpr int kFwdRgbW = kFwdAlphaW + kW;                 // (128, 3)
constexpr int kFwdParamsSize = (kFwdRgbW + 3 * (kW / 2) + 63) / 64 * 64;
// backward: the view layer's feature columns (4 groups), the feature layer
// and pts layers 7..1 (8 each), two slabs a group
constexpr int kBwdSlabs = 2 * (4 + 8 + 7 * 8);
static_assert(kBwdSlabs == 136, "backward slab schedule");
constexpr int kBwdAlphaW = kBwdSlabs * twg::kSlabFloats;   // 256 weights
constexpr int kBwdRgbW = kBwdAlphaW + kW;                 // (3, 128)
constexpr int kBwdParamsSize = (kBwdRgbW + 3 * (kW / 2) + 63) / 64 * 64;

using Ring = ring::SlabRing<kFwdSlabs, twg::kStages>;
using BwdRing = ring::SlabRing<kBwdSlabs, twg::kStages>;

// ----------------------------------------------------------------- forward

// This thread's fragment (rows r0 and r0 + 8, columns col0 + 8 j and + 1)
// as float2 stores into a point-major buffer of row stride kLdA.
template <int NW>
__device__ __forceinline__ void store_fragments(float* __restrict__ out,
                                                const float (&v)[NW / 2],
                                                int r0, int col0) {
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    float* o = out + r0 * mma::kLdA + col0 + 8 * j;
    *reinterpret_cast<float2*>(o) = make_float2(v[4 * j], v[4 * j + 1]);
    *reinterpret_cast<float2*>(o + 8 * mma::kLdA) =
        make_float2(v[4 * j + 2], v[4 * j + 3]);
  }
}

// out[:, 0..2 NW) = act(fmaf(u, ls, b)) with u = x1 @ w (+ x2 @ w2) for the
// tile's 64 points, the unscaled weights from the ring, this warpgroup's NW
// columns; u goes to U (the tile's first workspace row at the layer's
// columns, row stride kU) when SAVE and U is not null. U2: the layer's
// workspace columns start at an even offset. out may be x1 or x2. Ends with
// the consumers' barrier.
template <int NW, bool RELU, bool SAVE, bool U2>
__device__ __forceinline__ void train_layer(Ring& ring, float* out,
                                            const float* x1, int ld1, int K1,
                                            const float* x2, int ld2, int K2,
                                            const float* __restrict__ ls,
                                            const float* __restrict__ b,
                                            float* __restrict__ U) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col0 = (threadIdx.x >> 7) * NW + 2 * (lane & 3);
  float acc[NW / 2], tmp[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  twg::segment<NW>(ring, acc, tmp, x1, ld1, K1);
  if (K2 > 0) twg::segment<NW>(ring, acc, tmp, x2, ld2, K2);
  __syncthreads();   // every warp has read x1 and x2
  NNC_PROF(5);
  if constexpr (SAVE) {
    // u through the activation buffer: every thread then takes four
    // consecutive channels of 16 (8) rows, so a warp writes 512 contiguous
    // bytes of a workspace row
    constexpr int kQuads = NW / 2;   // float4s in a row of 2 NW channels
    const int c = 4 * (threadIdx.x % kQuads);
    const float4 l4 = make_float4(__ldg(ls + c), __ldg(ls + c + 1),
                                  __ldg(ls + c + 2), __ldg(ls + c + 3));
    const float4 b4 = make_float4(__ldg(b + c), __ldg(b + c + 1),
                                  __ldg(b + c + 2), __ldg(b + c + 3));
    store_fragments<NW>(out, acc, r0, col0);
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
    for (int j = 0; j < NW / 8; ++j) {
      const int c = col0 + 8 * j;
      const float l0 = __ldg(ls + c), l1 = __ldg(ls + c + 1);
      const float b0 = __ldg(b + c), b1 = __ldg(b + c + 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = fmaf(acc[4 * j + i], i & 1 ? l1 : l0, i & 1 ? b1 : b0);
        acc[4 * j + i] = RELU ? fmaxf(p, 0.f) : p;
      }
    }
    store_fragments<NW>(out, acc, r0, col0);
  }
  NNC_PROF(6);
  __syncthreads();
  NNC_PROF(7);
}

struct FwdSmem {
  ring::RingSmem<twg::kStages> ring;   // first: 1,024-byte aligned stages
  float act[kM * mma::kLdA];   // the layer's input, then its output
  float emb[kM * mma::kLdE];   // pts 0..62, 63 zero; dirs 64..90, 91..95 zero
  float xs[kM * 3];
  float ds[kM * 3];
};

// The training MLP on the embedded tile in s.emb; raw logits to out (the
// tile's first row; its first `rows` rows are written), u of every layer
// to U (the tile's first workspace row) when SAVE and U is not null. FW:
// pack_train_wgmma's forward buffer, whose slabs the ring streams. The
// consumers enter; starts (after the embedding's stores) and ends with
// their barrier.
template <bool SAVE>
__device__ __forceinline__ void mlp_tile_train(FwdSmem& s, Ring& ring,
                                               const float* __restrict__ FW,
                                               const float* __restrict__ LS,
                                               const float* __restrict__ BI,
                                               float* __restrict__ U,
                                               float* __restrict__ out,
                                               int rows) {
  float* A = s.act;
  const float* E = s.emb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  auto at = [U](int o) { return U == nullptr ? nullptr : U + o; };

  __syncthreads();
  NNC_PROF(0);
  train_layer<128, true, SAVE, true>(ring, A, E, mma::kLdE, mma::kPtsPad,
                                     nullptr, 0, 0, LS, BI, U);
#pragma unroll 1
  for (int i = 1; i <= 4; ++i)
    train_layer<128, true, SAVE, true>(ring, A, A, mma::kLdA, kW, nullptr, 0,
                                       0, LS + i * kW, BI + i * kW,
                                       at(i * kW));
  // skip: [emb, h] @ w5 — rows 0..62 of w5 act on emb, rows 63.. on h
  train_layer<128, true, SAVE, true>(ring, A, E, mma::kLdE, mma::kPtsPad, A,
                                     mma::kLdA, kW, LS + 5 * kW, BI + 5 * kW,
                                     at(5 * kW));
#pragma unroll 1
  for (int i = 6; i <= 7; ++i)
    train_layer<128, true, SAVE, true>(ring, A, A, mma::kLdA, kW, nullptr, 0,
                                       0, LS + i * kW, BI + i * kW,
                                       at(i * kW));

  // alpha head (256 -> 1) on h = A: warp w takes points 8 w .. 8 w + 7
  {
    constexpr int o = u_offset(kLayerAlpha);
    float wa[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wa[j] = __ldg(FW + kFwdAlphaW + lane + 32 * j);
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
        if (SAVE)
          __stcs(U + static_cast<size_t>(m) * kU + o, acc);
        if (m < rows) out[m * 4 + 3] = fmaf(acc, la, ba);
      }
    }
  }
  NNC_PROF(8);
  // feature (no activation) on h = A, in place
  train_layer<128, false, SAVE, true>(
      ring, A, A, mma::kLdA, kW, nullptr, 0, 0, LS + u_offset(kLayerFeature),
      BI + u_offset(kLayerFeature), at(u_offset(kLayerFeature)));
  // views: relu(ls * ([feature, view emb] @ wv) + bv) -> A cols 0..127
  train_layer<64, true, SAVE, false>(
      ring, A, A, mma::kLdA, kW, E + mma::kPtsPad, mma::kLdE, mma::kViewsPad,
      LS + u_offset(kLayerViews), BI + u_offset(kLayerViews),
      at(u_offset(kLayerViews)));
  // rgb head (128 -> 3)
  {
    constexpr int o = u_offset(kLayerRgb);
    float wr[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wr[j][c] = __ldg(FW + kFwdRgbW + (lane + 32 * j) * 3 + c);
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
        if (SAVE)
          __stcs(U + static_cast<size_t>(m) * kU + o + lane, u);
        if (m < rows) out[m * 4 + lane] = fmaf(u, lr, br);
      }
    }
  }
  __syncthreads();
  NNC_PROF(8);
}

template <bool SAVE>
__global__ void __launch_bounds__(kThreads, 1)
mlp_train_fwd_kernel(const float* __restrict__ FW,
                     const float* __restrict__ LS,
                     const float* __restrict__ BI,
                     const float* __restrict__ pts,
                     const float* __restrict__ dirs, float* __restrict__ out,
                     float* __restrict__ ws, int n, int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  if (twg::smem_u32(smem_raw) % 1024) __trap();
  const int tid = threadIdx.x;
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  mma::prof_begin();
  Ring ring{&s.ring, FW, mine * kFwdSlabs, 0};
  if (tid == 0) ring.start();
  twg::order_start();
  mma::zero_embedding_pad(s.emb);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kM;
    if (tid < kM * 3) {
      const bool valid = base + tid / 3 < n;
      s.xs[tid] = valid ? pts[base * 3 + tid] : 0.f;
      s.ds[tid] = valid ? dirs[base * 3 + tid] : 0.f;
    }
    __syncthreads();
    mma::embed_tile(s.emb, s.xs, s.ds);
    mlp_tile_train<SAVE>(s, ring, FW, LS, BI,
                         SAVE ? ws + static_cast<size_t>(base) * kU : nullptr,
                         out + base * 4,
                         static_cast<int>(n - base < kM ? n - base : kM));
  }
  twg::order_end();
  mma::prof_end();
}

// ------------------------------------------------- backward without dW

struct BwdSmem {
  ring::RingSmem<twg::kStages> ring;   // first: 1,024-byte aligned stages
  float g[kM * mma::kLdA];  // du of the layer above, then this layer's
  float gr[kM * 4];         // the tile's raw cotangent, then the heads' du
  float part[2 * kU];       // this CTA's sums: dls, then db
  float red[8][2][128];     // a layer's sums by warp, before their sum
};

// This thread's u of columns col0 + 8 (JH half + jj) (+ 1), jj < JH, of
// rows r0 and r0 + 8 from the workspace (U: the tile's first row at the
// layer's columns), in the fragment's order: u[4 jj + 2 h + e]. U2: the
// columns start at an even offset (8-byte loads).
template <int JH, bool U2>
__device__ __forceinline__ void load_u_half(float (&u)[4 * JH],
                                            const float* __restrict__ U,
                                            int r0, int col0, int half) {
#pragma unroll
  for (int jj = 0; jj < JH; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = U + static_cast<size_t>(r0 + 8 * h) * kU + col0 +
                       8 * (JH * half + jj);
      float2 u2;
      if (U2) {
        u2 = __ldcs(reinterpret_cast<const float2*>(p));
      } else {
        u2.x = __ldcs(p);
        u2.y = __ldcs(p + 1);
      }
      u[4 * jj + 2 * h] = u2.x;
      u[4 * jj + 2 * h + 1] = u2.y;
    }
}

// The accumulators hold the gradient of a layer's output for the tile
// (this warpgroup's NW columns). In place they become du = dpre * ls, with
// dpre the gradient masked by the layer's relu (RELU; the forward's
// fmaf(u, ls, b) > 0 from the workspace's u: U, the tile's first row at the
// layer's columns); du goes to G (the next product's input) unless G is
// null, and to DU (the du workspace at the layer's columns, the backward
// with dW) unless DU is null. dpre * u and dpre, summed over the tile's 64
// rows, are added to part_ls and part_b at the layer's columns. ls, b: the
// layer's scales and biases. The columns go in two halves: the first
// half's u is loaded before the barrier that starts this (the wait for it
// falls under the barrier), the second's after it, under the first half's
// work; each half's sums over the warp's rows are taken on their own, so
// that no more than half the sums are held at once. Ends with the sums
// added.
template <int NW, bool RELU>
__device__ __forceinline__ void grad_epilogue(
    float (&acc)[NW / 2], const float* __restrict__ U,
    const float* __restrict__ ls, const float* __restrict__ b,
    float* __restrict__ G, float* __restrict__ part_ls,
    float* __restrict__ part_b, float* __restrict__ DU,
    float (*red)[2][128]) {
  constexpr int JH = NW / 16;   // column pairs (j) of a half
  constexpr bool kEven = NW == 128;   // the columns start at an even offset
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;
  const int col0 = (warp >> 2) * NW + 2 * t;
  // a column pair's scales and biases, loaded one pair ahead
  auto pair = [](const float* p) {
    return kEven ? __ldg(reinterpret_cast<const float2*>(p))
                 : make_float2(__ldg(p), __ldg(p + 1));
  };
  float u0[4 * JH], u1[4 * JH];
  load_u_half<JH, kEven>(u0, U, r0, col0, 0);
  float2 ln = pair(ls + col0), bn = pair(b + col0);
  __syncthreads();
  NNC_PROF(5);
  load_u_half<JH, kEven>(u1, U, r0, col0, 1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float(&u)[4 * JH] = half ? u1 : u0;
    // v[2 jj + e]: this thread's dpre * u of column col0 + 8 j + e (j = JH
    // half + jj) over its two rows; v[2 JH + 2 jj + e]: its dpre
    float v[4 * JH];
#pragma unroll
    for (int jj = 0; jj < JH; ++jj) {
      // (hoisted, the loads would hold registers the fragments need)
      asm volatile("" ::: "memory");
      const int j = JH * half + jj;
      const int c = col0 + 8 * j;
      const float2 l2 = ln, b2 = bn;
      if (j + 1 < NW / 8) {
        ln = pair(ls + c + 8);
        bn = pair(b + c + 8);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = e ? l2.y : l2.x, bb = e ? b2.y : b2.x;
        float tl = 0.f, tb = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float uu = u[4 * jj + 2 * h + e];
          float d = acc[i];
          if (RELU && !(fmaf(uu, l, bb) > 0.f)) d = 0.f;
          tl = fmaf(d, uu, tl);
          tb += d;
          acc[i] = d * l;
        }
        v[2 * jj + e] = tl;
        v[2 * JH + 2 * jj + e] = tb;
      }
      if (G != nullptr) {
        float* o = G + r0 * mma::kLdA + c;
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(o + 8 * mma::kLdA) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      if (DU != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* w = DU + static_cast<size_t>(r0 + 8 * h) * kU + c;
          const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
          if (kEven) {
            __stcs(reinterpret_cast<float2*>(w), make_float2(d0, d1));
          } else {
            __stcs(w, d0);
            __stcs(w + 1, d1);
          }
        }
      }
    }
    // over the eight rows g of the warp: lane (g, t) keeps the sums of
    // values JH / 2 g .. of v, then writes them as the warp's
    twg::reduce_scatter_g<4 * JH>(v);
#pragma unroll
    for (int i = 0; i < JH / 2; ++i) {
      const int within = JH / 2 * (g & 3) + i;   // 2 jj + e
      red[warp][g >> 2][8 * (JH * half + (within >> 1)) + 2 * t +
                        (within & 1)] = v[i];
    }
  }
  NNC_PROF(6);
  __syncthreads();
  NNC_PROF(7);
  // the layer's 2 NW columns: the four warps of their warpgroup, in order
  for (int i = threadIdx.x; i < 4 * NW; i += kThreads) {
    const int kind = i / (2 * NW);
    const int col = i - kind * 2 * NW;
    const int w0 = 4 * (col / NW);
    const int lc = col % NW;
    const float sum = ((red[w0][kind][lc] + red[w0 + 1][kind][lc]) +
                       red[w0 + 2][kind][lc]) + red[w0 + 3][kind][lc];
    (kind ? part_b : part_ls)[col] += sum;
  }
}

// One step of the reverse chain: the gradient of layer L's output,
// du_above (64 x K, in s.g) @ (the ring's next K / 16 slabs), plus
// du_alpha (x) w_alpha when ALPHA (layer 7 feeds the alpha head too), then
// grad_epilogue of layer L (du to s.g if `write`). U, DU: the tile's first
// row of the workspace and of the du workspace (null without dW).
template <bool RELU, bool ALPHA>
__device__ __forceinline__ void bwd_layer(BwdSmem& s, BwdRing& ring, int K,
                                          int L, bool write,
                                          const float* __restrict__ BW,
                                          const float* __restrict__ LS,
                                          const float* __restrict__ BI,
                                          const float* __restrict__ U,
                                          float* __restrict__ DU) {
  const int o = L * kW;   // u_offset(L) for L <= 8
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col0 = (threadIdx.x >> 7) * 128 + 2 * (lane & 3);
  float acc[64], tmp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  twg::segment<128>(ring, acc, tmp, s.g, mma::kLdA, K);
  if (ALPHA) {
    const float d0 = s.gr[r0 * 4 + 3];
    const float d1 = s.gr[(r0 + 8) * 4 + 3];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float w0 = __ldg(BW + kBwdAlphaW + col0 + 8 * j);
      const float w1 = __ldg(BW + kBwdAlphaW + col0 + 8 * j + 1);
      acc[4 * j] = fmaf(d0, w0, acc[4 * j]);
      acc[4 * j + 1] = fmaf(d0, w1, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(d1, w0, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(d1, w1, acc[4 * j + 3]);
    }
  }
  grad_epilogue<128, RELU>(acc, U + o, LS + o, BI + o, write ? s.g : nullptr,
                           s.part + o, s.part + kU + o,
                           DU != nullptr ? DU + o : nullptr, s.red);
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_train_bwd_mma_kernel(const float* __restrict__ BW,
                         const float* __restrict__ LS,
                         const float* __restrict__ BI,
                         const float* __restrict__ gout,
                         const float* __restrict__ ws,
                         float* __restrict__ du,
                         float* __restrict__ partials, int n, int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  if (twg::smem_u32(smem_raw) % 1024) __trap();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  static_assert(u_offset(kLayerFeature) == kLayerFeature * kW, "u layout");
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  mma::prof_begin();
  BwdRing ring{&s.ring, BW, mine * kBwdSlabs, 0};
  if (tid == 0) ring.start();
  twg::order_start();
  for (int i = tid; i < 2 * kU; i += kThreads) s.part[i] = 0.f;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kM;
    const float* U = ws + static_cast<size_t>(tile) * (kM * kU);
    float* DU = du != nullptr ? du + static_cast<size_t>(tile) * (kM * kU)
                              : nullptr;
    static_assert(kM * 4 == kThreads, "one cotangent per thread");
    // (the last barrier of the tile before: everyone is done with s.gr)
    s.gr[tid] = base + tid / 4 < n ? gout[base * 4 + tid] : 0.f;
    // the view layer's u (128 columns) and the rgb head's next to them
    prefetch_u(U + u_offset(kLayerViews),
               (kW / 2 + 3) * static_cast<int>(sizeof(float)));
    __syncthreads();
    // the heads, which have no activation: warp c < 3 takes rgb channel
    // c, warp 3 alpha; their sums, and du = g * ls in place (and to DU)
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
      if (DU != nullptr) {
        __stcs(DU + static_cast<size_t>(lane) * kU + o, d0 * l);
        __stcs(DU + static_cast<size_t>(lane + 32) * kU + o, d1 * l);
      }
    }
    __syncthreads();
    NNC_PROF(0);
    // dv = du_rgb @ Wr^T (64 x 3 times 3 x 128) on the view layer's
    // fragments (this warpgroup's 64 columns), then the view layer's
    // epilogue -> du_v in s.g cols 0..127
    {
      const int r0 = 16 * (warp & 3) + (lane >> 2);
      const int col0 = (warp >> 2) * 64 + 2 * (lane & 3);
      constexpr int o = u_offset(kLayerViews);
      float acc[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float w[3][2];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            w[c][e] = __ldg(BW + kBwdRgbW + c * (kW / 2) + col0 + 8 * j + e);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 d = *reinterpret_cast<const float4*>(
              s.gr + (r0 + 8 * h) * 4);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[4 * j + 2 * h + e] =
                fmaf(d.z, w[2][e], fmaf(d.y, w[1][e], d.x * w[0][e]));
        }
      }
      NNC_PROF(1);
      grad_epilogue<64, true>(acc, U + o, LS + o, BI + o, s.g, s.part + o,
                              s.part + kU + o,
                              DU != nullptr ? DU + o : nullptr, s.red);
    }
    // dfeature = du_v @ Wv[:256]^T; the feature layer has no activation
    bwd_layer<false, false>(s, ring, kW / 2, kLayerFeature, true, BW, LS,
                            BI, U, DU);
    // dh7 = du_f @ Wf^T + du_alpha (x) w_alpha
    bwd_layer<true, true>(s, ring, kW, 7, true, BW, LS, BI, U, DU);
    // dh_{i} = du_{i+1} @ W_{i+1}^T (layer 5: its 256 rows for h), i =
    // 6..0 (layer 0's du feeds no product; with dW it goes to the du
    // workspace)
#pragma unroll 1
    for (int i = 6; i >= 0; --i)
      bwd_layer<true, false>(s, ring, kW, i, i > 0, BW, LS, BI, U, DU);
    NNC_PROF(8);
  }
  twg::order_end();
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

// Lengths of the two buffers of pack_train_wgmma.
extern "C" int nnc_train_wgmma_sizes(int* fwd_size, int* bwd_size) {
  *fwd_size = kFwdParamsSize;
  *bwd_size = kBwdParamsSize;
  return 0;
}

#ifdef NNC_MMA_PROFILE
// Reads the clock sums of the launches so far into out[kProfSlots] and
// zeroes them (nerf_mlp_mma.cuh, NNC_PROF).
extern "C" int nnc_train_profile(unsigned long long* out) {
  return mma::read_profile(out);
}
#endif

// fw: the forward buffer of pack_train_wgmma, 16-byte aligned; ls, bi:
// scales and biases (2,436 each); pts, dirs: (n, 3); out: (n, 4) [rgb
// logits, sigma]; ws: null, or (ceil(n / 64) * 64, 2,436) for the
// backward's u.
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
// the backward buffer of pack_train_wgmma, 16-byte aligned; g: (n, 4)
// cotangent of out; ws from nnc_mlp_train_fwd; du: null, or a workspace of
// ws's shape that takes every layer's du = dpre * ls per point (rows up to
// ceil(n / 64) * 64; nnc_mlp_train_dw, mlp_train_dw.cu, reads it); G: CTAs,
// at most ceil(n / 64); partials: (G, 4,872) scratch; out: (4,872,) = [dls
// (2,436), db (2,436)].
extern "C" int nnc_mlp_train_bwd_mma(const float* bw, const float* ls,
                                     const float* bi, const float* g,
                                     const float* ws, float* du,
                                     float* partials, float* out, int n,
                                     int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(sizeof(BwdSmem));
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
