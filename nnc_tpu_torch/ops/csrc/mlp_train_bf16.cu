// K-B1 in bf16: the NeRF MLP's training pass, forward and backward without
// dW, with bf16 operands on the tensor cores and float32 sums. (The backward
// with dW is this backward writing every layer's bf16(du) to a workspace,
// then mlp_train_dw.cu's GEMM of X^T dU.)
//
// Replaces the Pallas pair _fwd_call / _bwd_call
// (nnc_tpu/ops/mlp_train_pallas.py:275, :300) as it runs when
// config.compute_dtype is bfloat16 (mlp_train_pallas.py:380: the weights
// packed in bf16, _fwd_chain and _make_bwd_kernel with cdt bfloat16): every
// LSA step of a bf16 model renders its coarse and fine passes through it
// (renderer.py _query_mlp with use_fused_train).
//
// What it computes, with the reference's rounding points (all to nearest
// even). The UNSCALED weights are rounded (pack_train's astype, :77; the
// heads' too), the scales and biases stay float32; the plain MLP of a bf16
// model folds the scale first and is another function (nerf.py:110-116).
//  - Forward: the embedding computed in float32 and rounded once;
//    u = x @ W summed in float32; y = u * ls + b in float32 (:108-110);
//    every hidden layer's relu(y) rounded (:121), feature rounded (:128),
//    the view layer's relu(y) rounded (:132); the heads' u from the rounded
//    activations and weights, the logits float32.
//  - Backward without dW: du = dpre * ls rounded before it enters
//    dx = du @ W^T (bdot, :181-186); the relu mask from the rounded
//    activation (:227, :241); dls = colsum(dpre * u) and db = colsum(dpre)
//    in float32 (:216-217, :229-230, :243-245).
//
// Bound on the H100: bytes. A point's u is 2,436 floats, 9,744 bytes,
// written by the forward and read by the backward: at 196,608 points
// 1.92 GB, 0.572 ms each way at 3.35 TB/s. The products take 1.19 MFLOP a
// point forward and 1.12 MFLOP backward, 0.237 / 0.222 ms at the dense bf16
// peak of 989 TFLOP/s (H100 SXM data sheet, 700 W): in bf16 the workspace,
// not the tensor cores, is what no kernel of this design can go below.
//
// Design: the bf16 chain of nerf_mlp_bf16.cuh with K-B1's epilogues from
// mlp_train.cu.
//  - Forward (train_layer, mlp_group_train): tiles of 128 points, the 37
//    slabs of the forward streamed once a tile through a ring of three
//    32 KB stages (slab_ring.cuh: one bulk copy a slab), A by ldmatrix,
//    mma.sync m16n8k16 bf16 into float32 accumulators that start at zero
//    (the inference chain starts them at the bias: it folds the scale into
//    the weight, training keeps u apart for dls). The eight warps form two
//    groups of four, one for each 64-point half of the tile; a warp owns
//    its half's 64 points x 64 output channels (its two eighths of each
//    slab) and a group synchronises only its own four warps, so the groups
//    walk the slabs at their own pace (group 1 starts a layer late, and the
//    ring keeps it at most three slabs behind). u leaves off the product
//    path: right after its products each warp stages its u 16 rows x 32
//    columns (2 KB) at a time in two buffers of its own (32 KB for the
//    CTA, in the ~34 KB the chain leaves free) and hands each to the tensor
//    memory accelerator as one 2-D bulk store (stage_u), then meets its
//    group at the barrier and writes bf16(act(fmaf(u, ls, b))) to the
//    activation buffer. Each point's products run in the same order as in
//    the kernel this replaced (the u and raw it writes are the same bits).
//    Before, u went from the fragments to the workspace as 8-byte stores
//    between the two barriers of the epilogue: 65% of a tile's clocks, the
//    tensor cores idle (2.58 ms against 0.71 ms without the workspace at
//    196,608 points, NVIDIA H100 80GB HBM3, 700 W;
//    nnc_tpu_torch/tools/mma_probe.py section 7). Now the stores run at
//    about the card's write rate but still mostly while no products run:
//    the groups drift back into step (PERF.md). The view layer's
//    columns start at the odd offset 2,305, which a bulk copy cannot
//    address, so its u and the heads' stay scalar stores. The heads stay on
//    the SIMT cores, as in K-B3 bf16. The workspace has rows for whole
//    128-point tiles (mlp_train_fused.TILE_BF16); rows past n hold the u of
//    zero points.
//  - Backward without dW (bwd_layer, grad_epilogue): tiles of 64 points
//    (MT = 4), so that a layer's 64 accumulators and the 64 values of u its
//    epilogue loads fit a thread's registers as in the float32 backward. The
//    gradient du lives in shared memory as bf16, point-major with the
//    forward's row stride, and is the A of the next product (ldmatrix); B is
//    a second stream of 34 slabs, torch's (out, in) weights in the m16n8k16
//    fragment order (mlp_train_fused.pack_train_bf16: 2 for the view layer's
//    128 x 256, 4 for the feature layer and each of pts layers 7..1, layer 5
//    only its 256 rows for h). The epilogue masks, forms dpre, sums
//    dpre * u and dpre on the accumulator fragments over the thread's rows
//    and then over g by three shuffles, and writes bf16(dpre * ls). The rgb
//    head's 3 x 128 and the rank-1 alpha term are FMAs on the fragments.
//    u reaches the epilogue beside the products: at the nine 256-wide
//    layers each warp's 32 columns x 64 rows of u (8 KB) come as one TMA
//    2-D bulk load (a tensor map of the workspace, 128-byte swizzle) into a
//    box of the warp's own (64 KB for the CTA, in the ~78 KB the rest
//    leaves), which the warp reads into registers right after its products
//    and at once asks to refill with the next layer's (the next tile's
//    first at a tile's last layer), so that it lands during the epilogue
//    and the next layer's products; its mbarrier says when. The view
//    layer's columns start at the odd offset 2,305, so its u and the heads'
//    stay scalar loads (L2-prefetched at the tile's start). Before, a
//    layer's u was only prefetched to L2 before its products and loaded
//    into registers after them: 1.43 ms at 196,608 points; now 1.18 ms,
//    dls, db and the du workspace bit-equal (NVIDIA H100 80GB HBM3, 700 W;
//    PERF.md). A tile's clocks (mma_probe.py section 7): the products 49%,
//    u 17% (reading the box: 512 shared-memory wavefronts a layer; waiting
//    for it), the epilogue 23%. The relu mask compares the float's bits
//    (bf16_positive) in place of a conversion, and a layer's scales and
//    biases load while its products run. Tried and dropped: the weights
//    straight from L2 into registers a slab ahead, no ring, and a second
//    box a warp in the ring's place (1.29 ms: the products got slower);
//    one thread asking for all eight boxes after the CTA's barrier (1.19).
//    The product loops hold the rest, at ~290 clocks a k step where the
//    mma.sync rate allows 192: every warp loads the whole 64 x 16 A of a k
//    step for its 16 products, and the same loops take the same clocks
//    with a quarter of the CTAs (not L2 or device memory).
//  - dls / db: as in mlp_train.cu, one persistent CTA per SM keeps its sums
//    in shared memory, one thread a column, and a second kernel sums the
//    CTAs' rows in a fixed order: reruns are bit-equal.
#include <cuda.h>   // CUtensorMap and its enums (no libcuda is linked)

#include "mlp_train.cuh"
#include "nerf_mlp_bf16.cuh"
#include "slab_ring.cuh"

namespace {

using namespace nerf;
using namespace nerf::train;
namespace b16 = nerf::bf16;

constexpr int kBwdMT = 4;             // the backward's tile: 64 points (kM)
static_assert(16 * kBwdMT == kM, "the backward walks tiles of kM points");

// ------------------------------------------------------------- forward

// The forward's tile: 128 points, two groups of four warps with 64 points
// each; a warp owns its group's 64 points x 64 output channels (the view
// layer: 32). The groups walk the same slabs (slab_ring.cuh) at their own
// pace, so that one group's epilogue, whose u stores wait on device memory,
// runs beside the other group's products.
constexpr int kFwdPoints = 128;
constexpr int kGroupPoints = 64;
constexpr int kFwdStages = 3;
using FwdRing = ring::SlabRing<b16::kSlabs, kFwdStages>;
static_assert(mma::kSlab == ring::kSlabFloats, "one slab size");

// Named barriers: each group's own (128 threads; 0 is __syncthreads'), and
// the one that starts group 1 after group 0's first layer.
constexpr int kGroupBar = 1;   // + group
constexpr int kStartBar = 3;
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(kGroupBar + group) : "memory");
}

// u's way to the workspace in the 256-wide layers: each warp stages 16 rows
// x 32 columns of its u (2 KB) at a time in one of kUBuffers buffers of its
// own, and its lane 0 hands the chunk to the tensor memory accelerator as
// one 2-D bulk store (the workspace as a tensor map of kU float32 columns,
// boxes of 32 x 16), then goes on. Before a buffer is written again, lane
// 0 waits until the store kUBuffers chunks back has read it.
struct UStore {
  float* stage;   // this warp's buffers, kUBuffers x 16 x 32 floats
  int row0;       // the group's first workspace row of the tile
};
constexpr int kStageFloats = 16 * 32;
constexpr int kUBuffers = 2;   // staging buffers a warp

// until the store kUBuffers chunks back has read its buffer
__device__ __forceinline__ void bulk_wait_buffer() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kUBuffers - 1)
               : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// col, row: the box's first workspace column and row
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%1, %2}], [%3];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(ring::smem_u32(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This warp's u of a 256-wide layer (acc: its 64 columns of its group's 64
// rows, the mma fragments) to the workspace's columns col.. by the staging
// buffers, in chunks of one m-tile and 32 columns (n-tiles 4 hc .. + 3). A
// fragment holds two columns of a row; lanes t and t ^ 1 swap half of
// theirs (one shuffle a value), so that each lane holds two whole 16-byte
// pieces of a row: lane t keeps n-tiles 4 hc + 2 (t & 1) and 4 hc +
// 2 (t & 1) + 1, the pieces 4 (t & 1) + 2 k + (t >> 1) of the chunk row's
// eight. Rows g and g + 8 store them in opposite orders, so that every
// quarter warp's eight 16-byte stores hit eight distinct bank groups.
__device__ __forceinline__ void stage_u(const float (&acc)[4][8][4],
                                        const UStore& us,
                                        const CUtensorMap* map, int col) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const bool odd = lane & 1;
  const int h = (lane >> 1) & 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      if (lane == 0) bulk_wait_buffer();
      __syncwarp();
      float* buf = us.stage + (2 * mt + hc) % kUBuffers * kStageFloats;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float4 v[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int a0 = 4 * hc + k, a1 = 4 * hc + 2 + k;
          const float k0 = odd ? acc[mt][a1][2 * hf] : acc[mt][a0][2 * hf];
          const float k1 =
              odd ? acc[mt][a1][2 * hf + 1] : acc[mt][a0][2 * hf + 1];
          const float g0 = odd ? acc[mt][a0][2 * hf] : acc[mt][a1][2 * hf];
          const float g1 =
              odd ? acc[mt][a0][2 * hf + 1] : acc[mt][a1][2 * hf + 1];
          const float r0 = __shfl_xor_sync(0xffffffffu, g0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, g1, 1);
          v[k] = odd ? make_float4(r0, r1, k0, k1)
                     : make_float4(k0, k1, r0, r1);
        }
        float* row = buf + (g + 8 * hf) * 32 + 4 * (4 * odd + h);
        const bool swap = g & 1;
        *reinterpret_cast<float4*>(row + 8 * swap) = swap ? v[1] : v[0];
        *reinterpret_cast<float4*>(row + 8 * !swap) = swap ? v[0] : v[1];
      }
      // the generic proxy's stores, visible to the bulk copy's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) tma_store(map, buf, col + 32 * hc, us.row0 + 16 * mt);
    }
}

// The group's rows: out[:, 0..64 NT) = bf16(act(fmaf(u, ls, b))) with u =
// x1 @ w (+ x2 @ w2) for its 64 points, the unscaled weights from the ring;
// u goes to the workspace when SAVE: with TMA (NT = 8, the layer's columns
// start at ucol, 16-byte aligned) by stage_u before the group's barrier,
// so that this warp's stores are under way while the others finish their
// products; else (the view layer, whose columns start at the odd offset
// 2,305) from the fragments to U (the group's first workspace row at the
// layer's columns, row stride kU), one float a store. out may be x1 or x2.
// Ends with the group's barrier.
template <int NT, bool RELU, bool SAVE, bool TMA>
__device__ __forceinline__ void train_layer(
    FwdRing& ring, int group, __nv_bfloat16* out, const __nv_bfloat16* x1,
    int ld1, int K1, const __nv_bfloat16* x2, int ld2, int K2,
    const float* __restrict__ ls, const float* __restrict__ b,
    const UStore& us, const CUtensorMap* map, int ucol,
    float* __restrict__ U) {
  static_assert(!TMA || NT == 8, "TMA stores take 64 columns a warp");
  const int lane = threadIdx.x & 31;
  const int wg = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int col0 = wg * 8 * NT + 2 * (lane & 3);
  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const auto mma = [](float (&c)[4], const uint32_t (&a)[4],
                      const uint32_t (&b)[2]) { b16::mma_bf16(c, a, b); };
  ring::run_two_eighths<4, NT>(ring, acc, x1, ld1 * 2, K1 / 16, mma);
  if (K2 > 0)
    ring::run_two_eighths<4, NT>(ring, acc, x2, ld2 * 2, K2 / 16, mma);
  NNC_PROF(2);
  if constexpr (SAVE && TMA) {
    stage_u(acc, us, map, ucol + 64 * wg);
    NNC_PROF(4);
  }
  // every warp of the group is done reading the layer's input
  group_sync(group);
  NNC_PROF(3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col0 + nt * 8;
    const float l0 = __ldg(ls + c), l1 = __ldg(ls + c + 1);
    const float b0 = __ldg(b + c), b1 = __ldg(b + c + 1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if constexpr (SAVE && !TMA) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* w = U + static_cast<size_t>(mt * 16 + g + 8 * half) * kU + c;
          __stcs(w, acc[mt][nt][2 * half]);
          __stcs(w + 1, acc[mt][nt][2 * half + 1]);
        }
      }
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            fmaf(acc[mt][nt][i], i & 1 ? l1 : l0, i & 1 ? b1 : b0);
        v[i] = RELU ? fmaxf(p, 0.f) : p;
      }
      __nv_bfloat16* o = out + (mt * 16 + g) * b16::kLdA + c;
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * b16::kLdA) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
  }
  NNC_PROF(4);
  group_sync(group);
  NNC_PROF(5);
}

struct FwdSmem {
  ring::RingSmem<kFwdStages> ring;             // weight slabs in flight
  __nv_bfloat16 act[kFwdPoints * b16::kLdA];   // a layer's input, then output
  __nv_bfloat16 emb[kFwdPoints * b16::kLdE];   // as nerf_mlp_bf16.cuh's
  float raw[kFwdPoints * 4];                   // (point, [r, g, b, sigma])
  float xs[kFwdPoints * 3];
  float ds[kFwdPoints * 3];
  alignas(128) float stage[kThreads / 32][kUBuffers * kStageFloats];
};

// Positional encoding of the group's 64 points into its rows of emb
// (point-major), in float32 as nerf_mlp_bf16.cuh's embed_tile computes it,
// rounded once to bf16.
__device__ __forceinline__ void embed_group(FwdSmem& s, int group) {
  // c = 3 f + d; f = 0: raw xyz, 1..10: xyz freqs, 11: raw dir, 12..15: dir
  for (int i = threadIdx.x & 127; i < kGroupPoints * 48; i += 128) {
    const int m = kGroupPoints * group + i / 48;
    const int c = i % 48;
    const int f = c / 3;
    const int d = c - f * 3;
    const bool view = f >= 11;
    const float x = view ? s.ds[m * 3 + d] : s.xs[m * 3 + d];
    __nv_bfloat16* e = s.emb + m * b16::kLdE + (view ? b16::kPtsPad : 0);
    const int fr = view ? f - 12 : f - 1;
    if (fr < 0) {
      e[d] = __float2bfloat16_rn(x);
    } else {
      float sn, cs;
      sincosf(x * static_cast<float>(1 << fr), &sn, &cs);
      e[3 + 6 * fr + d] = __float2bfloat16_rn(sn);
      e[6 + 6 * fr + d] = __float2bfloat16_rn(cs);
    }
  }
}

// The training MLP on the group's embedded rows of s.emb; raw logits to its
// rows of s.raw, u of every layer to U (the group's first workspace row)
// when SAVE. FW: the buffer of pack_train_bf16's forward half, whose slabs
// `ring` streams and whose tail holds the heads' rounded weights. first:
// the CTA's first tile, after whose layer 0 group 0 lets group 1 start.
// Starts (after the embedding's stores) and ends with the group's barrier.
template <bool SAVE>
__device__ __forceinline__ void mlp_group_train(
    FwdSmem& s, FwdRing& ring, int group, bool first,
    const float* __restrict__ FW, const float* __restrict__ LS,
    const float* __restrict__ BI, const UStore& us, const CUtensorMap* map,
    float* __restrict__ U) {
  constexpr int kLdA = b16::kLdA;
  constexpr int kPerWarp = kGroupPoints / 4;   // points a warp takes in heads
  __nv_bfloat16* A = s.act + kGroupPoints * group * kLdA;
  const __nv_bfloat16* E = s.emb + kGroupPoints * group * b16::kLdE;
  float* raw = s.raw + kGroupPoints * group * 4;
  const int lane = threadIdx.x & 31;
  const int wg = (threadIdx.x >> 5) & 3;

  group_sync(group);
  NNC_PROF(1);
  train_layer<8, true, SAVE, true>(ring, group, A, E, b16::kLdE, b16::kPtsPad,
                                   nullptr, 0, 0, LS, BI, us, map, 0, U);
  if (first && group == 0)
    asm volatile("bar.arrive %0, 256;\n" ::"r"(kStartBar) : "memory");
#pragma unroll 1
  for (int i = 1; i <= 4; ++i)
    train_layer<8, true, SAVE, true>(ring, group, A, A, kLdA, kW, nullptr, 0,
                                     0, LS + i * kW, BI + i * kW, us, map,
                                     i * kW, U);
  // skip: [emb, h] @ w5 — rows 0..62 of w5 act on emb, rows 63.. on h
  train_layer<8, true, SAVE, true>(ring, group, A, E, b16::kLdE, b16::kPtsPad,
                                   A, kLdA, kW, LS + 5 * kW, BI + 5 * kW, us,
                                   map, 5 * kW, U);
#pragma unroll 1
  for (int i = 6; i <= 7; ++i)
    train_layer<8, true, SAVE, true>(ring, group, A, A, kLdA, kW, nullptr, 0,
                                     0, LS + i * kW, BI + i * kW, us, map,
                                     i * kW, U);

  // alpha head (256 -> 1) on h = A: warp wg takes points kPerWarp wg ..
  {
    constexpr int o = u_offset(kLayerAlpha);
    float wa[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wa[j] = __ldg(FW + b16::kOffAlphaW + lane + 32 * j);
    const float la = __ldg(LS + o), ba = __ldg(BI + o);
#pragma unroll 2
    for (int i = 0; i < kPerWarp; ++i) {
      const int m = wg * kPerWarp + i;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fmaf(__bfloat162float(A[m * kLdA + lane + 32 * j]), wa[j], acc);
      acc = mma::warp_sum_all(acc);
      if (lane == 0) {
        if (SAVE) __stcs(U + static_cast<size_t>(m) * kU + o, acc);
        raw[m * 4 + 3] = fmaf(acc, la, ba);
      }
    }
  }
  NNC_PROF(6);
  // feature (no activation) on h = A, in place
  train_layer<8, false, SAVE, true>(
      ring, group, A, A, kLdA, kW, nullptr, 0, 0, LS + u_offset(kLayerFeature),
      BI + u_offset(kLayerFeature), us, map, u_offset(kLayerFeature), U);
  // views: relu(ls * ([feature, view emb] @ wv) + bv) -> A cols 0..127
  train_layer<4, true, SAVE, false>(
      ring, group, A, A, kLdA, kW, E + b16::kPtsPad, b16::kLdE,
      b16::kViewsPad, LS + u_offset(kLayerViews), BI + u_offset(kLayerViews),
      us, map, 0, U + u_offset(kLayerViews));
  // rgb head (128 -> 3)
  {
    constexpr int o = u_offset(kLayerRgb);
    float wr[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wr[j][c] = __ldg(FW + b16::kOffRgbW + (lane + 32 * j) * 3 + c);
    float lr = 0.f, br = 0.f;
    if (lane < 3) {
      lr = __ldg(LS + o + lane);
      br = __ldg(BI + o + lane);
    }
#pragma unroll 2
    for (int i = 0; i < kPerWarp; ++i) {
      const int m = wg * kPerWarp + i;
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = __bfloat162float(A[m * kLdA + lane + 32 * j]);
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = fmaf(h, wr[j][c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = mma::warp_sum_all(acc[c]);
      if (lane < 3) {
        const float u = lane == 0 ? acc[0] : lane == 1 ? acc[1] : acc[2];
        if (SAVE) __stcs(U + static_cast<size_t>(m) * kU + o + lane, u);
        raw[m * 4 + lane] = fmaf(u, lr, br);
      }
    }
  }
  group_sync(group);
  NNC_PROF(7);
}

// ws_map: the workspace (rows of kU float32) as a tensor map with boxes of
// 32 columns x 16 rows, when SAVE.
template <bool SAVE>
__global__ void __launch_bounds__(kThreads, 1)
mlp_train_fwd_bf16_kernel(const float* __restrict__ FW,
                          const float* __restrict__ LS,
                          const float* __restrict__ BI,
                          const float* __restrict__ pts,
                          const float* __restrict__ dirs,
                          float* __restrict__ out, float* __restrict__ ws,
                          const __grid_constant__ CUtensorMap ws_map,
                          int n, int tiles) {
  // (the bulk copies read and write their buffers at 128-byte aligned
  // addresses)
  extern __shared__ __align__(128) unsigned char fwd_smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(fwd_smem_raw);
  const int tid = threadIdx.x;
  const int group = tid >> 7;
  const int gt = tid & 127;
  mma::prof_begin();
  const int my_tiles =
      (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  FwdRing ring{&s.ring, FW, my_tiles * b16::kSlabs, 0};
  if (tid == 0) ring.start();
  b16::zero_embedding_pad<kFwdPoints / 16>(s.emb);
  __syncthreads();
  UStore us{s.stage[tid >> 5], 0};
  // group 1 starts after group 0's first layer (then the ring keeps it a
  // few slabs behind)
  if (group == 1)
    asm volatile("bar.sync %0, 256;\n" ::"r"(kStartBar) : "memory");
  for (int t = 0; t < my_tiles; ++t) {
    const long long base =
        static_cast<long long>(blockIdx.x + t * gridDim.x) * kFwdPoints +
        kGroupPoints * group;
    for (int i = gt; i < kGroupPoints * 3; i += 128) {
      const bool valid = base + i / 3 < n;
      s.xs[kGroupPoints * 3 * group + i] = valid ? pts[base * 3 + i] : 0.f;
      s.ds[kGroupPoints * 3 * group + i] = valid ? dirs[base * 3 + i] : 0.f;
    }
    group_sync(group);
    NNC_PROF(0);
    embed_group(s, group);
    us.row0 = static_cast<int>(base);
    mlp_group_train<SAVE>(s, ring, group, t == 0, FW, LS, BI, us, &ws_map,
                          SAVE ? ws + static_cast<size_t>(base) * kU
                               : nullptr);
    for (int i = gt; i < kGroupPoints * 4; i += 128)
      if (base + i / 4 < n)
        out[base * 4 + i] = s.raw[kGroupPoints * 4 * group + i];
    NNC_PROF(8);
  }
  // the last chunks' stores done before the CTA's shared memory goes
  if (SAVE && (tid & 31) == 0) bulk_wait_all();
  mma::prof_end();
}

// cuTensorMapEncodeTiled of libcuda, found through the runtime (the
// library links no libcuda), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The error code returned when the tensor map cannot be made (outside
// cudaError_t's values).
constexpr int kTensorMapError = 10001;

// The workspace ws (rows of kU float32) as a tensor map over its first
// `rows` rows with boxes of 32 columns x box_rows rows; false if the map
// cannot be made.
bool ws_tensor_map(CUtensorMap* map, const float* ws, int rows, int box_rows,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kU),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kU * sizeof(float)};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ws), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SAVE>
int launch_fwd(const float* fw, const float* ls, const float* bi,
               const float* pts, const float* dirs, float* out, float* ws,
               int n, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(FwdSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_fwd_bf16_kernel<SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int tiles = (n + kFwdPoints - 1) / kFwdPoints;
    CUtensorMap map{};
    if (SAVE && !ws_tensor_map(&map, ws, tiles * kFwdPoints, 16,
                               CU_TENSOR_MAP_SWIZZLE_NONE))
      return kTensorMapError;
    mlp_train_fwd_bf16_kernel<SAVE>
        <<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(
            fw, ls, bi, pts, dirs, out, ws, map, n, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------ backward without dW, on the tensor cores

// The transposed slab stream in the order the reverse chain consumes it:
// the view layer's feature rows (2 slabs of 64 rows), the feature layer (4),
// pts layers 7..1 (4 each); then, as float32 words, the heads' rounded
// weights.
constexpr int kBwdSlabs = 2 + 4 + 7 * 4;
static_assert(kBwdSlabs == 34, "transposed slab schedule");
using BwdPipe = mma::PipeT<kBwdSlabs>;
constexpr int kOffAlphaWT = kBwdSlabs * mma::kSlab;   // 256 weights
constexpr int kOffRgbWT = kOffAlphaWT + kW;           // (3, 128) row-major
constexpr int kBwdParamsSize = (kOffRgbWT + 3 * (kW / 2) + 63) / 64 * 64;

// u's way in at the 256-wide layers: each warp owns one box of shared
// memory, its 32 columns of a layer's u for the tile's 64 rows (8 KB), which
// the tensor memory accelerator fills by one 2-D bulk load through a tensor
// map of the workspace (boxes of 32 columns x 64 rows, 128-byte swizzle),
// completing the warp's mbarrier. The warp reads the box into registers
// after its products, and its lane 0 asks at once for the next layer's
// (the next tile's first at a tile's last layer), which then lands while
// the epilogue and the next layer's products run.
constexpr int kBoxFloats = kM * 32;
constexpr int kUBoxBytes = kBoxFloats * 4;

struct BwdSmem {
  // the warps' boxes of u, 1024-byte aligned in ubox_raw (the swizzle
  // repeats every 1,024 bytes of the shared address)
  unsigned char ubox_raw[kThreads / 32 * kUBoxBytes + 1024];
  float ring[mma::kStages * mma::kSlab];   // transposed slabs in flight
  __nv_bfloat16 g[kM * b16::kLdA];  // du of the layer above, then this layer's
  float gr[kM * 4];         // the tile's raw cotangent, then the heads' du
  float part[2 * kU];       // this CTA's sums: dls, then db
  uint64_t ufull[kThreads / 32];   // a warp's box has landed
};

struct ULoad {
  const CUtensorMap* map;   // the workspace, boxes of 32 x 64
  float* box;               // this warp's box
  uint32_t bar;             // its mbarrier
  uint32_t parity;          // the phase the next wait() waits for

  // Lane 0: layer L's u (L <= 8), this warp's 32 columns, the tile's 64
  // rows, into the box. The warp's reads of the box are done (__syncwarp
  // before).
  __device__ __forceinline__ void issue(int tile, int L) const {
    if ((threadIdx.x & 31) == 0) {
      // the generic proxy's reads of the box, before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(kUBoxBytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
              ring::smem_u32(box)),
          "l"(reinterpret_cast<uint64_t>(map)),
          "r"(L * kW + 32 * static_cast<int>(threadIdx.x >> 5)),
          "r"(tile * kM), "r"(bar)
          : "memory");
    }
  }

  // Until the box issued last has landed; all lanes.
  __device__ __forceinline__ void wait() {
    ring::mbar_wait(bar, parity);
    parity ^= 1;
  }
};

// This thread's u of a 256-wide layer from the warp's box, as load_u<4>
// lays it out: row r = mt * 16 + g + 8 half, column c = 8 nt + 2 t of the
// warp's 32; the 128-byte swizzle puts 16-byte piece c / 4 of row r at
// piece (c / 4) ^ (r % 8), and r % 8 = g. Each load of a warp reads 256
// bytes in two wavefronts (no bank conflicts).
__device__ __forceinline__ void load_u_box(float (&u)[4][4][2][2],
                                           const float* __restrict__ box,
                                           int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        const float2 v = *reinterpret_cast<const float2*>(
            box + r * 32 + (((2 * nt + (t >> 1)) ^ g) << 2) + 2 * (t & 1));
        u[nt][mt][half][0] = v.x;
        u[nt][mt][half][1] = v.y;
      }
}

// An evict-first store of a bf16 value (the du workspace).
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, __nv_bfloat16 v) {
  asm volatile("st.global.cs.b16 [%0], %1;\n" ::"l"(p),
               "h"(*reinterpret_cast<const unsigned short*>(&v))
               : "memory");
}

// bf16_round(x) > 0 without the conversion: x rounds (to nearest even) to a
// positive bf16 value exactly when it is above 2^-134, the float32 whose
// bits are 0x8000 (half of bf16's least subnormal, 2^-133: the tie goes to
// zero); NaN is positive neither way.
__device__ __forceinline__ bool bf16_positive(float x) {
  return x > 0.f && __float_as_uint(x) > 0x8000u;
}

// The accumulators hold the gradient of a layer's output for the tile (the
// fragment layout of mma_run). They become du = dpre * ls, with dpre the
// gradient masked by the layer's relu (RELU; the rounded activation
// bf16(relu(fmaf(u, ls, b))) > 0, rebuilt from the workspace's u as the
// forward computed it); dpre * u and dpre, summed over the tile's 64 rows,
// are added to the CTA's dls and db of the layer's columns. bf16(du) goes
// to G, the next product's A, if `write`. part_ls, part_b: at the layer's
// columns; u, lb: the layer's u (load_u_box, or load_u at the view layer)
// and load_lb, loaded by the caller before its barrier. Every warp must be
// done reading G; ends with a barrier. DU: the tile's first row of the bf16
// du workspace at the layer's columns (the backward with dW), or null:
// bf16(du) goes there too, with evict-first stores; at the 256-wide layers
// (NT = 4) it is copied from G after the barrier in 16-byte pieces (their
// fragments are 4-byte pieces of 16-byte runs: stored from the registers
// they took 1.0 ms more at 196,608 points where 0.96 GB need 0.29; NVIDIA
// H100 80GB HBM3, 700 W, PERF.md), so `write` must be set with DU there.
template <int NT, bool RELU>
__device__ __forceinline__ void grad_epilogue(float (&acc)[4][NT][4],
                                              const float (&u)[NT][4][2][2],
                                              const float (&lb)[NT][4],
                                              __nv_bfloat16* __restrict__ G,
                                              float* __restrict__ part_ls,
                                              float* __restrict__ part_b,
                                              bool write,
                                              __nv_bfloat16* __restrict__ DU) {
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
          if (RELU && !bf16_positive(fmaf(uj, l, bb))) d = 0.f;
          tl = fmaf(d, uj, tl);
          tb += d;
          acc[mt][nt][2 * half + j] = d * l;
        }
      sl[nt][j] = tl;
      sb[nt][j] = tb;
    }
  NNC_PROF(5);
  // over g: the eight lanes that share t, in a fixed order
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
  if (write) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        __nv_bfloat16* o = G + (mt * 16 + g) * b16::kLdA + col0 + nt * 8;
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * b16::kLdA) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  if (DU && NT == 2) {
    // (the view layer starts at the odd column 2,305)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat16* w = DU +
              static_cast<size_t>(mt * 16 + g + 8 * half) * kDuLdBf16 + col0 +
              nt * 8;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
          store_cs(w, __low2bfloat16(v));
          store_cs(w + 1, __high2bfloat16(v));
        }
  }
  NNC_PROF(6);
  __syncthreads();
  if (DU && NT == 4) {
    // G's 64 rows x 256 columns in 16-byte pieces
    for (int i = threadIdx.x; i < kM * (kW / 8); i += kThreads) {
      const int r = i / (kW / 8), c = 8 * (i % (kW / 8));
      __stcs(reinterpret_cast<uint4*>(DU + static_cast<size_t>(r) * kDuLdBf16 +
                                      c),
             *reinterpret_cast<const uint4*>(G + r * b16::kLdA + c));
    }
  }
  NNC_PROF(7);
}

// In the builds with clock marks (NNC_MMA_PROFILE), this thread's loads of
// u have landed before the next mark: else their wait would fall in the
// epilogue's slot.
template <int NT>
__device__ __forceinline__ void prof_landed(const float (&u)[NT][4][2][2]) {
#ifdef NNC_MMA_PROFILE
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      asm volatile("" ::"f"((&u[nt][0][0][0])[i]));
#endif
}

// One step of the reverse chain: the gradient of layer L's output,
// du_above (64 x K, bf16 in s.g) @ (the next K / 64 transposed slabs), plus
// du_alpha (x) w_alpha when ALPHA (layer 7 feeds the alpha head too), then
// grad_epilogue of layer L, on layer L's u from the warp's box, whose next
// load (layer L - 1, or the next tile's layer 8 at L = 0) starts here.
template <bool RELU, bool ALPHA>
__device__ __forceinline__ void bwd_layer(BwdSmem& s, BwdPipe& pipe, int K,
                                          int L, bool write,
                                          const float* __restrict__ BW,
                                          const float* __restrict__ LS,
                                          const float* __restrict__ BI,
                                          ULoad& ul,
                                          __nv_bfloat16* __restrict__ du,
                                          int tile, int tiles) {
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int o = L * kW;   // u_offset(L) for L <= 8
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int col0 = (threadIdx.x >> 5) * 32 + 2 * (lane & 3);
  // the layer's scales and biases arrive while the products run
  float lb[4][4];
  load_lb<4>(lb, LS + o, BI + o, col0);
  b16::mma_run<kBwdMT, 4>(pipe, acc, s.g, b16::kLdA, K);
  if (ALPHA) {
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
  NNC_PROF(2);
  float u[4][4][2][2];
  ul.wait();
  NNC_PROF(3);
  load_u_box(u, ul.box, g, lane & 3);
  __syncwarp();
  if (L > 0)
    ul.issue(tile, L - 1);
  else if (tile + static_cast<int>(gridDim.x) < tiles)
    ul.issue(tile + gridDim.x, kLayerFeature);
  prof_landed(u);
  NNC_PROF(1);
  __syncthreads();
  NNC_PROF(4);
  grad_epilogue<4, RELU>(
      acc, u, lb, s.g, s.part + o, s.part + kU + o, write,
      du ? du + static_cast<size_t>(tile) * (kM * kDuLdBf16) + o : nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_train_bwd_bf16_kernel(const float* __restrict__ BW,
                          const float* __restrict__ LS,
                          const float* __restrict__ BI,
                          const float* __restrict__ gout,
                          const float* __restrict__ ws,
                          __nv_bfloat16* __restrict__ du,
                          float* __restrict__ partials,
                          const __grid_constant__ CUtensorMap ws_map, int n,
                          int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  static_assert(u_offset(kLayerFeature) == kLayerFeature * kW, "u layout");
  mma::prof_begin();
  BwdPipe pipe;
  pipe.start(BW, s.ring);
  for (int i = tid; i < 2 * kU; i += kThreads) s.part[i] = 0.f;
  // this warp's box and its barrier; the first tile's first layer asked for
  const int skip = (1024 - (ring::smem_u32(s.ubox_raw) & 1023)) & 1023;
  ULoad ul{&ws_map,
           reinterpret_cast<float*>(s.ubox_raw + skip + warp * kUBoxBytes),
           ring::smem_u32(&s.ufull[warp]), 0};
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(ul.bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (static_cast<int>(blockIdx.x) < tiles)
    ul.issue(blockIdx.x, kLayerFeature);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kM;
    const float* U = ws + static_cast<size_t>(tile) * (kM * kU);
    __nv_bfloat16* DU =
        du ? du + static_cast<size_t>(tile) * (kM * kDuLdBf16) : nullptr;
    static_assert(kM * 4 == kThreads, "one cotangent per thread");
    // (the last barrier of the tile before: everyone is done with s.gr)
    s.gr[tid] = base + tid / 4 < n ? gout[base * 4 + tid] : 0.f;
    // the view layer's u (128 columns) and the rgb head's next to them
    prefetch_u(U + u_offset(kLayerViews),
               (kW / 2 + 3) * static_cast<int>(sizeof(float)));
    __syncthreads();
    // the heads, which have no activation: warp c < 3 takes rgb channel c,
    // warp 3 alpha; their sums, and bf16(du = g * ls) in place (and to DU)
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
      s.gr[lane * 4 + warp] = bf16_round(d0 * l);
      s.gr[(lane + 32) * 4 + warp] = bf16_round(d1 * l);
      if (DU) {
        store_cs(DU + static_cast<size_t>(lane) * kDuLdBf16 + o,
                 __float2bfloat16_rn(d0 * l));
        store_cs(DU + static_cast<size_t>(lane + 32) * kDuLdBf16 + o,
                 __float2bfloat16_rn(d1 * l));
      }
    }
    __syncthreads();
    NNC_PROF(0);
    // dv = du_rgb @ Wr^T (64 x 3 times 3 x 128) on the view layer's
    // fragments, then the view layer's epilogue -> bf16 du_v in s.g cols
    // 0..127
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
      NNC_PROF(0);
      constexpr int o = u_offset(kLayerViews);
      float u[2][4][2][2], lb[2][4];
      load_u<2, false>(u, U + o, g, col0);
      load_lb<2>(lb, LS + o, BI + o, col0);
      prof_landed(u);
      NNC_PROF(3);
      grad_epilogue<2, true>(acc, u, lb, s.g, s.part + o, s.part + kU + o,
                             true, DU ? DU + o : nullptr);
    }
    // dfeature = du_v @ Wv[:256]^T; the feature layer has no activation
    bwd_layer<false, false>(s, pipe, kW / 2, kLayerFeature, true, BW, LS, BI,
                            ul, du, tile, tiles);
    // dh7 = du_f @ Wf^T + du_alpha (x) w_alpha
    bwd_layer<true, true>(s, pipe, kW, 7, true, BW, LS, BI, ul, du, tile,
                          tiles);
    // dh_{i} = du_{i+1} @ W_{i+1}^T (layer 5: its 256 rows for h), i = 6..0
    // (layer 0's du feeds no product; with dW it goes to the du workspace)
#pragma unroll 1
    for (int i = 6; i >= 0; --i)
      bwd_layer<true, false>(s, pipe, kW, i, i > 0 || du, BW, LS, BI, ul, du,
                             tile, tiles);
    NNC_PROF(8);
  }
  pipe.drain();
  __syncthreads();
  float* row = partials + static_cast<size_t>(blockIdx.x) * (2 * kU);
  for (int i = tid; i < 2 * kU; i += kThreads) row[i] = s.part[i];
  mma::prof_end();
}

}  // namespace

// The forward's tile (points; its workspace has rows for whole tiles) and
// the lengths of the two buffers of pack_train_bf16, in 32-bit words.
extern "C" int nnc_train_bf16_sizes(int* fwd_tile, int* fwd_size,
                                    int* bwd_size) {
  *fwd_tile = kFwdPoints;
  *fwd_size = b16::kParamsSize;
  *bwd_size = kBwdParamsSize;
  return 0;
}

#ifdef NNC_MMA_PROFILE
// Reads the clock sums of the launches so far into out[kProfSlots] and
// zeroes them (nerf_mlp_mma.cuh, NNC_PROF), for
// nnc_tpu_torch/tools/mma_probe.py.
extern "C" int nnc_train_bf16_profile(unsigned long long* out) {
  return mma::read_profile(out);
}
#endif

// fw: the forward half of pack_train_bf16, 16-byte aligned; ls, bi: scales
// and biases (2,436 each, float32); pts, dirs: (n, 3); out: (n, 4) [rgb
// logits, sigma]; ws: null, or (ceil(n / 128) * 128, 2,436) for the
// backward's u.
extern "C" int nnc_mlp_train_fwd_bf16(const float* fw, const float* ls,
                                      const float* bi, const float* pts,
                                      const float* dirs, float* out,
                                      float* ws, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ws != nullptr
             ? launch_fwd<true>(fw, ls, bi, pts, dirs, out, ws, n, st)
             : launch_fwd<false>(fw, ls, bi, pts, dirs, out, ws, n, st);
}

// The backward without dW, and the first pass of the backward with dW. bw:
// the backward half of pack_train_bf16, 16-byte aligned; g: (n, 4)
// cotangent of out; ws from nnc_mlp_train_fwd_bf16 (read through a tensor
// map made here: kTensorMapError if it cannot be); du: null, or a bf16
// workspace (rows of ws, 2,440 columns: u's layout, rows 16-byte aligned)
// that takes every layer's bf16(du) per point (rows up to ceil(n / 64) *
// 64; nnc_mlp_train_dw_bf16, mlp_train_dw.cu, reads it); G: CTAs, at most
// ceil(n / 64); partials: (G, 4,872) scratch; out: (4,872,) = [dls (2,436),
// db (2,436)].
extern "C" int nnc_mlp_train_bwd_bf16(const float* bw, const float* ls,
                                      const float* bi, const float* g,
                                      const float* ws, void* du,
                                      float* partials, float* out, int n,
                                      int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(sizeof(BwdSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int tiles = (n + kM - 1) / kM;
    // the workspace's rows of whole 64-point tiles (it has rows for whole
    // 128-point tiles), one box a tile's rows, 128-byte swizzle
    CUtensorMap map{};
    if (!ws_tensor_map(&map, ws, tiles * kM, kM, CU_TENSOR_MAP_SWIZZLE_128B))
      return kTensorMapError;
    mlp_train_bwd_bf16_kernel<<<G, kThreads, smem, st>>>(
        bw, ls, bi, g, ws, static_cast<__nv_bfloat16*>(du), partials, map, n,
        tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    G = 0;
  }
  return reduce_rows(partials, G, 2 * kU, out, st);
}
