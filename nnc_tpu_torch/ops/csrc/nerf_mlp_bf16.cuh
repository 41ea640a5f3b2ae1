// The flagship NeRF MLP (D=8, W=256, skip at layer 4, view head; posenc
// 10/4 frequencies) on a tile of 16 MT points in bf16: operands rounded to
// bf16, every product summed in float32 on the tensor cores. Used by
// mlp_from_points_bf16.cu (K-B3 bf16), mlp_embedded_bf16.cu (K-B5 bf16, the
// embedding loaded by load_embedded_tile) and render_pass_bf16.cu (K-B2
// bf16).
//
// Replaces the bf16 body of the Pallas kernels: _mlp_body with
// emb.dtype == bfloat16 (nnc_tpu/ops/mlp_pallas.py:162-188), reached through
// _kernel_pts (:238) and render_pallas.py's _make_kernel (:88) when
// config.compute_dtype is bfloat16. The rounding points are the reference's,
// all to nearest even: the embedding after sincosf in float32 (the raw x / d
// channels too), relu(sum + bias) of every layer, `feature` (no relu), the
// view layer's output; the weights arrive rounded (LSA scales folded in
// float32 first), biases and sums are float32, the logits float32. The TPU
// kernel's 2,048-point tiles and half-tile interleave are not carried over.
//
// Bound on the H100: operations, 1.19 MFLOP a point against 40 bytes, at
// the tensor cores' dense bf16 peak of 989 TFLOP/s (H100 SXM data sheet, 700
// W): 262,144 points cannot take less than 0.315 ms. What holds the chain
// well above that is not the tensor cores but the traffic around them: see
// "Where the time goes" below.
//
// Design (it stands beside the float32 chain of nerf_mlp_mma.cuh and shares
// its weight ring, PipeT, its clock marks and its heads' reductions).
//  * Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one per
//    16 x 8 output tile and 16 channels: no split, no correction terms. One
//    such product does the work of six of the float32 chain's m16n8k8 TF32
//    products.
//  * One accumulator per layer, started from the bias. The tensor core adds
//    into its accumulator by cutting; over a layer's 4 to 20 k steps that is
//    a few float32 ulps, three orders below one bf16 rounding of an
//    activation (2^-9), so the float32 chain's two-level sums are not needed
//    and their 64 registers are free: measured against the plain bf16 version
//    the kernel lies at a twentieth (rms) of the distance between the plain
//    bf16 and the plain float32 version (chip_smoke.py phase 14 prints both).
//  * Whole-layer accumulators, as in the float32 chain: the 8 warps each own
//    all 16 MT points x 32 (or 16) output channels, MT x 4 (2) tiles of
//    m16n8, so a layer's output overwrites its own input after one barrier
//    and the warps run free of each other inside a layer.
//  * A from shared memory by ldmatrix.sync.aligned.m8n8.x4.shared.b16: lane
//    l gives the address of row (l & 15), channels 8 (l >> 4) .. + 7 of the
//    m-tile's 16 x 16 block, and gets the fragment a0..a3 as the instruction
//    wants it. Activations are point-major bf16 with row strides of 264
//    (activations) and 104 (embedding) values: 528 and 208 bytes, odd
//    multiples of 16 modulo 128, so the eight 16-byte rows of every 8 x 8
//    matrix lie in distinct bank groups. The epilogue's bf16x2 stores (row g,
//    channels 2t, 2t + 1) are conflict-free with the same strides.
//  * B packed on the host in fragment order (nnc_tpu_torch/ops/mlp_fused.py,
//    pack_weights_bf16): per slab, per warp, per k step, per pair of
//    n-tiles, per lane, four 32-bit words {b0b1, b2b3} of two n-tiles, each
//    word two bf16 values of consecutive rows (the lower row in the low
//    half): row 16 ks + 2 t + 8 r + j, column 8 NT w + 8 nt + g. A thread's B
//    fragments of a k step are 16-byte conflict-free loads. The depths 63
//    and 27 are padded with zero rows to 64 and 32.
//  * The weight ring is the float32 chain's (PipeT, three stages of 32 KB,
//    every warp copies its own eighth with cp.async two slabs ahead and
//    waits only for its own copies), over 37 slabs: 64 rows of a 256-wide
//    layer or 128 of the 128-wide view layer. 1.18 MB a network instead of
//    2.39 MB.
//  * The tile. bf16 activations make 128 points fit (embedding 26 KB, one
//    activation buffer 66 KB, the ring 96 KB: 194 KB) with 128 accumulators
//    a thread. A tile reads all 37 slabs from L2 whatever its size, so 128
//    points halve the bytes per point: 9.2 KB against 18.5 KB. MT is a
//    template parameter; NNC_BF16_MT (8, or 4 for 64 points) picks what is
//    built, and nnc_tpu_torch/tools/mma_probe.py builds and times both.
//  * The small heads (alpha 256 -> 1, rgb 128 -> 3) stay on the SIMT cores:
//    bf16 activations times weights that the host rounded to bf16 and stores
//    as float32, summed in float32 by a warp's shuffles in a fixed order.
//  * Reruns are bit-equal: no atomics, a fixed order of accumulation.
//
// Where the time goes (mma_probe.py section 5; the numbers are in PERF.md):
// with one product doing six times the work, what the float32 chain hid
// under its product loops is now the larger part: the A fragments, which all
// eight warps load for themselves (shared-memory bandwidth: 40 KB per k step
// of a 128-point tile against 2,048 products), the weight stream from L2,
// and the embedding's sincosf.
#pragma once

#include <cuda_bf16.h>

#include "nerf_mlp_mma.cuh"

#ifndef NNC_BF16_MT
#define NNC_BF16_MT 8
#endif

namespace nerf {
namespace bf16 {

using mma::kPtsPad;
using mma::kSlab;
using mma::kStages;
using mma::kViewsPad;

constexpr int kLdE = kPtsPad + kViewsPad + 8;   // embedding row stride (104)
constexpr int kLdA = kW + 8;                    // activation row stride (264)
// slabs (32 KB: 8,192 words of two bf16 values) of the ten tensor-core
// layers in order: pts_linears.0 (1), .1-.4 (4 each), .5 (1 + 4), .6-.7
// (4 each), feature (4), views (2 + 1)
constexpr int kSlabs = 1 + 4 * 4 + 5 + 2 * 4 + 4 + 3;
static_assert(kSlabs == 37, "slab schedule");
// the packed buffer, in 32-bit words: slabs, then as float32 the biases of
// the ten layers and the heads (weights rounded to bf16 by the host)
constexpr int kOffBias = kSlabs * kSlab;             // 8 x 256, 256, 128
constexpr int kOffBiasFeature = kOffBias + 8 * kW;
constexpr int kOffBiasViews = kOffBiasFeature + kW;
constexpr int kOffAlphaW = kOffBiasViews + kW / 2;   // 256 weights
constexpr int kOffAlphaB = kOffAlphaW + kW;          // 1 bias (+ 3 pad)
constexpr int kOffRgbW = kOffAlphaB + 4;             // (128, 3) row-major
constexpr int kOffRgbB = kOffRgbW + 3 * (kW / 2);    // 3 biases (+ 1 pad)
constexpr int kParamsSize = (kOffRgbB + 4 + 63) / 64 * 64;

using Pipe = mma::PipeT<kSlabs>;

template <int MT>
struct MlpSmem {
  float ring[kStages * kSlab];          // weight slabs in flight
  __nv_bfloat16 act[16 * MT * kLdA];    // the layer's input, then its output
  __nv_bfloat16 emb[16 * MT * kLdE];    // cols 0..62 pts, 63 zero, 64..90 dirs, 91..95 zero
  float raw[16 * MT * 4];               // (point, [r, g, b, sigma]) logits
};

// a (16 x 16, row): four 8 x 8 matrices, rows 0-7 / 8-15 of channels 0-7,
// then of channels 8-15; lane l passes the address of row (l & 15), channel
// 8 (l >> 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// c (16 x 8) += a (16 x 16, row) * b (16 x 8, col); lane = 4 g + t holds
// a0 (g, 2t..) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..), two values
// a word; b0 (2t.., g) b1 (2t+8.., g); c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t)
// c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += x[:, 0..K) @ (the next ceil(K / rows-per-slab) slabs), for this
// warp's 8 NT output channels of all 16 MT points. x: point-major bf16 in
// shared memory with row stride ld. K % 16 == 0. PipeType: the forward's
// Pipe, or the slab stream of K-B1's bf16 backward (mlp_train_bf16.cu).
template <int MT, int NT, class PipeType = Pipe>
__device__ __forceinline__ void mma_run(PipeType& pipe,
                                        float (&acc)[MT][NT][4],
                                        const __nv_bfloat16* x, int ld,
                                        int K) {
  constexpr int kStepVec = 16 * NT;   // this warp's 16-byte vectors a k step
  constexpr int kStepsPerSlab = kSlab / 8 / (4 * kStepVec);   // 4 or 8
  const int lane = threadIdx.x & 31;
  uint32_t a_addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(x + (lane & 15) * ld + 8 * (lane >> 4)));
  const uint32_t mt_bytes = 16 * ld * sizeof(__nv_bfloat16);
  const int steps = K / 16;
  for (int s0 = 0; s0 < steps; s0 += kStepsPerSlab) {
    const uint4* wb = reinterpret_cast<const uint4*>(pipe.acquire()) + lane;
    const int n = steps - s0 < kStepsPerSlab ? steps - s0 : kStepsPerSlab;
#pragma unroll 2
    for (int ks = 0; ks < n; ++ks) {
      uint32_t b[NT][2];
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        const uint4 w4 = wb[ks * kStepVec + q * 32];
        b[2 * q][0] = w4.x;
        b[2 * q][1] = w4.y;
        b[2 * q + 1][0] = w4.z;
        b[2 * q + 1][1] = w4.w;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, a_addr + mt * mt_bytes);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
      a_addr += 16 * sizeof(__nv_bfloat16);
    }
  }
}

// out[:, 0..64 NT) = bf16(act(bias + x1 @ w (+ x2 @ w2))) for the tile's
// points, weights from the pipe. out may be x1 or x2: the whole output is
// held in registers until every warp has read its input. Ends with a
// barrier.
template <int MT, int NT, bool RELU>
__device__ __forceinline__ void mma_layer(Pipe& pipe, __nv_bfloat16* out,
                                          const __nv_bfloat16* x1, int ld1,
                                          int K1, const __nv_bfloat16* x2,
                                          int ld2, int K2,
                                          const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int col0 = warp * 8 * NT + 2 * (lane & 3);
  float acc[MT][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float b0 = __ldg(bias + col0 + nt * 8);
    const float b1 = __ldg(bias + col0 + nt * 8 + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][nt][0] = b0;
      acc[mt][nt][1] = b1;
      acc[mt][nt][2] = b0;
      acc[mt][nt][3] = b1;
    }
  }
  mma_run<MT, NT>(pipe, acc, x1, ld1, K1);
  if (K2 > 0) mma_run<MT, NT>(pipe, acc, x2, ld2, K2);
  NNC_PROF(2);
  __syncthreads();
  NNC_PROF(3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = RELU ? fmaxf(acc[mt][nt][i], 0.f) : acc[mt][nt][i];
      __nv_bfloat16* o = out + (mt * 16 + g) * kLdA + col0 + nt * 8;
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * kLdA) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
  NNC_PROF(4);
  __syncthreads();
  NNC_PROF(5);
}

// Zeroes the embedding's padding channels (63, 91..95), which no tile ever
// writes; once per CTA.
template <int MT>
__device__ __forceinline__ void zero_embedding_pad(__nv_bfloat16* emb) {
  for (int i = threadIdx.x; i < 16 * MT * 6; i += kThreads) {
    const int m = i / 6;
    const int j = i - m * 6;
    emb[m * kLdE + (j == 0 ? kInPts : kPtsPad + kInViews + j - 1)] =
        __float2bfloat16_rn(0.f);
  }
}

// Positional encoding of the tile into emb (point-major), computed in
// float32 as in nerf_mlp_mma.cuh's embed_tile and rounded once to bf16.
template <int MT>
__device__ __forceinline__ void embed_tile(__nv_bfloat16* __restrict__ emb,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ ds) {
  // c = 3 f + d; f = 0: raw xyz, 1..10: xyz freqs, 11: raw dir, 12..15: dir
  for (int i = threadIdx.x; i < 16 * MT * 48; i += kThreads) {
    const int m = i / 48;
    const int c = i - m * 48;
    const int f = c / 3;
    const int d = c - f * 3;
    const bool view = f >= 11;
    const float x = view ? ds[m * 3 + d] : xs[m * 3 + d];
    __nv_bfloat16* e = emb + m * kLdE + (view ? kPtsPad : 0);
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

// The second way in (K-B5 bf16): the tile's embeddings, computed by the
// caller, from device memory into the layout embed_tile writes, each value
// rounded once to bf16 (nearest even); rows past n become zeros. pts_emb:
// (n, kInPts), views_emb: (n, kInViews), contiguous float32. Rows of 252 and
// 108 bytes are not 16-byte aligned, so there is no cp.async here: the
// tile's pts and then views values are one index space, which consecutive
// threads walk in coalesced 4-byte loads, in two batches of loads in flight
// before their stores (23 a thread at 128 points: all 45 at once do not fit
// in the registers the chain leaves, and spill). The padding channels are
// never written: they stay as zero_embedding_pad left them.
template <int MT>
__device__ __forceinline__ void load_embedded_tile(
    __nv_bfloat16* __restrict__ emb, const float* __restrict__ pts_emb,
    const float* __restrict__ views_emb, long long base, int n) {
  constexpr int kP = 16 * MT * kInPts;
  constexpr int kAll = kP + 16 * MT * kInViews;
  constexpr int kIters = (kAll + kThreads - 1) / kThreads;
  constexpr int kB = (kIters + 1) / 2;
  const int rows = n - base < 16 * MT ? static_cast<int>(n - base) : 16 * MT;
  const float* __restrict__ p = pts_emb + base * kInPts;
  const float* __restrict__ q = views_emb + base * kInViews;
#pragma unroll
  for (int j0 = 0; j0 < kIters; j0 += kB) {
    float v[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = threadIdx.x + (j0 + j) * kThreads;
      v[j] = i < kP ? (i / kInPts < rows ? __ldg(p + i) : 0.f)
           : i < kAll && (i - kP) / kInViews < rows ? __ldg(q + (i - kP))
                                                     : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = threadIdx.x + (j0 + j) * kThreads;
      if (i < kP)
        emb[(i / kInPts) * kLdE + i % kInPts] = __float2bfloat16_rn(v[j]);
      else if (i < kAll)
        emb[((i - kP) / kInViews) * kLdE + kPtsPad + (i - kP) % kInViews] =
            __float2bfloat16_rn(v[j]);
    }
  }
}

// The MLP on the embedded tile in s.emb; leaves raw logits in s.raw. P: the
// buffer of pack_weights_bf16, whose slabs `pipe` streams. All threads
// enter; starts (after the embedding's stores) and ends with a barrier.
template <int MT>
__device__ __forceinline__ void mlp_tile(MlpSmem<MT>& s, Pipe& pipe,
                                         const float* __restrict__ P) {
  __nv_bfloat16* A = s.act;
  const __nv_bfloat16* E = s.emb;
  const float* bias = P + kOffBias;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kPerWarp = 2 * MT;   // points a warp takes in the heads

  __syncthreads();
  NNC_PROF(1);
  mma_layer<MT, 4, true>(pipe, A, E, kLdE, kPtsPad, nullptr, 0, 0, bias);
#pragma unroll 1
  for (int i = 1; i <= 4; ++i)
    mma_layer<MT, 4, true>(pipe, A, A, kLdA, kW, nullptr, 0, 0,
                           bias + i * kW);
  // skip: [emb, h] @ w5 — rows 0..62 of w5 act on emb, rows 63.. on h
  mma_layer<MT, 4, true>(pipe, A, E, kLdE, kPtsPad, A, kLdA, kW,
                         bias + 5 * kW);
#pragma unroll 1
  for (int i = 6; i <= 7; ++i)
    mma_layer<MT, 4, true>(pipe, A, A, kLdA, kW, nullptr, 0, 0,
                           bias + i * kW);

  // alpha head (256 -> 1) on h = A: warp w takes points 2 MT w ..
  {
    float wa[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wa[j] = __ldg(P + kOffAlphaW + lane + 32 * j);
    const float ba = __ldg(P + kOffAlphaB);
#pragma unroll 2
    for (int i = 0; i < kPerWarp; ++i) {
      const int m = warp * kPerWarp + i;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fmaf(__bfloat162float(A[m * kLdA + lane + 32 * j]), wa[j], acc);
      acc = mma::warp_sum_all(acc);
      if (lane == 0) s.raw[m * 4 + 3] = acc + ba;
    }
  }
  NNC_PROF(6);
  // feature (no activation) on h = A, in place
  mma_layer<MT, 4, false>(pipe, A, A, kLdA, kW, nullptr, 0, 0,
                          P + kOffBiasFeature);
  // views: relu([feature, view emb] @ wv + bv) -> A cols 0..127
  mma_layer<MT, 2, true>(pipe, A, A, kLdA, kW, E + kPtsPad, kLdE, kViewsPad,
                         P + kOffBiasViews);
  // rgb head (128 -> 3)
  {
    float wr[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wr[j][c] = __ldg(P + kOffRgbW + (lane + 32 * j) * 3 + c);
    float br = 0.f;
    if (lane < 3) br = __ldg(P + kOffRgbB + lane);
#pragma unroll 2
    for (int i = 0; i < kPerWarp; ++i) {
      const int m = warp * kPerWarp + i;
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = __bfloat162float(A[m * kLdA + lane + 32 * j]);
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = fmaf(h, wr[j][c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = mma::warp_sum_all(acc[c]);
      if (lane < 3)
        s.raw[m * 4 + lane] =
            (lane == 0 ? acc[0] : lane == 1 ? acc[1] : acc[2]) + br;
    }
  }
  __syncthreads();
  NNC_PROF(7);
}

// What mlp_from_points.cuh and render_pass.cuh need of a chain
// (load_embedded: only mlp_embedded_kernel).
template <int MT>
struct Chain {
  static constexpr int kPoints = 16 * MT;
  using Smem = MlpSmem<MT>;
  using Pipe = bf16::Pipe;
  static __device__ __forceinline__ void begin(Smem& s, Pipe& pipe,
                                               const float* P) {
    pipe.start(P, s.ring);
    zero_embedding_pad<MT>(s.emb);
  }
  static __device__ __forceinline__ void embed(Smem& s, const float* xs,
                                               const float* ds) {
    embed_tile<MT>(s.emb, xs, ds);
  }
  static __device__ __forceinline__ void load_embedded(
      Smem& s, const float* pts_emb, const float* views_emb, long long base,
      int n) {
    load_embedded_tile<MT>(s.emb, pts_emb, views_emb, base, n);
  }
  static __device__ __forceinline__ void mlp(Smem& s, Pipe& pipe,
                                             const float* P) {
    mlp_tile<MT>(s, pipe, P);
  }
};

}  // namespace bf16
}  // namespace nerf
