// The flagship NeRF MLP (D=8, W=256, skip at layer 4, view head; posenc
// 10/4 frequencies) on a tile of 64 points with its products on the tensor
// cores at float32 accuracy. Used by mlp_from_points.cu (K-B3),
// mlp_embedded.cu (K-B5: the embedding read by load_embedded_tile in place
// of embed_tile's posenc) and render_pass.cu (K-B2) (through the kernels of
// mlp_from_points.cuh and render_pass.cuh, which nerf_mlp_bf16.cuh's chain
// shares). mlp_train.cu (K-B1, whose products are warpgroup wgmma) takes
// the split, the embedding, the heads' reductions and the clock marks from
// here.
//
// K-B6 (mlp_tp_pair.cu) takes the split, the products and cp.async from
// here for its two products on row-major weights.
//
// Replaces, for those kernels, the SIMT chain of float32 FMAs (weights
// re-read from L1/L2 by __ldg at every k step, three 64 x 256 buffers in
// shared memory). It computes the same function as the Pallas
// bodies _kernel_pts and _kernel (nnc_tpu/ops/mlp_pallas.py:238, :191) and
// _make_kernel (nnc_tpu/ops/render_pallas.py:88).
//
// Bound on the H100: operations. A point costs 1.19 MFLOP against 40 bytes
// of input and output. Each float32 product is three TF32 products on the
// tensor cores (dense TF32 peak 495 TFLOP/s, H100 SXM data sheet at 700 W),
// so the float32-equivalent peak is 495 / 3 = 165 TFLOP/s: 262,144 points
// cannot take less than 1.89 ms. The instruction used here stops earlier: an
// SM sub-partition issues one mma.sync.m16n8k8 .tf32 every 6.0 clocks
// whatever the number of warps (294-308 TFLOP/s over the card, 60% of the
// peak; nnc_tpu_torch/tools/mma_probe.py), which puts 262,144 points at
// 3.1 ms. The chain takes 4.4 ms.
//
// Design.
//  * 3xTF32. Every operand is split in registers, x = hi + lo with hi = x
//    rounded to TF32 and lo = x - hi as the tensor core reads it (cut to
//    TF32), and a product accumulates lo * hi + hi * lo + hi * hi, the
//    small terms first, in float32 (lo * lo, at most 2^-20 of the product,
//    is dropped). The instruction is
//    mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: register fragments,
//    no shared-memory descriptors. wgmma (m64nNk8 .tf32) reaches the whole
//    peak, but it reads B from shared memory only, so hi and lo of every
//    weight would have to lie there: split by the CTA after staging (a pass
//    over 0.6M weights per 64-point tile) or staged already split (twice the
//    L2 traffic below, or a cluster sharing slabs by multicast), and a
//    64 x 256 accumulator tile plus the partial tile of the next item fills
//    a warpgroup's registers. mma.sync shipped because its layouts could be
//    checked against a plain model on the CPU before the first build on the
//    card, and its 3.1 ms is not reached yet.
//  * Sums in two levels. The tensor core adds into its accumulator by
//    cutting, not rounding: 96 such adds into a layer's running sum left
//    1.4e-5 on the raw logits (rms 2.4e-6 against float64, biased), seven
//    times the SIMT chain. So the twelve products of 32 channels (four k
//    steps) sum in a tile of their own, started from zero, where a cut is
//    small, and that tile joins the layer's sum by an ordinary rounded
//    float32 add: 2.3e-6, rms 2.3e-7 against float64 (the plain float32
//    version: 2.2e-7), for 64 more registers (224, no spills).
//  * Whole-layer accumulators. The 8 warps each own all 64 points x 32 (or
//    16) output channels: 4 m-tiles x 4 (2) n-tiles of m16n8, 64 (32)
//    float32 accumulators a thread. A layer's output therefore never needs a
//    second buffer: after one barrier it overwrites its own input.
//    Shared memory holds the embedding (64 x 96, row stride 112), one
//    activation buffer (64 x 256, row stride 272) and the weight ring, 194 KB
//    in all; the SIMT chain held the embedding and two activation buffers.
//  * Activations are point-major, act[point * 272 + channel]. A thread's A
//    fragments for two k steps (16 channels) are two 16-byte loads per
//    m-tile: the four channels 4t..4t+3 of rows g and g + 8. The order of
//    the 8 channels inside a k step is free as long as A and B agree, so
//    channels 4t, 4t+1 feed the first k step's slots t, t+4 and channels
//    4t+2, 4t+3 the second's. Row strides of 16 mod 32 words make these
//    loads conflict-free. The next 16 channels are loaded while the second
//    k step's products issue (3% of the time).
//  * Weights are packed on the host in exactly the order the fragments want
//    them (nnc_tpu_torch/ops/mlp_fused.py, pack_weights_mma): per slab, per
//    warp, per k step, per pair of n-tiles, per lane, the four values
//    {b0, b1} of two n-tiles, so a thread's B fragments are 16-byte
//    conflict-free loads, a slab is one contiguous run of the buffer and a
//    warp's eighth of it (its own output channels) another. The odd
//    depths are padded with zero rows (63 -> 64, 27 -> 32) and the embedding
//    tile has matching zero channels.
//  * The weight ring. The network is cut into 73 slabs of 32 KB (32 rows of
//    a 256-wide layer, 64 of the 128-wide view layer) in the order the chain
//    consumes them. Three ring stages; every warp copies its own eighth of a
//    slab with cp.async (8 x 16 bytes a lane, L2 only) two slabs ahead of
//    use and waits only for its own copies, so inside a layer the warps run
//    free of each other: two barriers a layer (inputs read, outputs
//    written), none per slab. The ring runs across layers, tiles and sample
//    blocks: the next layer's first slabs are in flight during this layer's
//    epilogue and the heads, the next tile's during this tile's output.
//  * L2 traffic. A 64-point tile reads the whole 2.39 MB of slabs: 37 KB a
//    point, 9.8 GB per 262,144-point launch, the same as the SIMT chain,
//    but asynchronously and once per CTA instead of by eight warps through
//    L1. At 4.4 ms a launch that is 2.2 TB/s of L2 reads over 132 SMs; the
//    split into hi and lo happens after staging, so it is not doubled.
//  * The small heads (alpha 256 -> 1, rgb 128 -> 3) stay on the SIMT cores:
//    a warp takes 8 points, its lanes stride over the channels and reduce by
//    shuffles in a fixed order.
//  * Reruns are bit-equal: no atomics, a fixed order of accumulation.
//
// Where the 4.4 ms go (mma_probe.py, clock marks): 87-90% of a tile's clocks
// in the product loops (8.4 a product, a sub-partition), 3-6% waiting for the
// slowest warp at the barrier after them, 3-4% in the epilogue's stores, 1%
// in the embedding, 2% in the heads.
// In the loops a warp issues about two other instructions for every product
// (three to split an operand, 48 operands per 48 products; the adds of the
// partial tile; the loads), two warps a scheduler cannot hide all of their
// latency, and the registers (224 of 255) leave no room for a third.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerf_mlp.cuh"

namespace nerf {
namespace mma {

constexpr int kPtsPad = 64;                    // 63 embedding channels + 1 zero
constexpr int kViewsPad = 32;                  // 27 + 5 zeros
constexpr int kLdE = kPtsPad + kViewsPad + 16;  // embedding row stride (112)
constexpr int kLdA = kW + 16;                  // activation row stride (272)
constexpr int kSlab = 8192;                    // floats in a slab (32 KB)
constexpr int kStages = 3;
// slabs of the ten tensor-core layers in order: pts_linears.0 (2),
// .1-.4 (8 each), .5 (2 + 8), .6-.7 (8 each), feature (8), views (4 + 1)
constexpr int kSlabs = 2 + 4 * 8 + 10 + 2 * 8 + 8 + 5;
static_assert(kSlabs == 73, "slab schedule");
// the packed buffer: slabs, then biases of the ten layers, then the heads
constexpr int kOffBias = kSlabs * kSlab;             // 8 x 256, 256, 128
constexpr int kOffBiasFeature = kOffBias + 8 * kW;
constexpr int kOffBiasViews = kOffBiasFeature + kW;
constexpr int kOffAlphaW = kOffBiasViews + kW / 2;   // 256 weights
constexpr int kOffAlphaB = kOffAlphaW + kW;          // 1 bias (+ 3 pad)
constexpr int kOffRgbW = kOffAlphaB + 4;             // (128, 3) row-major
constexpr int kOffRgbB = kOffRgbW + 3 * (kW / 2);    // 3 biases (+ 1 pad)
constexpr int kMmaParamsSize = (kOffRgbB + 4 + 63) / 64 * 64;

// Where a tile's clocks go, for nnc_tpu_torch/tools/mma_probe.py: built with
// -DNNC_MMA_PROFILE, thread 0 of every CTA adds the clocks since its last
// mark to one of kProfSlots sums, which nnc_mma_profile() reads back.
#ifdef NNC_MMA_PROFILE
constexpr int kProfSlots = 9;
__device__ unsigned long long prof_total[kProfSlots];
__shared__ long long prof_sum[kProfSlots];
__shared__ long long prof_last;
#define NNC_PROF(slot)                                        \
  do {                                                        \
    if (threadIdx.x == 0) {                                   \
      const long long now = clock64();                        \
      nerf::mma::prof_sum[slot] += now - nerf::mma::prof_last; \
      nerf::mma::prof_last = now;                             \
    }                                                         \
  } while (0)
__device__ __forceinline__ void prof_begin() {
  if (threadIdx.x < kProfSlots) prof_sum[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x == 0) prof_last = clock64();
}
__device__ __forceinline__ void prof_end() {
  __syncthreads();
  if (threadIdx.x < kProfSlots)
    atomicAdd(prof_total + threadIdx.x,
              static_cast<unsigned long long>(prof_sum[threadIdx.x]));
}
// Reads the clock sums of the launches so far into out[kProfSlots] and
// zeroes them.
inline int read_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, prof_total, sizeof(prof_total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kProfSlots] = {};
  return static_cast<int>(cudaMemcpyToSymbol(prof_total, zero, sizeof(zero)));
}
#else
#define NNC_PROF(slot)
__device__ __forceinline__ void prof_begin() {}
__device__ __forceinline__ void prof_end() {}
#endif

struct MlpSmem {
  float ring[kStages * kSlab];  // weight slabs in flight
  float act[kM * kLdA];         // the layer's input, then its output
  float emb[kM * kLdE];         // cols 0..62 pts, 63 zero, 64..90 dirs, 91..95 zero
  float raw[kM * 4];            // (point, [r, g, b, sigma]) logits
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The stream of weight slabs through the ring. Slab i of the schedule lies
// at slabs + i * kSlab; after slab kSlabs - 1 the stream starts over, so the
// copies for the next tile are under way while this one finishes. A warp
// reads only its own eighth of a slab (its output channels), which is
// contiguous in the packed buffer, and copies just that eighth itself: the
// ring needs no barrier across warps, only the warp's own wait. SLABS: the
// length of the schedule (kSlabs for the forward chain; the bf16 chain and
// K-B1 bf16's backward walk schedules of their own).
template <int SLABS>
struct PipeT {
  const float* src;   // this lane's first 16 bytes of slab 0
  float* dst;         // the same place in ring stage 0
  int next;           // schedule index of the slab acquire() returns next
  int stage;          // ring stage that slab is (being) copied into

  __device__ __forceinline__ void issue(int slab, int st) {
    const float* s = src + static_cast<size_t>(slab) * kSlab;
    float* d = dst + st * kSlab;
#pragma unroll
    for (int i = 0; i < kSlab / 8 / 128; ++i)
      cp_async16(d + i * 128, s + i * 128);
    cp_async_commit();
  }

  // Starts the copies of the first kStages - 1 slabs.
  __device__ __forceinline__ void start(const float* params, float* ring) {
    const int own = (threadIdx.x >> 5) * (kSlab / 8) + (threadIdx.x & 31) * 4;
    src = params + own;
    dst = ring + own;
    next = 0;
    stage = 0;
    for (int i = 0; i < kStages - 1; ++i) issue(i, i);
  }

  // This warp's eighth of the next slab of the schedule, landed; all lanes
  // of the warp must call it. The warp is done with the slab before, whose
  // stage takes the copy started here.
  __device__ __forceinline__ const float* acquire() {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    int ahead = next + kStages - 1;
    if (ahead >= SLABS) ahead -= SLABS;
    int free_stage = stage + kStages - 1;
    if (free_stage >= kStages) free_stage -= kStages;
    issue(ahead, free_stage);
    const float* cur = dst + stage * kSlab - (threadIdx.x & 31) * 4;
    if (++next == SLABS) next = 0;
    if (++stage == kStages) stage = 0;
    return cur;
  }

  // Waits for the copies still in flight (before the CTA exits).
  __device__ __forceinline__ void drain() { cp_async_wait<0>(); }
};
using Pipe = PipeT<kSlabs>;

// x = hi + lo: hi = x rounded to nearest (ties away from zero) to TF32's
// 10-bit mantissa, lo the exact float32 rest, of which the tensor core reads
// the upper 19 bits (it ignores the low 13 mantissa bits of a .tf32
// operand): |x - hi - lo as read| <= 2^-21 |x|. The rounding is an integer
// add and a mask on the float32 bits, which is what cvt.rna.tf32.f32 gives
// for every finite x; nvcc expands that instruction for sm_90a into four
// (an infinity test, the add, a select, the mask), and with 48 operands
// split for every 48 products a warp issues, the two it does not need
// cost 7% of the kernel's time. Rounding lo as well would halve the bound
// and cost two more instructions an operand.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
#ifdef NNC_SPLIT_CVT   // the instruction, for nnc_tpu_torch/tools/mma_probe.py to time
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
#else
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
#endif
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row) * b (8 x 8, col); lane = 4 g + t holds
// a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4); b0 (t, g) b1 (t+4, g);
// c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8) = a * b: the first product of a fresh tile (the zero addend
// costs no register and no instruction).
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// channels whose products sum in a tile of their own before they join the
// layer's sum: two 16-channel halves (one load of A each), four k steps
constexpr int kGroupHalves = 2;
constexpr int kGroup = 16 * kGroupHalves;

// acc += x[:, kGroup groups channels] @ (the slab's rows), for this warp's
// 8 * NT output channels. xr points at this thread's first A operand of the
// slab and av holds the first 16 channels' already; both are left at the
// next slab's (the last slab of a segment loads 16 channels past it: the
// row's next columns or its padding, never used). wslab: this warp's eighth
// of the slab, [k step][n-tile pair][lane][4].
// A thread's A operands of 16 channels (two k steps), raw: channels
// 4t..4t+3 of rows g and g + 8 of each m-tile, xr pointing at row g,
// channel 4t.
__device__ __forceinline__ void load_a(float4 (&av)[4][2],
                                       const float* __restrict__ xr, int ld) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    av[mt][0] = *reinterpret_cast<const float4*>(xr + (mt * 16) * ld);
    av[mt][1] = *reinterpret_cast<const float4*>(xr + (mt * 16 + 8) * ld);
  }
}

template <int NT>
__device__ __forceinline__ void mma_slab(float (&acc)[4][NT][4],
                                         float4 (&av)[4][2],
                                         const float*& xr, int ld,
                                         const float* __restrict__ wslab,
                                         int groups) {
  constexpr int kStep = 64 * NT;   // this warp's floats of one k step
  const int lane = threadIdx.x & 31;
  const float* wb = wslab + lane * 4;
#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    // the group's channels sum in a fresh tile, which joins the layer's sum
    // by a rounded float32 add
    float part[4][NT][4];
#pragma unroll
    for (int half = 0; half < kGroupHalves; ++half) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(wb + j * kStep + q * 128);
          split_tf32(w4.x, bh[2 * q][0], bl[2 * q][0]);
          split_tf32(w4.y, bh[2 * q][1], bl[2 * q][1]);
          split_tf32(w4.z, bh[2 * q + 1][0], bl[2 * q + 1][0]);
          split_tf32(w4.w, bh[2 * q + 1][1], bl[2 * q + 1][1]);
        }
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          split_tf32(j ? av[mt][0].z : av[mt][0].x, ah[mt][0], al[mt][0]);
          split_tf32(j ? av[mt][1].z : av[mt][1].x, ah[mt][1], al[mt][1]);
          split_tf32(j ? av[mt][0].w : av[mt][0].y, ah[mt][2], al[mt][2]);
          split_tf32(j ? av[mt][1].w : av[mt][1].y, ah[mt][3], al[mt][3]);
        }
        // av is spent: the next 16 channels (the next slab's first, at a
        // slab's end) load under this k step's products
        if (j == 1) load_a(av, xr + 16, ld);
        // the small terms first
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (half == 0 && j == 0)
              mma_tf32_first(part[mt][nt], al[mt], bh[nt]);
            else
              mma_tf32(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_tf32(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_tf32(part[mt][nt], ah[mt], bh[nt]);
      }
      xr += 16;
      wb += 2 * kStep;
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
}

// acc += x[:, 0..K) @ (the next ceil(K / rows-per-slab) slabs).
// K % kGroup == 0.
template <int NT>
__device__ __forceinline__ void mma_segment(Pipe& pipe,
                                            float (&acc)[4][NT][4],
                                            const float* __restrict__ x,
                                            int ld, int K) {
  constexpr int kRows = kSlab / (64 * NT);   // 32 (NT = 4) or 64 (NT = 2)
  const int lane = threadIdx.x & 31;
  const float* xr = x + (lane >> 2) * ld + 4 * (lane & 3);
  float4 av[4][2];
  load_a(av, xr, ld);
  for (int k0 = 0; k0 < K; k0 += kRows) {
    const float* w = pipe.acquire();
    const int rows = K - k0 < kRows ? K - k0 : kRows;
    mma_slab<NT>(acc, av, xr, ld, w, rows / kGroup);
  }
}

// out[:, 0..64 NT) = act(bias + x1 @ w (+ x2 @ w2)) for the tile's 64 points,
// weights from the pipe. out may be x1 or x2: the whole output is held in
// registers until every warp has read its input. Between its two barriers
// the warps run free of each other. Ends with a barrier.
template <int NT, bool RELU>
__device__ __forceinline__ void mma_layer(Pipe& pipe, float* out,
                                          const float* x1, int ld1, int K1,
                                          const float* x2, int ld2, int K2,
                                          const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int col0 = warp * 8 * NT + 2 * (lane & 3);
  float acc[4][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float b0 = __ldg(bias + col0 + nt * 8);
    const float b1 = __ldg(bias + col0 + nt * 8 + 1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      acc[mt][nt][0] = b0;
      acc[mt][nt][1] = b1;
      acc[mt][nt][2] = b0;
      acc[mt][nt][3] = b1;
    }
  }
  mma_segment<NT>(pipe, acc, x1, ld1, K1);
  if (K2 > 0) mma_segment<NT>(pipe, acc, x2, ld2, K2);
  NNC_PROF(2);
  __syncthreads();
  NNC_PROF(3);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = RELU ? fmaxf(acc[mt][nt][i], 0.f) : acc[mt][nt][i];
      float* o = out + (mt * 16 + g) * kLdA + col0 + nt * 8;
      *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(o + 8 * kLdA) = make_float2(v[2], v[3]);
    }
  NNC_PROF(4);
  __syncthreads();
  NNC_PROF(5);
}

__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Zeroes the embedding's padding channels (63, 91..95), which no tile ever
// writes; once per CTA.
__device__ __forceinline__ void zero_embedding_pad(float* __restrict__ emb) {
  for (int i = threadIdx.x; i < kM * 6; i += kThreads) {
    const int m = i / 6;
    const int j = i - m * 6;
    emb[m * kLdE + (j == 0 ? kInPts : kPtsPad + kInViews + j - 1)] = 0.f;
  }
}

// Positional encoding of the tile into emb (point-major). xs / ds: (kM, 3)
// points and view directions in shared memory (zeros for rows past the
// data). Consecutive threads take consecutive channels of one point. The
// argument x * 2^f is exact in float32; sin and cos come from the precise
// sincosf (arguments reach ~2^9 * |x|, where fast-math intrinsics lose
// several digits).
__device__ __forceinline__ void embed_tile(float* __restrict__ emb,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ ds) {
  // c = 3 f + d; f = 0: raw xyz, 1..10: xyz freqs, 11: raw dir, 12..15: dir
  for (int i = threadIdx.x; i < kM * 48; i += kThreads) {
    const int m = i / 48;
    const int c = i - m * 48;
    const int f = c / 3;
    const int d = c - f * 3;
    const bool view = f >= 11;
    const float x = view ? ds[m * 3 + d] : xs[m * 3 + d];
    float* e = emb + m * kLdE + (view ? kPtsPad : 0);
    const int fr = view ? f - 12 : f - 1;
    if (fr < 0) {
      e[d] = x;
    } else {
      float sn, cs;
      sincosf(x * static_cast<float>(1 << fr), &sn, &cs);
      e[3 + 6 * fr + d] = sn;
      e[6 + 6 * fr + d] = cs;
    }
  }
}

// The second way in (K-B5): the tile's embeddings, computed by the caller,
// from device memory into the layout embed_tile writes; rows past n become
// zeros. pts_emb: (n, kInPts), views_emb: (n, kInViews), contiguous
// float32. Rows of 252 and 108 bytes are not 16-byte aligned, so there is
// no cp.async here: the tile's pts and then views values are one index
// space, which consecutive threads walk in coalesced 4-byte loads, in two
// batches of loads in flight before their stores (as nerf_mlp_bf16.cuh's
// load_embedded_tile). The padding channels are never written: they stay
// as zero_embedding_pad left them.
__device__ __forceinline__ void load_embedded_tile(
    float* __restrict__ emb, const float* __restrict__ pts_emb,
    const float* __restrict__ views_emb, long long base, int n) {
  constexpr int kP = kM * kInPts;
  constexpr int kAll = kP + kM * kInViews;
  constexpr int kIters = (kAll + kThreads - 1) / kThreads;
  constexpr int kB = (kIters + 1) / 2;
  const int rows = n - base < kM ? static_cast<int>(n - base) : kM;
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
        emb[(i / kInPts) * kLdE + i % kInPts] = v[j];
      else if (i < kAll)
        emb[((i - kP) / kInViews) * kLdE + kPtsPad + (i - kP) % kInViews] =
            v[j];
    }
  }
}

// The MLP on the embedded tile in s.emb; leaves raw logits in s.raw. P: the
// buffer of pack_weights_mma, whose slabs `pipe` streams. All threads enter;
// starts (after the embedding's stores) and ends with a barrier.
__device__ __forceinline__ void mlp_tile(MlpSmem& s, Pipe& pipe,
                                         const float* __restrict__ P) {
  float* A = s.act;
  const float* E = s.emb;
  const float* bias = P + kOffBias;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __syncthreads();
  NNC_PROF(1);
  mma_layer<4, true>(pipe, A, E, kLdE, kPtsPad, nullptr, 0, 0, bias);
#pragma unroll 1
  for (int i = 1; i <= 4; ++i)
    mma_layer<4, true>(pipe, A, A, kLdA, kW, nullptr, 0, 0, bias + i * kW);
  // skip: [emb, h] @ w5 — rows 0..62 of w5 act on emb, rows 63.. on h
  mma_layer<4, true>(pipe, A, E, kLdE, kPtsPad, A, kLdA, kW, bias + 5 * kW);
#pragma unroll 1
  for (int i = 6; i <= 7; ++i)
    mma_layer<4, true>(pipe, A, A, kLdA, kW, nullptr, 0, 0, bias + i * kW);

  // alpha head (256 -> 1) on h = A: warp w takes points 8 w .. 8 w + 7
  {
    float wa[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wa[j] = __ldg(P + kOffAlphaW + lane + 32 * j);
    const float ba = __ldg(P + kOffAlphaB);
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int m = warp * 8 + i;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fmaf(A[m * kLdA + lane + 32 * j], wa[j], acc);
      acc = warp_sum_all(acc);
      if (lane == 0) s.raw[m * 4 + 3] = acc + ba;
    }
  }
  NNC_PROF(6);
  // feature (no activation) on h = A, in place
  mma_layer<4, false>(pipe, A, A, kLdA, kW, nullptr, 0, 0,
                      P + kOffBiasFeature);
  // views: relu([feature, view emb] @ wv + bv) -> A cols 0..127
  mma_layer<2, true>(pipe, A, A, kLdA, kW, E + kPtsPad, kLdE, kViewsPad,
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
    for (int i = 0; i < 8; ++i) {
      const int m = warp * 8 + i;
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = A[m * kLdA + lane + 32 * j];
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = fmaf(h, wr[j][c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = warp_sum_all(acc[c]);
      if (lane < 3)
        s.raw[m * 4 + lane] =
            (lane == 0 ? acc[0] : lane == 1 ? acc[1] : acc[2]) + br;
    }
  }
  __syncthreads();
  NNC_PROF(7);
}

// What mlp_from_points.cuh and render_pass.cuh need of a chain: the tile's
// size, its shared memory and weight ring, and the three steps of a tile
// (load_embedded in place of embed: only mlp_embedded_kernel).
struct Chain {
  static constexpr int kPoints = kM;
  using Smem = MlpSmem;
  using Pipe = mma::Pipe;
  static __device__ __forceinline__ void begin(Smem& s, Pipe& pipe,
                                               const float* P) {
    pipe.start(P, s.ring);
    zero_embedding_pad(s.emb);
  }
  static __device__ __forceinline__ void embed(Smem& s, const float* xs,
                                               const float* ds) {
    embed_tile(s.emb, xs, ds);
  }
  static __device__ __forceinline__ void load_embedded(
      Smem& s, const float* pts_emb, const float* views_emb, long long base,
      int n) {
    load_embedded_tile(s.emb, pts_emb, views_emb, base, n);
  }
  static __device__ __forceinline__ void mlp(Smem& s, Pipe& pipe,
                                             const float* P) {
    mlp_tile(s, pipe, P);
  }
};

}  // namespace mma
}  // namespace nerf
