// K-B5 in bf16: the NeRF MLP on embeddings computed outside the kernel,
// operands rounded to bf16, sums and logits float32.
//
// Replaces the Pallas kernel _kernel / _fused_call
// (nnc_tpu/ops/mlp_pallas.py:191, :248) as it runs when config.compute_dtype
// is bfloat16 (mlp_pallas.py:425-444: the embeddings cast to bf16 at
// :430-431, the weights packed in bf16, _mlp_body on the bf16 embedding).
//
// Bound on the H100: operations, 1.19 MFLOP a point against 376 bytes (the
// float32 embeddings in, the raw logits out), at the tensor cores' dense bf16
// peak of 989 TFLOP/s (H100 SXM data sheet, 700 W): 262,144 points cannot
// take less than 0.316 ms; their bytes alone take 0.03 ms.
//
// Design: K-B3 bf16 (mlp_from_points_bf16.cu) with another input stage.
// Persistent CTAs walk tiles of 16 NNC_BF16_MT points (128) over the chain
// of nerf_mlp_bf16.cuh, the weights streamed through nerf_mlp_mma.cuh's
// cp.async ring from the buffer of pack_weights_bf16 (the one K-B3 bf16
// reads). Each value of the float32 embeddings is rounded once to bf16 into
// s.emb, pts at channels 0..62 and views at 64..90; channels 63 and 91..95
// stay the zeros that Chain::begin wrote. The TPU kernel's (N, 128) packed
// input is not carried over. Reruns are bit-equal.
//
// The next tile's pts come in while this tile's products run. A tile's rows
// are contiguous in device memory, 128 x 252 = 32,256 bytes of pts_emb (and
// 128 x 108 = 13,824 of views_emb), multiples of 16 at offsets that are
// multiples of 16, so the pts part is one 1-D bulk copy (cp.async.bulk,
// completing on an mbarrier) with no tensor map over the unaligned rows.
// The chain's 194,560 bytes leave room for one 32 KB stage, not for both
// parts, so:
//  1. before the tile's products, the next tile's pts copy is issued into
//     the stage (behind a barrier: the stage's last reader is step 2 of the
//     tile before);
//  2. after the tile, whose last barrier ends every read of s.emb, the next
//     tile's views are loaded from device memory in one batch of coalesced
//     4-byte loads (14 a thread) and, while they are in flight, the stage is
//     rounded into s.emb's pts channels (shared to shared, a warp a row);
//     then the views are rounded in.
// The first tile of a CTA, and a next tile that is ragged (fewer than 128
// rows), load from device memory as before (bf16::load_embedded_tile),
// masked past n. The roundings are the same __float2bfloat16_rn of the same
// float32 values into the same places, so raw is bit-equal to the earlier
// kernel, which loaded every tile that way (nnc_tpu_torch/tools/
// kernel_compare.py --kernels kb5_bf16 holds the two against each other).
//
// Before (PERF.md): every tile loaded by load_embedded_tile between
// the previous tile's last barrier and the chain's first, with no product
// beside it: 1.007 ms at 262,144 points (NVIDIA H100 80GB HBM3, 700 W).
// Prediction, after clock marks gave the load 27% of a tile: 0.72-0.82 ms.
// Measured (same card; PERF.md): 0.984-0.993 ms against the tile-by-tile
// kernel's 1.014-1.029 timed in turns in one call, raw bit-equal; 255
// registers and 176 bytes of spills (the tile-by-tile kernel 254, none).
// The marks' 27% came from a build of the tile-by-tile kernel with them,
// which spills (952 bytes of stack): as shipped its load cost ~0.04 ms. The
// rest of the distance to K-B3 bf16 (0.91 ms) follows the registers of the
// kernel's embedding paths: a build that loads no embedding after a CTA's
// first tile (wrong results) takes 0.83 ms with 240 registers. Issuing the
// views too by a bulk copy through the same stage, from hooks inside the
// chain's tile, took no more off (3.5% against 3.3%, in other calls).
#include "mlp_from_points.cuh"
#include "nerf_mlp_bf16.cuh"
#include "slab_ring.cuh"   // mbar_wait, smem_u32

namespace {

using Chain = nerf::bf16::Chain<NNC_BF16_MT>;
using nerf::kInPts;
using nerf::kInViews;
using nerf::kThreads;
using nerf::bf16::kLdE;
using nerf::ring::smem_u32;
constexpr int kPoints = Chain::kPoints;
constexpr int kPtsBytes = kPoints * kInPts * 4;
static_assert(kPtsBytes % 16 == 0 && kPoints * kInViews * 4 % 16 == 0,
              "a tile's rows are whole 16-byte pieces");

struct StagedSmem {
  Chain::Smem mlp;
  alignas(16) float stage[kPoints * kInPts];   // the next tile's pts
  uint64_t bar;                                // the stage's copy has landed
};

// One thread: the bulk copy of a tile's pts from device memory into the
// stage, completing on the stage's mbarrier. The stage's earlier reads
// (generic proxy) are ordered before the copy's writes (async proxy) by the
// barrier the CTA passed and the fence here.
__device__ __forceinline__ void copy_pts(StagedSmem& s, const float* src) {
  const uint32_t bar = smem_u32(&s.bar);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(kPtsBytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(s.stage)),
      "l"(src), "r"(kPtsBytes), "r"(bar)
      : "memory");
}

// Every thread: waits for the stage's copy (the mbarrier's phase of parity
// `parity`), then rounds it to bf16 into s.emb's pts channels: warp w takes
// rows w, w + 8, ..., its lanes the channels.
__device__ __forceinline__ void round_pts(StagedSmem& s, uint32_t parity) {
  nerf::ring::mbar_wait(smem_u32(&s.bar), parity);
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < kPoints; m += kThreads / 32) {
#pragma unroll
    for (int c = lane; c < kInPts; c += 32)
      s.mlp.emb[m * kLdE + c] = __float2bfloat16_rn(s.stage[m * kInPts + c]);
  }
}

// Every thread: a whole tile's views (rows from q) and the stage's pts
// rounded to bf16 into s.emb. The views' loads (14 a thread) are in flight
// while the stage is rounded.
__device__ __forceinline__ void round_in(StagedSmem& s,
                                         const float* __restrict__ q,
                                         uint32_t parity) {
  constexpr int kAll = kPoints * kInViews;
  constexpr int kIters = (kAll + kThreads - 1) / kThreads;
  float v[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = i < kAll ? __ldg(q + i) : 0.f;
  }
  round_pts(s, parity);
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kAll)
      s.mlp.emb[(i / kInViews) * kLdE + nerf::mma::kPtsPad + i % kInViews] =
          __float2bfloat16_rn(v[j]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_embedded_staged_kernel(const float* __restrict__ P,
                           const float* __restrict__ pts_emb,
                           const float* __restrict__ views_emb,
                           float* __restrict__ out, int n, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StagedSmem& s = *reinterpret_cast<StagedSmem*>(smem_raw);
  const int tid = threadIdx.x;
  nerf::mma::prof_begin();
  Chain::Pipe pipe;
  Chain::begin(s.mlp, pipe, P);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&s.bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (blockIdx.x < tiles)
    nerf::bf16::load_embedded_tile<NNC_BF16_MT>(
        s.mlp.emb, pts_emb, views_emb,
        static_cast<long long>(blockIdx.x) * kPoints, n);
  NNC_PROF(0);
  uint32_t parity = 0;   // of the stage's next copy
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kPoints;
    const long long next = base + static_cast<long long>(gridDim.x) * kPoints;
    // the next tile exists and is whole (the same in every thread)
    const bool staged = next + kPoints <= n;
    if (staged) {
      __syncthreads();   // the stage's last reads (round_pts) are done
      if (tid == 0) copy_pts(s, pts_emb + next * kInPts);
    }
    nerf::bf16::mlp_tile<NNC_BF16_MT>(s.mlp, pipe, P);
    if (staged) {
      round_in(s, views_emb + next * kInViews, parity);
      parity ^= 1u;
    } else if (next < n) {
      nerf::bf16::load_embedded_tile<NNC_BF16_MT>(s.mlp.emb, pts_emb,
                                                  views_emb, next, n);
    }
    NNC_PROF(0);
    for (int i = tid; i < kPoints * 4; i += kThreads)
      if (base + i / 4 < n) out[base * 4 + i] = s.mlp.raw[i];
    NNC_PROF(8);
  }
  pipe.drain();
  nerf::mma::prof_end();
}

}  // namespace

#ifdef NNC_MMA_PROFILE
extern "C" int nnc_mma_profile(unsigned long long* out) {
  return nerf::mma::read_profile(out);
}
#endif

// pts_emb: (n, 63); views_emb: (n, 27); out: (n, 4) [rgb logits, sigma];
// params: the weights as pack_weights_bf16 lays them out; params, pts_emb
// and views_emb 16-byte aligned.
extern "C" int nnc_mlp_embedded_bf16(const float* params,
                                     const float* pts_emb,
                                     const float* views_emb, float* out,
                                     int n, void* stream) {
  return nerf::launch_persistent<kPoints>(
      mlp_embedded_staged_kernel, static_cast<int>(sizeof(StagedSmem)), n,
      stream, params, pts_emb, views_emb, out);
}
