// A stream of 32 KB weight slabs through a ring of shared-memory stages
// that every warp of the CTA reads in full, for kernels whose two groups of
// warps walk the same slabs at their own pace: mlp_int8_from_points.cu
// (K-B4), the bf16 training forward of mlp_train_bf16.cu (K-B1), the wgmma
// chain of K-B3 bf16 (nerf_mlp_wgmma.cuh) and K-B1 float32 (mlp_train.cu).
//
// Slab j of the CTA's sequence (slab j % SLABS of the packed buffer) lands
// in stage j % STAGES by one bulk copy (cp.async.bulk, the tensor memory
// accelerator), and the stage's mbarrier completes its phase
// (j / STAGES) & 1 when it has. Each warp acquires and releases every slab
// in order; the last of the CTA's warps to release a stage copies the slab
// STAGES further into it. A group can therefore run ahead of the other by
// at most STAGES slabs, and no warp waits at a CTA-wide barrier for a slab.
// (nerf_mlp_mma.cuh's PipeT, where each warp copies and reads only its own
// eighth of a slab, needs no such bookkeeping, but a warp there can read
// only the columns its eighth holds.) Both kernels' warps own the output
// channels of two eighths of every slab, and run their products through
// run_two_eighths below.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerf_mlp_bf16.cuh"   // ldmatrix_x4

namespace nerf {
namespace ring {

constexpr int kSlabFloats = 8192;   // 32 KB, as nerf_mlp_mma.cuh's kSlab

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Until the mbarrier at shared address `bar` has completed the phase of
// parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The ring's shared memory, a member of the kernel's own layout (whole
// 128-byte lines, so that the members after it keep their alignment).
template <int STAGES>
struct alignas(128) RingSmem {
  float stages[STAGES * kSlabFloats];
  uint64_t full[STAGES];   // a stage's slab has landed
  int released[STAGES];    // warps done with a stage's slab
};

template <int SLABS, int STAGES>
struct SlabRing {
  RingSmem<STAGES>* s;
  const float* src;   // the packed buffer; its slabs first, 16-byte aligned
  int total;          // slabs this CTA reads
  int j;              // the slab this warp releases next
  static constexpr int kWarps = 8;   // warps that read every slab

  // One thread: the barriers, then the first STAGES slabs. The CTA must
  // pass a __syncthreads() before any warp acquires.
  __device__ __forceinline__ void start() const {
    for (int st = 0; st < STAGES; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&s->full[st]))
                   : "memory");
      s->released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < STAGES && k < total; ++k) issue(k);
  }

  __device__ __forceinline__ void issue(int slab_j) const {
    const int st = slab_j % STAGES;
    const uint32_t bar = smem_u32(&s->full[st]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(kSlabFloats * 4)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(s->stages + st * kSlabFloats)),
        "l"(src + static_cast<size_t>(slab_j % SLABS) * kSlabFloats),
        "r"(kSlabFloats * 4), "r"(bar)
        : "memory");
  }

  // The next slab to release (its stage's first float), landed; all lanes
  // call it. ahead = 1: the one after it (a warpgroup's wgmma chain, which
  // keeps one slab's products in flight while it issues the next).
  __device__ __forceinline__ const float* acquire(int ahead = 0) const {
    const int st = (j + ahead) % STAGES;
    mbar_wait(smem_u32(&s->full[st]), ((j + ahead) / STAGES) & 1);
    return s->stages + st * kSlabFloats;
  }

  // This warp is done with the slab it acquired last (its reads of it have
  // returned: the instructions that use them issued before); all lanes call
  // it.
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const int st = j % STAGES;
      if (atomicAdd(&s->released[st], 1) == kWarps - 1) {
        atomicExch(&s->released[st], 0);
        if (j + STAGES < total) {
          // the warps' reads of the stage, before the copy's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(j + STAGES);
        }
      }
    }
    ++j;
  }
};

// acc += x @ (the next slabs of `ring`) for this warp: its 16 MT rows of
// x (point-major in shared memory, row stride ld bytes, 32 bytes of each
// row a k step: 16 bf16 or 32 int8 channels) and its 8 NT output channels,
// those of eighths 2 wg and 2 wg + 1 of each slab (wg: the warp within its
// group of four). The slabs hold the operand B of mma.sync in fragment
// order, per eighth [k step][pair of n-tiles][lane][4 words] (NT / 2
// n-tiles an eighth: 4 k steps a slab at NT = 8, 8 at NT = 4), as
// mlp_fused.pack_weights_bf16 and repack_int8_mma lay them out. mma(c, a,
// b) adds one m16n8 tile's product of one k step into c. `steps` k steps;
// the run's last slab may hold more, which are skipped.
template <int MT, int NT, class Ring, class Acc, class Mma>
__device__ __forceinline__ void run_two_eighths(Ring& ring,
                                                Acc (&acc)[MT][NT][4],
                                                const void* x, int ld,
                                                int steps, Mma mma) {
  constexpr int kPer = NT / 2;          // n-tiles of an eighth
  constexpr int kStepVec = 16 * kPer;   // an eighth's 16-byte vectors a k step
  constexpr int kEighth = kSlabFloats / 8 / 4;   // 16-byte vectors of one
  constexpr int kStepsPerSlab = kEighth / kStepVec;   // 4 or 8
  const int lane = threadIdx.x & 31;
  const int wg = (threadIdx.x >> 5) & 3;
  uint32_t a_addr = smem_u32(static_cast<const char*>(x) +
                             (lane & 15) * ld + 16 * (lane >> 4));
  for (int s0 = 0; s0 < steps; s0 += kStepsPerSlab) {
    const uint4* e0 = reinterpret_cast<const uint4*>(ring.acquire()) +
                      2 * wg * kEighth + lane;
    const uint4* e1 = e0 + kEighth;
    const int n = steps - s0 < kStepsPerSlab ? steps - s0 : kStepsPerSlab;
#pragma unroll 2
    for (int ks = 0; ks < n; ++ks) {
      uint32_t b[NT][2];
#pragma unroll
      for (int q = 0; q < kPer / 2; ++q) {
        const uint4 w0 = e0[ks * kStepVec + q * 32];
        const uint4 w1 = e1[ks * kStepVec + q * 32];
        b[2 * q][0] = w0.x;
        b[2 * q][1] = w0.y;
        b[2 * q + 1][0] = w0.z;
        b[2 * q + 1][1] = w0.w;
        b[kPer + 2 * q][0] = w1.x;
        b[kPer + 2 * q][1] = w1.y;
        b[kPer + 2 * q + 1][0] = w1.z;
        b[kPer + 2 * q + 1][1] = w1.w;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        bf16::ldmatrix_x4(a, a_addr + mt * 16 * ld);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a, b[nt]);
      }
      a_addr += 32;
    }
    ring.release();
  }
}

}  // namespace ring
}  // namespace nerf
