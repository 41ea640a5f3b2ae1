// Hopper's warpgroup products (wgmma) for the bf16 NeRF MLP: the
// instructions, their shared-memory descriptors and the operand layout they
// read, and the chain of K-B3 bf16 built on them (mlp_from_points_bf16.cu,
// whose source note holds the design). The primitives also serve the probe
// of nnc_tpu_torch/tools/mma_probe.py (section 10), which holds one layer of
// these products against torch.mm.
//
// The operand layout. Both A (points x channels) and B (output channels x
// depth) are K-major: a row holds 64 consecutive 16-bit values of the depth
// (128 bytes), eight rows make an atom of 1,024 bytes, and within an atom
// the 16-byte chunk c of row r is stored at chunk c ^ r (the 128-byte
// swizzle: address bits 4-6 XOR bits 7-9, with every atom 1,024-byte
// aligned). A depth of more than 64 is a run of such blocks, `rows` x 128
// bytes apart. swz() below is that map; mlp_fused.repack_bf16_wgmma lays the
// weight slabs out with the same map on the host side, and the CPU tests
// hold the two against an independent model.
//
// A product m64nNk16 reads 16 values of the depth: its descriptors start 32
// bytes further into the block for each k step of 16 (the hardware applies
// the swizzle to the address it forms), and at the next block after four.
// The accumulator fragment of warp w of the warpgroup, lane 4 g + t: d[4 j]
// and d[4 j + 1] are row 16 w + g, columns 8 j + 2 t and 8 j + 2 t + 1;
// d[4 j + 2] and d[4 j + 3] the same columns of row 16 w + g + 8.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "nerf_mlp_bf16.cuh"   // the tail of pack_weights_bf16; clock marks
#include "slab_ring.cuh"

namespace nerf {
namespace wg {

// Byte offset of value (row, col) of a K-major operand with the 128-byte
// swizzle whose 64-value blocks of the depth lie rows x 128 bytes apart.
__host__ __device__ constexpr uint32_t swz(int row, int col, int rows) {
  return static_cast<uint32_t>((col >> 6) * rows * 128 + row * 128 +
                               ((((col >> 3) & 7) ^ (row & 7)) << 4) +
                               (col & 7) * 2);
}

// The descriptor of a K-major operand with the 128-byte swizzle at shared
// address addr: start address >> 4 (bits 0-13), leading byte offset 1
// (unused by the swizzled K-major layouts, bits 16-29), stride byte offset
// 1,024 >> 4 from one atom of eight rows to the next (bits 32-45), base
// offset 0 (the atoms are 1,024-byte aligned), layout 1 = 128-byte swizzle
// (bits 62-63).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The descriptor of k step ks (16 values of the depth) of an operand at
// shared address base, whose 64-value blocks lie rows x 128 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int ks, int rows) {
  return desc(base + (ks >> 2) * rows * 128 + (ks & 3) * 32);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders this warpgroup's earlier register writes (the accumulators' start
// values) before the products that read them.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// This thread's shared-memory writes, before the async proxy's reads
// (wgmma operands, bulk copies) that a later barrier orders after them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A named barrier of `count` threads (a warpgroup: 128).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// point where this stands (the products write them asynchronously).
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32) += A (64 x 16) B (16 x N), both from shared memory
// by the descriptors da and db (K-major, 128-byte swizzle); N = 128 takes
// the first 64 of the 128 registers.
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void mma_n128(float (&d)[128], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

// --- the chain ------------------------------------------------------------
constexpr int kGroupPoints = 64;              // points a warpgroup owns
constexpr int kPoints = 2 * kGroupPoints;     // a CTA's tile
constexpr int kSlabs = bf16::kSlabs;          // 37, as the mma.sync chain's
constexpr int kStages = 4;                    // ring stages of 32 KB
constexpr int kActBytes = kGroupPoints * kW * 2;   // 32 KB, 4 depth blocks
constexpr int kEmbBytes = kGroupPoints * 64 * 2;   // 8 KB, one depth block
// pack_weights_bf16's tail: the ten layers' biases, the heads' weights and
// biases (float32), 12,544 bytes; offsets below are into it
constexpr int kTail = bf16::kParamsSize - bf16::kOffBias;
constexpr int kTailFeature = bf16::kOffBiasFeature - bf16::kOffBias;
constexpr int kTailViews = bf16::kOffBiasViews - bf16::kOffBias;
constexpr int kTailAlphaW = bf16::kOffAlphaW - bf16::kOffBias;
constexpr int kTailAlphaB = bf16::kOffAlphaB - bf16::kOffBias;
constexpr int kTailRgbW = bf16::kOffRgbW - bf16::kOffBias;
constexpr int kTailRgbB = bf16::kOffRgbB - bf16::kOffBias;
using Ring = ring::SlabRing<kSlabs, kStages>;

// The CTA's shared memory (227,328 bytes of the 232,448 a block may have):
// the ring's stages first, so that they and the operands after them start
// on 1,024 bytes (the swizzle's atoms) when the dynamic block does. A
// group's embedding block holds posenc(x) (63 channels + 1 zero) until the
// skip layer has read it, then posenc(d) (27 + 5 zero) for the view layer.
struct alignas(1024) Smem {
  ring::RingSmem<kStages> ring;   // 128 KB of slabs, barriers, counts
  alignas(1024) unsigned char act[2][kActBytes];   // a group's activations
  alignas(1024) unsigned char emb[2][kEmbBytes];   // and its embedding
  alignas(16) float tail[kTail];                   // biases and heads
};
static_assert(sizeof(Smem) <= 232448, "shared memory of one block");

template <int N>
__device__ __forceinline__ void product(float (&d)[128], uint64_t da,
                                        uint64_t db) {
  if constexpr (N == 256) mma_n256(d, da, db);
  else mma_n128(d, da, db);
}

// Before a layer's first product: d started at the bias (float32, N values
// in shared memory; every row of the fragment gets columns 8 j + 2 t and
// 8 j + 2 t + 1), and ordered before the products that add to it.
template <int N>
__device__ __forceinline__ void begin_layer(float (&d)[128],
                                            const float* bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = reinterpret_cast<const float2*>(bias + 8 * j)[t];
    d[4 * j] = d[4 * j + 2] = b.x;
    d[4 * j + 1] = d[4 * j + 3] = b.y;
  }
  fence_operands(d);
  NNC_PROF(7);
  fence();
}

// KS k steps of the slab that lands next in the ring (after the one this
// warp holds, if `held`) against A at shared address a, whose depth blocks
// lie 64 rows apart; commits them as one group. With a slab held, waits for
// that slab's group and releases it. Returns with the new slab held.
template <int N, int KS>
__device__ __forceinline__ void slab(Ring& ring, float (&d)[128],
                                     uint32_t a, bool held) {
  const uint32_t b = smem_u32(ring.acquire(held ? 1 : 0));
  NNC_PROF(1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    product<N>(d, desc_k(a, ks, kGroupPoints), desc_k(b, ks, N));
  commit();
  NNC_PROF(2);
  if (held) {
    wait<1>();
    ring.release();
  }
  NNC_PROF(3);
}

// A 256-wide layer's products on h (the group's activations at act, four
// slabs), after those of one slab on posenc(x) at emb if SKIP.
template <bool SKIP>
__device__ __forceinline__ void wide(Ring& ring, float (&d)[128],
                                     uint32_t act, uint32_t emb) {
  if constexpr (SKIP) slab<256, 4>(ring, d, emb, false);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    slab<256, 4>(ring, d, act + k * kGroupPoints * 128, SKIP || k > 0);
}

// The end of a layer's products: the last group done, its slab released,
// and every warp of the warpgroup past that point (their reads of A over),
// so that the epilogue may overwrite A.
__device__ __forceinline__ void products_done(Ring& ring, float (&d)[128],
                                              int group) {
  wait<0>();
  fence_operands(d);
  ring.release();
  NNC_PROF(3);
  bar_sync(1 + group, 128);
  NNC_PROF(5);
}

// A 256-wide layer's epilogue: v = bf16(relu(d)) (no relu for `feature`)
// into the group's activations through the swizzle; alpha != nullptr also
// returns the alpha head's sums of the rounded v of this thread's rows g
// and g + 8 (after the shuffles over t: the whole row). Ends with the
// stores fenced for the async proxy and the warpgroup's barrier.
template <bool RELU>
__device__ __forceinline__ void store_act(const float (&d)[128],
                                          unsigned char* act, int group,
                                          const float* alpha,
                                          float (&head)[2]) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned char* row = act + (16 * w + g) * 128 + 4 * t;
  head[0] = head[1] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = RELU ? fmaxf(d[4 * j + i], 0.f)
                                            : d[4 * j + i];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    unsigned char* o = row + (j >> 3) * (kGroupPoints * 128) +
                       (((j & 7) ^ g) << 4);
    *reinterpret_cast<__nv_bfloat162*>(o) = lo;
    *reinterpret_cast<__nv_bfloat162*>(o + 8 * 128) = hi;
    if (alpha != nullptr) {
      const float2 wa = reinterpret_cast<const float2*>(alpha + 8 * j)[t];
      head[0] = fmaf(__low2float(lo), wa.x, head[0]);
      head[0] = fmaf(__high2float(lo), wa.y, head[0]);
      head[1] = fmaf(__low2float(hi), wa.x, head[1]);
      head[1] = fmaf(__high2float(hi), wa.y, head[1]);
    }
  }
  if (alpha != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      head[r] += __shfl_xor_sync(0xffffffffu, head[r], 1);
      head[r] += __shfl_xor_sync(0xffffffffu, head[r], 2);
    }
  }
  NNC_PROF(4);
  fence_async_smem();
  bar_sync(1 + group, 128);
  NNC_PROF(5);
}

// This lane's three of the 96 coordinates of its warp's 16 points of the
// group's 64 (row base of n): pts then dirs, lane l holding values l, l +
// 32, l + 64; rows past n read zeros.
__device__ __forceinline__ void load_coords(float (&c)[3],
                                            const float* __restrict__ pts,
                                            const float* __restrict__ dirs,
                                            long long base, int n) {
  const int lane = threadIdx.x & 31;
  const long long first = base + 16 * ((threadIdx.x >> 5) & 3);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = lane + 32 * k;
    const int j = i < 48 ? i : i - 48;
    c[k] = first + j / 3 < n ? __ldg((i < 48 ? pts : dirs) + first * 3 + j)
                             : 0.f;
  }
}

// Items Q0..Q1 - 1 of the positional encoding of the warp's 16 points into
// the group's embedding block, through the swizzle: item q = 3 f + d of a
// point's 48 (f = 0: raw xyz, 1..10: xyz freqs; 11: raw dir, 12..15: dir
// freqs, posenc(d) starting at channel 0), of the coordinate the lane
// holding it passes round (c, as load_coords leaves them), computed in
// float32 as the mma.sync chain's embed_tile and rounded once to bf16.
template <int Q0, int Q1>
__device__ __forceinline__ void embed(unsigned char* emb,
                                      const float (&c)[3]) {
  constexpr int kQ = Q1 - Q0;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3);
  // every lane takes part in every round's shuffles (16 kQ need not be a
  // multiple of 32); lanes past the last item compute and store nothing
#pragma unroll 1
  for (int i0 = 0; i0 < 16 * kQ; i0 += 32) {
    const bool live = i0 + lane < 16 * kQ;
    const int i = live ? i0 + lane : 16 * kQ - 1;
    const int m = i / kQ;
    const int q = Q0 + i - m * kQ;
    const int f = q / 3;
    const int d = q - f * 3;
    const bool view = f >= 11;
    const int at = 3 * m + d + (view ? 48 : 0);   // among the 96 values
    const float v0 = __shfl_sync(0xffffffffu, c[0], at & 31);
    const float v1 = __shfl_sync(0xffffffffu, c[1], at & 31);
    const float v2 = __shfl_sync(0xffffffffu, c[2], at & 31);
    const float x = at < 32 ? v0 : at < 64 ? v1 : v2;
    const int r = row0 + m;
    const int fr = view ? f - 12 : f - 1;
    float sn, cs;
    sincosf(x * static_cast<float>(1 << (fr < 0 ? 0 : fr)), &sn, &cs);
    if (!live) continue;
    if (fr < 0) {
      *reinterpret_cast<__nv_bfloat16*>(emb + swz(r, d, 64)) =
          __float2bfloat16_rn(x);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(emb + swz(r, 3 + 6 * fr + d, 64)) =
          __float2bfloat16_rn(sn);
      *reinterpret_cast<__nv_bfloat16*>(emb + swz(r, 6 + 6 * fr + d, 64)) =
          __float2bfloat16_rn(cs);
    }
  }
}

// posenc(x) of the group's 64 points (the warp's 16 each), channel 63
// zero; ends with the stores fenced for the async proxy and the
// warpgroup's barrier.
__device__ __forceinline__ void embed_pts(unsigned char* emb,
                                          const float (&c)[3], int group) {
  embed<0, 33>(emb, c);
  if ((threadIdx.x & 31) < 16) {
    const int r = 16 * ((threadIdx.x >> 5) & 3) + (threadIdx.x & 15);
    *reinterpret_cast<__nv_bfloat16*>(emb + swz(r, kInPts, 64)) =
        __float2bfloat16_rn(0.f);
  }
  NNC_PROF(0);
  fence_async_smem();
  bar_sync(1 + group, 128);
  NNC_PROF(5);
}

// posenc(d) of the warp's 16 points into channels 0..26 of the embedding
// block, 27..31 zero, once the skip layer's products have read posenc(x);
// the epilogue after it fences and syncs.
__device__ __forceinline__ void embed_views(unsigned char* emb,
                                            const float (&c)[3]) {
  embed<33, 48>(emb, c);
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3);
  for (int i = lane; i < 16 * (mma::kViewsPad - kInViews); i += 32)
    *reinterpret_cast<__nv_bfloat16*>(
        emb + swz(row0 + i / (mma::kViewsPad - kInViews),
                  kInViews + i % (mma::kViewsPad - kInViews), 64)) =
        __float2bfloat16_rn(0.f);
  NNC_PROF(0);
}

// The MLP on the group's 64 points, whose posenc(x) embed_pts wrote; writes
// raw (rows base.. of out, those below n). c: the points' coordinates
// (load_coords), whose posenc(d) goes in after the skip layer. T: the
// tail of pack_weights_bf16 in shared memory; the slabs come from the ring.
__device__ __forceinline__ void mlp(Smem& s, Ring& ring, int group,
                                    const float (&c)[3],
                                    float* __restrict__ out, long long base,
                                    int n) {
  const uint32_t act = smem_u32(s.act[group]);
  const uint32_t emb = smem_u32(s.emb[group]);
  const float* T = s.tail;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float d[128];
  float head[2];
  // pts_linears.0 on posenc(x)
  begin_layer<256>(d, T);
  slab<256, 4>(ring, d, emb, false);
  products_done(ring, d, group);
  store_act<true>(d, s.act[group], group, nullptr, head);
#pragma unroll 1
  for (int i = 1; i <= 4; ++i) {
    begin_layer<256>(d, T + i * kW);
    wide<false>(ring, d, act, emb);
    products_done(ring, d, group);
    store_act<true>(d, s.act[group], group, nullptr, head);
  }
  // the skip: rows 0..62 of w5 act on posenc(x), the rest on h; posenc(x)
  // read, posenc(d) takes its place
  begin_layer<256>(d, T + 5 * kW);
  wide<true>(ring, d, act, emb);
  products_done(ring, d, group);
  embed_views(s.emb[group], c);
  store_act<true>(d, s.act[group], group, nullptr, head);
#pragma unroll 1
  for (int i = 6; i <= 7; ++i) {
    begin_layer<256>(d, T + i * kW);
    wide<false>(ring, d, act, emb);
    products_done(ring, d, group);
    store_act<true>(d, s.act[group], group,
                    i == 7 ? T + kTailAlphaW : nullptr, head);
  }
  if ((lane & 3) == 0) {   // alpha, on the rounded h of pts_linears.7
    const float ba = T[kTailAlphaB];
    if (base + r0 < n) out[(base + r0) * 4 + 3] = head[0] + ba;
    if (base + r0 + 8 < n) out[(base + r0 + 8) * 4 + 3] = head[1] + ba;
  }
  NNC_PROF(6);
  // feature (no activation) on h, in place
  begin_layer<256>(d, T + kTailFeature);
  wide<false>(ring, d, act, emb);
  products_done(ring, d, group);
  store_act<false>(d, s.act[group], group, nullptr, head);
  // views: relu([feature, posenc(d)] @ wv + bv) in d[0..63], then the rgb
  // head on its rounded output, straight from the fragments
  begin_layer<128>(d, T + kTailViews);
  slab<128, 8>(ring, d, act, false);
  slab<128, 8>(ring, d, act + 2 * kGroupPoints * 128, true);
  slab<128, 2>(ring, d, emb, true);
  products_done(ring, d, group);
  const float* wr = T + kTailRgbW;
  const int t = lane & 3;
  float rgb[2][3] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // columns 8 j + 2 t + h
      const int col = 8 * j + 2 * t + h;
      const float v0 = __bfloat162float(
          __float2bfloat16_rn(fmaxf(d[4 * j + h], 0.f)));
      const float v1 = __bfloat162float(
          __float2bfloat16_rn(fmaxf(d[4 * j + 2 + h], 0.f)));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float w = wr[col * 3 + k];
        rgb[0][k] = fmaf(v0, w, rgb[0][k]);
        rgb[1][k] = fmaf(v1, w, rgb[1][k]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rgb[r][k] += __shfl_xor_sync(0xffffffffu, rgb[r][k], 1);
      rgb[r][k] += __shfl_xor_sync(0xffffffffu, rgb[r][k], 2);
    }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (base + r0 + 8 * r < n) {
        float* o = out + (base + r0 + 8 * r) * 4;
#pragma unroll
        for (int k = 0; k < 3; ++k) o[k] = rgb[r][k] + T[kTailRgbB + k];
      }
    }
  }
  NNC_PROF(6);
}

}  // namespace wg
}  // namespace nerf
