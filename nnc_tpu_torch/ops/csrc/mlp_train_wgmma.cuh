// K-B1 float32's products on Hopper's warpgroup instructions: wgmma
// m64nNk8 .tf32 with A from registers and B from shared memory (slabs that
// slab_ring.cuh's ring brings in), and the product loop of one warpgroup
// over a segment of a layer's depth, as 3xTF32 with the 32-channel rounded
// joins.
// mlp_train.cu holds the kernels and the design note;
// mlp_train_fused.pack_train_wgmma lays the slabs out.
//
// B's images. A slab is 32 KB, one bulk copy. For a 256-wide output it is
// the hi or the lo half of one group of 32 input channels: 256 rows (output
// channels) of 128 bytes (the group's 32 depth values), eight rows to a
// 1,024-byte atom whose 16-byte chunk c of row r lies at chunk c ^ (r & 7)
// (the 128-byte swizzle); the hi slab comes first, then the lo slab. For the
// 128-wide view layer one slab holds both: hi (128 rows, 16 KB), then lo.
// A warpgroup's NW output channels are rows NW wg onwards. A k step (8
// depth values, 32 bytes of a row) advances the descriptor's start by 32
// bytes; the hardware applies the swizzle to the address it forms.
//
// A from registers (the fragment of mma.sync m16n8k8 .tf32, warp w of the
// group holding rows 16 w + g and 16 w + g + 8, lane 4 g + t): a0 (row g,
// slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4). A thread loads
// channels 4t..4t+3 of each 16-channel half of a group as one 16-byte load
// a row; channels 4t, 4t + 1 take slots t, t + 4 of the half's first k step
// and 4t + 2, 4t + 3 those of its second. So depth position p of a group's
// image row (k step p / 8, slot p % 8) holds the group's channel
//   16 (p >> 4) + 4 (p & 3) + 2 ((p >> 3) & 1) + ((p >> 2) & 1),
// which pack_train_wgmma's index arithmetic and the CPU tests share.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerf_mlp_mma.cuh"   // split_tf32, the layout constants, NNC_PROF
#include "slab_ring.cuh"      // kSlabFloats, smem_u32

namespace nerf {
namespace twg {

constexpr int kSlabFloats = ring::kSlabFloats;   // 32 KB
constexpr int kStages = 4;   // two groups' hi and lo slabs

using ring::smem_u32;

// The descriptor of a K-major operand with the 128-byte swizzle at shared
// address addr (1,024-byte aligned atoms): start >> 4, leading byte offset
// 1 (unused by this layout), stride byte offset 1,024 >> 4 from one atom of
// eight rows to the next, layout 1 (128-byte swizzle). Adding 2 moves the
// start 32 bytes: the next k step.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of registers that the products
// read or write asynchronously across the point where this stands.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

// d (64 x N) = A (64 x 8, registers) B (8 x N, descriptor db), tf32
// operands, float32 accumulators: _first starts the tile (d only written),
// the others add to it.
__device__ __forceinline__ void mma_n128_first(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void mma_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void mma_n64_first(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void mma_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int NW, bool FIRST>
__device__ __forceinline__ void product(float (&d)[NW / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NW == 128 && FIRST) mma_n128_first(d, a, db);
  else if constexpr (NW == 128) mma_n128(d, a, db);
  else if constexpr (FIRST) mma_n64_first(d, a, db);
  else mma_n64(d, a, db);
}

// -------------------------------------------------- a warpgroup's products
// A thread's A operands of one group (32 channels), hi and lo, from the
// input in shared memory: channels 16 h + 4t .. 16 h + 4t + 3 of rows x0 (16
// w + g) and x1 (+ 8), one 16-byte load each, for k steps 2 h and 2 h + 1.
__device__ __forceinline__ void load_split(uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4],
                                           const float* x0, const float* x1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 r0 = *reinterpret_cast<const float4*>(x0 + 16 * h);
    const float4 r1 = *reinterpret_cast<const float4*>(x1 + 16 * h);
    mma::split_tf32(r0.x, ah[2 * h][0], al[2 * h][0]);
    mma::split_tf32(r1.x, ah[2 * h][1], al[2 * h][1]);
    mma::split_tf32(r0.y, ah[2 * h][2], al[2 * h][2]);
    mma::split_tf32(r1.y, ah[2 * h][3], al[2 * h][3]);
    mma::split_tf32(r0.z, ah[2 * h + 1][0], al[2 * h + 1][0]);
    mma::split_tf32(r1.z, ah[2 * h + 1][1], al[2 * h + 1][1]);
    mma::split_tf32(r0.w, ah[2 * h + 1][2], al[2 * h + 1][2]);
    mma::split_tf32(r1.w, ah[2 * h + 1][3], al[2 * h + 1][3]);
  }
}

// The two warpgroups take turns at issuing a group's products (named
// barriers 2 and 3, warpgroup wg waiting at 2 + wg, signalling 3 - wg), so
// that one's products run while the other joins its sums and loads and
// splits its next operands, instead of both issuing and both joining at
// once. order_start() lets warpgroup 0 go first; order_end() takes up the
// signal warpgroup 1 gives after the last group.
__device__ __forceinline__ void order_wait() {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + (threadIdx.x >> 7))
               : "memory");
}
__device__ __forceinline__ void order_signal() {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - (threadIdx.x >> 7))
               : "memory");
}
__device__ __forceinline__ void order_start() {
  if (threadIdx.x >= 128)
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
}
__device__ __forceinline__ void order_end() {
  if (threadIdx.x < 128) asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// The twelve products of one group of 32 channels into d, started from
// zero: lo * hi, hi * lo, hi * hi k step by k step. x0, x1: the thread's
// two rows of A at the group's first channel; the group's slabs are the
// ring's next (released once the products have completed).
template <int NW, class R>
__device__ __forceinline__ void group(R& ring, float (&d)[NW / 2],
                                      const float* x0, const float* x1) {
  const int wg = threadIdx.x >> 7;
  uint32_t ah[4][4], al[4][4];
  load_split(ah, al, x0, x1);
  uint32_t hi, lo;
  if constexpr (NW == 128) {
    hi = smem_u32(ring.acquire(0)) + wg * 16384;
    lo = smem_u32(ring.acquire(1)) + wg * 16384;
  } else {
    hi = smem_u32(ring.acquire(0)) + wg * 8192;
    lo = hi + 16384;
  }
  NNC_PROF(1);
  const uint64_t dh = desc(hi), dl = desc(lo);
  order_wait();
  fence();
  product<NW, true>(d, al[0], dh);
  product<NW, false>(d, ah[0], dl);
  product<NW, false>(d, ah[0], dh);
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) {
    product<NW, false>(d, al[ks], dh + 2 * ks);
    product<NW, false>(d, ah[ks], dl + 2 * ks);
    product<NW, false>(d, ah[ks], dh + 2 * ks);
  }
  commit();
  order_signal();
  NNC_PROF(2);
  wait_all();
  fence_operands(d);
  fence_operands(ah);
  fence_operands(al);
  NNC_PROF(3);
  ring.release();
  if constexpr (NW == 128) ring.release();
}

// acc (this warpgroup's NW output channels of the tile's 64 points) +=
// x[:, 0..K) @ (the ring's next slabs), K % 32 == 0. x: point-major in
// shared memory, row stride ld (16-byte aligned rows). Each group of 32
// channels: hi and lo of its A split in registers, its twelve products in a
// tile of its own started from zero (group()), then, once they have
// completed, that tile added to the sum by rounded float32 adds (the tensor
// core adds into its accumulator by cutting). tmp and acc take turns as
// the tile and the sum, so that the adds write into the tile's registers
// and no sum is copied back; an odd count of groups ends with one copy.
template <int NW, class R>
__device__ __forceinline__ void segment(R& ring, float (&acc)[NW / 2],
                                        float (&tmp)[NW / 2], const float* x,
                                        int ld, int K) {
  const int lane = threadIdx.x & 31;
  const float* x0 = x + (16 * ((threadIdx.x >> 5) & 3) + (lane >> 2)) * ld +
                    4 * (lane & 3);
  const float* x1 = x0 + 8 * ld;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 64) {
    group<NW>(ring, tmp, x0 + k0, x1 + k0);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) tmp[i] += acc[i];
    if (k0 + 32 < K) {
      group<NW>(ring, acc, x0 + k0 + 32, x1 + k0 + 32);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] += tmp[i];
    } else {
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = tmp[i];
    }
    NNC_PROF(4);
  }
}

// One step of reduce_scatter_g on v[0 .. M): the sums of this lane's values
// and those of the lane OFF apart; the lane with that bit set keeps the
// upper half, in v[0 .. M / 2).
template <int M, int OFF, int N>
__device__ __forceinline__ void reduce_step(float (&v)[N]) {
  const bool upper = (threadIdx.x & OFF) != 0;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float keep = upper ? v[i + M / 2] : v[i];
    const float send = upper ? v[i] : v[i + M / 2];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// The reduction over g (lane bits 2-4) of N values a thread, in a fixed
// order, as a reduce-scatter: after it lane 4 g + t holds, in v[0 .. N / 8),
// the sums over the eight lanes of t of values g N / 8 .. g N / 8 + N / 8.
template <int N>
__device__ __forceinline__ void reduce_scatter_g(float (&v)[N]) {
  reduce_step<N, 16>(v);
  reduce_step<N / 2, 8>(v);
  reduce_step<N / 4, 4>(v);
}

}  // namespace twg
}  // namespace nerf
