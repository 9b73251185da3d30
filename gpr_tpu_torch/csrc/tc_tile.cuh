// Tensor-core tile of the rank-k update R = A B^T in 3xTF32, for K2's
// products and last slice (fullchol.cu) and K5 (syrk.cu).
//
// One block of kTcThreads (two warpgroups) computes one 128x128 tile
// R[r][c] = sum_k A[r][k] B[c][k], with A and B each 128 rows of a row-major
// matrix read along k; warpgroup g takes rows 64 g .. 64 g + 63, all 128
// columns, by wgmma.m64n128k8 (tf32), A from registers and B from shared
// memory.  Both are K-major, the layout tf32 wgmma takes (it has no
// transposed form).
//
// Precision (ROADMAP's rule: an f32-grade tier, never one TF32 pass): every
// operand value x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), and each product is small*big + big*small +
// big*big, summed in FP32 by the tensor cores (3xTF32; the dropped
// small*small term is ~2^-22 of the product).  The sum runs in two levels as
// K2's FP32 version did: a fresh partial tile
// per k-slice (32 terms, 12 tensor-core accumulations), added into the
// running tile by IEEE FP32 adds: the tensor cores' own accumulation is the
// larger error, so their partials are kept short.
//
// Data movement: wgmma reads B from shared memory and would truncate FP32
// there, so B is split once per k-slice of 32, by all threads, into big and
// small tiles (no-swizzle K-major core matrices of 8 rows x 16 bytes) in one
// half of a double buffer while the tensor cores read the other; A never
// goes to the tensor cores through shared memory: each thread splits its
// own fragments in registers (3xTF32 triples the operand reads, and at k = 8
// B alone costs ~0.06 B of shared memory per FMA).  The raw slices arrive by
// cp.async through a ring of kTcStages slots, kTcStages - 1 slices ahead,
// so device-memory latency stays off the tensor cores' path.  One block
// barrier a slice.  Within a slice a thread holds the 8 adjacent k = 8t ..
// 8t + 7 (t = lane % 4) of each of its two A rows; step s of the slice
// feeds the pair 8t + 2s, 8t + 2s + 1 where the fragment layout names k = t
// and t + 4, and B's tiles are laid out to match (a permutation of the
// summation index, so the product is unchanged).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpr {

constexpr int kTcRows = 128;     // rows of A and of B per tile
constexpr int kTcK = 32;         // depth of one k-slice
constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kTcTileFloats = kTcRows * kTcK;    // one split tile of B
constexpr int kTcBufFloats = 2 * kTcTileFloats;  // B big, B small
constexpr int kTcBRows = kTcRows * kTcK / 8 / kTcThreads;  // 8-deep B row pieces per thread
constexpr int kTcStages = 4;                     // raw ring depth
constexpr int kTcRawLd = kTcK + 4;               // raw row: 16-byte aligned, conflict-free
constexpr int kTcRawFloats = 2 * kTcRows * kTcRawLd;  // raw A and B of one slice
// no-swizzle K-major core matrices: 8 rows x 4 tf32 (128 B); LBO steps along
// k (the two core matrices of an 8-deep step), SBO along 8-row groups
constexpr uint32_t kTcLbo = 128;
constexpr uint32_t kTcSbo = (kTcK / 4) * 128;
constexpr size_t kTcSmem =
    (2 * (size_t)kTcBufFloats + (size_t)kTcStages * kTcRawFloats) * sizeof(float);  // 212992 B

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small (+ a remainder below 2^-22 |x|), each half a tf32 value,
// cvt.rna.tf32.f32 of x and of x - big.  big is rounded on the integer units
// (cheaper to issue): half a tf32 ulp added to the magnitude and the 13 low
// bits cleared, bit for bit cvt.rna's for a finite x.  A NaN x can come out
// of that finite (the card's NaN 0x7fffffff carries into the sign bit), so
// small keeps cvt.rna, which leaves x - big a NaN: every product of x stays
// NaN, as a failed pivot's poison must.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// descriptor of an 8-deep step of a split B tile in shared memory
__device__ __forceinline__ uint64_t tc_desc(const float* step) {
  return (uint64_t)((smem_addr(step) & 0x3FFFF) >> 4) | ((uint64_t)(kTcLbo >> 4) << 16) |
         ((uint64_t)(kTcSbo >> 4) << 32);
}

// d (64 x 128, this warpgroup's rows) += a (64 x 8, registers) b (8 x 128,
// shared memory through desc); scale_d = 0 overwrites d instead.
__device__ __forceinline__ void wgmma_tf32(float d[64], const uint32_t a[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of d across the asynchronous wgmma
__device__ __forceinline__ void fence_operands(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Stage k-slice [k0, k0 + 32) of the 128 rows at A and at B (row stride
// ld) raw into one ring slot: A's rows, then B's.
__device__ __forceinline__ void tc_stage(float* slot, const float* A, const float* B, size_t ld,
                                         int k0) {
#pragma unroll
  for (int i = 0; i < kTcRows * kTcK / 4 / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / (kTcK / 4);
    const int q = e % (kTcK / 4);
    cp_async16(slot + r * kTcRawLd + 4 * q, A + (size_t)r * ld + k0 + 4 * q);
    cp_async16(slot + (kTcRows + r) * kTcRawLd + 4 * q, B + (size_t)r * ld + k0 + 4 * q);
  }
}

// The A fragments of the 4 steps of a raw slice, split: frag[s] big,
// frag[s + 4] small.  This thread's rows are 16 w + g and 16 w + g + 8
// (w = warp, g = lane / 4), at k = 8t .. 8t + 7.
__device__ __forceinline__ void tc_split_a(const float* slot, uint32_t frag[8][4]) {
  const int lane = threadIdx.x % 32;
  const float* p = slot + ((threadIdx.x / 32) * 16 + lane / 4) * kTcRawLd + 8 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 r0 = *reinterpret_cast<const float4*>(p + 4 * h);                 // row g
    const float4 r1 = *reinterpret_cast<const float4*>(p + 8 * kTcRawLd + 4 * h);  // row g + 8
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 2 * h + e;
      split_tf32(e ? r0.z : r0.x, frag[s][0], frag[s + 4][0]);
      split_tf32(e ? r1.z : r1.x, frag[s][1], frag[s + 4][1]);
      split_tf32(e ? r0.w : r0.y, frag[s][2], frag[s + 4][2]);
      split_tf32(e ? r1.w : r1.y, frag[s][3], frag[s + 4][3]);
    }
  }
}

// Piece u of a slice (row n = u / 4 at k = 8 t' .. 8 t' + 7, t' = u % 4),
// its values v, split into the big and small tiles of buf: its k = 8 t' + q
// goes to core matrix (n / 8, q), row n % 8, position t'.
__device__ __forceinline__ void tc_put_split(float* buf, int u, const float v[8]) {
  const int n = u / 4;
  float* dst = buf + (n / 8) * (kTcSbo / 4) + (n % 8) * 4 + u % 4;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint32_t big, small;
    split_tf32(v[q], big, small);
    dst[q * (kTcLbo / 4)] = __uint_as_float(big);
    dst[kTcTileFloats + q * (kTcLbo / 4)] = __uint_as_float(small);
  }
}

// B of a raw slice into the big and small tiles of buf: piece p of this
// thread is piece u = threadIdx.x + p kTcThreads.
__device__ __forceinline__ void tc_split_b(const float* slot, float* buf) {
#pragma unroll
  for (int p = 0; p < kTcBRows; ++p) {
    const int u = threadIdx.x + p * kTcThreads;
    const float* src = slot + (kTcRows + u / 4) * kTcRawLd + 8 * (u % 4);
    const float4 x0 = *reinterpret_cast<const float4*>(src);
    const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
    const float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    tc_put_split(buf, u, v);
  }
}

// The running tile of one thread, in wgmma's accumulator layout: warp w
// (rows 16 w + g and 16 w + g + 8 of the block, g = lane / 4) holds, for
// each n8 column block c, v[4c + f] at column 8 c + 2 t + (f & 1)
// (t = lane % 4) of row 16 w + g + 8 (f >> 1).
struct TcAcc {
  float v[64];
};

// run = sum_k A[r][k] B[c][k] over k in [0, nk * 32);
// rows and k must be in range and 16-byte aligned.  smem holds kTcSmem bytes
// of dynamic shared memory, 128-byte aligned.
__device__ __forceinline__ void tc_rank_tile(const float* A, const float* B, size_t ld, int nk,
                                             float* smem, TcAcc& run) {
  float* ring = smem + 2 * kTcBufFloats;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    run.v[i] = 0.0f;
    part[i] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) tc_stage(ring + s * kTcRawFloats, A, B, ld, s * kTcK);
    cp_async_commit();
  }
  cp_async_wait<kTcStages - 2>();  // slice 0 has landed (for this thread)
  __syncthreads();                 // ... for all
  uint32_t frag[8][4];
  tc_split_a(ring, frag);
  tc_split_b(ring, smem);
  cp_async_wait<kTcStages - 3>();  // slice 1 has landed (for this thread)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // split tiles -> wgmma
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const float* b_big = smem + (kt % 2) * kTcBufFloats;
    const float* b_small = b_big + kTcTileFloats;
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kTcK / 8; ++s) {  // the small terms first
      const int o = s * 2 * (kTcLbo / 4);
      wgmma_tf32(part, frag[s + 4], tc_desc(b_big + o), 1);
      wgmma_tf32(part, frag[s], tc_desc(b_small + o), 1);
      wgmma_tf32(part, frag[s], tc_desc(b_big + o), 1);
    }
    wgmma_commit();
    // slot kt % kTcStages was emptied in the last iteration: refill it
    if (kt + kTcStages - 1 < nk)
      tc_stage(ring + ((kt + kTcStages - 1) % kTcStages) * kTcRawFloats, A, B, ld,
               (kt + kTcStages - 1) * kTcK);
    cp_async_commit();
    const float* next = ring + ((kt + 1) % kTcStages) * kTcRawFloats;
    if (kt + 1 < nk) tc_split_b(next, smem + ((kt + 1) % 2) * kTcBufFloats);  // overlaps them
    wgmma_wait_all();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      run.v[i] += part[i];
      part[i] = 0.0f;
    }
    if (kt + 1 < nk) tc_split_a(next, frag);  // the fragments are free once the products are done
    cp_async_wait<kTcStages - 3>();  // slice kt + 2 has landed (for this thread)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // slices kt + 1 (split) and kt + 2 (raw) in place for all
  }
  cp_async_wait<0>();  // no copy may outlive the block's use of smem
}

// Write the running tile to out (128 x 128, row stride ldo).
__device__ __forceinline__ void tc_store(const TcAcc& run, float* out, size_t ldo) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int c = 0; c < kTcRows / 8; ++c) {
    *reinterpret_cast<float2*>(&out[(size_t)r * ldo + 8 * c + 2 * t]) =
        make_float2(run.v[4 * c], run.v[4 * c + 1]);
    *reinterpret_cast<float2*>(&out[(size_t)(r + 8) * ldo + 8 * c + 2 * t]) =
        make_float2(run.v[4 * c + 2], run.v[4 * c + 3]);
  }
}

}  // namespace gpr
