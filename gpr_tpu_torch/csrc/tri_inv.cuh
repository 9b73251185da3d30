// The blocked triangular inverse's device code: a warp's inverse of one 32x32
// lower-triangular diagonal block, and the staged 64x64 register-tile product
// that joins two inverted blocks by
//   inv([[A, 0], [C, D]]) = [[inv A, 0], [-inv(D) C inv(A), inv D]]
// (the identity JAX uses, pallas_solve.py:213-227).  K11 diag_tri_inv
// (solve.cu) inverts the diagonal tiles of a factor with them, K14
// tri_inv_leaf and K13 leaf_chol_wi (leaf.cu) the whole factor of a leaf.
// Every function is inline, so that both sources link into one library.
#pragma once

#include <cuda_runtime.h>

namespace gpr {

constexpr int kInvNb = 32;          // diagonal block width, the longest dependent chain
constexpr int kInvDiagWarps = 4;    // diagonal blocks of one CTA
constexpr int kInvCb = 64;          // output tile of a level: 64 x 64, 4 x 4 a thread
constexpr int kInvK = 32;           // depth of a staged chunk, the first level of every sum
constexpr int kInvThreads = 256;
constexpr int kInvLd = kInvCb + 4;  // shared row: 16-byte aligned float4 reads

// The inverse of the w x w diagonal block at T (row stride ld, w <= 32; its
// lower triangle read, padded with I past w) into s[r][c], on one warp: lane
// i holds row i of the block and of its inverse; row m of the inverse is
// final once scaled by 1 / L[m][m], then every lower row subtracts L[i][m]
// times it (moved by shuffles).  Entries above the diagonal are never
// touched and stay exactly 0.  Ends with the warp synchronised.
__device__ __forceinline__ void warp_tri_inv32(const float* T, int ld, int w, float (*s)[kInvNb + 1]) {
  const int lane = threadIdx.x % 32;
  // rows r coalesced along the lanes; the strict upper is masked, not read
  for (int r = 0; r < kInvNb; ++r)
    s[r][lane] = (r < w && lane < w) ? (lane <= r ? T[(size_t)r * ld + lane] : 0.0f)
                                     : (lane == r ? 1.0f : 0.0f);
  __syncwarp();
  float a[kInvNb], v[kInvNb];
#pragma unroll
  for (int m = 0; m < kInvNb; ++m) {
    a[m] = s[lane][m];
    v[m] = (m == lane) ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < kInvNb; ++m) {
    const float sc = (lane == m) ? 1.0f / a[m] : 1.0f;
#pragma unroll
    for (int c = 0; c <= m; ++c) {
      v[c] *= sc;
      const float wmc = __shfl_sync(0xffffffffu, v[c], m);
      if (lane > m) v[c] = fmaf(-a[m], wmc, v[c]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kInvNb; ++m) s[lane][m] = v[m];
  __syncwarp();
}

// As[k][r] = M[r][k] for r < rows, k < cols of the row-major M (row stride
// ld), 0 elsewhere; 64 rows x 32 columns, each warp one row at a time
// (coalesced).  In two halves, so that a kernel can keep the next chunk's
// loads in flight while it computes on this one: inv_load_t, the eight loads
// of a thread into v, then inv_put_t, their stores.  With kL2 the loads go
// through L2 only (data that other CTAs of the same launch wrote: L1 is not
// coherent between SMs).
template <bool kL2 = false>
__device__ __forceinline__ void inv_load_t(float v[8], const float* M, size_t ld, int rows, int cols) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int e = threadIdx.x + u * kInvThreads, r = e / kInvK, k = e % kInvK;
    v[u] = (r < rows && k < cols) ? (kL2 ? __ldcg(M + (size_t)r * ld + k) : M[(size_t)r * ld + k]) : 0.0f;
  }
}

__device__ __forceinline__ void inv_put_t(float* As, const float v[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int e = threadIdx.x + u * kInvThreads;
    As[(e % kInvK) * kInvLd + e / kInvK] = v[u];
  }
}

__device__ __forceinline__ void inv_stage_t(float* As, const float* M, size_t ld, int rows, int cols) {
  float v[8];
  inv_load_t(v, M, ld, rows, cols);
  inv_put_t(As, v);
}

// Bs[k][c] = M[k][c] for k < rows, c < cols, 0 elsewhere; 32 rows x 64
// columns; in two halves as inv_stage_t.
__device__ __forceinline__ void inv_load(float v[8], const float* M, size_t ld, int rows, int cols) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int e = threadIdx.x + u * kInvThreads, k = e / kInvCb, c = e % kInvCb;
    v[u] = (k < rows && c < cols) ? M[(size_t)k * ld + c] : 0.0f;
  }
}

__device__ __forceinline__ void inv_put(float* Bs, const float v[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int e = threadIdx.x + u * kInvThreads;
    Bs[(e / kInvCb) * kInvLd + e % kInvCb] = v[u];
  }
}

__device__ __forceinline__ void inv_stage(float* Bs, const float* M, size_t ld, int rows, int cols) {
  float v[8];
  inv_load(v, M, ld, rows, cols);
  inv_put(Bs, v);
}

// acc[a][b] += sum_{k < 32} As[k][4 ty + a] Bs[k][4 tx + b], the chunk's 32
// terms summed apart first (the first level of the sum).
__device__ __forceinline__ void inv_chunk(const float* As, const float* Bs, float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float part[4][4] = {};
#pragma unroll 8
  for (int k = 0; k < kInvK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k * kInvLd + 4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k * kInvLd + 4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

}  // namespace gpr
