// The blocked factor-and-inverse of one small SPD tile in shared memory: the
// one copy shared by K7 crout_chol and K8 crout_chol_wi (crout.cu), and by K9
// fleet_fused (fleet.cu) for each panel's diagonal block, as the JAX package
// keeps one _crout_sweep (gpr_tpu/ops/pallas_batched.py:47-196) for its three
// fleet kernels.
//
// The tile sits in shared memory column-major, S[c ld + r] = A[r][c], padded
// with the identity to bp = 32 nt rows and columns (nt <= 4 block columns of
// 32), so that every width b = 1-128 runs one path; ld is a multiple of 4
// and 4 mod 32 (the float4s of one row of 8 columns fall on distinct banks).
// The padding lies after every real pivot, so it never hides a failure.
// crout_factor works in place, the lower triangle -> L, by block columns k:
// warp 0 subtracts panel k - 1's product from the diagonal block (the
// lookahead) and factors it in registers, a lane a row, with shuffles and no
// barrier per pivot (chol.cuh: diag_factor); meanwhile the other warps
// subtract panel k - 1 from the other trailing lower 32x32 tiles, a warp a
// tile, 32-term sums in registers (tile_update); then a thread a row solves
// the rows below the diagonal block (row_solve).  Two barriers a block column.
//
// With INV it also forms W = L^-1 on the way, by the same pieces: the tile
// carries bp more rows E below it (ld >= 2 bp), the identity at the start,
// and every step treats them as rows of the panel, so that they end as X with
// X L^T = I, X = L^-T = W^T: the tile updates of E's nonzero blocks (rows i <
// k, columns j >= k) join the other warps' trailing update, and E's rows up
// to the end of k's diagonal block join the row solve.  W costs the chain one
// more row solve, after the last block column.  W[r][c] = S[r ld + bp + c].
// (The warp's 32x32 inverse and the doubling joins of tri_inv.cuh, tried
// first, took as long as the factor itself, on the chain: PERF.md section 6.)
//
// Every function here is called by all kCroutThreads threads of a block.
//
// The pivot's scale is 1.0f / sqrtf(pivot), both correctly rounded: rsqrtf's
// 2-ulp error scales a whole column the same way, and over two panels it
// tripled the fleet MLL gradient's error on the H100 (PERF.md section 6).  A
// non-positive (or NaN) pivot gives NaN through sqrtf, with no clamp and no
// early exit, so every later pivot of the tile is NaN and so is its L[-1,
// -1]; W's rows take the scales too, so W[-1, -1] is NaN.
#pragma once

#include <cuda_runtime.h>

#include "chol.cuh"

namespace gpr {

constexpr int kCroutThreads = 256;
constexpr int kCroutWarps = kCroutThreads / 32;

// Lower 32x32 tile t, numbered row by row: (i, j), j <= i.
__device__ __forceinline__ void crout_tile(int t, int* i, int* j) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  *i = r;
  *j = t - r * (r + 1) / 2;
}

// S[c ld + r] = A[r, c] for c <= r < b, the identity beyond b, 0 above the
// diagonal of the diagonal blocks; only A's lower triangle is read.  A warp
// reads 32 columns of one row of A (coalesced); each thread issues 8 loads
// before it stores.  With INV also E = I.
template <bool INV = false>
__device__ __forceinline__ void crout_load(float* S, int ld, const float* A, size_t a_ld, int b) {
  constexpr int kT = kCroutThreads, kB = 8;
  const int nt = (b + kCholNb - 1) / kCholNb;
  const int total = nt * (nt + 1) / 2 * kCholNb * kCholNb;
  for (int base = threadIdx.x; base < total; base += kB * kT) {
    float v[kB];
    int at[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * kT;
      int ti, tj;
      crout_tile(idx >> 10, &ti, &tj);
      const int r = kCholNb * ti + ((idx >> 5) & 31), c = kCholNb * tj + (idx & 31);
      at[u] = c * ld + r;
      if (idx >= total) v[u] = 0.0f;
      else if (r < b && c < b) v[u] = r >= c ? A[(size_t)r * a_ld + c] : 0.0f;
      else v[u] = r == c ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u)
      if (base + u * kT < total) S[at[u]] = v[u];
  }
  if (INV) {
    const int bp = kCholNb * nt;
    for (int e = threadIdx.x; e < bp * bp; e += kT) {
      const int c = e / bp, r = e % bp;
      S[c * ld + bp + r] = r == c ? 1.0f : 0.0f;
    }
  }
}

// dst[r, c] = S[c ld + r] for c <= r < b, exactly 0 above the diagonal.
__device__ __forceinline__ void crout_store(const float* S, int ld, float* dst, size_t dst_ld, int b) {
  for (int e = threadIdx.x; e < b * b; e += kCroutThreads) {
    const int r = e / b, c = e % b;
    dst[(size_t)r * dst_ld + c] = c <= r ? S[c * ld + r] : 0.0f;
  }
}

// W[r, c] = S[r ld + bp + c] (X = W^T, from crout_factor with INV) for c <= r <
// b, exactly 0 above the diagonal.
__device__ __forceinline__ void crout_store_w(const float* S, int ld, int bp, float* dst, size_t dst_ld, int b) {
  for (int e = threadIdx.x; e < b * b; e += kCroutThreads) {
    const int r = e / b, c = e % b;
    dst[(size_t)r * dst_ld + c] = c <= r ? S[r * ld + bp + c] : 0.0f;
  }
}

// In place, the lower triangle of the padded tile S (nt block columns) -> L,
// and with INV the rows E below it -> W^T; the scales of the current diagonal
// block go to rd (32 floats).  Begins after a barrier (the tile loaded) and
// ends with one.
template <bool INV = false>
__device__ __forceinline__ void crout_factor(float* S, int ld, int nt, float* rd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, bp = kCholNb * nt;
  float* E = S + bp;
  for (int k = 0; k < nt; ++k) {
    float* Ck = S + kCholNb * k * ld;  // block column k, indexed by the tile's row
    float* Dk = Ck + kCholNb * k;
    const float* Pk = Ck - kCholNb * ld;  // panel k - 1
    if (warp == 0) {
      if (k > 0) {
        tile_update(Dk, ld, Pk + kCholNb * k, ld, Pk + kCholNb * k, ld, lane);
        __syncwarp();
      }
      diag_factor<1>(Dk, ld, rd, lane);
    }
    if (k > 0 && warp > 0) {
      int t = 0;
      for (int j = k; j < nt; ++j)
        for (int i = j; i < nt; ++i) {
          if (i == k && j == k) continue;
          if (t++ % (kCroutWarps - 1) == warp - 1)
            tile_update(S + kCholNb * (j * ld + i), ld, Pk + kCholNb * i, ld, Pk + kCholNb * j, ld, lane);
        }
      if (INV)  // E's blocks (i, j), i < k <= j: X[i][j] -= X[i][k-1] L[j][k-1]^T
        for (int j = k; j < nt; ++j)
          for (int i = 0; i < k; ++i)
            if (t++ % (kCroutWarps - 1) == warp - 1)
              tile_update(E + kCholNb * (j * ld + i), ld, Pk + bp + kCholNb * i, ld, Pk + kCholNb * j, ld, lane);
    }
    __syncthreads();
    // the rows below the diagonal block, then E's rows 0 .. 32 (k + 1) - 1
    const int lo = kCholNb * (k + 1), below = bp - lo, rows = below + (INV ? lo : 0);
    for (int e = threadIdx.x; e < rows; e += kCroutThreads)
      row_solve<1>(Ck, ld, e < below ? lo + e : bp + e - below, Dk, ld, rd, nullptr, 0, 0);
    __syncthreads();
  }
}

}  // namespace gpr
