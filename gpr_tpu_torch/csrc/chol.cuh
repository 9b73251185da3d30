// The device code of K19 tile_chol and K20 tile_chol_strips (chol.cu, which
// explains the scheme): one small SPD tile factored from its upper triangle
// in the shared memory of one 8-CTA thread-block cluster, a warp per 32-wide
// diagonal block.  K15 panel_factor and K17 panel_inplace (panel.cu) run the
// same factor on their 256-wide diagonal tile (K17 reading its lower
// triangle), and K12 leaf_chol (leaf.cu) its pieces: the warp's diagonal
// factor, the rows' solve and the 32x32 tile update.
//
// tile_chol_factor is called by every thread of the cluster; it leaves the
// factor in the CTAs' block columns, every panel's rows below its diagonal
// block in the workspace, and each thread with one cluster arrive that it
// has not waited on.
#pragma once
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace gpr {

constexpr int kCholNb = 32;                            // diagonal block: a warp, a lane a row
constexpr int kCholCluster = 8;                        // CTAs of the cluster, the portable maximum
constexpr int kCholThreads = 256;
constexpr int kCholWarps = kCholThreads / 32;
constexpr int kCholMaxN = 2 * kCholCluster * kCholNb;  // 512: two block columns a CTA
// A block column's stride is its rows + 4: the float4s of 8 columns at one
// row fall on distinct banks.
constexpr int kCholPad = 4;
// Shared memory (floats): the CTA's block columns (at most 544 rows at n =
// 512), a copy of the current panel (PT[m][row - 32 (k + 1)], the rows below
// its diagonal block, column-major as the block columns) and the diagonal
// block's 32 scales.  A factored panel is published once to a workspace in
// device memory (it stays in L2), one slot of kCholSlot floats per panel in
// PT's layout, and every CTA copies from there what it needs.
constexpr int kCholOwn = kCholNb * (kCholMaxN + kCholNb + 2 * kCholPad);
constexpr int kCholLdp = kCholMaxN - kCholNb;
constexpr int kCholSlot = kCholNb * kCholLdp;
constexpr int kCholSmemBytes = (kCholOwn + kCholSlot + kCholNb) * (int)sizeof(float);

// Block column j: the CTA that holds it, its column stride and its offset
// in that CTA's shared memory (column b first, then column 15 - b).
__device__ __forceinline__ int col_owner(int j) { return j < kCholCluster ? j : 2 * kCholCluster - 1 - j; }
__device__ __forceinline__ int col_ld(int j, int nt) { return kCholNb * (nt - j) + kCholPad; }
__device__ __forceinline__ int col_offset(int j, int nt) {
  return j < kCholCluster ? 0 : kCholNb * col_ld(col_owner(j), nt);
}

// Block column j of L into P: P[c ld + r] = L[j0 + r][j0 + c] = A[j0 + c][j0 +
// r] for r >= c, 0 above the diagonal; the identity beyond n.  Each thread
// issues 8 loads before it stores.
__device__ inline void load_column(const float* __restrict__ A, size_t lda, int n, int j, int nt, float* P) {
  const int ld = col_ld(j, nt), rows = kCholNb * (nt - j), total = kCholNb * rows, j0 = kCholNb * j;
  constexpr int kB = 8;
  for (int base = threadIdx.x; base < total; base += kB * kCholThreads) {
    float v[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * kCholThreads, c = idx / rows, r = idx - c * rows;
      const int gc = j0 + c, gr = j0 + r;
      if (gr < n && gc < n) v[u] = gr >= gc && idx < total ? A[(size_t)gc * lda + gr] : 0.0f;
      else v[u] = gr == gc ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * kCholThreads, c = idx / rows;
      if (idx < total) P[c * ld + idx - c * rows] = v[u];
    }
  }
}

// As load_column, from A's lower triangle: P[c ld + r] = A[j0 + r][j0 + c]
// for r >= c.  A warp reads 32 columns of one row of the block column
// (coalesced, where load_column's reads of a column stride by lda).
__device__ inline void load_column_lower(const float* __restrict__ A, size_t lda, int n, int j, int nt, float* P) {
  const int ld = col_ld(j, nt), rows = kCholNb * (nt - j), total = kCholNb * rows, j0 = kCholNb * j;
  constexpr int kB = 8;
  for (int base = threadIdx.x; base < total; base += kB * kCholThreads) {
    float v[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * kCholThreads, r = idx / kCholNb, c = idx % kCholNb;
      const int gr = j0 + r, gc = j0 + c;
      if (gr < n && gc < n) v[u] = gr >= gc && idx < total ? A[(size_t)gr * lda + gc] : 0.0f;
      else v[u] = gr == gc ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * kCholThreads;
      if (idx < total) P[(idx % kCholNb) * ld + idx / kCholNb] = v[u];
    }
  }
}

// Rows [32 j1, n_pad) of panel k from its workspace slot into PT: a warp four
// columns, a lane four float4 of each, all 16 loads issued before the stores.
__device__ inline void copy_panel(const float* __restrict__ W, float* PT, int k, int j1, int nt) {
  constexpr int kCols = kCholNb / kCholWarps, kChunks = (kCholLdp + 127) / 128;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = kCholNb * (j1 - k - 1), end = kCholNb * (nt - k - 1);
  const float* src = W + (size_t)k * kCholSlot;
  float4 v[kCols][kChunks];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int m = warp + c * kCholWarps, e = d0 + 4 * (lane + 32 * u);
      if (e < end) v[c][u] = __ldcg(reinterpret_cast<const float4*>(&src[m * kCholLdp + e]));
    }
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int m = warp + c * kCholWarps, e = d0 + 4 * (lane + 32 * u);
      if (e < end) *reinterpret_cast<float4*>(&PT[m * kCholLdp + e]) = v[c][u];
    }
}

// One warp factors the diagonal block at D (column stride ld) in place, lane
// i holding row i in registers; the scales 1 / sqrt(pivot) go to rd.  Lane u
// holds L[u][t] itself, so it computes its own pivot from its registers
// (piv) as soon as the last column before it is scaled: the chain from one
// pivot to the next is a shuffle, sqrtf, a division and an FMA or SW.  The
// shuffles that spread a column go out together, before the FMAs that use
// them.  K19 (SW = 1) updates by single FMAs, as the rank-1 steps of JAX's.
// Every lane updates all 32 entries of its row, with no test of the lane:
// an entry right of the diagonal (c > i) takes garbage, but only entries
// right of the diagonal ever read it, and they are not stored.
template <int SW>
__device__ __forceinline__ void diag_factor(float* D, int ld, float* rd, int lane) {
  float x[kCholNb];
#pragma unroll
  for (int c = 0; c < kCholNb; ++c) x[c] = c <= lane ? D[c * ld + lane] : 0.0f;
  float piv = x[0];
#pragma unroll
  for (int sb = 0; sb < kCholNb / SW; ++sb) {
    const int s0 = sb * SW;
#pragma unroll
    for (int t = s0; t < s0 + SW; ++t) {  // SW rank-1 steps confined to the strip
      const float d = 1.0f / sqrtf(__shfl_sync(0xffffffffu, piv, t));  // NaN below 0, inf at 0
      x[t] *= d;
      if (lane == 0) rd[t] = d;
      if (SW == 1 || t + 1 < s0 + SW) {
        piv = fmaf(-x[t], x[t], x[t + 1 < kCholNb ? t + 1 : t]);  // lane t + 1's, as its update below
      } else if (t + 1 < kCholNb) {
        float s = 0.0f;
#pragma unroll
        for (int v = s0; v < s0 + SW; ++v) s = fmaf(x[v], x[v], s);
        piv = x[t + 1] - s;  // lane t + 1's, as the rank-SW update below
      }
      float l[kCholNb];
#pragma unroll
      for (int u = t + 1; u < (SW == 1 ? kCholNb : s0 + SW); ++u) l[u] = __shfl_sync(0xffffffffu, x[t], u);
#pragma unroll
      for (int u = t + 1; u < (SW == 1 ? kCholNb : s0 + SW); ++u) x[u] = fmaf(-x[t], l[u], x[u]);
    }
    if (SW > 1) {
#pragma unroll
      for (int u = s0 + SW; u < kCholNb; ++u) {  // one rank-SW update of the later columns
        float l[SW], s = 0.0f;
#pragma unroll
        for (int t = 0; t < SW; ++t) l[t] = __shfl_sync(0xffffffffu, x[s0 + t], u);
#pragma unroll
        for (int t = 0; t < SW; ++t) s = fmaf(x[s0 + t], l[t], s);
        x[u] -= s;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCholNb; ++c)
    if (c <= lane) D[c * ld + lane] = x[c];
}

// Row r of the tile X (column stride ldx): x L_kk^T = a by the diagonal
// block D's (column stride ldd) strips and scales, in registers, reading
// L_kk's columns as float4 broadcasts; the row goes back to X and, unless Wj
// is null, to Wj[c * ldw + wr] (a panel's workspace slot).  K19 and K20 pass
// their block column as both X and D.
template <int SW>
__device__ __forceinline__ void row_solve(float* X, int ldx, int r, const float* D, int ldd, const float* rd,
                                          float* __restrict__ Wj, int ldw, int wr) {
  float x[kCholNb];
#pragma unroll
  for (int c = 0; c < kCholNb; ++c) x[c] = X[c * ldx + r];
#pragma unroll
  for (int sb = 0; sb < kCholNb / SW; ++sb) {
    const int s0 = sb * SW;
#pragma unroll
    for (int t = s0; t < s0 + SW; ++t) {
      x[t] *= rd[t];
#pragma unroll
      for (int u = t + 1; u < s0 + SW; ++u) x[u] = fmaf(-x[t], D[t * ldd + u], x[u]);
    }
#pragma unroll
    for (int q = (s0 + SW) / 4; q < kCholNb / 4; ++q) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = s0; t < s0 + SW; ++t) {
        const float4 l4 = *reinterpret_cast<const float4*>(&D[t * ldd + 4 * q]);
        const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (SW == 1 && 4 * q + e > t) x[4 * q + e] = fmaf(-x[t], l[e], x[4 * q + e]);
          if (SW > 1) s[e] = fmaf(x[t], l[e], s[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (SW > 1 && 4 * q + e >= s0 + SW) x[4 * q + e] -= s[e];
    }
  }
#pragma unroll
  for (int c = 0; c < kCholNb; ++c) X[c * ldx + r] = x[c];
  if (Wj != nullptr)
#pragma unroll
    for (int c = 0; c < kCholNb; ++c) Wj[c * ldw + wr] = x[c];
}

// out (32x32, column stride ld) -= Pi Pj^T, Pi and Pj 32-row tiles stored
// column-major with column strides ldi and ldj (K19/K20: 32 rows of the
// panel's copy PT): lane (rg, cg) takes rows 4 rg .. 4 rg + 3 and columns 8
// cg .. 8 cg + 7, three float4 loads a step for 32 FMAs.
__device__ __forceinline__ void tile_update(float* out, int ld, const float* Pi, int ldi, const float* Pj, int ldj,
                                            int lane) {
  const int rg = lane & 7, cg = lane >> 3;
  float acc[4][8] = {};
#pragma unroll 8
  for (int m = 0; m < kCholNb; ++m) {
    const float4 a = *reinterpret_cast<const float4*>(&Pi[m * ldi + 4 * rg]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Pj[m * ldj + 8 * cg]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Pj[m * ldj + 8 * cg + 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    float4* o = reinterpret_cast<float4*>(&out[(8 * cg + y) * ld + 4 * rg]);
    float4 v = *o;
    v.x -= acc[0][y];
    v.y -= acc[1][y];
    v.z -= acc[2][y];
    v.w -= acc[3][y];
    *o = v;
  }
}

// Columns 8 q .. 8 q + 7 of tile_update's product, one warp of four that
// share a tile: lane (rg, cs) takes rows 4 rg .. 4 rg + 3 and columns 8 q + 2
// cs, + 1; the same 32-term sums in the same order.
__device__ __forceinline__ void tile_update_cols(float* out, int ld, const float* Pi, int ldi, const float* Pj,
                                                 int ldj, int lane, int q) {
  const int rg = lane & 7, c0 = 8 * q + 2 * (lane >> 3);
  float acc[4][2] = {};
#pragma unroll 8
  for (int m = 0; m < kCholNb; ++m) {
    const float4 a = *reinterpret_cast<const float4*>(&Pi[m * ldi + 4 * rg]);
    const float2 b = *reinterpret_cast<const float2*>(&Pj[m * ldj + c0]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc[x][0] = fmaf(av[x], b.x, acc[x][0]);
      acc[x][1] = fmaf(av[x], b.y, acc[x][1]);
    }
  }
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    float4* o = reinterpret_cast<float4*>(&out[(c0 + y) * ld + 4 * rg]);
    float4 v = *o;
    v.x -= acc[0][y];
    v.y -= acc[1][y];
    v.z -= acc[2][y];
    v.w -= acc[3][y];
    *o = v;
  }
}

// The CTA's tiles of block columns cols[0 .. nc) (ascending, each > k) less
// the products of panel k: a warp a tile.
__device__ inline void update_columns(float* smem, const float* PT, const int* cols, int nc, int k, int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, p0 = kCholNb * (k + 1);
  const int n0 = nc > 0 ? nt - cols[0] : 0, total = n0 + (nc > 1 ? nt - cols[1] : 0);
  for (int t = warp; t < total; t += kCholWarps) {
    const int j = t < n0 ? cols[0] : cols[1], i = j + (t < n0 ? t : t - n0);
    tile_update(smem + col_offset(j, nt) + kCholNb * (i - j), col_ld(j, nt), PT + kCholNb * i - p0, kCholLdp,
                PT + kCholNb * j - p0, kCholLdp, lane);
  }
}

// The diagonal step of block column j, held by this CTA, with panel j - 1 in
// PT (none for j = 0): warp 0 updates the diagonal block and factors it while
// the other warps update the blocks below; then a thread a row solves them
// and publishes its row to the panel's workspace slot.
template <int SW>
__device__ void factor_column(float* smem, const float* PT, float* rd, float* W, int j, int nt) {
  float* P = smem + col_offset(j, nt);
  const int ld = col_ld(j, nt), rows = kCholNb * (nt - j), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    if (j > 0) {
      tile_update(P, ld, PT, kCholLdp, PT, kCholLdp, lane);
      __syncwarp();
    }
    diag_factor<SW>(P, ld, rd, lane);
  } else if (j > 0) {
    for (int i = j + warp; i < nt; i += kCholWarps - 1)
      tile_update(P + kCholNb * (i - j), ld, PT + kCholNb * (i - j), kCholLdp, PT, kCholLdp, lane);
  }
  __syncthreads();
  float* Wj = j + 1 < nt ? W + (size_t)j * kCholSlot : nullptr;
  for (int r = kCholNb + threadIdx.x; r < rows; r += kCholThreads)
    row_solve<SW>(P, ld, r, P, ld, rd, Wj, kCholLdp, r - kCholNb);
  __threadfence();  // this thread's rows of the slot are written before its arrive
  __syncthreads();
}

// Output columns 32 j .. 32 j + 31 of L, every row: a lane a column, a warp
// four rows at a time (one float4 of the block column, four coalesced rows).
__device__ inline void store_column(float* __restrict__ L, size_t ldl, int n, int j, int nt, const float* P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ld = col_ld(j, nt), j0 = kCholNb * j;
  const int gc = j0 + lane;
  if (gc >= n) return;
  for (int g = 4 * warp; g < n; g += 4 * kCholWarps) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g >= j0) v = *reinterpret_cast<const float4*>(&P[lane * ld + g - j0]);
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (g + t < n) L[(size_t)(g + t) * ldl + gc] = g + t >= gc ? vs[t] : 0.0f;
  }
}

// Load A (its upper triangle, or with LOWER its lower triangle; row stride
// lda) into the CTAs' block columns and factor it there; W the workspace, nt
// - 1 slots.  Returns this CTA's block columns (ascending) in own[0 .. *no).
// A CTA reads only its own block columns of A.
template <int SW, bool LOWER = false>
__device__ __forceinline__ void tile_chol_factor(const float* __restrict__ A, size_t lda, float* W, int n, float* smem, int own[2],
                                 int* no) {
  float* PT = smem + kCholOwn;
  float* rd = PT + kCholSlot;
  const int rank = cluster_rank(), nt = (n + kCholNb - 1) / kCholNb;
  *no = 0;
  if (rank < nt) own[(*no)++] = rank;
  if (2 * kCholCluster - 1 - rank < nt) own[(*no)++] = 2 * kCholCluster - 1 - rank;

  for (int s = 0; s < *no; ++s) {
    if constexpr (LOWER) load_column_lower(A, lda, n, own[s], nt, smem + col_offset(own[s], nt));
    else load_column(A, lda, n, own[s], nt, smem + col_offset(own[s], nt));
  }
  __syncthreads();
  if (rank == 0) factor_column<SW>(smem, PT, rd, W, 0, nt);
  cluster_arrive();
  for (int k = 0; k + 1 < nt; ++k) {
    cluster_wait();  // panel k is in its slot
    int cols[2], nc = 0;
    for (int s = 0; s < *no; ++s)
      if (own[s] > k) cols[nc++] = own[s];
    if (nc == 0) {
      cluster_arrive();
      continue;
    }
    copy_panel(W, PT, k, cols[0], nt);
    __syncthreads();
    if (cols[0] == k + 1) {  // the next diagonal step first
      factor_column<SW>(smem, PT, rd, W, k + 1, nt);
      cluster_arrive();
      update_columns(smem, PT, cols + 1, nc - 1, k, nt);
    } else {
      update_columns(smem, PT, cols, nc, k, nt);
      cluster_arrive();
    }
    __syncthreads();  // PT is read up to here
  }
}

}  // namespace gpr
