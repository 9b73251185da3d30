// K2-K4: left-looking panel Cholesky of K(X, X) + diag*I (Gram mode) or of a
// given SPD matrix A (matrix mode), one panel of 128 columns at a time.
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_fullchol.py::_fused_kernel
// (line 722), launched once per factorization by _call_fused (1125).  On the
// TPU the whole factorization is one dispatch whose sequential grid walks
// the panels; here the host walks them and launches three kernels per panel
// on PyTorch's current stream, whose order takes the place of the TPU grid's
// "arbitrary" (sequential) semantics:
//
//   K2 panel_update     P = S - L[rows, :jp] L[panel, :jp]^T, written into
//                       column block j of L; zeros into L[:jp, panel].
//   K3 diag_factor_inv  L_jj = chol(P_jj) and W_j = inv(L_jj) in shared memory.
//   K4 panel_solve      L[r, panel] = P[r, :] W_j^T for the rows below.
//
// The TPU's bf16 hi|lo slab, its DMA/semaphore choreography and its chunk,
// group and diagonal-scheme knobs are TPU artifacts and have no counterpart.
//
// What bounds it on the H100, and what the design does about it:
//   * K2's update is n^3/3 FLOPs over a factorization and compute bound.  It
//     runs on the tensor cores in 3xTF32 (tc_tile.cuh: wgmma.m64n128k8, A
//     split in registers, B split once per k-slice into shared memory, a
//     cp.async ring, two-level sums), one 128x128 tile a block at a time, so
//     its bound is the FLOPs at 495/3 = 165 TFLOP/s (against 67 for FP32
//     FMA).  A late panel has few row tiles but a deep k range, an early one
//     many tiles and a short range, so the work is cut in 128-deep slices of
//     each tile and dealt out evenly to one block per SM
//     (ops/fullchol.py::_split_plan): a tile's k range is split into the
//     pieces its blocks hold, each written to a scratch slot, and a second
//     kernel in stream order builds S (gram_tile.cuh in Gram mode),
//     subtracts the tile's pieces in a fixed order and writes P.  No
//     atomics: L is bit-identical from call to call.  The two kernels are one
//     counted K2 launch.
//   * K3 is a latency-bound chain on one SM while the rest of the card waits
//     for it.  It factors the 128x128 block by four 32-wide diagonal blocks:
//     one warp factors each 32x32 block in registers with shuffles (no block
//     barrier), the rows below solve against it and the trailing update runs
//     as products on all warps, the four diagonal inverses run side by side
//     on four warps, and W's off-diagonal blocks come from products in
//     block-row order: 18 block barriers a panel in place of the first
//     design's 512.
//   * K4 is a small GEMM per panel in plain FP32 FMA.
//
// Contracts kept from the TPU kernel:
//   * matrix mode reads only A[r, c] with r >= c (potrf 'L');
//   * the strict upper triangle of L is written as exact zeros;
//   * a non-positive pivot gives NaN through sqrtf (no clamp, no early exit),
//     which reaches W_j, every later panel and so L[-1, -1];
//   * in Gram mode rows and columns >= n_true are the pad block: the strip is
//     [[K, 0], [0, scale^2 I]] + diag*I, so L[:n_true, :n_true] is exact.
#include "gram_tile.cuh"
#include "tc_tile.cuh"

namespace gpr {

constexpr int kPanel = 128;
constexpr int kMatrixMode = -1;
constexpr int kDiagThreads = 512;
constexpr int kDiagWarps = kDiagThreads / 32;
constexpr int kDiagLd = kPanel + 4;  // K3's smem row: see the K3 section
constexpr int kNb = 32;              // K3's diagonal block
constexpr size_t kDiagSmem = (2 * kPanel * kDiagLd + 3 * kNb * kNb) * sizeof(float);
constexpr int kSolveRows = 64;
constexpr int kSolveLd = kPanel + 4;
static_assert(kTcRows == kPanel, "K2's tensor-core tile is one panel wide");

// ---------------------------------------------------------------- K2 -------
// (a) the products.  grid (blocks); block (kTcThreads); dynamic shared
// memory kTcSmem.  Panel j has T = (n_pad - jp) / 128 row tiles of j
// 128-deep slices each, U = T j units in tile-major order.  Block b
// takes units [b U / blocks, (b + 1) U / blocks): for each tile t they
// touch, it sums L[jp + 128 t + r, k] L[jp + c, k] over its k range into
// scratch slot b + t (128 x 128).  Every block gets the same work to within
// one unit, so the narrow late panels fill the card as the wide early ones.
__global__ void __launch_bounds__(kTcThreads, 1)
    panel_products_kernel(const float* __restrict__ L, float* __restrict__ part, int n_pad,
                          int j, int blocks) {
  extern __shared__ __align__(128) float tc_smem[];
  const int jp = j * kPanel;
  const long long units = (long long)(n_pad - jp) / kPanel * j;
  const int b = blockIdx.x;
  const int u0 = (int)(b * units / blocks);
  const int u1 = (int)((b + 1) * units / blocks);
  for (int t = u0 / j; t <= (u1 - 1) / j; ++t) {
    const int lo = max(u0, t * j) - t * j;
    const int hi = min(u1, (t + 1) * j) - t * j;
    const float* A = L + (size_t)(jp + t * kTcRows) * n_pad + lo * kPanel;
    const float* B = L + (size_t)jp * n_pad + lo * kPanel;
    TcAcc run;
    tc_rank_tile(A, B, n_pad, (hi - lo) * (kPanel / kTcK), tc_smem, run);
    tc_store(run, part + (size_t)(b + t) * kTcRows * kPanel, kPanel);
  }
}

// (b) the strip.  grid (kPanel / kTile, n_pad / kTile); block (kThreads).
// S, minus the pieces of its row tile in block order (the order of k), into
// column block j of L; exact zeros above it.
template <int FORM>
__global__ void __launch_bounds__(kThreads)
    panel_strip_kernel(const float* __restrict__ src, float* __restrict__ L,
                       const float* __restrict__ part, int n_pad, int n_true, int d, int j,
                       int blocks, GramParams par, float diag) {
  __shared__ TileSmem sm;
  const int jp = j * kPanel;
  const int row0 = blockIdx.y * kTile;
  const int col0 = jp + blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  if (row0 < jp) {  // strict upper of this column block: exact zeros
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(&L[(size_t)(row0 + ty * kPer + i) * n_pad + col0 + tx * kPer]) = z;
    }
    return;
  }

  // 1. the strip S
  float acc[kPer][kPer];
  if constexpr (FORM == kMatrixMode) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c4 = 0; c4 < kPer; ++c4) {
        const int r = row0 + ty * kPer + i;
        const int c = col0 + tx * kPer + c4;
        // mirror the diagonal block from its lower half
        acc[i][c4] = (r >= c) ? src[(size_t)r * n_pad + c] : src[(size_t)c * n_pad + r];
      }
  } else {
    gram_tile<FORM>(src, n_true, row0, src, n_true, col0, d, par, sm, acc);
    const float pad_diag = diag + par.scale * par.scale;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c4 = 0; c4 < kPer; ++c4) {
        const int r = row0 + ty * kPer + i;
        const int c = col0 + tx * kPer + c4;
        float v = (r >= n_true || c >= n_true) ? 0.0f : acc[i][c4];
        if (r == c) v += (r >= n_true) ? pad_diag : diag;
        acc[i][c4] = v;
      }
  }

  // 2. minus the pieces of this row tile, in a fixed order: blocks b_lo ..
  // b_hi hold units t j .. t j + j - 1 (the block of unit u is
  // ((u + 1) blocks - 1) / U), in slots b + t
  if (blocks > 0) {
    const int t = (row0 - jp) / kPanel;
    const long long units = (long long)(n_pad - jp) / kPanel * j;
    const int b_lo = (int)(((long long)t * j + 1) * blocks - 1) / units;
    const int b_hi = (int)(((long long)(t + 1) * j * blocks - 1) / units);
    const int r0 = (row0 - jp) % kPanel + ty * kPer;
    const int c0 = blockIdx.x * kTile + tx * kPer;
    for (int b = b_lo; b <= b_hi; ++b) {
      const float* p = part + (size_t)(b + t) * kPanel * kPanel;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(&p[(r0 + i) * kPanel + c0]);
        acc[i][0] -= v.x;
        acc[i][1] -= v.y;
        acc[i][2] -= v.z;
        acc[i][3] -= v.w;
      }
    }
  }

  // 3. P into column block j of L
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&L[(size_t)(row0 + ty * kPer + i) * n_pad + col0 + tx * kPer]) = v;
  }
}

// ---------------------------------------------------------------- K3 -------
// Shared memory rows are kDiagLd = 132 floats: 16-byte aligned, and a
// quarter-warp's float4 loads of 8 consecutive rows land on distinct banks.
// Every product below is written O[x][y] = sum_m P[x][m] Q[y][m] or
// sum_m P[x][m] Q[m][y] with lane = y: P's rows are broadcast float4 loads
// shared by the lanes, Q's rows float4 loads (or its columns consecutive
// words), and each thread keeps several rows x in registers, so that a
// shared load feeds 2-4 FMAs.

// One warp factors the SPD 32x32 block at a (row stride kDiagLd, lower
// triangle read) into L_bb over a, strict upper written 0.  Lane i holds row
// i in registers and column k moves by shuffles: no block barrier.
__device__ __forceinline__ void warp_chol32(float* a, int lane) {
  float r[kNb];
#pragma unroll
  for (int m = 0; m < kNb; m += 4) {
    const float4 x = *reinterpret_cast<const float4*>(&a[lane * kDiagLd + m]);
    r[m] = (m <= lane) ? x.x : 0.0f;
    r[m + 1] = (m + 1 <= lane) ? x.y : 0.0f;
    r[m + 2] = (m + 2 <= lane) ? x.z : 0.0f;
    r[m + 3] = (m + 3 <= lane) ? x.w : 0.0f;
  }
  // right-looking: pivot k scales column k, then updates the trailing lower
  // triangle with column k (L[m][k] from lane m)
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const float piv = sqrtf(__shfl_sync(0xffffffffu, r[k], k));  // < 0 or NaN -> NaN, kept
    if (lane == k) r[k] = piv;
    else if (lane > k) r[k] /= piv;
#pragma unroll
    for (int m = k + 1; m < kNb; ++m) {
      const float lmk = __shfl_sync(0xffffffffu, r[k], m);
      if (lane >= m) r[m] = fmaf(-r[k], lmk, r[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kNb; m += 4)  // r's strict upper is exactly 0
    *reinterpret_cast<float4*>(&a[lane * kDiagLd + m]) = make_float4(r[m], r[m + 1], r[m + 2], r[m + 3]);
}

// One warp writes inv(L_bb) of the factored 32x32 block at a into w, by
// rows: lane i holds row i of L_bb and of the inverse; row m of the inverse
// is final once scaled by 1 / L[m][m], then every lower row subtracts
// L[i][m] times it (moved by shuffles).  Entries above the diagonal stay 0.
__device__ __forceinline__ void warp_inv32(const float* a, float* w, int lane) {
  float r[kNb], v[kNb];
#pragma unroll
  for (int m = 0; m < kNb; m += 4) {
    const float4 x = *reinterpret_cast<const float4*>(&a[lane * kDiagLd + m]);
    r[m] = x.x;
    r[m + 1] = x.y;
    r[m + 2] = x.z;
    r[m + 3] = x.w;
  }
#pragma unroll
  for (int m = 0; m < kNb; ++m) v[m] = (m == lane) ? 1.0f : 0.0f;
#pragma unroll
  for (int m = 0; m < kNb; ++m) {
    const float sc = (lane == m) ? 1.0f / r[m] : 1.0f;
#pragma unroll
    for (int c = 0; c <= m; ++c) {
      v[c] *= sc;
      const float wmc = __shfl_sync(0xffffffffu, v[c], m);
      if (lane > m) v[c] = fmaf(-r[m], wmc, v[c]);
    }
  }
#pragma unroll
  for (int m = 0; m < kNb; m += 4)
    *reinterpret_cast<float4*>(&w[lane * kDiagLd + m]) = make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
}

// One thread solves its row x of the block column below a factored diagonal
// block in place: x L_bb^T = a_row, by forward substitution over the 32
// columns (L_bb's rows read as broadcast float4 loads).
__device__ __forceinline__ void row_solve32(float* row, const float* lbb) {
  float x[kNb];
#pragma unroll
  for (int m = 0; m < kNb; m += 4) {
    const float4 v = *reinterpret_cast<const float4*>(&row[m]);
    x[m] = v.x;
    x[m + 1] = v.y;
    x[m + 2] = v.z;
    x[m + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    const float* lc = lbb + c * kDiagLd;
    float s0 = x[c], s1 = 0.0f;
#pragma unroll
    for (int m = 0; m + 4 <= c; m += 4) {
      const float4 l4 = *reinterpret_cast<const float4*>(&lc[m]);
      s0 = fmaf(-x[m], l4.x, s0);
      s1 = fmaf(-x[m + 1], l4.y, s1);
      s0 = fmaf(-x[m + 2], l4.z, s0);
      s1 = fmaf(-x[m + 3], l4.w, s1);
    }
#pragma unroll
    for (int m = c & ~3; m < c; ++m) s0 = fmaf(-x[m], lc[m], s0);
    x[c] = (s0 + s1) / lc[c];
  }
#pragma unroll
  for (int m = 0; m < kNb; m += 4)
    *reinterpret_cast<float4*>(&row[m]) = make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
}

// acc[i] += sum_{m < 32} P[rows[i]][m] Q[lane][m]: P and Q rows of stride kDiagLd
template <int R>
__device__ __forceinline__ void rows_by_rows32(const float* P, const int rows[R], const float* Q,
                                               float acc[R], int lane) {
#pragma unroll
  for (int m = 0; m < kNb; m += 4) {
    const float4 q = *reinterpret_cast<const float4*>(&Q[lane * kDiagLd + m]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(&P[rows[i] * kDiagLd + m]);
      acc[i] = fmaf(p.x, q.x, acc[i]);
      acc[i] = fmaf(p.y, q.y, acc[i]);
      acc[i] = fmaf(p.z, q.z, acc[i]);
      acc[i] = fmaf(p.w, q.w, acc[i]);
    }
  }
}

// grid (1); block (kDiagThreads); dynamic shared memory kDiagSmem.
//
// Blocked right-looking on the 128x128 block in shared memory, by four
// 32-wide diagonal blocks b: warp 0 factors block b; one thread a row solves
// the block column below it against L_bb (L_ib = A_ib L_bb^-T); all warps
// apply the trailing lower update A_ik -= L_ib L_kb^T as products.  Then
// four warps invert the four diagonal blocks side by side (D_b =
// inv(L_bb)), and W = inv(L_jj) follows by block rows as products:
// W_ib = -D_i sum_{b <= m < i} L_im W_mb.  18 block barriers in all.
__global__ void __launch_bounds__(kDiagThreads, 1)
    diag_factor_inv_kernel(float* __restrict__ L, float* __restrict__ W, int n_pad, int j) {
  extern __shared__ __align__(16) float smem[];
  float* A = smem;                     // P_jj, factored in place (lower triangle)
  float* V = smem + kPanel * kDiagLd;  // inv(L_jj), lower triangle; strict upper 0
  float* T = V + kPanel * kDiagLd;     // 3 blocks of 32 x 32: W products
  const int jp = j * kPanel;
  float* Ljj = L + (size_t)jp * n_pad + jp;
  float* Wj = W + (size_t)j * kPanel * kPanel;
  constexpr int kGroups = kDiagThreads / kPanel;  // 4 row groups
  constexpr int kRows = kPanel / kGroups;         // 32 rows per thread
  constexpr int kMaxRows = (kPanel - kNb) / kDiagWarps;  // 6 rows of a warp below a block
  const int l = threadIdx.x % kPanel;
  const int rg = threadIdx.x / kPanel;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  {
    float x[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) x[s] = Ljj[(size_t)(rg + kGroups * s) * n_pad + l];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int r = rg + kGroups * s;
      A[r * kDiagLd + l] = (l <= r) ? x[s] : 0.0f;
      V[r * kDiagLd + l] = 0.0f;
    }
  }
  __syncthreads();

  for (int b = 0; b < kPanel / kNb; ++b) {
    const int c0 = b * kNb;
    if (warp == 0) warp_chol32(A + c0 * kDiagLd + c0, lane);
    __syncthreads();
    if (c0 + kNb == kPanel) break;

    // the block column below, one row a thread: L[r][c0 ..] L_bb^T = A[r][c0 ..]
    if (threadIdx.x < kPanel - c0 - kNb)
      row_solve32(A + (c0 + kNb + threadIdx.x) * kDiagLd + c0, A + c0 * kDiagLd + c0);
    __syncthreads();

    // the trailing lower triangle: A[r][c] -= sum_m L[r][c0 + m] L[c][c0 + m]
    for (int q = b + 1; q < kPanel / kNb; ++q) {
      const int c = q * kNb + lane;
      float acc[kMaxRows];
      int rows[kMaxRows];
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        rows[i] = min(q * kNb + warp + kDiagWarps * i, kPanel - 1);
        acc[i] = 0.0f;
      }
      rows_by_rows32<kMaxRows>(A + c0, rows, A + q * kNb * kDiagLd + c0, acc, lane);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        const int r = q * kNb + warp + kDiagWarps * i;
        if (r < kPanel && c <= r) A[r * kDiagLd + c] -= acc[i];
      }
    }
    __syncthreads();
  }

  // the inverses D_b of the four diagonal blocks, a warp each, side by side
  if (warp < kPanel / kNb) warp_inv32(A + warp * kNb * (kDiagLd + 1), V + warp * kNb * (kDiagLd + 1), lane);
  __syncthreads();

  // W's block rows i = 1..3: T_b = sum_{32 b <= m < 32 i} L[32 i + r][m] W[m][32 b + c],
  // then W_ib = -D_i T_b (rows of W above block row i are final).  Item e
  // of a phase is block b = e / 8 and its rows 4 (e % 8) .. + 3.
  constexpr int kWRows = 4;
  for (int i = 1; i < kPanel / kNb; ++i) {
    const int ri = i * kNb;
    for (int e = warp; e < i * (kNb / kWRows); e += kDiagWarps) {
      const int b = e / (kNb / kWRows), r0 = ri + (e % (kNb / kWRows)) * kWRows;
      float acc[kWRows] = {};
      for (int m = b * kNb; m < ri; m += 4) {
        const float w0 = V[m * kDiagLd + b * kNb + lane], w1 = V[(m + 1) * kDiagLd + b * kNb + lane];
        const float w2 = V[(m + 2) * kDiagLd + b * kNb + lane], w3 = V[(m + 3) * kDiagLd + b * kNb + lane];
#pragma unroll
        for (int h = 0; h < kWRows; ++h) {
          const float4 p = *reinterpret_cast<const float4*>(&A[(r0 + h) * kDiagLd + m]);
          acc[h] = fmaf(p.x, w0, fmaf(p.y, w1, fmaf(p.z, w2, fmaf(p.w, w3, acc[h]))));
        }
      }
#pragma unroll
      for (int h = 0; h < kWRows; ++h) T[(b * kNb + r0 - ri + h) * kNb + lane] = acc[h];
    }
    __syncthreads();
    for (int e = warp; e < i * (kNb / kWRows); e += kDiagWarps) {
      const int b = e / (kNb / kWRows), r0 = ri + (e % (kNb / kWRows)) * kWRows;
      float acc[kWRows] = {};
#pragma unroll 2
      for (int m = 0; m < kNb; m += 4) {
        const float t0 = T[(b * kNb + m) * kNb + lane], t1 = T[(b * kNb + m + 1) * kNb + lane];
        const float t2 = T[(b * kNb + m + 2) * kNb + lane], t3 = T[(b * kNb + m + 3) * kNb + lane];
#pragma unroll
        for (int h = 0; h < kWRows; ++h) {
          const float4 p = *reinterpret_cast<const float4*>(&V[(r0 + h) * kDiagLd + ri + m]);
          acc[h] = fmaf(p.x, t0, fmaf(p.y, t1, fmaf(p.z, t2, fmaf(p.w, t3, acc[h]))));
        }
      }
#pragma unroll
      for (int h = 0; h < kWRows; ++h) V[(r0 + h) * kDiagLd + b * kNb + lane] = -acc[h];
    }
    __syncthreads();
  }

#pragma unroll 8
  for (int s = 0; s < kRows; ++s) {
    const int r = rg + kGroups * s;
    Ljj[(size_t)r * n_pad + l] = (l <= r) ? A[r * kDiagLd + l] : 0.0f;
    Wj[r * kPanel + l] = (l <= r) ? V[r * kDiagLd + l] : 0.0f;
  }
}

// ---------------------------------------------------------------- K4 -------
// grid ((n_pad - (j+1)*kPanel) / kSolveRows); block (kThreads).  Each block
// owns whole rows of the panel: it reads its 64 x 128 slice of P into shared
// memory before it writes any of it, so the in-place update is race free.
__global__ void __launch_bounds__(kThreads)
    panel_solve_kernel(float* __restrict__ L, const float* __restrict__ W, int n_pad, int j) {
  __shared__ __align__(16) float Ps[kSolveRows][kSolveLd];
  __shared__ __align__(16) float Ws[kChunk][kSolveLd];  // Ws[k][c] = W_j[c][k0 + k]
  const int jp = j * kPanel;
  const int row0 = (j + 1) * kPanel + blockIdx.x * kSolveRows;
  float* Lp = L + (size_t)row0 * n_pad + jp;
  const float* Wj = W + (size_t)j * kPanel * kPanel;
  const int tx = threadIdx.x % 16;  // columns tx*8 .. tx*8+7
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3

  for (int e = threadIdx.x; e < kSolveRows * kPanel / 4; e += kThreads) {
    const int r = e / (kPanel / 4), q = e % (kPanel / 4);
    *reinterpret_cast<float4*>(&Ps[r][4 * q]) =
        *reinterpret_cast<const float4*>(&Lp[(size_t)r * n_pad + 4 * q]);
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < kPanel; k0 += kChunk) {
    for (int e = threadIdx.x; e < kPanel * kChunk / 4; e += kThreads) {
      const int c = e / (kChunk / 4), q = e % (kChunk / 4);
      const float4 w = *reinterpret_cast<const float4*>(&Wj[(size_t)c * kPanel + k0 + 4 * q]);
      Ws[4 * q + 0][c] = w.x;
      Ws[4 * q + 1][c] = w.y;
      Ws[4 * q + 2][c] = w.z;
      Ws[4 * q + 3][c] = w.w;
    }
    __syncthreads();  // also orders the Ps fill before its first read
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 8]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 8 + 4]);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[ty * 4 + i][k0 + kk];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p, w[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* dst = &Lp[(size_t)(ty * 4 + i) * n_pad + tx * 8];
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <int FORM>
static void launch_strip(cudaStream_t s, const float* src, float* L, const float* part, int n_pad,
                         int n_true, int d, int j, int blocks, GramParams par, float diag) {
  const dim3 grid(kPanel / kTile, n_pad / kTile);
  panel_strip_kernel<FORM><<<grid, kThreads, 0, s>>>(src, L, part, n_pad, n_true, d, j, blocks,
                                                      par, diag);
}

}  // namespace gpr

// form: a gpr::Form code (Gram mode, src = X (n_true, d)) or -1 (matrix
// mode, src = A (n_pad, n_pad)).  n_pad % 128 == 0.  blocks: 0 for j = 0,
// else 1 .. j (n_pad - 128 j) / 128 (ops/fullchol.py::_split_plan); part
// holds blocks + (n_pad - 128 j) / 128 - 1 tiles of 128 x 128.  Two kernels
// in stream order: the products (for j > 0), the strip.
extern "C" int gpr_panel_update(const float* src, float* L, float* part, int n_pad, int n_true,
                                int d, int j, int blocks, int form, float sigma, float scale,
                                float third, float diag, void* stream) {
  using namespace gpr;
  const GramParams par{sigma, scale, third};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = (long long)(n_pad - j * kPanel) / kPanel * j;
  if (j == 0 ? blocks != 0 : (blocks < 1 || blocks > units)) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    cudaError_t err = cudaFuncSetAttribute(panel_products_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
    if (err != cudaSuccess) return (int)err;
    panel_products_kernel<<<blocks, kTcThreads, kTcSmem, s>>>(L, part, n_pad, j, blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  switch (form) {
    case kMatrixMode: launch_strip<kMatrixMode>(s, src, L, part, n_pad, n_true, d, j, blocks, par, diag); break;
    case kGaussian: launch_strip<kGaussian>(s, src, L, part, n_pad, n_true, d, j, blocks, par, diag); break;
    case kRQ: launch_strip<kRQ>(s, src, L, part, n_pad, n_true, d, j, blocks, par, diag); break;
    case kMatern12: launch_strip<kMatern12>(s, src, L, part, n_pad, n_true, d, j, blocks, par, diag); break;
    case kMatern32: launch_strip<kMatern32>(s, src, L, part, n_pad, n_true, d, j, blocks, par, diag); break;
    case kMatern52: launch_strip<kMatern52>(s, src, L, part, n_pad, n_true, d, j, blocks, par, diag); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gpr_diag_factor_inv(float* L, float* W, int n_pad, int j, void* stream) {
  using namespace gpr;
  cudaError_t err = cudaFuncSetAttribute(diag_factor_inv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDiagSmem);
  if (err != cudaSuccess) return (int)err;
  diag_factor_inv_kernel<<<1, kDiagThreads, kDiagSmem, static_cast<cudaStream_t>(stream)>>>(L, W, n_pad, j);
  return (int)cudaGetLastError();
}

extern "C" int gpr_panel_solve(float* L, const float* W, int n_pad, int j, void* stream) {
  using namespace gpr;
  const int rows = n_pad - (j + 1) * kPanel;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  panel_solve_kernel<<<rows / kSolveRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(L, W, n_pad, j);
  return (int)cudaGetLastError();
}
