// K2-K4: left-looking panel Cholesky of K(X, X) + diag*I (Gram mode) or of a
// given SPD matrix A (matrix mode), one panel of 128 columns at a time.
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_fullchol.py::_fused_kernel
// (line 722), launched once per factorization by _call_fused (1125).  On the
// TPU the whole factorization is one dispatch whose sequential grid walks
// the panels; here the host walks them (ops/fullchol.py::_factor) and
// launches the kernels below on two streams, whose order and events take
// the place of the TPU grid's "arbitrary" (sequential) semantics:
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
//     cp.async ring, two-level sums), so its bound is the FLOPs at 495/3 =
//     165 TFLOP/s (against 67 for FP32 FMA).  The update of panel j is cut
//     in three stages, each a kernel:
//       (a) the products over the columns before panel j - 1, k in [0, jp -
//           128): a late panel has few row tiles but a deep k range, an
//           early one many tiles and a short range, so each tile's 128-deep
//           slices are dealt out evenly to one block an SM but one
//           (ops/fullchol.py::_split_plan), each block's piece of a tile
//           written to a scratch slot;
//       (b) the last slice, k in [jp - 128, jp): L[rows, panel j - 1]
//           L[panel j, panel j - 1]^T by the same tensor-core tile, into
//           one more slot a tile;
//       (c) the strip: S (gram_tile.cuh in Gram mode), minus the tile's
//           pieces in a fixed order, the last slice last, into P.
//     (a) reads only columns that are final once panel j - 2 is solved, so
//     the host runs it on a second stream beside K3 and K4 of panel j - 1
//     (the lookahead), on all SMs but one, which K3 takes.  No atomics: L
//     is bit-identical from call to call, and equal to running the stages
//     in one stream.
//   * K3 is a latency-bound chain on one SM.  It factors the 128x128 block by
//     four 32-wide diagonal blocks: one warp factors each 32x32 block in
//     registers with shuffles (no block barrier), the rows below solve
//     against it and the trailing update runs as products on all warps, the
//     four diagonal inverses run side by side on four warps, and W's
//     off-diagonal blocks come from products in block-row order: 18 block
//     barriers a panel.  The lookahead hides it behind the next panel's
//     products wherever those take longer.
//   * K4 is P W_j^T with K = 128, in FP32 FMA on the CUDA cores: 3xTF32 at
//     this depth measured 8x the rms error of FP32 against float64 and
//     moved a standing accuracy gate past its limit, so K4 keeps the sums
//     of a plain GEMM (each entry one FMA chain in the order of k), bit for
//     bit, at 32 rows a block so that the late panels' few rows still
//     spread over several SMs, W_j staged once a block, and the zero terms
//     of W_j's upper triangle skipped a warp at a time.
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
constexpr int kProducts = 1, kLastSlice = 2, kStrip = 4;  // stages of K2
constexpr int kSolveRows = 32;        // K4: rows of P a block
constexpr int kSolveLd = kPanel + 4;  // K4's smem rows of P and of W_j
constexpr size_t kSolveSmem = (size_t)(kSolveRows + kPanel) * kSolveLd * sizeof(float);  // 84480 B
static_assert(kTcRows == kPanel, "K2's tensor-core tile is one panel wide");

// ---------------------------------------------------------------- K2 -------
// (a) the products.  grid (blocks); block (kTcThreads); dynamic shared
// memory kTcSmem.  Panel j has T = (n_pad - jp) / 128 row tiles of ks =
// j - 1 slices 128 deep each (k in [0, jp - 128)), U = T ks units in
// tile-major order.  Block b takes units [b U / blocks, (b + 1) U / blocks):
// for each tile t they touch, it sums L[jp + 128 t + r, k] L[jp + c, k] over
// its k range into scratch slot b + t (128 x 128).  Every block gets the same
// work to within one unit, so the narrow late panels fill the card as the
// wide early ones.
__global__ void __launch_bounds__(kTcThreads, 1)
    panel_products_kernel(const float* __restrict__ L, float* __restrict__ part, int n_pad,
                          int j, int blocks) {
  extern __shared__ __align__(128) float tc_smem[];
  const int jp = j * kPanel;
  const int ks = j - 1;
  const long long units = (long long)(n_pad - jp) / kPanel * ks;
  const int b = blockIdx.x;
  const int u0 = (int)(b * units / blocks);
  const int u1 = (int)((b + 1) * units / blocks);
  for (int t = u0 / ks; t <= (u1 - 1) / ks; ++t) {
    const int lo = max(u0, t * ks) - t * ks;
    const int hi = min(u1, (t + 1) * ks) - t * ks;
    const float* A = L + (size_t)(jp + t * kTcRows) * n_pad + lo * kPanel;
    const float* B = L + (size_t)jp * n_pad + lo * kPanel;
    TcAcc run;
    tc_rank_tile(A, B, n_pad, (hi - lo) * (kPanel / kTcK), tc_smem, run);
    tc_store(run, part + (size_t)(b + t) * kTcRows * kPanel, kPanel);
  }
}

// (b) the last slice.  grid (T); block (kTcThreads); dynamic shared memory
// kTcSmem.  Tile t of panel j: L[jp + 128 t + r, k] L[jp + c, k] over the
// 128 columns k of panel j - 1, into scratch slot s0 + t.
__global__ void __launch_bounds__(kTcThreads, 1)
    panel_last_kernel(const float* __restrict__ L, float* __restrict__ part, int n_pad, int j,
                      int s0) {
  extern __shared__ __align__(128) float tc_smem[];
  const float* B = L + (size_t)j * kPanel * n_pad + (j - 1) * kPanel;
  TcAcc run;
  tc_rank_tile(B + (size_t)blockIdx.x * kTcRows * n_pad, B, n_pad, kPanel / kTcK, tc_smem, run);
  tc_store(run, part + (size_t)(s0 + blockIdx.x) * kTcRows * kPanel, kPanel);
}

// (c) the strip.  grid (kPanel / kTile, n_pad / kTile); block (kThreads).
// S, minus the pieces of its row tile in block order (the order of k), then
// minus its last slice (slot s0 + t), into column block j of L; exact zeros
// above it.
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
  // b_hi hold units t ks .. t ks + ks - 1 (ks = j - 1; the block of unit u
  // is ((u + 1) blocks - 1) / U), in slots b + t; then the last slice
  if (j > 0) {
    const int t = (row0 - jp) / kPanel;
    const int tiles = (n_pad - jp) / kPanel;
    const int ks = j - 1;
    const long long units = (long long)tiles * ks;
    const int b_lo = blocks ? (int)((((long long)t * ks + 1) * blocks - 1) / units) : 0;
    const int b_hi = blocks ? (int)(((long long)(t + 1) * ks * blocks - 1) / units) : -1;
    const int s0 = blocks ? blocks + tiles - 1 : 0;
    const int r0 = (row0 - jp) % kPanel + ty * kPer;
    const int c0 = blockIdx.x * kTile + tx * kPer;
    for (int b = b_lo; b <= b_hi + 1; ++b) {
      const int slot = b <= b_hi ? b + t : s0 + t;
      const float* p = part + (size_t)slot * kPanel * kPanel;
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

// ---------------------------------------------------------------- K4 -------
// grid ((n_pad - (j + 1) 128) / 32); block (kThreads); dynamic shared memory
// kSolveSmem.  A block stages its 32 rows of P and W_j's rows in shared
// memory (coalesced 16-byte copies), then thread (tx = threadIdx.x / 8, ty =
// threadIdx.x % 8) sums rows ty + 8 i (i < 4), columns 4 tx .. 4 tx + 3 by
// FP32 FMA in the order of k from 0 (the sums of a plain GEMM, bit for bit),
// reading P's rows and W_j's rows 4 k at a time.  W_j is lower triangular,
// so warp w (columns 16 w .. 16 w + 15) stops at k = 16 w + 16: the terms it
// skips are exact zeros.  The block reads its rows whole before it writes
// them back in place, and no other block reads them.
__global__ void __launch_bounds__(kThreads)
    panel_solve_kernel(float* L, const float* __restrict__ W, int n_pad, int j) {
  extern __shared__ __align__(16) float solve_smem[];
  float* Ps = solve_smem;                   // [kSolveRows][kSolveLd]
  float* Ws = Ps + kSolveRows * kSolveLd;   // [kPanel][kSolveLd]
  float* Lp = L + (size_t)((j + 1) * kPanel + blockIdx.x * kSolveRows) * n_pad + j * kPanel;
  const float* Wj = W + (size_t)j * kPanel * kPanel;
  for (int e = threadIdx.x; e < kSolveRows * kPanel / 4; e += kThreads) {
    const int r = e / (kPanel / 4), q = e % (kPanel / 4);
    *reinterpret_cast<float4*>(&Ps[r * kSolveLd + 4 * q]) =
        *reinterpret_cast<const float4*>(&Lp[(size_t)r * n_pad + 4 * q]);
  }
  for (int e = threadIdx.x; e < kPanel * kPanel / 4; e += kThreads) {
    const int c = e / (kPanel / 4), q = e % (kPanel / 4);
    *reinterpret_cast<float4*>(&Ws[c * kSolveLd + 4 * q]) =
        *reinterpret_cast<const float4*>(&Wj[c * kPanel + 4 * q]);
  }
  __syncthreads();
  const int tx = threadIdx.x / 8, ty = threadIdx.x % 8;
  const int kend = 16 * (threadIdx.x / 32) + 16;
  float acc[4][4] = {};
  for (int k = 0; k < kend; k += 4) {
    float p[4][4], w[4][4];  // p[i][e] = P[ty + 8 i][k + e], w[c][e] = W_j[4 tx + c][k + e]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(&Ps[(ty + 8 * i) * kSolveLd + k]);
      p[i][0] = v.x;
      p[i][1] = v.y;
      p[i][2] = v.z;
      p[i][3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(&Ws[(4 * tx + c) * kSolveLd + k]);
      w[c][0] = v.x;
      w[c][1] = v.y;
      w[c][2] = v.z;
      w[c][3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p[i][e], w[c][e], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&Lp[(size_t)(ty + 8 * i) * n_pad + 4 * tx]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

template <int FORM>
static void launch_strip(cudaStream_t s, const float* src, float* L, const float* part, int n_pad,
                         int n_true, int d, int j, int blocks, GramParams par, float diag) {
  const dim3 grid(kPanel / kTile, n_pad / kTile);
  panel_strip_kernel<FORM><<<grid, kThreads, 0, s>>>(src, L, part, n_pad, n_true, d, j, blocks,
                                                      par, diag);
}

// the dynamic shared memory of K2's products and last slice, K3 and K4
static cudaError_t smem_attributes() {
  cudaError_t err = cudaFuncSetAttribute(panel_products_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(panel_last_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kTcSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(diag_factor_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kDiagSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(panel_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSolveSmem);
  return err;
}

struct Src {  // K2's S: X (n_true, d) and a gpr::Form code, or A (form kMatrixMode)
  const float* src;
  int n_true, d, form;
  GramParams par;
  float diag;
};

// the stages of K2 for panel j named in the mask, in stream order, on
// stream s (see gpr_panel_update); the strip needs the other two to have run
static int panel_update(const Src& S, float* L, float* part, int n_pad, int j, int blocks,
                        int stages, cudaStream_t s) {
  const int jp = j * kPanel;
  const int tiles = (n_pad - jp) / kPanel;
  const long long units = (long long)tiles * (j - 1);
  if (j < 2 ? blocks != 0 : (blocks < 1 || blocks > units)) return (int)cudaErrorInvalidValue;
  if (stages < 1 || stages > 7 || (blocks == 0 && (stages & kProducts)) ||
      (j == 0 && (stages & kLastSlice)))
    return (int)cudaErrorInvalidValue;
  if (stages & kProducts) {
    panel_products_kernel<<<blocks, kTcThreads, kTcSmem, s>>>(L, part, n_pad, j, blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & kLastSlice) {
    const int s0 = blocks ? blocks + tiles - 1 : 0;
    panel_last_kernel<<<tiles, kTcThreads, kTcSmem, s>>>(L, part, n_pad, j, s0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!(stages & kStrip)) return 0;
  const float* src = S.src;
  const int n_true = S.n_true, d = S.d;
  switch (S.form) {
    case kMatrixMode: launch_strip<kMatrixMode>(s, src, L, part, n_pad, n_true, d, j, blocks, S.par, S.diag); break;
    case kGaussian: launch_strip<kGaussian>(s, src, L, part, n_pad, n_true, d, j, blocks, S.par, S.diag); break;
    case kRQ: launch_strip<kRQ>(s, src, L, part, n_pad, n_true, d, j, blocks, S.par, S.diag); break;
    case kMatern12: launch_strip<kMatern12>(s, src, L, part, n_pad, n_true, d, j, blocks, S.par, S.diag); break;
    case kMatern32: launch_strip<kMatern32>(s, src, L, part, n_pad, n_true, d, j, blocks, S.par, S.diag); break;
    case kMatern52: launch_strip<kMatern52>(s, src, L, part, n_pad, n_true, d, j, blocks, S.par, S.diag); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

static int diag_factor_inv(float* L, float* W, int n_pad, int j, cudaStream_t s) {
  diag_factor_inv_kernel<<<1, kDiagThreads, kDiagSmem, s>>>(L, W, n_pad, j);
  return (int)cudaGetLastError();
}

static int panel_solve(float* L, const float* W, int n_pad, int j, cudaStream_t s) {
  const int rows = n_pad - (j + 1) * kPanel;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  panel_solve_kernel<<<rows / kSolveRows, kThreads, kSolveSmem, s>>>(L, W, n_pad, j);
  return (int)cudaGetLastError();
}

}  // namespace gpr

// form: a gpr::Form code (Gram mode, src = X (n_true, d)) or -1 (matrix
// mode, src = A (n_pad, n_pad)).  n_pad % 128 == 0.  blocks: 0 for j < 2,
// else 1 .. (j - 1) (n_pad - 128 j) / 128 (ops/fullchol.py::_split_plan);
// part holds s0 + T tiles of 128 x 128, T = (n_pad - 128 j) / 128, s0 =
// blocks + T - 1 (0 without products).  K2's stages in stream order: the
// products (j >= 2), the last slice (j >= 1), the strip.
extern "C" int gpr_panel_update(const float* src, float* L, float* part, int n_pad, int n_true,
                                int d, int j, int blocks, int form, float sigma, float scale,
                                float third, float diag, void* stream) {
  using namespace gpr;
  const cudaError_t err = smem_attributes();
  if (err != cudaSuccess) return (int)err;
  const Src S{src, n_true, d, form, GramParams{sigma, scale, third}, diag};
  const int stages = (blocks ? kProducts : 0) | (j ? kLastSlice : 0) | kStrip;
  return panel_update(S, L, part, n_pad, j, blocks, stages, static_cast<cudaStream_t>(stream));
}

extern "C" int gpr_diag_factor_inv(float* L, float* W, int n_pad, int j, void* stream) {
  using namespace gpr;
  const cudaError_t err = smem_attributes();
  if (err != cudaSuccess) return (int)err;
  return diag_factor_inv(L, W, n_pad, j, static_cast<cudaStream_t>(stream));
}

extern "C" int gpr_panel_solve(float* L, const float* W, int n_pad, int j, void* stream) {
  using namespace gpr;
  const cudaError_t err = smem_attributes();
  if (err != cudaSuccess) return (int)err;
  return panel_solve(L, W, n_pad, j, static_cast<cudaStream_t>(stream));
}

// The whole factorization with the one-panel lookahead, stepped here so that
// the host enqueues a panel in a few microseconds: per panel j, on stream
// (the caller's) K2's last slice, a wait for panel j's products, the strip,
// then K3 and K4; after the strip, panel j + 1's products on `side`, behind
// an event on stream and ahead of one that the strip of j + 1 waits for.
// plan[j] is K2's block count for panel j (ops/fullchol.py::_split_plan,
// at most sms - 1); panel j uses scratch part0 (j even) or part1 (j odd),
// each of the most tiles any panel needs.  The two events are made and
// released here; the side stream is joined to stream before it returns.
extern "C" int gpr_factor_lookahead(const float* src, float* L, float* W, float* part0,
                                    float* part1, const int* plan, int n_pad, int n_true, int d,
                                    int form, float sigma, float scale, float third, float diag,
                                    void* side, void* stream) {
  using namespace gpr;
  cudaError_t err = smem_attributes();
  if (err != cudaSuccess) return (int)err;
  const Src S{src, n_true, d, form, GramParams{sigma, scale, third}, diag};
  cudaStream_t s = static_cast<cudaStream_t>(stream), t = static_cast<cudaStream_t>(side);
  cudaEvent_t ready, done;
  err = cudaEventCreateWithFlags(&ready, cudaEventDisableTiming);
  if (err != cudaSuccess) return (int)err;
  err = cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
  if (err != cudaSuccess) {
    cudaEventDestroy(ready);
    return (int)err;
  }
  const int nc = n_pad / kPanel;
  int rc = 0;
  for (int j = 0; j < nc && rc == 0; ++j) {
    float* part = (j % 2) ? part1 : part0;
    if (j) rc = panel_update(S, L, part, n_pad, j, plan[j], kLastSlice, s);
    if (rc == 0 && j >= 2) rc = (int)cudaStreamWaitEvent(s, done, 0);
    if (rc == 0) rc = panel_update(S, L, part, n_pad, j, plan[j], kStrip, s);
    if (rc == 0 && 0 < j && j < nc - 1) {  // panel j + 1's products over k < 128 j
      rc = (int)cudaEventRecord(ready, s);
      if (rc == 0) rc = (int)cudaStreamWaitEvent(t, ready, 0);
      if (rc == 0)
        rc = panel_update(S, L, (j % 2) ? part0 : part1, n_pad, j + 1, plan[j + 1], kProducts, t);
      if (rc == 0) rc = (int)cudaEventRecord(done, t);
    }
    if (rc == 0) rc = diag_factor_inv(L, W, n_pad, j, s);
    if (rc == 0 && j + 1 < nc) rc = panel_solve(L, W, n_pad, j, s);
  }
  // join the side stream on every path, a failed one too, so that nothing
  // runs there once the caller lets go of the scratch
  const cudaError_t e1 = cudaEventRecord(done, t);
  const cudaError_t e2 = e1 == cudaSuccess ? cudaStreamWaitEvent(s, done, 0) : e1;
  cudaEventDestroy(ready);  // released once the device has passed them
  cudaEventDestroy(done);
  return rc ? rc : (int)e2;
}
