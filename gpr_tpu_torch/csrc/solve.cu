// K10: the narrow Cholesky substitution, and K11: the inverses of the diagonal
// tiles of a Cholesky factor.  Together they solve (L L^T) X = B for a skinny
// right-hand side B (n, q <= 128), n % bs == 0 (gpr_tpu_torch/ops/solve.py).
//
// K10 narrow_subst replaces the TPU kernel gpr_tpu/ops/pallas_solve.py::
// _subst_kernel (line 52), launched by _subst_pass (118) once per sweep:
//   forward   y_i = W_ii (b_i - sum_{j<i} L_ij y_j)         i ascending
//   backward  x_i = W_ii^T (y_i - sum_{j>i} L_ji^T x_j)     i descending
// with W_ii = inv(L_ii).  The TPU walks the lower tiles of L on a sequential
// grid and keeps every solved block in VMEM (nb x q x bs, 512 KB at n = 16384,
// q = 8).  Hopper blocks run in no order and that exceeds a block's shared
// memory, so the solved blocks live in device memory and the block rows are
// ordered by the stream: one counted launch per block row, 2 nb per solve.  A
// launch runs two kernels:
//   subst_offdiag  the off-diagonal sum of block row i, split over blocks of
//                  64 rows x 128 columns x (8 or 16) right-hand sides, each a
//                  128-term partial written to scratch; the last block of each
//                  row group (an atomic ticket after __threadfence()) sums the
//                  partials in chunk order and writes r_i = b_i - sum, so every
//                  sum runs in two levels (partials of 128 terms), as K2's
//                  fold_update does (gram_tile.cuh);
//   subst_diag     y_i = W_ii r_i (W_ii^T r_i backward) in the kernel body, 64
//                  rows a block, the same 128-column chunks.
// A tile of L or W is staged through shared memory coalesced, row-wise for the
// forward sweep and column-wise (L_ji^T, W^T) for the backward one.  Only the
// strict lower triangle of L outside the diagonal tiles is read: the strict
// upper may hold anything.  A NaN in what is read makes the result non-finite.
//
// What bounds K10 on the H100: bytes.  A sweep reads the nb(nb-1)/2
// off-diagonal tiles of L and the lower triangle of each W_ii,
// (nb(nb-1)/2) bs^2 + nb bs(bs+1)/2 floats, plus B read and X written: 537.9 MB
// at n = 16384, bs = 512, q = 8, so 0.321 ms for the two sweeps of a solve at
// 3.35 TB/s, against 4.3 GFLOP (0.064 ms at 67 TFLOP/s).  Plain FP32 FMA; with
// q > 16 each 16-column group of B re-reads L (served from L2 within a block
// row where it fits).
//
// K11 diag_tri_inv replaces pallas_solve.py::_diag_inv_kernel (173), launched
// by _diag_block_inverses_pallas (188): W_i = inv(tril(L_ii)) of every
// (bs, bs) diagonal tile, bs <= 512, the strict upper of L_ii masked.  The
// TPU's bottom-up 8-row strip scheme is VMEM tuning; substitution column by
// column is a chain of bs dependent steps.  Here the tile is inverted by
// blocks, so that no chain is longer than one 32-wide diagonal block:
//   tri_inv_diag   every 32x32 diagonal block of every tile at once, one
//                  warp a block (lane i holds row i; K3's warp_inv32 order,
//                  fullchol.cu), a ragged last block of 16 padded with I;
//                  it also writes the zeros right of its block, so W's
//                  strict upper is exactly 0;
//   tri_inv_level  for h = 32, 64, 128, 256 (h < bs), one kernel each: the
//                  pairs of h-wide diagonal blocks are joined by
//                  inv([[A, 0], [C, D]]) = [[inv A, 0], [-inv(D) C inv(A), inv D]],
//                  the identity JAX uses for bs = 1024 (pallas_solve.py:213-227).
//                  A block takes one 64-column block of the pair's output:
//                  T = C inv(A)[:, cols] into shared memory, then X = -inv(D) T
//                  into W, both products by 64x64 register tiles (4x4 a
//                  thread) over 32-deep chunks staged through shared memory,
//                  C and inv(D) transposed there, each chunk's partial folded
//                  into an FP32 running tile (two-level sums, as everywhere in
//                  the port).  The zero halves of the triangular operands are
//                  skipped: T's column block j0 sums from row j0 of inv(A), X's
//                  row block i0 up to column i0 + 63 of inv(D).
// The warp's block inverse and the staged product tile live in tri_inv.cuh,
// which K13 leaf_chol_wi (leaf.cu) shares for the inverse of a whole leaf.
// One counted launch runs 1 + log2(bs / 32) kernels in stream order (five at
// bs = 512).  L's strict upper is never read: the diagonal blocks are staged
// through a mask and C lies strictly below the diagonal.  A NaN on a pivot
// makes its tile's W non-finite through 1 / L_ii and the products.
// What bounds it: bs^3/3 FLOP a tile for the inverse, 1.43 GFLOP at n =
// 16384, bs = 512 (0.021 ms at 67 TFLOP/s FP32), against 16.8 MB read and
// 33.5 MB written (0.015 ms); the doubling computes ~2x that (the products
// at each level, 2.9 GFLOP, ~0.04 ms).  Plain FP32 FMA on the CUDA cores:
// the FLOP are few, and the levels are short, so the time is the five
// kernels' latency and the last level's single wave of 128 blocks.
#include <cuda_runtime.h>

#include "tri_inv.cuh"

namespace gpr {

constexpr int kSubstThreads = 256;
constexpr int kSubstRows = 64;    // output rows of a block
constexpr int kSubstChunk = 128;  // columns of a tile chunk: the first level of every sum

template <int QC>
struct SubstSmem {
  float A[kSubstChunk][kSubstRows + 1];  // A[kappa][rho]: the tile, transposed, padded
  float V[kSubstChunk][QC];              // the solved rows the chunk multiplies
};

// A[kappa][rho] = M[row0 + rho, col0 + kappa] (trans false) or
// M[col0 + kappa, row0 + rho] (trans true), row stride ld; coalesced along
// the source's rows.  LOWER keeps only elements of M's lower triangle
// (source row >= source column) and loads 0 elsewhere.  Each thread issues
// its loads 8 at a time before it stores any, so that they are in flight
// together.
template <int QC, bool LOWER>
__device__ __forceinline__ void load_tile(SubstSmem<QC>& sm, const float* M, size_t ld, int row0,
                                          int col0, bool trans) {
  constexpr int kPer = kSubstRows * kSubstChunk / kSubstThreads;  // 32
  for (int s0 = 0; s0 < kPer; s0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = threadIdx.x + (s0 + u) * kSubstThreads;
      const int rho = trans ? e % kSubstRows : e / kSubstChunk;
      const int kappa = trans ? e / kSubstRows : e % kSubstChunk;
      const int sr = trans ? col0 + kappa : row0 + rho;
      const int sc = trans ? row0 + rho : col0 + kappa;
      v[u] = (!LOWER || sr >= sc) ? M[(size_t)sr * ld + sc] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = threadIdx.x + (s0 + u) * kSubstThreads;
      const int rho = trans ? e % kSubstRows : e / kSubstChunk;
      const int kappa = trans ? e / kSubstRows : e % kSubstChunk;
      sm.A[kappa][rho] = v[u];
    }
  }
}

// V[kappa][j] = S[row0 + kappa, q0 + j] of the (., q) row-major S; 0 past q.
template <int QC>
__device__ __forceinline__ void load_rows(SubstSmem<QC>& sm, const float* S, int q, int row0,
                                          int q0) {
  constexpr int kPer = kSubstChunk * QC / kSubstThreads;  // 4 or 8
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kSubstThreads, kappa = e / QC, j = e % QC;
    v[u] = q0 + j < q ? S[(size_t)(row0 + kappa) * q + q0 + j] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kSubstThreads;
    sm.V[e / QC][e % QC] = v[u];
  }
}

// acc[m] = sum over the chunk of A[kappa][rho] V[kappa][j], for this thread's
// row rho = t % 64 and columns j = t / 64 + 4 m: a chain of 128 terms.
template <int QC>
__device__ __forceinline__ void chunk_product(const SubstSmem<QC>& sm, float* acc) {
  const int rho = threadIdx.x % kSubstRows, j0 = threadIdx.x / kSubstRows;
#pragma unroll
  for (int m = 0; m < QC / 4; ++m) acc[m] = 0.0f;
#pragma unroll 4
  for (int kappa = 0; kappa < kSubstChunk; ++kappa) {
    const float a = sm.A[kappa][rho];
#pragma unroll
    for (int m = 0; m < QC / 4; ++m) acc[m] = fmaf(a, sm.V[kappa][j0 + 4 * m], acc[m]);
  }
}

// grid (chunks, bs / 64, ceil(q / QC)).  Partial sums of block row i over the
// solved rows of out, then, in the last block of each (row group, column
// group), r_i = src_i - sum of the partials in chunk order into R (bs, q).
template <int QC>
__global__ void __launch_bounds__(kSubstThreads)
    subst_offdiag(const float* L, int n, const float* src, const float* out, float* P, float* R,
                  int* tickets, int q, int bs, int i, int forward) {
  __shared__ SubstSmem<QC> sm;
  __shared__ bool last;
  const int k = blockIdx.x, chunks = gridDim.x, g = blockIdx.y, z = blockIdx.z;
  const int row0 = i * bs + g * kSubstRows;
  const int col0 = forward ? k * kSubstChunk : (i + 1) * bs + k * kSubstChunk;
  load_tile<QC, false>(sm, L, (size_t)n, row0, col0, !forward);
  load_rows<QC>(sm, out, q, col0, z * QC);
  __syncthreads();
  float acc[QC / 4];
  chunk_product<QC>(sm, acc);
  const int rho = threadIdx.x % kSubstRows, j0 = threadIdx.x / kSubstRows;
  const int r = g * kSubstRows + rho;  // row within the block row
#pragma unroll
  for (int m = 0; m < QC / 4; ++m) {
    const int j = z * QC + j0 + 4 * m;
    if (j < q) P[((size_t)k * bs + r) * q + j] = acc[m];
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + g * gridDim.z + z;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int m = 0; m < QC / 4; ++m) {
    const int j = z * QC + j0 + 4 * m;
    if (j < q) {
      // in chunk order; the loads go out 8 at a time
      const float* p = P + (size_t)r * q + j;
      const size_t stride = (size_t)bs * q;
      float s = 0.0f;
      int kk = 0;
      for (; kk + 8 <= chunks; kk += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(p + (kk + u) * stride);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      for (; kk < chunks; ++kk) s += __ldcg(p + kk * stride);
      R[(size_t)r * q + j] = src[(size_t)(row0 + rho) * q + j] - s;
    }
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next block row
}

// grid (bs / 64, ceil(q / QC)).  out_i = W_i rhs (forward) or W_i^T rhs
// (backward), rhs (bs, q); W_i's lower triangle only.
template <int QC>
__global__ void __launch_bounds__(kSubstThreads)
    subst_diag(const float* Wi, const float* rhs, float* out, int q, int bs, int i, int forward) {
  __shared__ SubstSmem<QC> sm;
  const int g = blockIdx.x, z = blockIdx.y;
  const int r0 = g * kSubstRows;
  // forward: row r needs columns c <= r; backward: c >= r
  const int k_lo = forward ? 0 : r0 / kSubstChunk;
  const int k_hi = forward ? (r0 + kSubstRows - 1) / kSubstChunk : bs / kSubstChunk - 1;
  float tot[QC / 4], acc[QC / 4];
#pragma unroll
  for (int m = 0; m < QC / 4; ++m) tot[m] = 0.0f;
  for (int k = k_lo; k <= k_hi; ++k) {
    __syncthreads();
    load_tile<QC, true>(sm, Wi, (size_t)bs, r0, k * kSubstChunk, !forward);
    load_rows<QC>(sm, rhs, q, k * kSubstChunk, z * QC);
    __syncthreads();
    chunk_product<QC>(sm, acc);
#pragma unroll
    for (int m = 0; m < QC / 4; ++m) tot[m] += acc[m];
  }
  const int rho = threadIdx.x % kSubstRows, j0 = threadIdx.x / kSubstRows;
#pragma unroll
  for (int m = 0; m < QC / 4; ++m) {
    const int j = z * QC + j0 + 4 * m;
    if (j < q) out[(size_t)(i * bs + r0 + rho) * q + j] = tot[m];
  }
}

template <int QC>
cudaError_t narrow_subst_row(const float* L, const float* W, const float* src, float* out, float* P,
                             float* R, int* tickets, int n, int q, int bs, int i, int forward,
                             cudaStream_t stream) {
  const int nb = n / bs, zq = (q + QC - 1) / QC;
  const bool off = forward ? i > 0 : i < nb - 1;
  const float* rhs = src + (size_t)i * bs * q;
  if (off) {
    const int chunks = (forward ? i : nb - 1 - i) * bs / kSubstChunk;
    subst_offdiag<QC><<<dim3(chunks, bs / kSubstRows, zq), kSubstThreads, 0, stream>>>(
        L, n, src, out, P, R, tickets, q, bs, i, forward);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rhs = R;
  }
  subst_diag<QC><<<dim3(bs / kSubstRows, zq), kSubstThreads, 0, stream>>>(
      W + (size_t)i * bs * bs, rhs, out, q, bs, i, forward);
  return cudaGetLastError();
}

constexpr int kInvMaxTile = 512;

// grid ceil(nb * nblk / 4), nblk = ceil(bs / 32); warp g the diagonal block
// b = g % nblk of tile g / nblk (tri_inv.cuh: warp_tri_inv32, a ragged last
// block padded with I past its width w), stored with the zeros right of it.
__global__ void __launch_bounds__(kInvDiagWarps * 32)
    tri_inv_diag(const float* L, int ld, float* W, int nb, int bs) {
  __shared__ float sm[kInvDiagWarps][kInvNb][kInvNb + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nblk = (bs + kInvNb - 1) / kInvNb;
  const int g = blockIdx.x * kInvDiagWarps + warp;
  if (g >= nb * nblk) return;  // warp-uniform: the warps share no barrier
  const int tile = g / nblk, c0 = (g % nblk) * kInvNb, w = min(kInvNb, bs - c0);
  float(*s)[kInvNb + 1] = sm[warp];
  warp_tri_inv32(L + (size_t)(tile * bs + c0) * ld + tile * bs + c0, ld, w, s);
  float* Wr = W + (size_t)tile * bs * bs + (size_t)c0 * bs;
  for (int r = 0; r < w; ++r) {
    if (lane < w) Wr[(size_t)r * bs + c0 + lane] = s[r][lane];
    for (int c = c0 + w + lane; c < bs; c += 32) Wr[(size_t)r * bs + c] = 0.0f;
  }
}

// grid (pairs * ceil(h / 64), nb), pairs = ceil((bs - h) / 2h); dynamic
// shared memory (max(h, 64) + 64) * kInvLd floats.  Pair p of tile t: A =
// the h-wide block at c0 = 2 p h, D the hd-wide block at r0 = c0 + h (hd <
// h for a ragged pair), C = L[r0 .., c0 ..]; inv(A) and inv(D) are W's
// diagonal blocks from the levels before (their strict upper is 0).  Block
// (p, cb) writes W[r0 .., c0 + 64 cb ..] = -inv(D) C inv(A)[:, 64 cb ..].
__global__ void __launch_bounds__(kInvThreads)
    tri_inv_level(const float* L, int ld, float* W, int bs, int h) {
  extern __shared__ __align__(16) float ism[];
  float* Ts = ism;                                    // T = C inv(A)[:, cols]: hd rows
  float* As = Ts + max(h, kInvCb) * kInvLd;           // [32][kInvLd]: C or inv(D), transposed
  float* Bs = As + kInvK * kInvLd;                    // [32][kInvLd]: rows of inv(A)
  const int cbs = (h + kInvCb - 1) / kInvCb;
  const int p = blockIdx.x / cbs, j0 = (blockIdx.x % cbs) * kInvCb, tile = blockIdx.y;
  const int c0 = 2 * p * h, r0 = c0 + h, hd = min(h, bs - r0), jw = min(kInvCb, h - j0);
  const float* Lt = L + (size_t)tile * bs * ld + (size_t)tile * bs;
  float* Wt = W + (size_t)tile * bs * bs;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // T's 64-row blocks; inv(A)[k][j] = 0 for k < j, so the sum starts at row j0
  for (int i0 = 0; i0 < hd; i0 += kInvCb) {
    float acc[4][4] = {};
    for (int k0 = j0; k0 < h; k0 += kInvK) {
      __syncthreads();
      inv_stage_t(As, Lt + (size_t)(r0 + i0) * ld + c0 + k0, (size_t)ld, hd - i0, h - k0);
      inv_stage(Bs, Wt + (size_t)(c0 + k0) * bs + c0 + j0, (size_t)bs, h - k0, jw);
      __syncthreads();
      inv_chunk(As, Bs, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&Ts[(i0 + 4 * ty + i) * kInvLd + 4 * tx]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  // X's 64-row blocks; inv(D)[i][k] = 0 for k > i, so the sum ends at i0 + 63
  for (int i0 = 0; i0 < hd; i0 += kInvCb) {
    float acc[4][4] = {};
    const int k1 = min(i0 + kInvCb, hd);
    for (int k0 = 0; k0 < k1; k0 += kInvK) {
      __syncthreads();  // also: T complete before its first read
      inv_stage_t(As, Wt + (size_t)(r0 + i0) * bs + r0 + k0, (size_t)bs, hd - i0, k1 - k0);
      __syncthreads();
      inv_chunk(As, Ts + k0 * kInvLd, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + 4 * ty + i;
      if (r >= hd) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        if (c < jw) Wt[(size_t)(r0 + r) * bs + c0 + j0 + c] = -acc[i][j];
      }
    }
  }
}

}  // namespace gpr

// Block row i of one sweep (forward != 0: ascending rows, out = y; else
// descending, out = x).  L (n, n) row-major, W (n / bs, bs, bs), src and out
// (n, q) row-major and distinct; scratch P ((n - bs) / 128, bs, q), R (bs, q)
// and tickets (bs / 64 * ceil(q / 8)) ints, all zero before the first call.
extern "C" int gpr_narrow_subst(const float* L, const float* W, const float* src, float* out,
                                float* P, float* R, int* tickets, int n, int q, int bs, int i,
                                int forward, void* stream) {
  using namespace gpr;
  if (bs < kSubstChunk || bs % kSubstChunk || n < bs || n % bs || q < 1 || i < 0 || i >= n / bs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q <= 8) return (int)narrow_subst_row<8>(L, W, src, out, P, R, tickets, n, q, bs, i, forward, s);
  return (int)narrow_subst_row<16>(L, W, src, out, P, R, tickets, n, q, bs, i, forward, s);
}

// W (nb, bs, bs) = the inverses of the lower triangles of the diagonal tiles
// of L (nb bs, nb bs), row stride ld; W's strict upper is exact 0.  bs % 16
// == 0, bs <= 512.  1 + log2(bs / 32) kernels in stream order.
extern "C" int gpr_diag_tri_inv(const float* L, int ld, float* W, int nb, int bs, void* stream) {
  using namespace gpr;
  if (nb < 1 || bs < 16 || bs % 16 || bs > kInvMaxTile || ld < nb * bs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (bs + kInvNb - 1) / kInvNb;
  tri_inv_diag<<<(nb * nblk + kInvDiagWarps - 1) / kInvDiagWarps, kInvDiagWarps * 32, 0, s>>>(
      L, ld, W, nb, bs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem_max = (kInvMaxTile / 2 + 2 * kInvK) * kInvLd * (int)sizeof(float);
  err = cudaFuncSetAttribute(tri_inv_level, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return (int)err;
  for (int h = kInvNb; h < bs; h *= 2) {
    const int pairs = (bs - h + 2 * h - 1) / (2 * h), cbs = (h + kInvCb - 1) / kInvCb;
    const int smem = (max(h, kInvCb) + 2 * kInvK) * kInvLd * (int)sizeof(float);
    tri_inv_level<<<dim3(pairs * cbs, nb), kInvThreads, smem, s>>>(L, ld, W, bs, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
