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
// (bs, bs) diagonal tile, bs <= 512, the strict upper of L_ii masked.  A
// 512 tile (1 MiB) does not fit shared memory, and the TPU's bottom-up 8-row
// strip scheme is VMEM tuning.  Here the columns of W are independent (column
// c solves L w = e_c): one warp per column, 16 columns a block, so n columns
// in all; 32 rows of the tile at a time are staged in shared memory for the
// block's 16 warps.  Each step of a column's forward substitution is a dot
// product split over the warp's lanes (w held in registers, 16 entries a
// lane) and summed by shuffles, so no thread carries a serial chain longer
// than 16 terms (K8 gives a column to one thread).  What bounds it: bs^3/3
// FLOP a tile, 1.43 GFLOP at n = 16384, bs = 512 (0.021 ms), against 16.8 MB
// read and 33.5 MB written (0.015 ms); the bs steps of each column are a
// dependent chain, so in practice it is latency bound.
#include <cuda_runtime.h>

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

constexpr int kInvCols = 16;  // columns of W a block, one warp each
constexpr int kInvRows = 32;  // rows of the tile staged at a time
constexpr int kInvMaxTile = 512;
constexpr int kInvThreads = kInvCols * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (bs / 16, nb).  W[t] = inv(tril(L_tt)); column c = c0 + warp.  Lane l
// holds w[m] = W[c0 + l + 32 m, c].
__global__ void __launch_bounds__(kInvThreads)
    diag_tri_inv_kernel(const float* L, int ld, float* W, int bs) {
  extern __shared__ float Ls[];  // kInvRows x bs, row stride bs; later W's 16 columns
  const int tile = blockIdx.y, c0 = blockIdx.x * kInvCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = c0 + warp;
  const float* T = L + (size_t)tile * bs * ld + (size_t)tile * bs;
  float w[kInvMaxTile / 32];
#pragma unroll
  for (int m = 0; m < kInvMaxTile / 32; ++m) w[m] = 0.0f;
  for (int i0 = c0; i0 < bs; i0 += kInvRows) {
    const int i1 = min(i0 + kInvRows, bs), wd = i1 - c0;
    __syncthreads();
    // the staging loads go out 8 at a time, before any of them is stored
    const int total = (i1 - i0) * wd;
    for (int e0 = threadIdx.x; e0 < total; e0 += 8 * kInvThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kInvThreads;
        const int row = i0 + e / wd, col = c0 + e % wd;
        v[u] = e < total && col <= row ? T[(size_t)row * ld + col] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kInvThreads;
        if (e < total) Ls[(e / wd) * bs + e % wd] = v[u];
      }
    }
    __syncthreads();
    for (int i = max(i0, c); i < i1; ++i) {
      const float* Li = Ls + (i - i0) * bs;  // row i, from column c0
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < kInvMaxTile / 32; ++m) {
        const int k = c0 + lane + 32 * m;
        if (k >= c && k < i) acc = fmaf(Li[lane + 32 * m], w[m], acc);
      }
      acc = warp_sum(acc);
      const float v = ((i == c ? 1.0f : 0.0f) - acc) / Li[i - c0];
      const int own = i - c0;
#pragma unroll
      for (int m = 0; m < kInvMaxTile / 32; ++m)
        if (lane + 32 * m == own) w[m] = v;
    }
  }
  __syncthreads();
  float* Ws = Ls;  // Ws[(k - c0) * 16 + col]
#pragma unroll
  for (int m = 0; m < kInvMaxTile / 32; ++m) {
    const int kk = lane + 32 * m;
    if (c0 + kk < bs) Ws[kk * kInvCols + warp] = w[m];
  }
  __syncthreads();
  float* Wt = W + (size_t)tile * bs * bs;
  for (int e = threadIdx.x; e < bs * kInvCols; e += kInvThreads) {
    const int k = e / kInvCols, col = e % kInvCols;
    Wt[(size_t)k * bs + c0 + col] = k < c0 ? 0.0f : Ws[(k - c0) * kInvCols + col];
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
// of L (nb bs, nb bs), row stride ld; W's strict upper is exact 0.
extern "C" int gpr_diag_tri_inv(const float* L, int ld, float* W, int nb, int bs, void* stream) {
  using namespace gpr;
  if (nb < 1 || bs < kInvCols || bs % kInvCols || bs > kInvMaxTile || ld < nb * bs)
    return (int)cudaErrorInvalidValue;
  // one tile row of slack: a predicated-off read of the last staged row stays inside
  const int smem = (kInvRows * bs + kInvMaxTile) * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(diag_tri_inv_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  diag_tri_inv_kernel<<<dim3(bs / kInvCols, nb), kInvThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(L, ld, W, bs);
  return (int)cudaGetLastError();
}
