// K19 tile_chol and K20 tile_chol_strips: L = U^T for one small SPD tile A,
// U the Cholesky factor computed from A's upper triangle only
// (gpr_tpu_torch/ops/chol.py).
//
// They replace the TPU kernels of gpr_tpu/ops/pallas_chol.py: K19
// _chol_kernel (line 29, launched by cholesky_pallas, 62; the one the
// dispatcher leaf_cholesky, 72, runs for n <= 512 on the accelerator) and K20
// _chol_strip_kernel (83, launched by cholesky_pallas_v2, 140).  Both TPU
// kernels keep the whole tile in VMEM and factor U = L^T row by row: K19 by
// n rank-1 updates, K20 by n / sw strips of sw rows, each factored by rank-1
// steps confined to the strip and followed by one rank-sw update of the
// trailing rows.  Here the tile does not fit a Hopper block's 227 KB (1 MiB
// at n = 512), so one block of 512 threads walks it in the output buffer in
// device memory (it stays in L2), and shared memory holds the active strip:
//
//   copy      L = transpose of A's upper triangle, exact zeros above the
//             diagonal (32x32 tiles through shared memory; A's strict lower
//             triangle is never read, so NaN there leaves L bit-identical);
//   per strip of SW columns of L (SW = 1 for K19, 8 or 16 for K20):
//     load    the strip's columns, rows j0 .. n - 1, into shared memory;
//     factor  SW pivots, one barrier each: step t reads the unscaled column
//             t (pivot and coefficients), updates the strip's later columns
//             of its own row and scales column t - 1, which no thread reads
//             in step t;
//     update  L[i][k] -= sum_t P[i][t] P[k][t] for j0 + SW <= k <= i (a warp
//             takes 16, 8 or 4 rows at a time, a lane a column, the rows'
//             loads issued together; sums in FP32 in t order, as JAX's
//             HIGHEST dot) and the strip written back.
//
// JAX's K20 reads its in-strip coefficients from the strip's own rows below
// the pivot, i.e. from A's strict lower triangle inside each sw x sw diagonal
// block; this kernel reads their symmetric counterparts above the diagonal,
// so it reads the upper triangle only, like K19.  For a symmetric input the
// two agree (ROADMAP section 3, "Settled").
//
// The pivot scale is 1.0f / sqrtf(pivot), both correctly rounded, as in
// crout.cuh (JAX's K19 uses rsqrt, its K20 1 / sqrt).  A non-positive (or
// NaN) pivot at j gives NaN through sqrtf, with no clamp and no early exit:
// rows before j stay finite, every row from j on holds a non-finite entry,
// and L[-1, -1] is NaN.  The strict upper triangle of L is exactly 0.
//
// What bounds them on the H100: n^3 / 3 FLOP against the upper triangle read
// and L written, 4 (n (n + 1) / 2 + n^2) bytes: at n = 256, 0.12 us (bytes);
// at n = 512, 0.67 us (FLOP at 67 TFLOP/s FP32).  In practice one SM does all
// the work: K19 reads and writes the trailing triangle once per column (~n^3
// / 6 updates through L2) behind two barriers a column, K20 once per strip;
// latency and one SM's L2 traffic, not the card's bytes or FLOP.  Plain FP32
// FMA; a multi-block trailing update and tensor cores are later work.
#include <cuda_runtime.h>

namespace gpr {

constexpr int kCholThreads = 512;
constexpr int kCholWarps = kCholThreads / 32;
constexpr int kCholMaxN = 512;  // one row of the strip per thread

// L = (A's upper triangle)^T with an exact-zero strict upper; A and L (n, n)
// contiguous.  32x32 tiles: a block of 512 threads moves 16 rows a pass.
__device__ __forceinline__ void chol_copy_upper_transposed(const float* A, float* L, int n,
                                                           float (*T)[33]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nt = (n + 31) / 32;
  for (int bi = 0; bi < nt; ++bi)
    for (int bj = bi; bj < nt; ++bj) {
      for (int y = ty; y < 32; y += kCholWarps) {
        const int r = bi * 32 + y, c = bj * 32 + tx;  // A[r][c], r <= c only
        if (r < n && c < n) {
          if (r <= c) T[y][tx] = A[(size_t)r * n + c];
          if (r < c) L[(size_t)r * n + c] = 0.0f;  // L's strict upper
        }
      }
      __syncthreads();
      for (int y = ty; y < 32; y += kCholWarps) {
        const int lr = bj * 32 + y, lc = bi * 32 + tx;  // L[lr][lc] = A[lc][lr]
        if (lr < n && lc <= lr) L[(size_t)lr * n + lc] = T[tx][y];
      }
      __syncthreads();
    }
}

template <int SW>
__global__ void __launch_bounds__(kCholThreads) tile_chol_kernel(const float* A, float* L, int n) {
  __shared__ float P[SW][kCholMaxN + 1];  // P[t][i] = L[i][j0 + t], the active strip
  __shared__ float T[32][33];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  chol_copy_upper_transposed(A, L, n, T);

  for (int j0 = 0; j0 < n; j0 += SW) {
    for (int idx = tid; idx < (n - j0) * SW; idx += kCholThreads) {
      const int i = j0 + idx / SW, t = idx % SW;
      if (i >= j0 + t) P[t][i] = L[(size_t)i * n + j0 + t];
    }
    __syncthreads();

    // factor the strip; thread tid owns row i = j0 + tid
    const int i = j0 + tid;
    float rd_prev = 0.0f, rd = 0.0f;
#pragma unroll
    for (int t = 0; t < SW; ++t) {
      rd = 1.0f / sqrtf(P[t][j0 + t]);  // NaN for a negative pivot, inf for 0
      if (i < n) {
        const float lit = P[t][i] * rd;  // L[i][j0 + t]
#pragma unroll
        for (int u = t + 1; u < SW; ++u)
          if (i >= j0 + u) P[u][i] = fmaf(-lit, P[t][j0 + u] * rd, P[u][i]);
        if (t > 0 && i >= j0 + t - 1) P[t - 1][i] *= rd_prev;
      }
      rd_prev = rd;
      if (SW > 1) __syncthreads();
    }
    // column SW - 1 is scaled on the fly below; write the strip back
    for (int idx = tid; idx < (n - j0) * SW; idx += kCholThreads) {
      const int r = j0 + idx / SW, t = idx % SW;
      if (r >= j0 + t) L[(size_t)r * n + j0 + t] = t == SW - 1 ? P[t][r] * rd : P[t][r];
    }

    // trailing update of rows and columns >= j0 + SW, lower triangle: a warp
    // takes R rows, a lane one column of them.  The rows' SW factors stay in
    // registers (R SW <= 64) and the R loads of a column go out together, so
    // that more of the trailing triangle is in flight from L2.
    constexpr int R = SW == 1 ? 16 : 64 / SW;
    const int k0 = j0 + SW;
    for (int g = k0 + warp * R; g < n; g += kCholWarps * R) {
      float pi[R][SW];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < SW; ++t) {
          const float v = g + r < n ? P[t][g + r] : 0.0f;
          pi[r][t] = t == SW - 1 ? v * rd : v;
        }
      const int last = min(g + R, n) - 1;
      for (int k = k0 + lane; k <= last; k += 32) {
        float* col = L + (size_t)g * n + k;  // L[g][k]
        float v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = k <= g + r && g + r < n ? col[(size_t)r * n] : 0.0f;
        float pk[SW];
#pragma unroll
        for (int t = 0; t < SW; ++t) pk[t] = t == SW - 1 ? P[t][k] * rd : P[t][k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = 0.0f;
#pragma unroll
          for (int t = 0; t < SW; ++t) s = fmaf(pi[r][t], pk[t], s);
          if (k <= g + r && g + r < n) col[(size_t)r * n] = v[r] - s;
        }
      }
    }
    __syncthreads();
  }
}

template <int SW>
int launch_tile_chol(const float* A, float* L, int n, void* stream) {
  if (n < 1 || n > kCholMaxN || n % SW) return (int)cudaErrorInvalidValue;
  tile_chol_kernel<SW><<<1, kCholThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, L, n);
  return (int)cudaGetLastError();
}

}  // namespace gpr

// A: (n, n) contiguous, only its upper triangle read; L: (n, n) contiguous,
// sharing no memory with A.  1 <= n <= 512.
extern "C" int gpr_tile_chol(const float* A, float* L, int n, void* stream) {
  return gpr::launch_tile_chol<1>(A, L, n, stream);
}

// As gpr_tile_chol, by strips of sw rows: sw in {8, 16}, sw | n.
extern "C" int gpr_tile_chol_strips(const float* A, float* L, int n, int sw, void* stream) {
  if (sw == 8) return gpr::launch_tile_chol<8>(A, L, n, stream);
  if (sw == 16) return gpr::launch_tile_chol<16>(A, L, n, stream);
  return (int)cudaErrorInvalidValue;
}
