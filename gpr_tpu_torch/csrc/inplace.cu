// The in-place Cholesky schedule's three kernels, each rewriting one (n, n)
// row-major float32 buffer S in place (gpr_tpu_torch/ops/inplace_chol.py):
//
//   K16 rank_update_tiles  S[i, j] -= S[i, kc] S[j, kc]^T over listed (bm x bm)
//                          target tiles (rows[t], cols[t]), contracting over
//                          the listed bk-wide column tiles kcols; the whole
//                          target tile, diagonal tiles included.  Replaces
//                          gpr_tpu/ops/inplace_chol.py::_rank_update_call
//                          (line 53; its kernel wraps pallas_syrk.py::
//                          _syrk_kernel), launched by rank_update_inplace (105).
//   K17 panel_inplace      the 256-wide column panel at tile column c0t: its
//                          diagonal tile factored from its lower triangle
//                          (the strict upper may hold junk) with an exact-zero
//                          upper, every row tile below -> tile L_dd^-T.
//                          Replaces _panel_kernel_inplace (135), launched by
//                          _panel_call (162) from panel_inplace (184).
//   K18 zero_upper         the strict upper of listed (bm x bm) tiles zeroed:
//                          diagonal tiles masked, strictly-upper tiles written
//                          without being read, so NaN there never reaches the
//                          factor.  Replaces _tril_kernel (201), launched by
//                          _tril_call (212) from zero_upper_inplace (229).
//
// JAX passes the tile lists as scalar prefetch; here they are int32 arrays in
// device memory that each block reads for itself (the wrapper builds them once
// per shape).  The TPU grid walks the target tiles in order; here every
// (bm x bm) target tile is cut into (bm / 64)^2 register tiles of 64 x 64
// (gram_tile.cuh: stage_rows, rank_update_chunk, fold_update, syrk_tile's tile) and
// all run at once.  That is race-free because no target tile overlaps the
// source columns (the schedule's targets lie strictly right of them) and each
// target element is written by one block only; S is not __restrict__, since
// the kernel reads the buffer it writes (as K9, fleet.cu).  Sums in two levels
// (128-term partials).  K17 is panel.cuh's panel on S: the diagonal kernel,
// then the row kernel, in stream order, one counted launch.
//
// What bounds them on the H100, per n = 16384 factorization (w = 512, b =
// 256): K16 ~1.5e12 FLOP in 63 calls (the 5456 wide 512-tiles and 1024 narrow
// 256-tiles), 22.4 ms at 67 TFLOP/s FP32, far above its bytes: compute bound;
// plain FP32 FMA on the CUDA cores, measured ~70 ms (21.4 TFLOP/s, PERF.md
// section 6).  K17 3.4e10 FLOP (0.51 ms), but each of its 64 diagonal tiles is
// a chain of 4 dependent 64-wide steps on one SM: latency, ~0.5 ms a panel.
// K18 must write the strict upper, n (n - 1) / 2 floats = 0.54 GB: 0.16 ms
// at 3.35 TB/s, bytes bound (it reads and writes the diagonal tiles whole,
// ~9 % more bytes than that).
#include <cuda_runtime.h>

#include "gram_tile.cuh"
#include "panel.cuh"

namespace gpr {

// grid: T (bm / 64)^2 blocks; block (t, a, b) the register tile (a, b) of
// list tile t.
__global__ void __launch_bounds__(kThreads)
    rank_update_tiles(float* S, int n, const int* __restrict__ rows, const int* __restrict__ cols,
                      const int* __restrict__ kcols, int ks, int bm, int bk) {
  __shared__ TileSmem sm;
  const int per = bm / kTile;
  const int t = blockIdx.x / (per * per);
  const int sub = blockIdx.x % (per * per);
  const int row0 = rows[t] * bm + (sub / per) * kTile;
  const int col0 = cols[t] * bm + (sub % per) * kTile;
  float acc[kPer][kPer] = {};
  float part[kPer][kPer] = {};
  int c = 1;
  for (int s = 0; s < ks; ++s) {
    const int k1 = (kcols[s] + 1) * bk;
    for (int k0 = kcols[s] * bk; k0 < k1; k0 += kChunk, ++c) {
      stage_rows(sm.a, S, n, n, n, row0, k0);
      stage_rows(sm.b, S, n, n, n, col0, k0);
      __syncthreads();
      rank_update_chunk(sm, part);  // part -= S[rows, k] . S[cols, k]
      __syncthreads();
      if (c % kFold == 0) fold_update(acc, part);
    }
  }
  fold_update(acc, part);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      float* p = S + (size_t)(row0 + ty * kPer + a) * n + col0 + tx * kPer + b;
      *p += acc[a][b];
    }
}

// one block, the diagonal tile at (c0, c0): factor in place, W = L_dd^-1
__global__ void __launch_bounds__(kThreads) panel_inplace_diag(float* S, int n, int c0, float* W) {
  __shared__ LeafSmem sm;
  panel_diag(S + (size_t)c0 * (n + 1), (size_t)n, W, sm);
}

// grid: (n - c0 - 256) / 64 blocks, block g the rows c0 + 256 + 64 g .. in place
__global__ void __launch_bounds__(kThreads) panel_inplace_rows(float* S, int n, int c0,
                                                               const float* W) {
  __shared__ TileSmem sm;
  float* R = S + (size_t)(c0 + kPanel + blockIdx.x * kTile) * n + c0;
  panel_row_strip(R, (size_t)n, R, (size_t)n, W, sm);
}

// grid: T bm^2 / (4 kThreads) blocks, each thread one float4 of list tile t
__global__ void __launch_bounds__(kThreads)
    zero_upper(float* S, int n, const int* __restrict__ ti, const int* __restrict__ tj,
               const int* __restrict__ dg, int bm) {
  const int per = bm * bm / (4 * kThreads);
  const int t = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kThreads + threadIdx.x;
  const int r = e / (bm / 4), c = e % (bm / 4) * 4;
  float4* p = reinterpret_cast<float4*>(S + (size_t)(ti[t] * bm + r) * n + tj[t] * bm + c);
  if (dg[t]) {
    float4 v = *p;
    if (c > r) v.x = 0.0f;
    if (c + 1 > r) v.y = 0.0f;
    if (c + 2 > r) v.z = 0.0f;
    if (c + 3 > r) v.w = 0.0f;
    *p = v;
  } else {
    *p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace gpr

// S: (n, n) contiguous; rows, cols (T) and kcols (ks): int32 tile coordinates
// in device memory, in units of bm and bk.  n % bm == 0, n % bk == 0,
// bm % 64 == 0, bk % 16 == 0.
extern "C" int gpr_rank_update_tiles(float* S, int n, const int* rows, const int* cols,
                                     const int* kcols, int T, int ks, int bm, int bk,
                                     void* stream) {
  using namespace gpr;
  if (n < 1 || T < 1 || ks < 1 || bm < kTile || bm % kTile || bk < kChunk || bk % kChunk ||
      n % bm || n % bk || (long long)T * (bm / kTile) * (bm / kTile) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int blocks = T * (bm / kTile) * (bm / kTile);
  rank_update_tiles<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      S, n, rows, cols, kcols, ks, bm, bk);
  return (int)cudaGetLastError();
}

// S: (n, n) contiguous, n % 256 == 0; W: a (256, 256) float scratch.
extern "C" int gpr_panel_inplace(float* S, int n, int c0t, float* W, void* stream) {
  using namespace gpr;
  const int c0 = c0t * kPanel;
  if (n < kPanel || n % kPanel || c0t < 0 || c0 >= n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  panel_inplace_diag<<<1, kThreads, 0, s>>>(S, n, c0, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || c0 + kPanel == n) return (int)err;
  panel_inplace_rows<<<(n - c0 - kPanel) / kTile, kThreads, 0, s>>>(S, n, c0, W);
  return (int)cudaGetLastError();
}

// S: (n, n) contiguous and 16-byte aligned; ti, tj, dg (T): int32 tile
// coordinates in units of bm and 1 for a diagonal tile, in device memory.
// n % bm == 0, bm % 64 == 0.
extern "C" int gpr_zero_upper(float* S, int n, const int* ti, const int* tj, const int* dg, int T,
                              int bm, void* stream) {
  using namespace gpr;
  const long long per = (long long)bm * bm / (4 * kThreads);
  if (n < 1 || T < 1 || bm < kTile || bm % kTile || n % bm || per * T > 0x7fffffffLL ||
      reinterpret_cast<size_t>(S) % 16)
    return (int)cudaErrorInvalidValue;
  zero_upper<<<(int)(per * T), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(S, n, ti, tj, dg,
                                                                                 bm);
  return (int)cudaGetLastError();
}
