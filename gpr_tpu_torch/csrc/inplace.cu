// Two of the in-place Cholesky schedule's three kernels, each rewriting one
// (n, n) row-major float32 buffer S in place (gpr_tpu_torch/ops/inplace_chol.py):
//
//   K16 rank_update_tiles  S[i, j] -= S[i, kc] S[j, kc]^T over listed (bm x bm)
//                          target tiles (rows[t], cols[t]), contracting over
//                          the listed bk-wide column tiles kcols; the whole
//                          target tile, diagonal tiles included.  Replaces
//                          gpr_tpu/ops/inplace_chol.py::_rank_update_call
//                          (line 53; its kernel wraps pallas_syrk.py::
//                          _syrk_kernel), launched by rank_update_inplace (105).
//   K18 zero_upper         the strict upper of listed (bm x bm) tiles zeroed:
//                          diagonal tiles masked, strictly-upper tiles written
//                          without being read, so NaN there never reaches the
//                          factor.  Replaces _tril_kernel (201), launched by
//                          _tril_call (212) from zero_upper_inplace (229).
//
// The third, K17 panel_inplace (the 256-wide column panel factored in place),
// lives in panel.cu beside K15 panel_factor, whose two kernels it shares.
//
// JAX passes the tile lists as scalar prefetch; here they are int32 arrays in
// device memory that each block reads for itself (the wrapper builds them once
// per shape).  The TPU grid walks the target tiles in order; here every
// (bm x bm) target tile is cut into (bm / 128)^2 tiles of 128 x 128, each one
// block of tc_tile.cuh's 3xTF32 tensor-core tile (tc_rank_tile, as K2 and K5:
// wgmma.m64n128k8, A split in registers, B split once per 32-deep slice, a
// cp.async ring, each slice's tensor-core partial folded into an FP32
// running tile), and all run at once.  A run of consecutive column tiles in
// kcols (the schedule's lists are one run) is one contraction with one
// epilogue, S -= run over the whole 128 x 128 tile; a list with gaps takes one
// epilogue per run.  The target tile is prefetched into L2 when the block
// starts, so the epilogue's read does not wait on device memory (11 % of
// K16's time at n = 16384, PERF.md).  That is race-free because no target
// tile overlaps the source columns (the schedule's targets lie strictly right
// of them) and each target element is written by one block only; S is not __restrict__, since
// the kernel reads, by cp.async, the buffer other blocks write (as K9,
// fleet.cu).
//
// What bounds them on the H100, per n = 16384 factorization (w = 512, b =
// 256): K16 ~1.5e12 FLOP in 63 calls (the 5456 wide 512-tiles and 1024 narrow
// 256-tiles), 9.1 ms at the 3xTF32 tier (495 / 3 = 165 TFLOP/s), 22.4 ms at
// 67 TFLOP/s FP32, far above its bytes: compute bound.  Each call's k is only
// 256 or 512 (8 or 16 slices), so the ring's fill and the epilogue's
// read-modify-write weigh more than in K5, and the last calls' grids (4-48
// tiles of 128) leave most SMs idle.  K18 must write the strict upper, n (n - 1) / 2
// floats = 0.54 GB: 0.16 ms at 3.35 TB/s, bytes bound (it reads and writes
// the diagonal tiles whole, ~9 % more bytes than that).
#include <cuda_runtime.h>

#include "tc_tile.cuh"

namespace gpr {

constexpr int kZeroThreads = 256;  // K18's block: a float4 a thread
constexpr int kZeroTile = 64;      // K18's tiles are multiples of this

// grid: T (bm / 128)^2 blocks; block (t, a, b) the 128 x 128 tile (a, b) of
// list tile t; dynamic shared memory kTcSmem.
__global__ void __launch_bounds__(kTcThreads, 1)
    rank_update_tiles(float* S, int n, const int* __restrict__ rows, const int* __restrict__ cols,
                      const int* __restrict__ kcols, int ks, int bm, int bk) {
  extern __shared__ __align__(128) float tc_smem[];
  const int per = bm / kTcRows;
  const int t = blockIdx.x / (per * per);
  const int sub = blockIdx.x % (per * per);
  const int row0 = rows[t] * bm + (sub / per) * kTcRows;
  const int col0 = cols[t] * bm + (sub % per) * kTcRows;
  // run.v[4 c + f] is row 16 w + g + 8 (f >> 1), columns 8 c + 2 t + (f & 1)
  // of the tile (tc_tile.cuh::TcAcc)
  const int r = row0 + (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4;
  const int c = col0 + 2 * (threadIdx.x % 4);
  // the target tile into L2 while the contraction runs, so that the
  // epilogue's read-modify-write finds it there: 128 rows of 512 B, two
  // 128-byte lines a thread
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = threadIdx.x + u * kTcThreads;
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(S + (size_t)(row0 + e / 4) * n + col0 + 32 * (e % 4)));
  }
  for (int s = 0; s < ks;) {
    int e = s + 1;
    while (e < ks && kcols[e] == kcols[e - 1] + 1) ++e;
    const size_t k0 = (size_t)kcols[s] * bk;
    TcAcc run;
    tc_rank_tile(S + (size_t)row0 * n + k0, S + (size_t)col0 * n + k0, (size_t)n,
                 (e - s) * bk / kTcK, tc_smem, run);
#pragma unroll
    for (int cc = 0; cc < kTcRows / 8; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(S + (size_t)(r + 8 * h) * n + c + 8 * cc);
        float2 v = *p;
        v.x -= run.v[4 * cc + 2 * h];
        v.y -= run.v[4 * cc + 2 * h + 1];
        *p = v;
      }
    __syncthreads();  // the next run refills the shared memory
    s = e;
  }
}

// grid: T bm^2 / (4 kZeroThreads) blocks, each thread one float4 of list tile t
__global__ void __launch_bounds__(kZeroThreads)
    zero_upper(float* S, int n, const int* __restrict__ ti, const int* __restrict__ tj,
               const int* __restrict__ dg, int bm) {
  const int per = bm * bm / (4 * kZeroThreads);
  const int t = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kZeroThreads + threadIdx.x;
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

// S: (n, n) contiguous and 16-byte aligned; rows, cols (T) and kcols (ks):
// int32 tile coordinates in device memory, in units of bm and bk.  n % bm ==
// 0, n % bk == 0, bm % 128 == 0, bk % 32 == 0 (so that every row start of a
// contraction is 16-byte aligned for cp.async).
extern "C" int gpr_rank_update_tiles(float* S, int n, const int* rows, const int* cols,
                                     const int* kcols, int T, int ks, int bm, int bk,
                                     void* stream) {
  using namespace gpr;
  if (n < 1 || T < 1 || ks < 1 || bm < kTcRows || bm % kTcRows || bk < kTcK || bk % kTcK ||
      n % bm || n % bk || reinterpret_cast<size_t>(S) % 16 ||
      (long long)T * (bm / kTcRows) * (bm / kTcRows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(rank_update_tiles,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = T * (bm / kTcRows) * (bm / kTcRows);
  rank_update_tiles<<<blocks, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
      S, n, rows, cols, kcols, ks, bm, bk);
  return (int)cudaGetLastError();
}

// S: (n, n) contiguous and 16-byte aligned; ti, tj, dg (T): int32 tile
// coordinates in units of bm and 1 for a diagonal tile, in device memory.
// n % bm == 0, bm % 64 == 0.
extern "C" int gpr_zero_upper(float* S, int n, const int* ti, const int* tj, const int* dg, int T,
                              int bm, void* stream) {
  using namespace gpr;
  const long long per = (long long)bm * bm / (4 * kZeroThreads);
  if (n < 1 || T < 1 || bm < kZeroTile || bm % kZeroTile || n % bm || per * T > 0x7fffffffLL ||
      reinterpret_cast<size_t>(S) % 16)
    return (int)cudaErrorInvalidValue;
  zero_upper<<<(int)(per * T), kZeroThreads, 0, static_cast<cudaStream_t>(stream)>>>(S, n, ti, tj, dg,
                                                                                 bm);
  return (int)cudaGetLastError();
}
