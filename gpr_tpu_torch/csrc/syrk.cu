// K5: lower-triangle SYRK update  S = A22 - L21 L21^T  (the trailing update of
// the blocked Cholesky, gpr_tpu_torch/ops/blocked.py).
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_syrk.py::_syrk_kernel (line 73),
// launched by syrk_update (108).  It computes what that kernel computes, not
// its schedule: on the TPU one core walks a 1-D grid of lower output tiles
// (coordinates scalar-prefetched) with the contraction as a sequential grid
// axis that accumulates into a VMEM tile.  Here the grid is the
// nt (nt + 1) / 2 lower 64x64 output tiles, all in flight at once; each block
// decodes its own tile (i, j), j <= i, from blockIdx.x, runs the whole k loop
// itself with the 64x64 accumulator in registers (4x4 per thread), and stages
// k-slices of its two row tiles of L21 through shared memory.  The staging
// and the register-tile product, summed in two levels (partials of 128
// terms), are K2's (gram_tile.cuh: stage_rows, rank_update_chunk,
// fold_update); the whole tile is gram_tile.cuh's syrk_tile, which K9's
// trailing update runs too.
//
// Contracts, as on the TPU:
//   * only the lower tiles are computed and written; upper tiles (j > i) of
//     the output are never touched, so its strict upper is undefined beyond
//     the diagonal tiles, which are computed whole;
//   * A22 is read only where the output is written, so out may be A22 itself
//     (the recursion updates its buffer in place); out must share no memory
//     with L21.
// Unlike the TPU kernel it takes row strides (lda, ldl, ldo) and masks the
// ragged edge of m and k, so there is no alignment gate.
//
// What bounds it on the H100: about m^2 k FLOP for the lower tiles against
// (m^2 + m k) * 4 bytes, so it is compute bound.  At the n = 16383 top level
// (m = 8191, k = 8192) that is 5.5e11 FLOP, ~8.2 ms at the 67 TFLOP/s FP32
// peak, against ~0.2 ms of bytes at 3.35 TB/s.  This simple version runs
// plain FP32 FMA on the CUDA cores (the f32 grade the JAX package asks of its
// bf16x3 tier; no TF32).  3xTF32 / wgmma tensor-core tiles are later work.
#include "gram_tile.cuh"

namespace gpr {

// grid (nt (nt + 1) / 2), nt = ceil(m / 64); block (kThreads).
__global__ void __launch_bounds__(kThreads)
    syrk_update_kernel(const float* A22, size_t lda, const float* __restrict__ L21, size_t ldl,
                       float* out, size_t ldo, int m, int k) {
  __shared__ TileSmem sm;
  // tile t = i (i + 1) / 2 + j: the float estimate of i is corrected exactly
  const int t = blockIdx.x;
  int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  const int j = t - i * (i + 1) / 2;
  syrk_tile(A22, lda, L21, ldl, out, ldo, m, k, i, j, false, sm);
}

}  // namespace gpr

// A22 (m, m) row stride lda, L21 (m, k) row stride ldl, out (m, m) row stride
// ldo; out may be A22.  m >= 1, k >= 0.
extern "C" int gpr_syrk_update(const float* A22, int lda, const float* L21, int ldl, float* out,
                               int ldo, int m, int k, void* stream) {
  using namespace gpr;
  if (m < 1 || k < 0 || lda < m || ldo < m || ldl < k) return (int)cudaErrorInvalidValue;
  const int nt = (m + kTile - 1) / kTile;
  syrk_update_kernel<<<nt * (nt + 1) / 2, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A22, (size_t)lda, L21, (size_t)ldl, out, (size_t)ldo, m, k);
  return (int)cudaGetLastError();
}
