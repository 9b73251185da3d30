// K5: lower-triangle SYRK update  S = A22 - L21 L21^T  (the trailing update of
// the blocked Cholesky, gpr_tpu_torch/ops/blocked.py).
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_syrk.py::_syrk_kernel (line 73),
// launched by syrk_update (108).  It computes what that kernel computes, not
// its schedule: on the TPU one core walks a 1-D grid of lower output tiles
// (coordinates scalar-prefetched) with the contraction as a sequential grid
// axis that accumulates into a VMEM tile.  Here the grid is the
// nt (nt + 1) / 2 lower 128x128 output tiles; each block decodes its own
// tile (i, j), j <= i, from blockIdx.x and runs the whole k loop itself on
// the tensor cores: tc_tile.cuh's 3xTF32 tile (wgmma.m64n128k8, A split in
// registers, B split once per 32-deep slice into shared memory, a cp.async
// ring), the 32-term tensor-core partial of each slice folded into an FP32
// running tile, as K2's products do.
//
// Contracts, as on the TPU:
//   * only the lower triangle of the output is written (the diagonal tiles
//     are computed whole, their upper part is dropped); the upper tiles
//     (j > i) are never touched;
//   * A22 is read only where the output is written, so out may be A22 itself
//     (the recursion updates its buffer in place).
// Unlike the TPU kernel it takes any (m, k): the wrapper (ops/syrk.py) hands
// it L21 copied into an aligned buffer of ceil(m / 128) * 128 rows and
// ceil(k / 32) * 32 columns, zero-filled, so that cp.async's 16-byte loads
// need no alignment gate (the recursion's views at odd n have rows 4 bytes
// apart from alignment) and the ragged rows and k tail add zeros; the
// epilogue masks the rows and columns at or past m.  A22 and out keep their
// row strides (lda, ldo), read and written by scalar accesses.
//
// What bounds it on the H100: about m^2 k FLOP for the lower tiles against
// (m^2 + m k) * 4 bytes, so it is compute bound.  At the n = 16383 top level
// (m = 8191, k = 8192) that is 5.5e11 FLOP, ~3.3 ms at the 3xTF32 tier (three
// TF32 products at 495 TFLOP/s for each FP32 one) and ~8.2 ms at the 67
// TFLOP/s FP32 peak, against ~0.2 ms of bytes at 3.35 TB/s; the aligned copy
// moves 2 m k * 4 bytes more (~0.16 ms there).
#include "tc_tile.cuh"

namespace gpr {

// grid (nt (nt + 1) / 2), nt = ceil(m / 128); block (kTcThreads); dynamic
// shared memory kTcSmem.
__global__ void __launch_bounds__(kTcThreads, 1)
    syrk_update_kernel(const float* A22, size_t lda, const float* __restrict__ Lp, size_t ldp,
                       float* out, size_t ldo, int m, int nk) {
  extern __shared__ __align__(128) float tc_smem[];
  // tile t = i (i + 1) / 2 + j: the float estimate of i is corrected exactly
  const int t = blockIdx.x;
  int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  const int j = t - i * (i + 1) / 2;
  TcAcc run;
  if (nk > 0) {
    tc_rank_tile(Lp + (size_t)i * kTcRows * ldp, Lp + (size_t)j * kTcRows * ldp, ldp, nk, tc_smem,
                 run);
  } else {
#pragma unroll
    for (int e = 0; e < 64; ++e) run.v[e] = 0.0f;
  }
  // run.v[4 c + f] is row 16 w + g + 8 (f >> 1), column 8 c + 2 t + (f & 1)
  // of the tile (tc_tile.cuh::TcAcc)
  const int r0 = i * kTcRows + (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4;
  const int c0 = j * kTcRows + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int c = 0; c < kTcRows / 8; ++c)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = r0 + 8 * (f >> 1);
      const int col = c0 + 8 * c + (f & 1);
      if (r < m && col <= r) out[(size_t)r * ldo + col] = A22[(size_t)r * lda + col] - run.v[4 * c + f];
    }
}

}  // namespace gpr

// A22 (m, m) row stride lda, out (m, m) row stride ldo, out may be A22; Lp
// (ceil(m / 128) * 128, ldp) holds L21 (m, k) zero-filled to k_pad columns,
// k_pad % 32 == 0, ldp >= k_pad, ldp % 4 == 0 and Lp 16-byte aligned.
extern "C" int gpr_syrk_update(const float* A22, int lda, const float* Lp, int ldp, float* out,
                               int ldo, int m, int k_pad, void* stream) {
  using namespace gpr;
  if (m < 1 || k_pad < 0 || k_pad % kTcK || lda < m || ldo < m || ldp < k_pad || ldp % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(syrk_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (m + kTcRows - 1) / kTcRows;
  syrk_update_kernel<<<nt * (nt + 1) / 2, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
      A22, (size_t)lda, Lp, (size_t)ldp, out, (size_t)ldo, m, k_pad / kTcK);
  return (int)cudaGetLastError();
}
