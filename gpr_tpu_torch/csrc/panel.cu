// K15 panel_factor: one (n, 256) Cholesky column panel [D; A21] -> [L_dd; L21],
// L_dd = chol(D) with D read from its upper triangle (as rows), L21 = A21
// L_dd^-T (gpr_tpu_torch/ops/panel.py).
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_panel.py::_panel_kernel (line
// 143), launched by panel_factor (163) for each panel of cholesky_panels and
// cholesky_left_panels (190, 220).  It computes what that kernel computes, not
// its blocking: panel.cuh has the scheme it shares with K17 panel_inplace.
// One launch is two kernels in stream order: panel_factor_diag (one block:
// D's upper mirrored into the output's top tile, factored in place, W =
// L_dd^-1 to scratch) and panel_factor_rows (one block per 64 rows below:
// L21 rows = A21 rows W^T, the products in the kernel body, not a library
// GEMM).  The input is read, never written.
//
// What bounds it on the H100, per panel of n rows: 256^3 / 3 FLOP for D and
// (n - 256) 256^2 for the rows' triangular solve (the products with W do 1.25x
// that), against 2 n 256 4 bytes read and written: at n = 8192, 0.53 GFLOP
// (7.9 us at 67 TFLOP/s FP32) against 16.8 MB (5.0 us at 3.35 TB/s).  In practice the
// diagonal tile is a dependent chain of four 64-wide steps on one SM, tens of
// microseconds each (K13's measured ~77 us a step, PERF.md section 6), while
// the card idles: latency, not FLOP.  Plain FP32 FMA.
#include <cuda_runtime.h>

#include "panel.cuh"

namespace gpr {

__global__ void __launch_bounds__(kThreads)
    panel_factor_diag(const float* P, size_t ldp, float* out, float* W) {
  __shared__ LeafSmem sm;
  panel_diag_upper_copy(P, ldp, out, kPanel);
  panel_diag(out, kPanel, W, sm);
}

// grid: (n - 256) / 64 blocks, block g the rows 256 + 64 g ..
__global__ void __launch_bounds__(kThreads)
    panel_factor_rows(const float* P, size_t ldp, float* out, const float* W) {
  __shared__ TileSmem sm;
  const size_t r0 = kPanel + (size_t)blockIdx.x * kTile;
  panel_row_strip(P + r0 * ldp, ldp, out + r0 * kPanel, kPanel, W, sm);
}

}  // namespace gpr

// P: (n, 256) row stride ldp (read only); out: (n, 256) contiguous, sharing no
// memory with P; W: a (256, 256) float scratch.  n % 256 == 0.
extern "C" int gpr_panel_factor(const float* P, int ldp, float* out, float* W, int n,
                                void* stream) {
  using namespace gpr;
  if (n < kPanel || n % kPanel || ldp < kPanel) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  panel_factor_diag<<<1, kThreads, 0, s>>>(P, (size_t)ldp, out, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == kPanel) return (int)err;
  panel_factor_rows<<<(n - kPanel) / kTile, kThreads, 0, s>>>(P, (size_t)ldp, out, W);
  return (int)cudaGetLastError();
}
