// K7: L = chol(A), and K8: (L, W = L^-1), for a batch of small SPD tiles A
// (B, b, b), b <= 128, by a right-looking column sweep in shared memory
// (crout.cuh).
//
// K7 replaces the TPU kernel gpr_tpu/ops/pallas_batched.py::_crout_l_kernel
// (line 205), the W-free _crout_sweep (47-196, with_w=False), launched by
// crout_chol (211) once per panel step of the fleet factorization for the
// diagonal blocks of every member.  K8 replaces ::_crout_wi_kernel (199), the
// with-W sweep (97-117, step2 119-173), launched by crout_chol_wi (253) from
// the fleet solve without the diagonal-block inverses (cho_solve_batched,
// 494-506: one launch on the (B n / p, p, p) tiles D D^T) and per panel step
// under GPR_FLEET_DIAG=crout (392-393).
//
// What bounds them on the H100: neither bytes nor FLOP.  A tile is b^3/3 FLOP
// for L (2 b^3 / 3 with W) and 4 (b(b+1)/2 + b^2) bytes (4 (b(b+1)/2 + 2 b^2)
// with W): the lower triangle read, the whole tiles written.  The sweep is b
// dependent pivots, each a shared-memory barrier, so a launch is latency
// bound.  Design: one block of 256 threads per tile, the tile in shared memory
// (crout.cuh: crout_sweep); K8 then forms W in a second shared tile by a
// column-parallel forward substitution that needs no barrier (tri_inverse),
// 2 b (b | 1) * 4 bytes of shared memory, 132 KB at b = 128.
//
// Contracts kept from the TPU kernels:
//   * only A[r, c] with r >= c is read;
//   * the strict upper triangles of L and W are written as exact zeros;
//   * a non-positive (or NaN) pivot gives NaN through sqrtf, with no clamp
//     and no early exit, in its tile only: its L[-1, -1] and W[-1, -1] are
//     NaN.  Other tiles are untouched.
// A and L may be one tensor (in place): a block reads its whole tile before
// it writes any of it.  W must share no memory with A.  Each is addressed with
// a batch and a row stride, so the tiles may be the diagonal blocks of a
// larger (B, n, n) buffer.
#include "crout.cuh"

namespace gpr {

constexpr int kCroutMaxTile = 128;

__global__ void __launch_bounds__(kCroutThreads)
    crout_chol_kernel(const float* A, long long a_bs, int a_ld, float* L, long long l_bs, int l_ld,
                      int b) {  // A and L may alias: no __restrict__
  extern __shared__ float S[];
  const int ld = b | 1;
  load_lower(S, ld, A + blockIdx.x * a_bs, a_ld, b);
  crout_sweep(S, ld, b);
  store_lower(S, ld, L + blockIdx.x * l_bs, l_ld, b);
}

__global__ void __launch_bounds__(kCroutThreads)
    crout_chol_wi_kernel(const float* A, long long a_bs, int a_ld, float* L, long long l_bs,
                         int l_ld, float* W, long long w_bs, int w_ld, int b) {
  extern __shared__ float S[];
  const int ld = b | 1;
  float* Ws = S + b * ld;
  load_lower(S, ld, A + blockIdx.x * a_bs, a_ld, b);
  crout_sweep(S, ld, b);
  tri_inverse(S, Ws, ld, b);
  store_lower(S, ld, L + blockIdx.x * l_bs, l_ld, b);
  store_lower(Ws, ld, W + blockIdx.x * w_bs, w_ld, b);
}

}  // namespace gpr

// A, L: (B, b, b) float32 tiles, element [t, r, c] at t * bs + r * ld + c.
extern "C" int gpr_crout_chol(const float* A, long long a_bs, int a_ld, float* L, long long l_bs,
                              int l_ld, int B, int b, void* stream) {
  using namespace gpr;
  if (B < 1 || b < 1 || b > kCroutMaxTile) return (int)cudaErrorInvalidValue;
  const int smem = b * (b | 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(crout_chol_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  crout_chol_kernel<<<B, kCroutThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, a_bs, a_ld, L, l_bs, l_ld, b);
  return (int)cudaGetLastError();
}

// A, L, W: (B, b, b) float32 tiles addressed as above.
extern "C" int gpr_crout_chol_wi(const float* A, long long a_bs, int a_ld, float* L,
                                 long long l_bs, int l_ld, float* W, long long w_bs, int w_ld,
                                 int B, int b, void* stream) {
  using namespace gpr;
  if (B < 1 || b < 1 || b > kCroutMaxTile) return (int)cudaErrorInvalidValue;
  const int smem = 2 * b * (b | 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(crout_chol_wi_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  crout_chol_wi_kernel<<<B, kCroutThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, a_bs, a_ld, L, l_bs, l_ld, W, w_bs, w_ld, b);
  return (int)cudaGetLastError();
}
