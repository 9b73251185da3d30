// K7: L = chol(A), and K8: (L, W = L^-1), for a batch of small SPD tiles A
// (B, b, b), 1 <= b <= 128.
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
// with W): the lower triangle read, the whole tiles written.  The pace is the
// chain of b dependent pivots.
//
// One CTA of 256 threads a tile runs crout.cuh's blocked factor (a warp's
// 32-wide diagonal block in registers with no barrier per pivot, the other
// warps on the trailing 32x32 tiles, two barriers a block column) on the
// tile's lower triangle, column-major in shared memory and padded with the
// identity to bp = 32 ceil(b / 32) (column stride bp + 4: 67.7 KB at b = 128,
// three CTAs an SM).  K8 runs the same factor on the tile with bp identity
// rows below it, which the factor's own row solves and tile updates turn into
// W^T on the way (column stride 2 bp + 4: 133.2 KB at b = 128, one CTA an SM;
// 33.8 KB at b = 64).
//
// Contracts kept from the TPU kernels:
//   * only A[r, c] with r >= c is read;
//   * the strict upper triangles of L and W are written as exact zeros;
//   * a non-positive (or NaN) pivot gives NaN through sqrtf (the scale is
//     1.0f / sqrtf, never rsqrtf: crout.cuh), with no clamp and no early exit,
//     in its tile only: its L[-1, -1] and W[-1, -1] are NaN.  The identity
//     padding lies after every real pivot, so it never hides a failure.
//     Other tiles are untouched.
// A and L may be one tensor (in place): a block reads its whole tile before
// it writes any of it.  W must share no memory with A.  Each is addressed with
// a batch and a row stride, so the tiles may be the diagonal blocks of a
// larger (B, n, n) buffer.
#include "chol.cuh"
#include "crout.cuh"

namespace gpr {

constexpr int kCroutMaxTile = 128;

// grid (B); dynamic shared memory bp (bp + 4) + 32 floats (K7), bp (2 bp + 4)
// + 32 (K8).  A and L may alias: no __restrict__.
__global__ void __launch_bounds__(kCroutThreads)
    crout_chol_kernel(const float* A, long long a_bs, int a_ld, float* L, long long l_bs, int l_ld, int b) {
  extern __shared__ __align__(16) float S[];
  const int nt = (b + kCholNb - 1) / kCholNb, bp = kCholNb * nt, ld = bp + kCholPad;
  crout_load(S, ld, A + blockIdx.x * a_bs, a_ld, b);
  __syncthreads();
  crout_factor(S, ld, nt, S + bp * ld);
  crout_store(S, ld, L + blockIdx.x * l_bs, l_ld, b);
}

__global__ void __launch_bounds__(kCroutThreads)
    crout_chol_wi_kernel(const float* A, long long a_bs, int a_ld, float* L, long long l_bs, int l_ld, float* W,
                         long long w_bs, int w_ld, int b) {
  extern __shared__ __align__(16) float S[];
  const int nt = (b + kCholNb - 1) / kCholNb, bp = kCholNb * nt, ld = 2 * bp + kCholPad;
  crout_load<true>(S, ld, A + blockIdx.x * a_bs, a_ld, b);
  __syncthreads();
  crout_factor<true>(S, ld, nt, S + bp * ld);
  crout_store(S, ld, L + blockIdx.x * l_bs, l_ld, b);
  crout_store_w(S, ld, bp, W + blockIdx.x * w_bs, w_ld, b);
}

}  // namespace gpr

// A, L: (B, b, b) float32 tiles, element [t, r, c] at t * bs + r * ld + c.
extern "C" int gpr_crout_chol(const float* A, long long a_bs, int a_ld, float* L, long long l_bs,
                              int l_ld, int B, int b, void* stream) {
  using namespace gpr;
  if (B < 1 || b < 1 || b > kCroutMaxTile) return (int)cudaErrorInvalidValue;
  const int bp = kCholNb * ((b + kCholNb - 1) / kCholNb);
  const int smem = (bp * (bp + kCholPad) + kCholNb) * (int)sizeof(float);
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
  const int bp = kCholNb * ((b + kCholNb - 1) / kCholNb);
  const int smem = (bp * (2 * bp + kCholPad) + kCholNb) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(crout_chol_wi_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  crout_chol_wi_kernel<<<B, kCroutThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, a_bs, a_ld, L, l_bs, l_ld, W, w_bs, w_ld, b);
  return (int)cudaGetLastError();
}
