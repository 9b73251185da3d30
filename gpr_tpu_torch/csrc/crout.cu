// K7: L = chol(A) for a batch of small SPD tiles A (B, b, b), b <= 128,
// by a right-looking column sweep in shared memory.
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_batched.py::_crout_l_kernel
// (line 205), the W-free _crout_sweep (47-196, with_w=False), launched by
// crout_chol (211) once per panel step of the fleet factorization for the
// diagonal blocks of every member.
//
// What bounds it on the H100: neither bytes nor FLOP.  A tile is b^3/3 FLOP
// and 4 (b(b+1)/2 + b^2) bytes (the lower triangle read, the whole tile
// written); the sweep is b dependent pivots, each a shared-memory
// barrier, so a launch is latency bound.  Design: one block of 256 threads
// per tile, the tile in shared memory with an odd row stride (b | 1, as K3
// in fullchol.cu) so that a warp's column accesses hit distinct banks.
// Thread t owns column l = t % b and rows rg, rg + G, ... (rg = t / b,
// G = 256 / b row groups), so its updates need no index arithmetic.  One
// barrier per column: step k updates the trailing lower triangle from the
// unscaled column k (each thread scales its own factors by rsqrt(pivot))
// and scales column k - 1, which no thread reads in step k.
//
// Contracts kept from the TPU kernel:
//   * only A[r, c] with r >= c is read;
//   * the strict upper triangle of L is written as exact zeros;
//   * a non-positive (or NaN) pivot gives NaN through rsqrtf, with no clamp
//     and no early exit: L[k, k] = piv * rsqrt(piv) is NaN for piv <= 0, and
//     every later pivot of that tile, so its L[-1, -1], is NaN.  Other tiles
//     are untouched.
// A and L may be one tensor (in place): a block reads its whole tile before
// it writes any of it.  Both are addressed with a batch and a row stride,
// so the tiles may be the diagonal blocks of a larger (B, n, n) buffer.
#include <cuda_runtime.h>

namespace gpr {

constexpr int kCroutThreads = 256;
constexpr int kCroutMaxTile = 128;

__global__ void __launch_bounds__(kCroutThreads)
    crout_chol_kernel(const float* A, long long a_bs, int a_ld, float* L, long long l_bs, int l_ld,
                      int b) {  // A and L may alias: no __restrict__
  extern __shared__ float S[];
  const int ld = b | 1;
  const float* At = A + blockIdx.x * a_bs;
  float* Lt = L + blockIdx.x * l_bs;
  const int t = threadIdx.x;
  const int groups = kCroutThreads / b;
  const int l = t % b;
  const int rg = t / b;
  const bool active = rg < groups;
  // this thread's first row at or below the diagonal of its column
  const int i0 = l <= rg ? rg : rg + ((l - rg + groups - 1) / groups) * groups;

  for (int e = t; e < b * b; e += kCroutThreads) {
    const int r = e / b, c = e % b;
    if (c <= r) S[r * ld + c] = At[(size_t)r * a_ld + c];
  }
  __syncthreads();

  float rd_prev = 0.0f;
  for (int k = 0; k < b; ++k) {
    const float rd = rsqrtf(S[k * ld + k]);  // NaN for a negative pivot, inf for 0
    if (active && l > k) {
      const float m = S[l * ld + k] * rd;  // L[l, k]
      for (int i = i0; i < b; i += groups)
        S[i * ld + l] = fmaf(-(S[i * ld + k] * rd), m, S[i * ld + l]);
    }
    if (k > 0 && t < b - k + 1) S[(k - 1 + t) * ld + k - 1] *= rd_prev;  // column k-1 -> L
    rd_prev = rd;
    __syncthreads();
  }
  if (t == 0) S[(b - 1) * ld + b - 1] *= rd_prev;
  __syncthreads();

  for (int e = t; e < b * b; e += kCroutThreads) {
    const int r = e / b, c = e % b;
    Lt[(size_t)r * l_ld + c] = c <= r ? S[r * ld + c] : 0.0f;
  }
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
