// K12 leaf_chol: L = chol(A); K13 leaf_chol_wi: (L, W = L^-1) from one
// factorization; K14 tri_inv_leaf: W = L^-1 of a lower-triangular L.  Each
// takes one whole recursion leaf, s x s with s % 64 == 0 (the wrappers keep the
// JAX package's gate: s % 256 == 0, s <= 1024), as a strided view.
//
// They replace the TPU kernels of gpr_tpu/ops/pallas_leaf.py: K12 _leaf_kernel
// (line 47, launched by leaf_cholesky, 99), K13 _leaf_wi_kernel (118, by
// leaf_cholesky_wi, 222; the one the blocked recursion dispatches under
// GPR_CHOL_LEAF_INV=1) and K14 _tri_inv_kernel (239, by tri_inv_leaf, 294).
// They compute what those compute, not their blocking.  The TPU kernel keeps
// the whole leaf in VMEM (4 MiB at s = 1024) and walks 256-wide diagonal
// blocks in one program.  A Hopper block has at most 227 KB of shared memory,
// so here the leaf stays in device memory (L2 holds it) and one launch of a
// persistent grid walks it, with a grid-wide barrier between dependent phases.
// The launch is cooperative (cudaLaunchCooperativeKernel), so every block is
// resident and the barrier cannot deadlock; a barrier that waits ~9 s traps
// rather than hang the card.  The diagonal block is 64, one register tile:
//
//   factor (K12, K13), right-looking, for k = 0 .. nb - 1:
//     diagonal   one block: L_kk = chol(A_kk) and V_k = L_kk^-1 in shared memory
//                (crout.cuh: crout_sweep, tri_inverse, as K7-K9)
//     column     L_ik = A_ik V_k^T for i > k, a tile per block
//     trailing   the lower 64x64 tiles of A22 -= L21 L21^T (gram_tile.cuh:
//                syrk_tile, K9's tile); the block that updates the next
//                diagonal tile factors it in the same phase
//   inverse (K13, K14), by block doubling over the 64-tiles: at width w (1, 2,
//   4, ...) each pair of ranges A = [a0, a0 + w), C = [a0 + w, a0 + 2w) of
//   tiles, whose inverses W_A and W_C are known, gets
//     W_CA = -W_C (L_CA W_A)
//   in two phases: X^T = -(L_CA W_A)^T into W's strict upper (scratch, zeroed
//   at the end), then W_CA = W_C (-X).  Every product skips the zero tiles of
//   its triangular factor.  K14 first inverts the diagonal tiles, a block each.
//
// Every sum runs in two levels (partials of 128 terms, gram_tile.cuh:
// fold_update), as K9 and K16 do.
//
// Contracts kept from the TPU kernels:
//   * only the lower triangle of the input is read: its strict upper may hold
//     NaN or junk (the port's in-place recursion leaves A's upper triangle
//     there);
//   * the outputs have an exactly-zero strict upper triangle;
//   * a non-positive (or NaN) pivot gives NaN through sqrtf with no clamp
//     (crout.cuh) and the NaN reaches every later block, so L[-1, -1] is NaN
//     and W is not finite: the caller's O(1) check and jitter retry work.
// K12 and K13 may factor in place (L the same view as A); W shares no memory
// with A or L.
//
// What bounds them on the H100: s^3 / 3 FLOP (K12, K14) or 2 s^3 / 3 (K13),
// 0.36 / 0.72 GFLOP at s = 1024, 5.3 / 10.7 us at 67 TFLOP/s FP32, against
// 4 (s(s+1)/2 + s^2) bytes (4 (s(s+1)/2 + 2 s^2) for K13), 2.7-4.2 us at
// 3.35 TB/s.  In practice the nb = s / 64 diagonal steps are a dependent chain
// on one block each (64 pivots a step, each a shared-memory barrier), and the
// ~2 nb + 2 log2(nb) grid barriers sit between them: latency, not bytes or
// FLOP.  Plain FP32 FMA; tensor cores and a shorter diagonal step are later
// work.
#include <cuda_runtime.h>

#include "leaf.cuh"

namespace gpr {

// grid: cooperative, at most as many blocks as resident (leaf.cuh: leaf_body).
template <bool FACTOR, bool INVERSE>
__global__ void __launch_bounds__(kThreads)
    leaf_kernel(const float* A, size_t lda, float* L, size_t ldl, float* W, size_t ldw, float* V,
                size_t ldv, long long v_step, int s, unsigned* bar) {
  __shared__ LeafSmem sm;
  leaf_body<FACTOR, INVERSE>(A, lda, L, ldl, W, ldw, V, ldv, v_step, s, bar, sm);
}

template <bool FACTOR, bool INVERSE>
int launch_leaf(const float* A, int lda, float* L, int ldl, float* W, int ldw, float* V, int ldv,
                long long v_step, int s, unsigned* bar, void* stream) {
  if (s < kLeafBlock || s % kLeafBlock || s > kLeafMax || ldl < s || (FACTOR && lda < s) ||
      (INVERSE && ldw < s))
    return (int)cudaErrorInvalidValue;
  auto kernel = leaf_kernel<FACTOR, INVERSE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int nb = s / kLeafBlock;
  const int most = nb * (nb - 1) / 2 > 1 ? nb * (nb - 1) / 2 : 1;  // the widest phase's tiles
  const int grid = per_sm * sms < most ? per_sm * sms : most;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  size_t lda_ = (size_t)lda, ldl_ = (size_t)ldl, ldw_ = (size_t)ldw, ldv_ = (size_t)ldv;
  void* args[] = {&A, &lda_, &L, &ldl_, &W, &ldw_, &V, &ldv_, &v_step, &s, &bar};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gpr

// A, L: (s, s) row-major views, row strides lda and ldl (L may be A); V: a
// (64, 64) float scratch; bar: two zeroed unsigned ints.
extern "C" int gpr_leaf_chol(const float* A, int lda, float* L, int ldl, float* V, int s,
                             unsigned* bar, void* stream) {
  return gpr::launch_leaf<true, false>(A, lda, L, ldl, nullptr, 0, V, gpr::kLeafBlock, 0, s, bar,
                                       stream);
}

// As gpr_leaf_chol; W: (s, s), row stride ldw, sharing no memory with A or L.
extern "C" int gpr_leaf_chol_wi(const float* A, int lda, float* L, int ldl, float* W, int ldw,
                                int s, unsigned* bar, void* stream) {
  const long long v_step = (long long)gpr::kLeafBlock * (ldw + 1);
  return gpr::launch_leaf<true, true>(A, lda, L, ldl, W, ldw, W, ldw, v_step, s, bar, stream);
}

// L: (s, s) lower-triangular (only its lower triangle is read), W: (s, s).
extern "C" int gpr_tri_inv_leaf(const float* L, int ldl, float* W, int ldw, int s, unsigned* bar,
                                void* stream) {
  return gpr::launch_leaf<false, true>(nullptr, 0, const_cast<float*>(L), ldl, W, ldw, nullptr, 0,
                                       0, s, bar, stream);
}
