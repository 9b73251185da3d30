// The Cholesky-Crout sweep of one small SPD tile in shared memory, and the
// inverse of its factor: the one copy of both, shared by K8 crout_chol_wi
// (crout.cu) and K9 fleet_fused (fleet.cu), as the JAX package keeps one
// _crout_sweep (gpr_tpu/ops/pallas_batched.py:47-196) for its three fleet
// kernels.  K7 crout_chol (crout.cu) no longer runs it: it factors by 32-wide
// blocks on chol.cuh's warp pieces.
//
// Every function here is called by all kCroutThreads threads of a block;
// all but store_lower end with a barrier.  A tile is b x b, 1 <= b <= 128, row stride ld (odd,
// b | 1, so that a warp's column accesses hit distinct banks).
#pragma once

#include <cuda_runtime.h>

namespace gpr {

constexpr int kCroutThreads = 256;

// S[r, c] = src[r, c] for c <= r; the strict upper of S is not written.
__device__ __forceinline__ void load_lower(float* S, int ld, const float* src, size_t src_ld,
                                           int b) {
  for (int e = threadIdx.x; e < b * b; e += kCroutThreads) {
    const int r = e / b, c = e % b;
    if (c <= r) S[r * ld + c] = src[r * src_ld + c];
  }
  __syncthreads();
}

// dst[r, c] = S[r, c] for c <= r and exactly 0 above the diagonal.
__device__ __forceinline__ void store_lower(const float* S, int ld, float* dst, size_t dst_ld,
                                            int b) {
  for (int e = threadIdx.x; e < b * b; e += kCroutThreads) {
    const int r = e / b, c = e % b;
    dst[r * dst_ld + c] = c <= r ? S[r * ld + c] : 0.0f;
  }
}

// In place, the lower triangle of S -> its lower Cholesky factor L; the strict
// upper of S is neither read nor written.  A right-looking column sweep: thread
// t owns column l = t % b and rows rg, rg + G, ... (rg = t / b, G = 256 / b row
// groups).  One barrier per column: step k updates the trailing lower triangle
// from the unscaled column k (each thread scales its own factors by
// 1 / sqrt(pivot)) and scales column k - 1, which no thread reads in step k.
// The scale is 1.0f / sqrtf(pivot), both correctly rounded: rsqrtf's 2-ulp
// error scales a whole column the same way, and over two panels it tripled
// the fleet MLL gradient's error on the H100 (PERF.md section 6).  A
// non-positive (or NaN) pivot gives NaN through sqrtf, with no clamp and no
// early exit: L[k, k] = piv / sqrt(piv) is NaN for piv <= 0, and so is every
// later pivot of the tile, so its L[-1, -1].
__device__ __forceinline__ void crout_sweep(float* S, int ld, int b) {
  const int t = threadIdx.x;
  const int groups = kCroutThreads / b;
  const int l = t % b;
  const int rg = t / b;
  const bool active = rg < groups;
  // this thread's first row at or below the diagonal of its column
  const int i0 = l <= rg ? rg : rg + ((l - rg + groups - 1) / groups) * groups;

  float rd_prev = 0.0f;
  for (int k = 0; k < b; ++k) {
    const float rd = 1.0f / sqrtf(S[k * ld + k]);  // NaN for a negative pivot, inf for 0
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
}

// W = L^-1 for the factor L in the lower triangle of S, lower triangle and
// exact-zero upper, by forward substitution after the sweep: thread t < b
// solves L w = e_t for column t of W.  The columns are independent, so this
// takes no barrier, where JAX's in-sweep substitution (pallas_batched.py:
// 104-116) adds a row matvec to every step of the sweep's serial chain; both
// compute the same W.  A NaN on L's diagonal makes the rows of W from there on
// NaN.
__device__ __forceinline__ void tri_inverse(const float* S, float* W, int ld, int b) {
  const int t = threadIdx.x;
  if (t < b) {
    for (int i = 0; i < t; ++i) W[i * ld + t] = 0.0f;
    for (int i = t; i < b; ++i) {
      float acc = i == t ? 1.0f : 0.0f;
      for (int k = t; k < i; ++k) acc = fmaf(-S[i * ld + k], W[k * ld + t], acc);
      W[i * ld + t] = acc / S[i * ld + i];
    }
  }
  __syncthreads();
}

}  // namespace gpr
