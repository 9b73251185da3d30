// K9: the fused fleet.  For every member of a fleet of SPD matrices A (B, n, n)
// and right-hand sides Y (B, n, q), the lower Cholesky factor L and
// alpha = A^-1 Y, the whole factorization and solve in one launch.
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_batched.py::_fleet_kernel (line
// 560), launched by factor_solve_fused (654) with one grid step per member:
// blocked Crout factorization with in-kernel Schur updates, then block
// forward/backward substitution with the diagonal-block inverses (575-639).
//
// What bounds it on the H100: per member n^3/3 + 2 n^2 q FLOP against
// 4 (n(n+1)/2 + n^2 + 2 n q) bytes (A's lower triangle and Y read, L and alpha
// written), so the fleet is FLOP bound by the bytes-to-FLOP ratio; but the
// work of a member runs on one SM, and each panel's diagonal sweep is a chain
// of p dependent pivots (K7's latency), so the launch is bound by the slowest
// SM's sequence of sweeps and register-tile updates, not by the card's peak.
//
// Design: one block of 256 threads per member, so B = 128 members are one wave
// over 132 SMs.  A member (1 MiB at n = 512) does not fit shared memory, so the
// block factors its own (n, n) slice of L in place, panel by panel (width p):
//   1. L = tril(A): only A's lower triangle is read, L's strict upper is 0;
//   2. per panel k, the diagonal block through crout.cuh's sweep and inverse in
//      shared memory (K8's code: L_kk written back, W_k = L_kk^-1 kept in the
//      (B, n / p, p, p) scratch W); the panel solve P = S_pk W_k^T, 64 rows at
//      a time staged through shared memory, written over S_pk; the trailing
//      update S22 -= P P^T over its lower 64x64 tiles with gram_tile.cuh's
//      syrk_tile (a 64x64 FP32 register tile, summed in two levels; a diagonal tile
//      writes only its lower triangle, so L's strict upper stays 0 at any p);
//   3. alpha by the block substitution y_i = W_i (y_i - L[i, :i] y[:i]),
//      x_i = W_i^T (y_i - L[i+1:, i]^T x[i+1:]), 8 right-hand sides per pass,
//      the sums over L's rows spread over the block with coalesced loads.
// __syncthreads() between the stages orders the block's own global-memory
// writes; no other block touches the member, so no grid-wide sync is needed.
// No pointer is __restrict__: the block reads back what it wrote.
// A failed pivot makes its member's L and alpha NaN from that pivot on;
// the other members are untouched.
#include "crout.cuh"
#include "gram_tile.cuh"

namespace gpr {

static_assert(kThreads == kCroutThreads, "the sweep and the register tile share the block");

constexpr int kFusedMaxPanel = 128;
constexpr int kFusedMaxN = 2048;
constexpr int kRhs = 8;  // right-hand sides per substitution pass

__host__ __device__ constexpr int fused_chunk_rows(int p) { return p > kTile ? p : kTile; }

// Dynamic shared memory, in floats: the sweep tile or the panel-solve chunk,
// the inverse tile, and the substitution's partial sums and right-hand block.
__host__ __device__ constexpr int fused_smem_floats(int p) {
  return (fused_chunk_rows(p) + p) * (p | 1) + kThreads * kRhs + kFusedMaxPanel * kRhs;
}

__global__ void __launch_bounds__(kThreads)
    fleet_fused_kernel(const float* A, float* L, const float* Y, float* X, float* W, int n, int p,
                       int q) {
  extern __shared__ float smem[];
  __shared__ TileSmem ts;
  const int ld = p | 1;
  float* S = smem;                                // sweep tile / panel-solve chunk
  float* Ws = S + fused_chunk_rows(p) * ld;       // W_k
  float* part = Ws + p * ld;                      // (kThreads, kRhs)
  float* rhs = part + kThreads * kRhs;            // (p, kRhs)
  const int t = threadIdx.x;
  const int nb = n / p;
  const size_t member = blockIdx.x;
  const float* Am = A + member * n * n;
  float* Lm = L + member * n * n;
  const float* Ym = Y + member * n * q;
  float* Xm = X + member * n * q;
  float* Wm = W + member * nb * p * p;

  // 1. L = tril(A)
  for (int r = 0; r < n; ++r)
    for (int c = t; c < n; c += kThreads)
      Lm[(size_t)r * n + c] = c <= r ? Am[(size_t)r * n + c] : 0.0f;
  __syncthreads();

  // 2. the panels
  for (int k = 0; k < nb; ++k) {
    const int k0 = k * p;
    float* D = Lm + (size_t)k0 * n + k0;
    load_lower(S, ld, D, n, p);
    crout_sweep(S, ld, p);
    tri_inverse(S, Ws, ld, p);
    store_lower(S, ld, D, n, p);
    store_lower(Ws, ld, Wm + (size_t)k * p * p, p, p);
    __syncthreads();
    const int m = n - k0 - p;
    if (m == 0) break;

    // panel solve, in place: P[r, c] = sum_{j <= c} S_pk[r, j] W_k[c, j]
    float* P = Lm + (size_t)(k0 + p) * n + k0;
    const int tx = t % 16, ty = t / 16;
    for (int r0 = 0; r0 < m; r0 += kTile) {
      for (int e = t; e < kTile * p; e += kThreads) {
        const int r = e / p, c = e % p;
        S[r * ld + c] = r0 + r < m ? P[(size_t)(r0 + r) * n + c] : 0.0f;
      }
      __syncthreads();
      for (int c = tx; c < p; c += 16) {
        float acc[kPer] = {};
        for (int j = 0; j <= c; ++j) {
          const float w = Ws[c * ld + j];
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] = fmaf(S[(ty * kPer + i) * ld + j], w, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int r = r0 + ty * kPer + i;
          if (r < m) P[(size_t)r * n + c] = acc[i];
        }
      }
      __syncthreads();
    }

    // trailing update of the lower tiles: S22 -= P P^T
    float* S22 = Lm + (size_t)(k0 + p) * n + k0 + p;
    const int nt = (m + kTile - 1) / kTile;
    for (int i = 0; i < nt; ++i)
      for (int j = 0; j <= i; ++j) syrk_tile(S22, n, P, n, S22, n, m, p, i, j, true, ts);
    __syncthreads();
  }

  // 3. alpha, kRhs columns at a time
  const int lane = t % 32, warp = t / 32;
  const int groups = kThreads / p;
  for (int c0 = 0; c0 < q; c0 += kRhs) {
    const int qc = min(kRhs, q - c0);
    // forward: rhs = Y_i - L[i, :i] y[:i], then y_i = W_i rhs
    for (int i = 0; i < nb; ++i) {
      const int R = i * p;
      for (int r = warp; r < p; r += kThreads / 32) {
        float acc[kRhs] = {};
        const float* Lr = Lm + (size_t)(R + r) * n;
        for (int j = lane; j < R; j += 32) {
          const float l = Lr[j];
#pragma unroll
          for (int c = 0; c < kRhs; ++c)
            if (c < qc) acc[c] = fmaf(l, Xm[(size_t)j * q + c0 + c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < kRhs; ++c)
          for (int off = 16; off > 0; off /= 2) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
        if (lane == 0)
          for (int c = 0; c < qc; ++c) rhs[r * kRhs + c] = Ym[(size_t)(R + r) * q + c0 + c] - acc[c];
      }
      for (int e = t; e < p * p; e += kThreads) Ws[(e / p) * ld + e % p] = Wm[(size_t)i * p * p + e];
      __syncthreads();
      for (int e = t; e < p * qc; e += kThreads) {
        const int r = e / qc, c = e % qc;
        float acc = 0.0f;
        for (int j = 0; j <= r; ++j) acc = fmaf(Ws[r * ld + j], rhs[j * kRhs + c], acc);
        Xm[(size_t)(R + r) * q + c0 + c] = acc;
      }
      __syncthreads();
    }
    // backward: rhs = y_i - L[i+1:, i]^T x[i+1:], then x_i = W_i^T rhs
    for (int i = nb - 1; i >= 0; --i) {
      const int R = i * p;
      const int r = t % p, g = t / p;
      if (g < groups) {
        float acc[kRhs] = {};
        for (int s = R + p + g; s < n; s += groups) {
          const float l = Lm[(size_t)s * n + R + r];
#pragma unroll
          for (int c = 0; c < kRhs; ++c)
            if (c < qc) acc[c] = fmaf(l, Xm[(size_t)s * q + c0 + c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < kRhs; ++c) part[(g * p + r) * kRhs + c] = acc[c];
      }
      for (int e = t; e < p * p; e += kThreads) Ws[(e / p) * ld + e % p] = Wm[(size_t)i * p * p + e];
      __syncthreads();
      for (int e = t; e < p * qc; e += kThreads) {
        const int rr = e / qc, c = e % qc;
        float s = 0.0f;
        for (int gg = 0; gg < groups; ++gg) s += part[(gg * p + rr) * kRhs + c];
        rhs[rr * kRhs + c] = Xm[(size_t)(R + rr) * q + c0 + c] - s;
      }
      __syncthreads();
      for (int e = t; e < p * qc; e += kThreads) {
        const int rr = e / qc, c = e % qc;
        float acc = 0.0f;
        for (int j = rr; j < p; ++j) acc = fmaf(Ws[j * ld + rr], rhs[j * kRhs + c], acc);
        Xm[(size_t)(R + rr) * q + c0 + c] = acc;
      }
      __syncthreads();
    }
  }
}

}  // namespace gpr

// A, L: (B, n, n), Y, X: (B, n, q), W: (B, n / p, p, p) scratch, all float32
// and contiguous; L, X and W share no memory with A, Y or each other.
// n % p == 0, p <= 128, n <= 2048, q >= 1.
extern "C" int gpr_fleet_fused(const float* A, float* L, const float* Y, float* X, float* W,
                               int B, int n, int p, int q, void* stream) {
  using namespace gpr;
  if (B < 1 || p < 1 || p > kFusedMaxPanel || n < p || n > kFusedMaxN || n % p || q < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = fused_smem_floats(p) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fleet_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fleet_fused_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, L, Y, X, W, n,
                                                                                p, q);
  return (int)cudaGetLastError();
}
