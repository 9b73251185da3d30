// K14 tri_inv_leaf's walk (leaf.cu): W = L^-1 of a whole leaf on one
// cooperative launch of a persistent grid, the leaf in device memory (L2
// holds it), 64-wide diagonal blocks inverted a block each, then block
// doubling with a grid-wide barrier between dependent phases.  leaf.cu's
// header explains the scheme.
//
// Every function is called by all kThreads threads of every block of the
// grid; tri_inv_body's grid barriers (grid_sync) need a cooperative launch.
#pragma once

#include <cuda_runtime.h>

#include "gram_tile.cuh"

namespace gpr {

constexpr int kLeafBlock = kTile;  // 64: the diagonal block is one register tile
constexpr int kLeafMax = 1024;
constexpr int kDiagLd = kLeafBlock | 1;
constexpr long long kBarrierTimeout = 1LL << 34;  // SM cycles, ~9 s

union LeafSmem {  // a diagonal tile and its inverse, or a product's staging
  float diag[2 * kLeafBlock * kDiagLd];
  TileSmem tile;
};

// All blocks of the grid meet here.  bar[0] counts arrivals, bar[1] is the
// generation; the last block to arrive resets the count and advances the
// generation.  Both are 0 at launch.  Only a cooperative launch may call it
// with more than one block; a grid of one block only meets its own threads.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (gridDim.x == 1) return;
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g0) {
        __nanosleep(64);
        if (clock64() - t0 > kBarrierTimeout) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// dst[kk][r] = element (r, t0 + kk) of a 64-row operand P: P[r ld + t]
// (row-major) or P[t ld + r] (DEPTH_MAJOR).
template <bool DEPTH_MAJOR>
__device__ __forceinline__ void stage(float (*dst)[kLd], const float* P, size_t ld, int t0) {
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    if (DEPTH_MAJOR) {
      const int kk = e / kTile, r = e % kTile;
      dst[kk][r] = P[(size_t)(t0 + kk) * ld + r];
    } else {
      const int r = e / kChunk, kk = e % kChunk;
      dst[kk][r] = P[(size_t)r * ld + t0 + kk];
    }
  }
}

// acc[r][c] -= sum_{t0 <= t < t1} a(r, t) b(c, t) over one 64x64 output tile
// (thread (ty, tx) holds rows ty*4.., columns tx*4..), a and b 64-row
// operands laid out as stage() reads them; t1 - t0 a multiple of 16.  Every
// read of a and b is done, by every thread, when it returns.
template <bool A_DM, bool B_DM>
__device__ __forceinline__ void tile_product(const float* A, size_t lda, const float* B,
                                             size_t ldb, int t0, int t1, TileSmem& sm,
                                             float acc[kPer][kPer]) {
  float part[kPer][kPer] = {};
  __syncthreads();  // the shared memory may still be read by the block's last step
  for (int t = t0, c = 1; t < t1; t += kChunk, ++c) {
    stage<A_DM>(sm.a, A, lda, t);
    stage<B_DM>(sm.b, B, ldb, t);
    __syncthreads();
    rank_update_chunk(sm, part);
    __syncthreads();
    if (c % kFold == 0) fold_update(acc, part);
  }
  fold_update(acc, part);
}

__device__ __forceinline__ void store_tile(float* out, size_t ld, const float acc[kPer][kPer],
                                           float sign) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < kPer; ++c) out[(size_t)(ty * kPer + a) * ld + tx * kPer + c] = sign * acc[a][c];
}

// S[r, c] = src[r, c] for c <= r; the strict upper of S is not written.
__device__ __forceinline__ void load_lower(float* S, int ld, const float* src, size_t src_ld,
                                           int b) {
  for (int e = threadIdx.x; e < b * b; e += kThreads) {
    const int r = e / b, c = e % b;
    if (c <= r) S[r * ld + c] = src[r * src_ld + c];
  }
  __syncthreads();
}

// dst[r, c] = S[r, c] for c <= r and exactly 0 above the diagonal.
__device__ __forceinline__ void store_lower(const float* S, int ld, float* dst, size_t dst_ld,
                                            int b) {
  for (int e = threadIdx.x; e < b * b; e += kThreads) {
    const int r = e / b, c = e % b;
    dst[r * dst_ld + c] = c <= r ? S[r * ld + c] : 0.0f;
  }
}

// W = L^-1 for the factor L in the lower triangle of S, lower triangle and
// exact-zero upper, by forward substitution: thread t < b solves L w = e_t
// for column t of W.  The columns are independent, so this takes no barrier.
// A NaN on L's diagonal makes the rows of W from there on NaN.
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

// W_kk = inv(tril(L_kk)), exact-zero upper (K14's diagonal tiles).
__device__ inline void invert_diag(const float* L, size_t ldl, float* W, size_t ldw, int k,
                                   LeafSmem& sm) {
  float* S = sm.diag;
  float* Ws = S + kLeafBlock * kDiagLd;
  __syncthreads();
  load_lower(S, kDiagLd, L + (size_t)k * kLeafBlock * (ldl + 1), ldl, kLeafBlock);
  tri_inverse(S, Ws, kDiagLd, kLeafBlock);
  store_lower(Ws, kDiagLd, W + (size_t)k * kLeafBlock * (ldw + 1), ldw, kLeafBlock);
  __syncthreads();
}

// W = L^-1 of the lower triangle of L (K14), W's strict upper exactly 0.
// Run by every block of the grid.
__device__ inline void tri_inv_body(const float* L, size_t ldl, float* W, size_t ldw, int s, unsigned* bar,
                                    LeafSmem& sm) {
  constexpr int b = kLeafBlock;
  const int nb = s / b;
  const int G = gridDim.x;
  const int g = blockIdx.x;
  const size_t tid = (size_t)g * kThreads + threadIdx.x;
  const size_t nthreads = (size_t)G * kThreads;

  for (int k = g; k < nb; k += G) invert_diag(L, ldl, W, ldw, k, sm);
  grid_sync(bar);
  for (int w = 1; w < nb; w *= 2) {
    const int items = (nb + 2 * w - 1) / (2 * w) * w * w;
    // X^T(c, r) = -sum_t W_A[t, c] L_CA[r, t] into W[A rows, C columns]
    for (int it = g; it < items; it += G) {
      const int a0 = it / (w * w) * 2 * w, c0 = a0 + w;
      const int ci = it % (w * w) / w, ri = it % w;
      if (c0 + ri >= nb) continue;
      const float* WA = W + (size_t)a0 * b * ldw + (size_t)a0 * b;
      const float* LCA = L + (size_t)(c0 + ri) * b * ldl + (size_t)a0 * b;
      float acc[kPer][kPer] = {};
      tile_product<true, false>(WA + ci * b, ldw, LCA, ldl, ci * b, w * b, sm.tile, acc);
      store_tile(W + (size_t)(a0 + ci) * b * ldw + (size_t)(c0 + ri) * b, ldw, acc, 1.0f);
    }
    grid_sync(bar);
    // W_CA(r, c) = sum_t W_C[r, t] X^T(c, t), t up to the diagonal of W_C
    for (int it = g; it < items; it += G) {
      const int a0 = it / (w * w) * 2 * w, c0 = a0 + w;
      const int ci = it % (w * w) / w, ri = it % w;
      if (c0 + ri >= nb) continue;
      const float* WC = W + (size_t)(c0 + ri) * b * ldw + (size_t)c0 * b;
      const float* XT = W + (size_t)(a0 + ci) * b * ldw + (size_t)c0 * b;
      float acc[kPer][kPer] = {};
      tile_product<false, false>(WC, ldw, XT, ldw, 0, (ri + 1) * b, sm.tile, acc);
      store_tile(W + (size_t)(c0 + ri) * b * ldw + (size_t)(a0 + ci) * b, ldw, acc, -1.0f);
    }
    grid_sync(bar);
  }
  for (size_t e = tid; e < (size_t)s * s; e += nthreads) {  // exact-zero strict upper
    const int r = (int)(e / s), c = (int)(e % s);
    if (c > r) W[r * ldw + c] = 0.0f;
  }
}

}  // namespace gpr
