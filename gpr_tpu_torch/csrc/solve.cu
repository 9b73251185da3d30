// K10: the narrow Cholesky substitution, and K11: the inverses of the diagonal
// tiles of a Cholesky factor.  Together they solve (L L^T) X = B for a skinny
// right-hand side B (n, q <= 128), n % bs == 0 (gpr_tpu_torch/ops/solve.py).
//
// K10 narrow_subst replaces the TPU kernel gpr_tpu/ops/pallas_solve.py::
// _subst_kernel (line 52), launched by _subst_pass (118) once per sweep:
//   forward   y_i = W_ii (b_i - sum_{j<i} L_ij y_j)         i ascending
//   backward  x_i = W_ii^T (y_i - sum_{j>i} L_ji^T x_j)     i descending
// with W_ii = inv(L_ii).  The TPU walks the lower tiles of L on a sequential
// grid and keeps every solved block in VMEM (nb x q x bs, 512 KB at n = 16384,
// q = 8).  Hopper blocks run in no order and that exceeds a block's shared
// memory, so the solved blocks live in device memory.  Here too a sweep is one
// launch: one persistent kernel (subst_sweep), a grid of as many 256-thread
// CTAs as the card holds at once (two an SM), each taking work items from an
// atomic ticket counter in the sweep's order until none is left.  Block row
// i's items, each for one (64-row group, column group of 8 or 16 right-hand
// sides):
//   partial   64 rows x 128 columns of L_ij (L_ji^T backward) times the same
//             128 solved rows: a 128-term partial into a scratch slot.  The
//             last of the row's older partials (those not against the block
//             solved just before) sums their slots in age order into R; the
//             last of the newest ones adds the newest slots to that sum and
//             writes r_i = b_i - sum.  Every sum runs in two levels (partials
//             of 128 terms), as K2's products do (tc_tile.cuh), and
//             only C = bs / 128 of its terms wait on the block solved before;
//   diagonal  one 128-column chunk of W_ii (W_ii^T backward) times its chunk
//             of r_i, as soon as that chunk of r_i is there (W's tile is
//             loaded before the wait); the last of a row group's chunks adds
//             the chunk products in chunk order into y_i (x_i).
// Each wait is on flags in device memory (flags.cuh): per block row and (row
// group, column group), counts of finished older and newest partials and of
// diagonal chunks, and flags for the older sum, r_i and the solved rows.  A
// writer publishes after __threadfence(); one thread waits by acquire loads
// and __nanosleep, then its CTA's barrier; data written in the sweep is read
// through L2 (__ldcg).  Items are handed out in the sweep's order, a row's
// partials (oldest solved block first) before its diagonal items: row i + 1's
// work against the older blocks runs while row i's diagonal step waits.  An
// item waits only on items with smaller tickets, which running CTAs hold, so
// the sweep cannot deadlock, whatever the number of CTAs resident.  The slots
// alternate between two sets by the row's parity; a partial waits until the
// row two steps back has been summed before it overwrites a slot.  The sums'
// order: the forward sweep's is the first design's (one launch a block
// row), so y is bit for bit the same; the backward sweep sums the
// partials from the farthest block to the block solved just before, where the
// first design began with that newest block, so that the older part of the
// sum is taken before the newest block is solved (x agrees with the plain
// version to 1e-5 of its largest entry, as before).  A tile of L or W is
// staged through shared memory coalesced, row-wise for the forward sweep and
// column-wise (L_ji^T, W^T) for the backward one.  Only the strict lower
// triangle of L outside the diagonal tiles and W's lower triangle are read:
// the strict upper may hold anything.  A NaN in what is read makes the result
// non-finite.
//
// What bounds K10 on the H100: bytes.  A sweep reads the nb(nb-1)/2
// off-diagonal tiles of L and the lower triangle of each W_ii,
// (nb(nb-1)/2) bs^2 + nb bs(bs+1)/2 floats, plus B read and X written: 537.9 MB
// at n = 16384, bs = 512, q = 8, so 0.321 ms for the two sweeps of a solve at
// 3.35 TB/s, against 4.3 GFLOP (0.064 ms at 67 TFLOP/s).  The time is the
// chain of nb block rows a sweep, each a diagonal chunk, the newest partials
// and their sum, with the flags between them (chip_tools/k10_probe.py stamps
// each).  Plain FP32 FMA; with q > 16 each 16-column group of B re-reads L
// (served from L2 within a block row where it fits).
//
// K11 diag_tri_inv replaces pallas_solve.py::_diag_inv_kernel (173), launched
// by _diag_block_inverses_pallas (188): W_i = inv(tril(L_ii)) of every
// (bs, bs) diagonal tile, bs <= 512, the strict upper of L_ii masked.  The
// TPU's bottom-up 8-row strip scheme is VMEM tuning; substitution column by
// column is a chain of bs dependent steps.  Here the tile is inverted by
// blocks, so that no chain is longer than one 32-wide diagonal block:
//   tri_inv_diag   every 32x32 diagonal block of every tile at once, one
//                  warp a block (lane i holds row i; K3's warp_inv32 order,
//                  fullchol.cu), a ragged last block of 16 padded with I;
//                  it also writes the zeros right of its block, so W's
//                  strict upper is exactly 0;
//   tri_inv_level  for h = 32, 64, 128, 256 (h < bs), one kernel each: the
//                  pairs of h-wide diagonal blocks are joined by
//                  inv([[A, 0], [C, D]]) = [[inv A, 0], [-inv(D) C inv(A), inv D]],
//                  the identity JAX uses for bs = 1024 (pallas_solve.py:213-227).
//                  A block takes one 64-column block of the pair's output:
//                  T = C inv(A)[:, cols] into shared memory, then X = -inv(D) T
//                  into W, both products by 64x64 register tiles (4x4 a
//                  thread) over 32-deep chunks staged through shared memory,
//                  C and inv(D) transposed there, each chunk's partial folded
//                  into an FP32 running tile (two-level sums, as everywhere in
//                  the port).  The zero halves of the triangular operands are
//                  skipped: T's column block j0 sums from row j0 of inv(A), X's
//                  row block i0 up to column i0 + 63 of inv(D).
// The warp's block inverse and the staged product tile live in tri_inv.cuh,
// which K13 leaf_chol_wi (leaf.cu) shares for the inverse of a whole leaf.
// One counted launch runs 1 + log2(bs / 32) kernels in stream order (five at
// bs = 512).  L's strict upper is never read: the diagonal blocks are staged
// through a mask and C lies strictly below the diagonal.  A NaN on a pivot
// makes its tile's W non-finite through 1 / L_ii and the products.
// What bounds it: bs^3/3 FLOP a tile for the inverse, 1.43 GFLOP at n =
// 16384, bs = 512 (0.021 ms at 67 TFLOP/s FP32), against 16.8 MB read and
// 33.5 MB written (0.015 ms); the doubling computes ~2x that (the products
// at each level, 2.9 GFLOP, ~0.04 ms).  Plain FP32 FMA on the CUDA cores:
// the FLOP are few, and the levels are short, so the time is the five
// kernels' latency and the last level's single wave of 128 blocks.
#include <cuda_runtime.h>

#include "flags.cuh"
#include "tri_inv.cuh"

namespace gpr {

constexpr int kSubstThreads = 256;
constexpr int kSubstRows = 64;    // output rows of an item
constexpr int kSubstChunk = 128;  // columns of a tile chunk: the first level of every sum
constexpr int kSubstPer = kSubstRows * kSubstChunk / kSubstThreads;  // a tile's elements a thread
constexpr int kSubstSum = 64;     // slots of a sum loaded at once
constexpr int kSubstMaxChunks = 8;  // chunks of a diagonal tile: bs <= 1024
constexpr int kSubstCtas = 2;     // CTAs an SM: 128 registers a thread, 37-41 KB of shared memory

template <int QC>
struct SubstSmem {
  float A[kSubstChunk][kSubstRows + 1];  // A[kappa][rho]: the tile, transposed, padded
  float V[kSubstChunk][QC];              // the solved rows the chunk multiplies
};

// This thread's elements of the tile A[kappa][rho] = M[row0 + rho, col0 +
// kappa] (trans false: kappa = t % 128, rho = t / 128 + 2 u) or M[col0 +
// kappa, row0 + rho] (trans true: rho = t % 64, kappa = t / 64 + 4 u), row
// stride ld, all loads in flight together, coalesced along the source's rows.
// LOWER keeps only elements of M's lower triangle (source row >= source
// column) and loads 0 elsewhere.
template <bool LOWER>
__device__ __forceinline__ void fetch_tile(float (&v)[kSubstPer], const float* M, size_t ld, int row0,
                                           int col0, bool trans) {
  const int t = threadIdx.x;
  const int sr = trans ? col0 + t / kSubstRows : row0 + t / kSubstChunk;  // source row of u = 0
  const int sc = trans ? row0 + t % kSubstRows : col0 + t % kSubstChunk;  // source column
  const int step = trans ? kSubstThreads / kSubstRows : kSubstThreads / kSubstChunk;
  const float* p = M + (size_t)sr * ld + sc;
#pragma unroll
  for (int u = 0; u < kSubstPer; ++u) v[u] = (!LOWER || sr + step * u >= sc) ? p[(size_t)(step * u) * ld] : 0.0f;
}

template <int QC>
__device__ __forceinline__ void stage_tile(SubstSmem<QC>& sm, const float (&v)[kSubstPer], bool trans) {
  const int t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kSubstPer; ++u) {
    if (trans) sm.A[t / kSubstRows + 4 * u][t % kSubstRows] = v[u];
    else sm.A[t % kSubstChunk][t / kSubstChunk + 2 * u] = v[u];
  }
}

// This thread's elements of V[kappa][j] = S[row0 + kappa, q0 + j] of the (.,
// q) row-major S; 0 past q.  Through L2: S may have been written by other
// CTAs of the sweep.
template <int QC>
__device__ __forceinline__ void fetch_rows(float (&v)[kSubstChunk * QC / kSubstThreads], const float* S, int q,
                                           int row0, int q0) {
#pragma unroll
  for (int u = 0; u < kSubstChunk * QC / kSubstThreads; ++u) {
    const int e = threadIdx.x + u * kSubstThreads, kappa = e / QC, j = e % QC;
    v[u] = q0 + j < q ? __ldcg(&S[(size_t)(row0 + kappa) * q + q0 + j]) : 0.0f;
  }
}

template <int QC>
__device__ __forceinline__ void stage_rows(SubstSmem<QC>& sm, const float (&v)[kSubstChunk * QC / kSubstThreads]) {
#pragma unroll
  for (int u = 0; u < kSubstChunk * QC / kSubstThreads; ++u) {
    const int e = threadIdx.x + u * kSubstThreads;
    sm.V[e / QC][e % QC] = v[u];
  }
}

// acc[m] = sum over the chunk of A[kappa][rho] V[kappa][j], for this thread's
// row rho = t % 64 and columns j = t / 64 + 4 m: a chain of 128 terms.
template <int QC>
__device__ __forceinline__ void chunk_product(const SubstSmem<QC>& sm, float* acc) {
  const int rho = threadIdx.x % kSubstRows, j0 = threadIdx.x / kSubstRows;
#pragma unroll
  for (int m = 0; m < QC / 4; ++m) acc[m] = 0.0f;
#pragma unroll 4
  for (int kappa = 0; kappa < kSubstChunk; ++kappa) {
    const float a = sm.A[kappa][rho];
#pragma unroll
    for (int m = 0; m < QC / 4; ++m) acc[m] = fmaf(a, sm.V[kappa][j0 + 4 * m], acc[m]);
  }
}

// The chunks of W_ii that row group g multiplies: forward, row r needs
// columns c <= r; backward, c >= r.
__host__ __device__ __forceinline__ void subst_w_chunks(int g, int C, int forward, int* lo, int* hi) {
  *lo = forward ? 0 : g * kSubstRows / kSubstChunk;
  *hi = forward ? (g * kSubstRows + kSubstRows - 1) / kSubstChunk : C - 1;
}

// Diagonal items of a block row: one a (row group, chunk of W, column group).
__host__ __device__ __forceinline__ int subst_w_items(int G, int C, int Z, int forward) {
  int d = 0;
  for (int g = 0; g < G; ++g) {
    int lo, hi;
    subst_w_chunks(g, C, forward, &lo, &hi);
    d += hi - lo + 1;
  }
  return d * Z;
}

// One sweep (forward != 0: out = y, block rows ascending; else out = x,
// descending).  Step s (block row i) hands out s C G Z partials, then its
// diagonal items.  flags, each [nb][G][Z]: finished older partials, finished
// newest partials, the older partials' sum in R, r in R, finished diagonal
// chunks, rows solved; then the ticket; all 0 at the launch.  P: two sets of
// max(nb - 1, 1) C slots of (bs, q), then the diagonal chunks' slots (C, n,
// q); R: (n, q).
template <int QC>
__global__ void __launch_bounds__(kSubstThreads, kSubstCtas)
    subst_sweep(const float* L, const float* W, const float* src, float* out, float* P, float* R,
                int* flags, int n, int q, int bs, int forward) {
  __shared__ SubstSmem<QC> sm;
  __shared__ int item_sh, last_sh;
  const int nb = n / bs, G = bs / kSubstRows, C = bs / kSubstChunk, Z = (q + QC - 1) / QC, GZ = G * Z;
  int* pdone = flags;
  int* ndone = pdone + nb * GZ;
  int* sdone = ndone + nb * GZ;
  int* rdone = sdone + nb * GZ;
  int* wdone = rdone + nb * GZ;
  int* solved = wdone + nb * GZ;
  int* ticket = solved + nb * GZ;
  const int DW = subst_w_items(G, C, Z, forward);
  const int total = GZ * C * nb * (nb - 1) / 2 + nb * DW;
  const size_t slots = (size_t)max(nb - 1, 1) * C * bs * q;
  float* WP = P + 2 * slots;
  const int rho = threadIdx.x % kSubstRows, j0 = threadIdx.x / kSubstRows;
  float v[kSubstPer], vr[kSubstChunk * QC / kSubstThreads], acc[QC / 4];
  for (;;) {
    __syncthreads();  // the last item is done with sm and item_sh
    if (threadIdx.x == 0) item_sh = atomicAdd(ticket, 1);
    __syncthreads();
    int t = item_sh;
    if (t >= total) return;
    int s = 0;
    while (t >= GZ * C * s + DW) t -= GZ * C * s++ + DW;
    const int i = forward ? s : nb - 1 - s, nchunks = C * s;
    if (t < nchunks * GZ) {
      // a partial: slot m of the block row, against chunk k of the solved
      // rows, in age order: the newest solved block's chunks come last
      const int m = t / GZ, g = t % GZ / Z, z = t % Z, at = (i * G + g) * Z + z;
      const int k = forward ? m : (s - 1 - m / C) * C + m % C, nold = nchunks - C;
      const bool newest = m >= nold;
      const int row0 = i * bs + g * kSubstRows;
      const int col0 = forward ? k * kSubstChunk : (i + 1) * bs + k * kSubstChunk;
      float* Pp = P + (s & 1) * slots;
      fetch_tile<false>(v, L, (size_t)n, row0, col0, !forward);
      stage_tile<QC>(sm, v, !forward);
      if (threadIdx.x == 0) {
        const int jb = col0 / bs, g1 = col0 % bs / kSubstRows;
        flag_wait(&solved[(jb * G + g1) * Z + z], 1);
        flag_wait(&solved[(jb * G + g1 + 1) * Z + z], 1);
        if (s >= 3) flag_wait(&rdone[((forward ? i - 2 : i + 2) * G + g) * Z + z], 1);  // its slots are free
      }
      __syncthreads();
      fetch_rows<QC>(vr, out, q, col0, z * QC);
      stage_rows<QC>(sm, vr);
      __syncthreads();
      chunk_product<QC>(sm, acc);
      const int r = g * kSubstRows + rho;  // row within the block row
#pragma unroll
      for (int mm = 0; mm < QC / 4; ++mm) {
        const int j = z * QC + j0 + 4 * mm;
        if (j < q) Pp[((size_t)m * bs + r) * q + j] = acc[mm];
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        last_sh = newest ? atomicAdd(&ndone[at], 1) == C - 1 : atomicAdd(&pdone[at], 1) == nold - 1;
      __syncthreads();
      if (!last_sh) continue;
      // The last older partial sums the older slots into R; the last newest
      // one adds the newest slots to that sum and writes r = b - sum: one sum
      // in age order, of which only C terms wait on the block solved before.
      if (newest && nold > 0) {
        if (threadIdx.x == 0) flag_wait(&sdone[at], 1);
        __syncthreads();
      }
      __threadfence();
      const size_t stride = (size_t)bs * q;
      if (newest) {
        // the older sum and the newest slots, all loads in flight, then added in order
        float base[QC / 4], pv[QC / 4][kSubstMaxChunks];
#pragma unroll
        for (int mm = 0; mm < QC / 4; ++mm) {
          const int j = min(z * QC + j0 + 4 * mm, q - 1);
          base[mm] = nold > 0 ? __ldcg(&R[(size_t)(row0 + rho) * q + j]) : 0.0f;
#pragma unroll
          for (int u = 0; u < kSubstMaxChunks; ++u)
            if (u < C) pv[mm][u] = __ldcg(&Pp[((size_t)(nold + u) * bs + r) * q + j]);
        }
#pragma unroll
        for (int mm = 0; mm < QC / 4; ++mm) {
          const int j = z * QC + j0 + 4 * mm;
          float sum = base[mm];
#pragma unroll
          for (int u = 0; u < kSubstMaxChunks; ++u)
            if (u < C) sum += pv[mm][u];
          const size_t o = (size_t)(row0 + rho) * q + j;
          if (j < q) R[o] = src[o] - sum;
        }
      } else {
#pragma unroll
        for (int mm = 0; mm < QC / 4; ++mm) {
          const int j = z * QC + j0 + 4 * mm;
          if (j >= q) continue;
          // kSubstSum loads in flight
          const float* p = Pp + (size_t)r * q + j;
          float sum = 0.0f;
          int kk = 0;
          for (; kk + kSubstSum <= nold; kk += kSubstSum) {
            float pv[kSubstSum];
#pragma unroll
            for (int u = 0; u < kSubstSum; ++u) pv[u] = __ldcg(p + (kk + u) * stride);
#pragma unroll
            for (int u = 0; u < kSubstSum; ++u) sum += pv[u];
          }
          for (; kk < nold; ++kk) sum += __ldcg(p + kk * stride);
          R[(size_t)(row0 + rho) * q + j] = sum;
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(newest ? &rdone[at] : &sdone[at], 1);
    } else {
      // a diagonal item: chunk kc of row group g's product with W_ii (the
      // groups with the most chunks first); the last of the group's chunks to
      // finish adds them in chunk order
      t -= nchunks * GZ;
      int g, k_lo, k_hi;
      for (int gi = 0;; ++gi) {
        g = forward ? G - 1 - gi : gi;
        subst_w_chunks(g, C, forward, &k_lo, &k_hi);
        if (t < (k_hi - k_lo + 1) * Z) break;
        t -= (k_hi - k_lo + 1) * Z;
      }
      const int kc = k_lo + t / Z, z = t % Z, r0 = g * kSubstRows;
      const float* rhs = (s > 0 ? R : src) + (size_t)i * bs * q;
      fetch_tile<true>(v, W + (size_t)i * bs * bs, (size_t)bs, r0, kc * kSubstChunk, !forward);  // before the wait
      if (s > 0 && threadIdx.x == 0) {
        flag_wait(&rdone[(i * G + 2 * kc) * Z + z], 1);
        flag_wait(&rdone[(i * G + 2 * kc + 1) * Z + z], 1);
      }
      __syncthreads();
      fetch_rows<QC>(vr, rhs, q, kc * kSubstChunk, z * QC);
      stage_tile<QC>(sm, v, !forward);
      stage_rows<QC>(sm, vr);
      __syncthreads();
      chunk_product<QC>(sm, acc);
      const size_t row = (size_t)i * bs + r0 + rho;
      if (k_hi == k_lo) {
#pragma unroll
        for (int mm = 0; mm < QC / 4; ++mm) {
          const int j = z * QC + j0 + 4 * mm;
          if (j < q) out[row * q + j] = 0.0f + acc[mm];  // the chunk-order sum from 0
        }
      } else {
#pragma unroll
        for (int mm = 0; mm < QC / 4; ++mm) {
          const int j = z * QC + j0 + 4 * mm;
          if (j < q) WP[((size_t)kc * n + row) * q + j] = acc[mm];
        }
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) last_sh = atomicAdd(&wdone[(i * G + g) * Z + z], 1) == k_hi - k_lo;
        __syncthreads();
        if (!last_sh) continue;
        __threadfence();
        float pv[QC / 4][kSubstMaxChunks];  // all loads in flight, then added in chunk order
#pragma unroll
        for (int mm = 0; mm < QC / 4; ++mm) {
          const int j = min(z * QC + j0 + 4 * mm, q - 1);
#pragma unroll
          for (int kk = 0; kk < kSubstMaxChunks; ++kk)
            if (k_lo + kk <= k_hi) pv[mm][kk] = __ldcg(&WP[((size_t)(k_lo + kk) * n + row) * q + j]);
        }
#pragma unroll
        for (int mm = 0; mm < QC / 4; ++mm) {
          const int j = z * QC + j0 + 4 * mm;
          float tot = 0.0f;
#pragma unroll
          for (int kk = 0; kk < kSubstMaxChunks; ++kk)
            if (k_lo + kk <= k_hi) tot += pv[mm][kk];
          if (j < q) out[row * q + j] = tot;
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(&solved[(i * G + g) * Z + z], 1);
    }
  }
}

// The grid: as many CTAs as the card holds at once (asked once a process),
// at most one an item.
template <int QC>
cudaError_t narrow_subst_sweep(const float* L, const float* W, const float* src, float* out, float* P,
                               float* R, int* flags, int n, int q, int bs, int forward,
                               cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, subst_sweep<QC>, kSubstThreads, 0);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms;
  }
  const int nb = n / bs, C = bs / kSubstChunk, G = bs / kSubstRows, Z = (q + QC - 1) / QC;
  const int total = G * Z * C * nb * (nb - 1) / 2 + nb * subst_w_items(G, C, Z, forward);
  subst_sweep<QC><<<min(resident, total), kSubstThreads, 0, stream>>>(L, W, src, out, P, R, flags, n,
                                                                       q, bs, forward);
  return cudaGetLastError();
}

constexpr int kInvMaxTile = 512;

// grid ceil(nb * nblk / 4), nblk = ceil(bs / 32); warp g the diagonal block
// b = g % nblk of tile g / nblk (tri_inv.cuh: warp_tri_inv32, a ragged last
// block padded with I past its width w), stored with the zeros right of it.
__global__ void __launch_bounds__(kInvDiagWarps * 32)
    tri_inv_diag(const float* L, int ld, float* W, int nb, int bs) {
  __shared__ float sm[kInvDiagWarps][kInvNb][kInvNb + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nblk = (bs + kInvNb - 1) / kInvNb;
  const int g = blockIdx.x * kInvDiagWarps + warp;
  if (g >= nb * nblk) return;  // warp-uniform: the warps share no barrier
  const int tile = g / nblk, c0 = (g % nblk) * kInvNb, w = min(kInvNb, bs - c0);
  float(*s)[kInvNb + 1] = sm[warp];
  warp_tri_inv32(L + (size_t)(tile * bs + c0) * ld + tile * bs + c0, ld, w, s);
  float* Wr = W + (size_t)tile * bs * bs + (size_t)c0 * bs;
  for (int r = 0; r < w; ++r) {
    if (lane < w) Wr[(size_t)r * bs + c0 + lane] = s[r][lane];
    for (int c = c0 + w + lane; c < bs; c += 32) Wr[(size_t)r * bs + c] = 0.0f;
  }
}

// grid (pairs * ceil(h / 64), nb), pairs = ceil((bs - h) / 2h); dynamic
// shared memory (max(h, 64) + 64) * kInvLd floats.  Pair p of tile t: A =
// the h-wide block at c0 = 2 p h, D the hd-wide block at r0 = c0 + h (hd <
// h for a ragged pair), C = L[r0 .., c0 ..]; inv(A) and inv(D) are W's
// diagonal blocks from the levels before (their strict upper is 0).  Block
// (p, cb) writes W[r0 .., c0 + 64 cb ..] = -inv(D) C inv(A)[:, 64 cb ..].
__global__ void __launch_bounds__(kInvThreads)
    tri_inv_level(const float* L, int ld, float* W, int bs, int h) {
  extern __shared__ __align__(16) float ism[];
  float* Ts = ism;                                    // T = C inv(A)[:, cols]: hd rows
  float* As = Ts + max(h, kInvCb) * kInvLd;           // [32][kInvLd]: C or inv(D), transposed
  float* Bs = As + kInvK * kInvLd;                    // [32][kInvLd]: rows of inv(A)
  const int cbs = (h + kInvCb - 1) / kInvCb;
  const int p = blockIdx.x / cbs, j0 = (blockIdx.x % cbs) * kInvCb, tile = blockIdx.y;
  const int c0 = 2 * p * h, r0 = c0 + h, hd = min(h, bs - r0), jw = min(kInvCb, h - j0);
  const float* Lt = L + (size_t)tile * bs * ld + (size_t)tile * bs;
  float* Wt = W + (size_t)tile * bs * bs;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // T's 64-row blocks; inv(A)[k][j] = 0 for k < j, so the sum starts at row j0
  for (int i0 = 0; i0 < hd; i0 += kInvCb) {
    float acc[4][4] = {};
    for (int k0 = j0; k0 < h; k0 += kInvK) {
      __syncthreads();
      inv_stage_t(As, Lt + (size_t)(r0 + i0) * ld + c0 + k0, (size_t)ld, hd - i0, h - k0);
      inv_stage(Bs, Wt + (size_t)(c0 + k0) * bs + c0 + j0, (size_t)bs, h - k0, jw);
      __syncthreads();
      inv_chunk(As, Bs, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&Ts[(i0 + 4 * ty + i) * kInvLd + 4 * tx]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  // X's 64-row blocks; inv(D)[i][k] = 0 for k > i, so the sum ends at i0 + 63
  for (int i0 = 0; i0 < hd; i0 += kInvCb) {
    float acc[4][4] = {};
    const int k1 = min(i0 + kInvCb, hd);
    for (int k0 = 0; k0 < k1; k0 += kInvK) {
      __syncthreads();  // also: T complete before its first read
      inv_stage_t(As, Wt + (size_t)(r0 + i0) * bs + r0 + k0, (size_t)bs, hd - i0, k1 - k0);
      __syncthreads();
      inv_chunk(As, Ts + k0 * kInvLd, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + 4 * ty + i;
      if (r >= hd) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        if (c < jw) Wt[(size_t)(r0 + r) * bs + c0 + j0 + c] = -acc[i][j];
      }
    }
  }
}

}  // namespace gpr

// One sweep (forward != 0: block rows ascending, out = y; else descending,
// out = x), one launch.  L (n, n) row-major, W (n / bs, bs, bs), src and out
// (n, q) row-major and distinct, bs <= 1024; scratch P ((2 max(n / bs - 1, 1)
// bs + n) / 128 slots of (bs, q)), R (n, q) and flags (6 (n / bs) (bs / 64)
// ceil(q / QC) + 1 ints, QC = 8 for q <= 8, else 16), the flags zero.
extern "C" int gpr_narrow_subst(const float* L, const float* W, const float* src, float* out,
                                float* P, float* R, int* flags, int n, int q, int bs, int forward,
                                void* stream) {
  using namespace gpr;
  if (bs < kSubstChunk || bs % kSubstChunk || bs > kSubstMaxChunks * kSubstChunk || n < bs || n % bs || q < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q <= 8) return (int)narrow_subst_sweep<8>(L, W, src, out, P, R, flags, n, q, bs, forward, s);
  return (int)narrow_subst_sweep<16>(L, W, src, out, P, R, flags, n, q, bs, forward, s);
}

// W (nb, bs, bs) = the inverses of the lower triangles of the diagonal tiles
// of L (nb bs, nb bs), row stride ld; W's strict upper is exact 0.  bs % 16
// == 0, bs <= 512.  1 + log2(bs / 32) kernels in stream order.
extern "C" int gpr_diag_tri_inv(const float* L, int ld, float* W, int nb, int bs, void* stream) {
  using namespace gpr;
  if (nb < 1 || bs < 16 || bs % 16 || bs > kInvMaxTile || ld < nb * bs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (bs + kInvNb - 1) / kInvNb;
  tri_inv_diag<<<(nb * nblk + kInvDiagWarps - 1) / kInvDiagWarps, kInvDiagWarps * 32, 0, s>>>(
      L, ld, W, nb, bs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem_max = (kInvMaxTile / 2 + 2 * kInvK) * kInvLd * (int)sizeof(float);
  err = cudaFuncSetAttribute(tri_inv_level, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return (int)err;
  for (int h = kInvNb; h < bs; h *= 2) {
    const int pairs = (bs - h + 2 * h - 1) / (2 * h), cbs = (h + kInvCb - 1) / kInvCb;
    const int smem = (max(h, kInvCb) + 2 * kInvK) * kInvLd * (int)sizeof(float);
    tri_inv_level<<<dim3(pairs * cbs, nb), kInvThreads, smem, s>>>(L, ld, W, bs, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
