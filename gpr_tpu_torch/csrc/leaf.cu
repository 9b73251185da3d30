// K12 leaf_chol: L = chol(A); K13 leaf_chol_wi: (L, W = L^-1) from one
// factorization; K14 tri_inv_leaf: W = L^-1 of a lower-triangular L.  Each
// takes one whole recursion leaf, s x s (the wrappers keep the JAX package's
// gate: s % 256 == 0, s <= 1024), as a strided view.
//
// They replace the TPU kernels of gpr_tpu/ops/pallas_leaf.py: K12 _leaf_kernel
// (line 47, launched by leaf_cholesky, 99), K13 _leaf_wi_kernel (118, by
// leaf_cholesky_wi, 222; the one the blocked recursion dispatches under
// GPR_CHOL_LEAF_INV=1) and K14 _tri_inv_kernel (239, by tri_inv_leaf, 294).
// They compute what those compute, not their blocking.  The TPU kernel keeps
// the whole leaf in VMEM (4 MiB at s = 1024) and walks 256-wide diagonal
// blocks in one program.
//
// K12: the leaf in the shared memory of one thread-block cluster.  A Hopper
// block has at most 227 KB of shared memory; the lower triangle of a 1024
// leaf (2.1 MB) fits the 16 CTAs of one non-portable cluster (the card places
// 7 such clusters at this kernel's shared memory; chip_smoke.py phase 18 asks
// cudaOccupancyMaxActiveClusters).  The leaf is cut into nt = s / 32 block
// rows of 32-square tiles, and CTA c of the nt / 2 owns block rows c and
// nt - 1 - c whole: nt + 1 tiles, 152 KB at s = 1024, each tile column-major
// with a column stride of 36 floats.  A CTA reads only its own rows of A's
// lower triangle (coalesced rows of the strided view) and writes only its own
// rows of L, so L may be A.  Right-looking by 32-wide panels k = 0 .. nt - 2,
// with one cluster barrier a step (A_k: the diagonal block L_kk and every
// tile of panel k - 1 are published to an L2 workspace, a slot a tile):
//
//   stage    after A_k, a CTA that holds rows below k copies L_kk, its scales
//            and L_k,k-1 from their slots (ld.cg);
//   column   each of its rows i > k, on four warps: tile (i, k) -=
//            L_i,k-1 L_k,k-1^T (panel k - 1's last update of the column), then
//            L_ik = A_ik L_kk^-T by a thread a row (chol.cuh: row_solve),
//            published to its slot, and the diagonal tile (i, i) -= L_ik
//            L_ik^T at once: a diagonal tile needs only its own row's panels;
//   factor   the owner of row k + 1 factors tile (k + 1, k + 1) on one warp
//            in registers with shuffles (chol.cuh: diag_factor) and publishes
//            it with its scales; then every CTA arrives on A_k+1;
//   bulk     after its arrive, each CTA subtracts panel k - 1 from its other
//            tiles (i, j), k + 1 <= j < i: a warp a tile, panel k - 1's tiles
//            streamed from L2 in chunks of 8 (cp.async, double-buffered), so
//            that this work overlaps the next factor.
//
// The chain from one step to the next is the barrier, the column's update
// and solve, the diagonal tile's update and the warp's 32 pivots; the rows'
// solve is spread over all CTAs (each solves its own <= 2 tiles).  No grid
// barrier.  The scale is 1.0f / sqrtf(pivot) with no clamp (chol.cuh), so a
// non-positive or NaN pivot poisons every later diagonal block and L[-1, -1]
// is NaN.  Sums are 32-term tile products in a fixed order, no atomics.
//
// K13: K12's launch, then W = L^-1 by blocks over the whole card, in stream
// order, one counted launch.  The factor is K12's kernel
// itself, so K13's L is K12's bit for bit; it leaves L in the output (and in
// L2), and its workspace, dead once the cluster is done, is the inverse's
// scratch.  The inverse is kept off the factor's chain (a warp's 32 pivots
// and the barrier, ~19.5k cycles a step) and out of the cluster: a 1024 leaf
// fills 225,920 of the 227 KB a CTA may hold.  By the identity K11 uses
// (tri_inv.cuh; JAX's pallas_solve.py:213-227)
//
//   inv([[A, 0], [C, D]]) = [[inv A, 0], [-inv(D) C inv(A), inv D]]:
//
//   leaf_inv_base  the s / 64 diagonal blocks of 64, a CTA each, in shared
//                  memory: its two 32-wide diagonal blocks a warp each (lane
//                  i a row of the block and of its inverse), then the level
//                  h = 32 below, four outputs a thread;
//   then, for h = 64, 128, .. < s, the pairs of h-wide inverted blocks A
//   (at c0 = 2 p h) and D (at r0 = c0 + h, hd <= h wide) joined in two
//   kernels:
//   leaf_inv_t     T = C inv(A), C = L[r0 .., c0 ..], into the scratch at
//                  W_CA's coordinates, a block a 64x64 output tile, the sum
//                  from row j0 of inv(A) (inv(A) is 0 above);
//   leaf_inv_x     W_CA = -inv(D) T, a block a 64x64 tile, the sum up to the
//                  tile's last row (inv(D) is 0 right of it); the block also
//                  writes the tile's mirror in W's strict upper as exact
//                  zeros, so the levels zero W's upper between them.
// Cutting rows as well as columns gives a 1024 leaf 64 blocks a kernel at h =
// 512 and 32 at 256 (K11's 64-column blocks would give 8 and 8).  64x64
// register tiles (4x4 a thread) over 32-deep chunks staged through shared
// memory, the next chunk's loads in flight while the block computes, each
// chunk's partial folded into an FP32 running tile; the zero halves of the
// triangular operands skipped.  A launch is 2 + 2 log2(s / 64) kernels, 10
// at s = 1024.
// C lies strictly below the diagonal and the diagonal blocks are staged
// through a mask, so L's strict upper is never read.
//
// K14 keeps the first design: the leaf stays in device memory (L2 holds it)
// and one cooperative launch of a persistent grid walks it (leaf.cuh), with a
// grid-wide barrier between dependent phases; a barrier that waits ~9 s traps
// rather than hang the card.  It inverts the 64-wide diagonal tiles, a block
// each (leaf.cuh: tri_inverse), then doubles over the 64-tiles: at width w
// (1, 2, 4, ...) each pair of ranges A = [a0, a0 + w), C = [a0 + w, a0 + 2w)
// of tiles, whose inverses W_A and W_C are known, gets
//     W_CA = -W_C (L_CA W_A)
// in two phases: X^T = -(L_CA W_A)^T into W's strict upper (scratch, zeroed
// at the end), then W_CA = W_C (-X).  Every product skips the zero tiles of
// its triangular factor, and every sum runs in two levels (partials of 128
// terms, gram_tile.cuh: fold_update), as K9 and K16 do.
//
// Contracts kept from the TPU kernels:
//   * only the lower triangle of the input is read: its strict upper may hold
//     NaN or junk (the port's in-place recursion leaves A's upper triangle
//     there);
//   * the outputs have an exactly-zero strict upper triangle;
//   * a non-positive (or NaN) pivot gives NaN through sqrtf with no clamp
//     (chol.cuh) and the NaN reaches every later block, so L[-1, -1] is NaN
//     and W is not finite (1 / L_ii and the products): the caller's O(1)
//     check and jitter retry work.
// K12 and K13 may factor in place (L the same view as A); W shares no memory
// with A or L.
//
// What bounds them on the H100: s^3 / 3 FLOP (K12, K14) or 2 s^3 / 3 (K13),
// 0.36 / 0.72 GFLOP at s = 1024, 5.3 / 10.7 us at 67 TFLOP/s FP32, against
// 4 (s(s+1)/2 + s^2) bytes (4 (s(s+1)/2 + 2 s^2) for K13), 2.7-4.2 us at
// 3.35 TB/s.  In practice K12's pace is its chain of nt = 32 dependent
// diagonal steps (a warp's 32 pivots each, ~260 cycles a pivot in K19);
// K13's is K12's plus its inverse's 9 dependent kernels (a launch's latency
// each; the deepest tile of a level, h / 32 chunks of 32 x 64 x 64 FMA on one
// SM, 8 us at h = 512); K14's
// the nb = 16 64-wide steps with ~2 log2(nb) grid barriers between them:
// latency, not bytes or FLOP.  Plain FP32 FMA.
#include <cuda_runtime.h>

#include "chol.cuh"
#include "leaf.cuh"
#include "tri_inv.cuh"

namespace gpr {

// K14: grid cooperative, at most as many blocks as resident (leaf.cuh: tri_inv_body).
__global__ void __launch_bounds__(kThreads)
    tri_inv_leaf_kernel(const float* L, size_t ldl, float* W, size_t ldw, int s, unsigned* bar) {
  __shared__ LeafSmem sm;
  tri_inv_body(L, ldl, W, ldw, s, bar, sm);
}

// ---- K12: the leaf in one cluster ----------------------------------------

constexpr int kLcLd = kCholNb + 4;             // an own tile's column stride
constexpr int kLcTile = kCholNb * kLcLd;       // floats of an own tile
constexpr int kLcPub = kCholNb * kCholNb;      // a published tile, column-major, stride 32
constexpr int kLcChunk = 8;                    // published tiles a staging buffer holds
constexpr int kLcMaxCluster = kLeafMax / (2 * kCholNb);  // 16

// Shared memory (floats) at nt block rows: the nt + 1 own tiles, two staging
// buffers, L_kk, L_k,k-1 and the 32 scales.  225,920 bytes at nt = 32.
__host__ __device__ constexpr int leaf_cluster_floats(int nt) {
  return (nt + 1) * kLcTile + 2 * kLcChunk * kLcPub + 2 * kLcPub + kCholNb;
}

// Own tile (i, j) of the CTA that holds block rows r0 (r0 + 1 tiles) and r1.
__device__ __forceinline__ float* own_tile(float* own, int r0, int i, int j) {
  return own + ((i == r0 ? 0 : r0 + 1) + j) * kLcTile;
}

// Block row i of A's lower triangle (row stride lda) into its tiles T: 0
// above the diagonal; A's strict upper is never read.  8 loads in flight a
// thread.
__device__ void leaf_load_row(const float* __restrict__ A, size_t lda, int i, float* T) {
  const int w = kCholNb * (i + 1), total = kCholNb * w, d0 = kCholNb * i;
  constexpr int kB = 8;
  for (int base = threadIdx.x; base < total; base += kB * kCholThreads) {
    float v[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = base + u * kCholThreads, r = e / w, c = e - r * w;
      v[u] = e < total && c <= d0 + r ? A[(size_t)(d0 + r) * lda + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = base + u * kCholThreads, r = e / w, c = e - r * w;
      if (e < total) T[(c / kCholNb) * kLcTile + (c % kCholNb) * kLcLd + r] = v[u];
    }
  }
}

// Block row i of L from its tiles T, every column of the s: exact zeros above
// the diagonal.
__device__ void leaf_store_row(float* __restrict__ L, size_t ldl, int s, int i, const float* T) {
  const int d0 = kCholNb * i, total = kCholNb * s;
  for (int e = threadIdx.x; e < total; e += kCholThreads) {
    const int r = e / s, c = e - r * s;
    L[(size_t)(d0 + r) * ldl + c] = c <= d0 + r ? T[(c / kCholNb) * kLcTile + (c % kCholNb) * kLcLd + r] : 0.0f;
  }
}

// Warp 0 factors the diagonal tile T of block row k and publishes it and its
// scales (rd, in shared memory) to their slots; the caller fences.
__device__ __forceinline__ void leaf_factor_publish(float* T, float* rd, float* slot, float* rds, int lane) {
  diag_factor<1>(T, kLcLd, rd, lane);
  __syncwarp();
#pragma unroll 8
  for (int c = 0; c < kCholNb; ++c) slot[c * kCholNb + lane] = T[c * kLcLd + lane];
  rds[lane] = rd[lane];
}

// `tiles` published tiles of a panel, contiguous in the workspace, into a
// staging buffer: 16 bytes a copy, asynchronous, one commit group.
__device__ __forceinline__ void leaf_stage(float* buf, const float* src, int tiles) {
  for (int e = threadIdx.x; e < tiles * kLcPub / 4; e += kCholThreads) cp_async16(buf + 4 * e, src + 4 * e);
  cp_async_commit();
}

// The bulk of step k: panel m = k - 1 subtracted from the own tiles (i, j),
// k + 1 <= j < i, i in {r0, r1}; panel m's tiles streamed in chunks.
__device__ void leaf_bulk(float* own, float* ring, const float* WS, int nt, int r0, int r1, int k) {
  const int m = k - 1, j0 = k + 1, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (r1 <= j0) return;
  const float* panel = WS + (size_t)m * nt * kLcPub;
  const int chunks = (r1 - j0 + kLcChunk - 1) / kLcChunk;
  leaf_stage(ring, panel + (size_t)j0 * kLcPub, min(kLcChunk, r1 - j0));
  for (int c = 0; c < chunks; ++c) {
    const int a = j0 + c * kLcChunk, b = min(a + kLcChunk, r1);
    if (c + 1 < chunks) {
      const int a1 = b, b1 = min(a1 + kLcChunk, r1);
      leaf_stage(ring + ((c + 1) & 1) * kLcChunk * kLcPub, panel + (size_t)a1 * kLcPub, b1 - a1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in its buffer, for every thread
    const float* buf = ring + (c & 1) * kLcChunk * kLcPub;
    const int n0 = max(0, min(b, r0) - a), total = n0 + (b - a);
    for (int t = warp; t < total; t += kCholWarps) {
      const int i = t < n0 ? r0 : r1, j = a + (t < n0 ? t : t - n0);
      tile_update(own_tile(own, r0, i, j), kLcLd, own_tile(own, r0, i, m), kLcLd, buf + (j - a) * kLcPub,
                  kCholNb, lane);
    }
    __syncthreads();  // the buffer is read before chunk c + 2 refills it
  }
}

// grid (s / 64) as one cluster; block (256); dynamic shared memory
// leaf_cluster_floats(s / 32) floats.  WS: the workspace, nt * nt published
// tiles (slot (k, i) the tile (i, k) of L) and nt * 32 scales.
__global__ void __launch_bounds__(kCholThreads, 1)
    leaf_chol_cluster(const float* A, size_t lda, float* L, size_t ldl, float* __restrict__ WS, int s) {
  extern __shared__ __align__(16) float smem[];
  const int nt = s / kCholNb, rank = cluster_rank(), r0 = rank, r1 = nt - 1 - rank;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* own = smem;
  float* ring = own + (nt + 1) * kLcTile;
  float* Dk = ring + 2 * kLcChunk * kLcPub;  // L_kk
  float* Pk = Dk + kLcPub;                   // L_k,k-1
  float* rd = Pk + kLcPub;                   // L_kk's scales
  float* rds = WS + (size_t)nt * nt * kLcPub;
  auto slot = [&](int k, int i) { return WS + ((size_t)k * nt + i) * kLcPub; };

  leaf_load_row(A, lda, r0, own_tile(own, r0, r0, 0));
  leaf_load_row(A, lda, r1, own_tile(own, r0, r1, 0));
  __syncthreads();
  if (r0 == 0 && warp == 0) {
    leaf_factor_publish(own_tile(own, r0, 0, 0), rd, slot(0, 0), rds, lane);
    __threadfence();
  }
  __syncthreads();
  cluster_arrive();  // A_0
  for (int k = 0; k + 1 < nt; ++k) {
    cluster_wait();  // A_k: L_kk and panel k - 1 are in their slots
    int rows[2], np = 0;
    if (r0 > k) rows[np++] = r0;
    if (r1 > k) rows[np++] = r1;
    if (np > 0) {
      for (int e = threadIdx.x; e < kLcPub / 4; e += kCholThreads) {
        reinterpret_cast<float4*>(Dk)[e] = __ldcg(reinterpret_cast<const float4*>(slot(k, k)) + e);
        if (k > 0) reinterpret_cast<float4*>(Pk)[e] = __ldcg(reinterpret_cast<const float4*>(slot(k - 1, k)) + e);
      }
      if (threadIdx.x < kCholNb) rd[threadIdx.x] = __ldcg(rds + k * kCholNb + threadIdx.x);
      __syncthreads();
      // the column: panel k - 1's last update, the solve against L_kk, then
      // the row's diagonal tile; four warps a row, each a quarter of the tile
      // products, the first of them solves
      const int g = warp >> 2, q = warp & 3, i = rows[g < np ? g : 0];
      float* T = own_tile(own, r0, i, k);
      if (k > 0 && g < np) tile_update_cols(T, kLcLd, own_tile(own, r0, i, k - 1), kLcLd, Pk, kCholNb, lane, q);
      __syncthreads();
      if (g < np && q == 0) row_solve<1>(T, kLcLd, lane, Dk, kCholNb, rd, slot(k, i), kCholNb, lane);
      __syncthreads();
      if (g < np) tile_update_cols(own_tile(own, r0, i, i), kLcLd, T, kLcLd, T, kLcLd, lane, q);
      __syncthreads();
      if (warp == 0 && (r0 == k + 1 || r1 == k + 1))
        leaf_factor_publish(own_tile(own, r0, k + 1, k + 1), rd, slot(k + 1, k + 1), rds + (k + 1) * kCholNb,
                            lane);
      __threadfence();  // this thread's tiles of the slots are written before its arrive
      __syncthreads();
    }
    cluster_arrive();  // A_k+1
    if (k > 0) leaf_bulk(own, ring, WS, nt, r0, r1, k);
  }
  leaf_store_row(L, ldl, s, r0, own_tile(own, r0, r0, 0));
  leaf_store_row(L, ldl, s, r1, own_tile(own, r0, r1, 0));
  cluster_wait();  // each thread waits on its last arrive
}

// The launch configuration of K12 at leaf size s (grid = cluster = s / 64).
struct LeafClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err;
  LeafClusterLaunch(int s, void* stream) : cfg() {
    const int cl = s / (2 * kCholNb);
    const int bytes = leaf_cluster_floats(s / kCholNb) * (int)sizeof(float);
    err = cudaFuncSetAttribute(leaf_chol_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && cl > 8)
      err = cudaFuncSetAttribute(leaf_chol_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cl);
    cfg.blockDim = dim3(kCholThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

inline bool leaf_cluster_size_ok(int s) { return s >= 2 * kCholNb && s % (2 * kCholNb) == 0 && s <= kLeafMax; }

// ---- K13: W = L^-1 of the factor, over the card ----------------------------

constexpr int kInvBase = 2 * kInvNb;      // 64: the blocks inverted whole in one CTA
constexpr int kInvBaseLd = kInvBase + 1;  // a row of the CTA's copies of L and W
// Shared memory (floats) of leaf_inv_base: the block of L, the block of W,
// and the warps' 32x32 inverses (later the level's T).
constexpr int kInvBaseFloats = 2 * kInvBase * kInvBaseLd + kInvBase / kInvNb * kInvNb * (kInvNb + 1);

// The doubling level h = 32 inside leaf_inv_base's block (A its first 32
// rows and columns, D its last): T = C inv(A) into Ts, then W_CA = -inv(D) T
// into Ws.  A thread takes CPT adjacent outputs of a row and sums over the
// whole depth h: the entries of inv(A) above its diagonal and of inv(D)
// right of it are exact zeros, which leave the sums as they are.
__device__ __forceinline__ void leaf_inv_base_level(const float* Ls, float* Ws, float* Ts) {
  constexpr int h = kInvNb, CPT = h * h / kInvThreads, per_row = h / CPT;
  const int r = threadIdx.x / per_row, c = threadIdx.x % per_row * CPT, c0 = 0, r0 = h;
  float t[CPT] = {};
  for (int k = 0; k < h; ++k) {  // T[r][c ..] = sum_k C[r][k] inv(A)[k][c ..]
    const float a = Ls[(r0 + r) * kInvBaseLd + c0 + k];
    const float* B = Ws + (c0 + k) * kInvBaseLd + c0 + c;
#pragma unroll
    for (int j = 0; j < CPT; ++j) t[j] = fmaf(a, B[j], t[j]);
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) Ts[r * h + c + j] = t[j];
  __syncthreads();
  float x[CPT] = {};
  for (int k = 0; k < h; ++k) {  // X[r][c ..] = -sum_k inv(D)[r][k] T[k][c ..]
    const float a = Ws[(r0 + r) * kInvBaseLd + r0 + k];
    const float* B = Ts + k * h + c;
#pragma unroll
    for (int j = 0; j < CPT; ++j) x[j] = fmaf(a, B[j], x[j]);
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) Ws[(r0 + r) * kInvBaseLd + c0 + c + j] = -x[j];
  __syncthreads();
}

// grid s / 64; block (256); dynamic shared memory kInvBaseFloats floats.
// CTA q inverts the 64-wide diagonal block q of L into W's, exact zeros above
// its diagonal: the block of L staged in shared memory, two warps its 32-wide
// diagonal blocks (warp_tri_inv32), then the doubling level h = 32 in shared
// memory, X = -inv(D) (C inv(A)), four outputs a thread (sums of 32 terms, a
// partial of the first level).
__global__ void __launch_bounds__(kInvThreads)
    leaf_inv_base(const float* __restrict__ L, int ldl, float* __restrict__ W, int ldw) {
  extern __shared__ __align__(16) float ism[];
  float* Ls = ism;                               // the block of L, its lower triangle
  float* Ws = Ls + kInvBase * kInvBaseLd;        // the block of W
  float(*sb)[kInvNb + 1] = reinterpret_cast<float(*)[kInvNb + 1]>(Ws + kInvBase * kInvBaseLd);
  float* Ts = Ws + kInvBase * kInvBaseLd;        // T, over the warps' buffers once they are read
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t d0 = (size_t)blockIdx.x * kInvBase;
  constexpr int kB = 8, kBatches = kInvBase * kInvBase / (kB * kInvThreads);  // eight loads a thread in flight
  for (int b0 = 0; b0 < kBatches; ++b0) {
    float v[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = (b0 * kB + u) * kInvThreads + threadIdx.x, r = e / kInvBase, c = e % kInvBase;
      v[u] = c <= r ? L[(d0 + r) * ldl + d0 + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = (b0 * kB + u) * kInvThreads + threadIdx.x, r = e / kInvBase, c = e % kInvBase;
      Ls[r * kInvBaseLd + c] = v[u];
      Ws[r * kInvBaseLd + c] = 0.0f;
    }
  }
  __syncthreads();
  if (warp < kInvBase / kInvNb) {
    float(*sw)[kInvNb + 1] = sb + warp * kInvNb;
    warp_tri_inv32(Ls + warp * kInvNb * (kInvBaseLd + 1), kInvBaseLd, kInvNb, sw);
    for (int r = 0; r < kInvNb; ++r) Ws[(warp * kInvNb + r) * kInvBaseLd + warp * kInvNb + lane] = sw[r][lane];
  }
  __syncthreads();  // the 32-wide inverses are in Ws; Ts is free
  leaf_inv_base_level(Ls, Ws, Ts);
  for (int e = threadIdx.x; e < kInvBase * kInvBase; e += kInvThreads) {
    const int r = e / kInvBase, c = e % kInvBase;
    W[(d0 + r) * ldw + d0 + c] = Ws[r * kInvBaseLd + c];
  }
}

// Block (x, y) of a level-h kernel: pair y joins A, the h-wide block at c0 =
// 2 y h, and D, the hd-wide block at r0 = c0 + h (hd < h for a ragged last
// pair), and the block takes the output tile at rows i0, columns j0 (jw wide).
struct LeafInvTile {
  int c0, r0, hd, i0, j0, jw;
  __device__ __forceinline__ LeafInvTile(int s, int h) {
    const int cbs = (h + kInvCb - 1) / kInvCb;
    c0 = 2 * (int)blockIdx.y * h;
    r0 = c0 + h;
    hd = min(h, s - r0);
    i0 = (int)blockIdx.x / cbs * kInvCb;
    j0 = (int)blockIdx.x % cbs * kInvCb;
    jw = min(kInvCb, h - j0);
  }
};

// out[r][c] = sign acc for the rows < rows and columns < cols of a 64x64
// tile, thread (ty, tx) rows 4 ty .., columns 4 tx ..
__device__ __forceinline__ void leaf_inv_store(float* out, size_t ld, const float acc[4][4], int rows, int cols,
                                               float sign) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
    if (r >= rows) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * tx + b < cols) out[(size_t)r * ld + 4 * tx + b] = sign * acc[a][b];
  }
}

// grid (ceil(h / 64)^2, pairs), pairs = ceil((s - h) / 2h): T = C inv(A) into
// the scratch T (row stride s) at the coordinates of W_CA.  The next chunk's
// loads are in flight while the block computes on this one.
__global__ void __launch_bounds__(kInvThreads)
    leaf_inv_t(const float* __restrict__ L, int ldl, const float* __restrict__ W, int ldw, float* __restrict__ T,
               int s, int h) {
  __shared__ __align__(16) float As[kInvK * kInvLd];  // C, transposed
  __shared__ __align__(16) float Bs[kInvK * kInvLd];  // rows of inv(A)
  const LeafInvTile t(s, h);
  if (t.i0 >= t.hd) return;  // block-uniform, before any barrier
  const float* C = L + (size_t)(t.r0 + t.i0) * ldl + t.c0;
  const float* IA = W + (size_t)t.c0 * ldw + t.c0 + t.j0;
  float acc[4][4] = {}, va[8], vb[8];
  inv_load_t(va, C + t.j0, (size_t)ldl, t.hd - t.i0, h - t.j0);  // inv(A)[k][j] = 0 for k < j
  inv_load(vb, IA + (size_t)t.j0 * ldw, (size_t)ldw, h - t.j0, t.jw);
  for (int k0 = t.j0; k0 < h; k0 += kInvK) {
    __syncthreads();
    inv_put_t(As, va);
    inv_put(Bs, vb);
    __syncthreads();
    const int k1 = k0 + kInvK;
    if (k1 < h) {
      inv_load_t(va, C + k1, (size_t)ldl, t.hd - t.i0, h - k1);
      inv_load(vb, IA + (size_t)k1 * ldw, (size_t)ldw, h - k1, t.jw);
    }
    inv_chunk(As, Bs, acc);
  }
  leaf_inv_store(T + (size_t)(t.r0 + t.i0) * s + t.c0 + t.j0, (size_t)s, acc, t.hd - t.i0, t.jw, 1.0f);
}

// grid as leaf_inv_t: W_CA = -inv(D) T into W, and the tile's mirror in W's
// strict upper (rows c0 + j0 .., columns r0 + i0 ..) as exact zeros.  W is
// read (inv(D)) and written (W_CA and the mirror) in three disjoint regions.
__global__ void __launch_bounds__(kInvThreads)
    leaf_inv_x(const float* __restrict__ T, float* W, int ldw, int s, int h) {
  __shared__ __align__(16) float As[kInvK * kInvLd];  // inv(D), transposed
  __shared__ __align__(16) float Bs[kInvK * kInvLd];  // rows of T
  const LeafInvTile t(s, h);
  if (t.i0 >= t.hd) return;
  const int kend = min(t.i0 + kInvCb, t.hd);  // inv(D)[i][k] = 0 for k > i
  const float* ID = W + (size_t)(t.r0 + t.i0) * ldw + t.r0;
  const float* Tc = T + (size_t)t.r0 * s + t.c0 + t.j0;
  float acc[4][4] = {}, va[8], vb[8];
  inv_load_t(va, ID, (size_t)ldw, t.hd - t.i0, kend);
  inv_load(vb, Tc, (size_t)s, kend, t.jw);
  for (int k0 = 0; k0 < kend; k0 += kInvK) {
    __syncthreads();
    inv_put_t(As, va);
    inv_put(Bs, vb);
    __syncthreads();
    const int k1 = k0 + kInvK;
    if (k1 < kend) {
      inv_load_t(va, ID + k1, (size_t)ldw, t.hd - t.i0, kend - k1);
      inv_load(vb, Tc + (size_t)k1 * s, (size_t)s, kend - k1, t.jw);
    }
    inv_chunk(As, Bs, acc);
  }
  leaf_inv_store(W + (size_t)(t.r0 + t.i0) * ldw + t.c0 + t.j0, (size_t)ldw, acc, t.hd - t.i0, t.jw, -1.0f);
  const int zc = min(kInvCb, t.hd - t.i0);
  for (int e = threadIdx.x; e < t.jw * kInvCb; e += kInvThreads)
    if (e % kInvCb < zc) W[(size_t)(t.c0 + t.j0 + e / kInvCb) * ldw + t.r0 + t.i0 + e % kInvCb] = 0.0f;
}

}  // namespace gpr

// A, L: (s, s) row-major views, row strides lda and ldl (L may be A); WS: a
// workspace of nt (nt * 1024 + 32) floats, nt = s / 32.  s % 64 == 0, s <=
// 1024.  One cluster of s / 64 CTAs (16 at s = 1024, non-portable); a cluster
// the card cannot place fails the launch.
extern "C" int gpr_leaf_chol(const float* A, int lda, float* L, int ldl, float* WS, int s, void* stream) {
  if (!gpr::leaf_cluster_size_ok(s) || lda < s || ldl < s) return (int)cudaErrorInvalidValue;
  gpr::LeafClusterLaunch launch(s, stream);
  if (launch.err != cudaSuccess) return (int)launch.err;
  cudaError_t err = cudaLaunchKernelEx(&launch.cfg, gpr::leaf_chol_cluster, A, (size_t)lda, L, (size_t)ldl, WS, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many of K12's clusters the card can hold at once at leaf size s
// (cudaOccupancyMaxActiveClusters; 0: it cannot place one) into *out.
extern "C" int gpr_leaf_chol_clusters(int s, int* out) {
  if (!gpr::leaf_cluster_size_ok(s)) return (int)cudaErrorInvalidValue;
  gpr::LeafClusterLaunch launch(s, nullptr);
  if (launch.err != cudaSuccess) return (int)launch.err;
  return (int)cudaOccupancyMaxActiveClusters(out, gpr::leaf_chol_cluster, &launch.cfg);
}

// As gpr_leaf_chol, then W = L^-1: W (s, s), row stride ldw, sharing no memory
// with A, L or WS; WS K12's workspace, the inverse's scratch after the factor.
// 2 + 2 log2(s / 64) kernels in stream order.
extern "C" int gpr_leaf_chol_wi(const float* A, int lda, float* L, int ldl, float* W, int ldw, float* WS, int s,
                                void* stream) {
  using namespace gpr;
  if (!leaf_cluster_size_ok(s) || lda < s || ldl < s || ldw < s) return (int)cudaErrorInvalidValue;
  const int rc = gpr_leaf_chol(A, lda, L, ldl, WS, s, stream);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = kInvBaseFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(leaf_inv_base, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  leaf_inv_base<<<s / kInvBase, kInvThreads, smem, st>>>(L, ldl, W, ldw);
  err = cudaGetLastError();
  for (int h = kInvBase; h < s && err == cudaSuccess; h *= 2) {
    const int pairs = (s - h + 2 * h - 1) / (2 * h), cbs = (h + kInvCb - 1) / kInvCb;
    leaf_inv_t<<<dim3(cbs * cbs, pairs), kInvThreads, 0, st>>>(L, ldl, W, ldw, WS, s, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    leaf_inv_x<<<dim3(cbs * cbs, pairs), kInvThreads, 0, st>>>(WS, W, ldw, s, h);
    err = cudaGetLastError();
  }
  return (int)err;
}

// L: (s, s) lower-triangular (only its lower triangle is read), W: (s, s);
// bar: K14's grid barrier, two zeros.  One cooperative launch.
extern "C" int gpr_tri_inv_leaf(const float* L, int ldl, float* W, int ldw, int s, unsigned* bar, void* stream) {
  using namespace gpr;
  if (s < kLeafBlock || s % kLeafBlock || s > kLeafMax || ldl < s || ldw < s) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_inv_leaf_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int nb = s / kLeafBlock;
  const int most = nb * (nb - 1) / 2 > 1 ? nb * (nb - 1) / 2 : 1;  // the widest phase's tiles
  const int grid = per_sm * sms < most ? per_sm * sms : most;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  size_t ldl_ = (size_t)ldl, ldw_ = (size_t)ldw;
  void* args[] = {&L, &ldl_, &W, &ldw_, &s, &bar};
  err = cudaLaunchCooperativeKernel((const void*)tri_inv_leaf_kernel, dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
