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
// K14: W = L^-1 of the lower triangle of L on one launch of a persistent
// grid (leaf_inv), no cooperative launch and no grid barrier.  By the
// identity K11 uses (tri_inv.cuh; JAX's pallas_solve.py:213-227)
//
//   inv([[A, 0], [C, D]]) = [[inv A, 0], [-inv(D) C inv(A), inv D]],
//
// the work is cut into items, handed out by an atomic ticket in an order
// that respects their dependencies (K10's scheme, solve.cu), from a table
// the host makes once a launch (InvPlan, passed by value):
//   diagonal  the s / 64 diagonal blocks of 64, an item each, in shared
//             memory: two warps invert its 32-wide diagonal blocks (lane c a
//             column, by forward substitution in registers), then the
//             doubling level h = 32 below, four outputs a thread;
//   then, for h = 64, 128, .. < s, the pairs of h-wide inverted blocks A (at
//   c0 = 2 p h) and D (at r0 = c0 + h, hd <= h wide), each 64x64 output tile
//   of W_CA in two phases, each cut along its sum into pieces (32 terms at
//   h = 64 and 128 and 64 at h = 256, where a phase has few pieces and their
//   depth sets its pace; 128 at h = 512, which keeps its 160 pieces a phase
//   to one wave of the card's 132 CTAs), an item a piece:
//   T         T = C inv(A), C = L[r0 .., c0 ..], the sum from the tile's
//             column block j0 (inv(A) is 0 above);
//   X         W_CA = -inv(D) T, the sum up to the tile's last row (inv(D) is
//             0 right of it).
// A piece writes its partial tile to its own slot of the scratch WS and
// counts itself at the tile's flag in device memory.  A consumer stages its
// operand as the sum of the producer's partials, added in their fixed order
// (T's pieces for X, W_CA's for the next level's T), so no phase waits on a
// sum of its own; no float atomics.  The last X piece of a tile (a second
// count) adds the partials in the same order into W, as -sum, with the
// tile's mirror in W's strict upper as exact zeros, and marks the tile
// written for X's inv(D), which waits on it: so W's tile and every staged
// copy of it are the same bits.  Ticket order: the diagonal items, then level
// by level T's pieces, then X's.  A piece waits (flags.cuh: one thread's
// acquire loads, then its CTA's barrier) on the flags of the tiles it reads;
// the operand that does not depend on the phase before (C of L for T,
// inv(D) for X) has its first chunk in flight during the wait; data written
// in the launch is read through L2 (ld.cg).  An item waits only on items
// with smaller tickets, which CTAs that are running hold, so the launch
// cannot deadlock, whatever the number of CTAs resident.  Every counter
// returns to 0 within the launch: the last CTA to find no item left zeroes
// the ticket and the flags, so they need no fill of their own.  64x64
// register tiles (4x4 a thread) over 32-deep chunks staged through shared
// memory, the next chunk's loads in flight while the block computes, each
// chunk's partial folded into an FP32 running tile (tri_inv.cuh:
// inv_chunk), the pieces added in a second level.  One CTA an SM (255
// registers).  C lies strictly below the diagonal and the diagonal blocks
// are staged through a mask, so L's strict upper is never read.
//
// K13: K12's launch, then K14's launch on the L it wrote, one counted
// launch; K12's workspace, dead once the cluster is done, is part of the
// inverse's scratch.  So K13's L is K12's bit for bit and its W is
// tri_inv_leaf of that L bit for bit.
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
// K14's the chain of a diagonal item and 2 log2(s / 64) phases, each about a
// piece's product, its publication and a flag's round trip
// (chip_tools/k14_probe.py stamps each); K13's is K12's plus K14's.  Latency,
// not bytes or FLOP.  Plain FP32 FMA.
#include <cuda_runtime.h>

#include "chol.cuh"
#include "flags.cuh"
#include "tri_inv.cuh"

namespace gpr {

constexpr int kLeafMax = 1024;  // the largest leaf

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

// The leaf sizes every kernel here takes: s % 64 == 0, 64 <= s <= 1024.
inline bool leaf_size_ok(int s) { return s >= 2 * kCholNb && s % (2 * kCholNb) == 0 && s <= kLeafMax; }


// ---- K14 (and K13's inverse): W = L^-1 on one persistent launch -----------

constexpr int kInvBase = 2 * kInvNb;                 // 64: a diagonal item's block, an output tile's side
constexpr int kInvSlot = kInvBase * kInvBase;        // floats of a scratch slot: a 64x64 tile, row stride 64
constexpr int kInvMaxBlocks = kLeafMax / kInvBase;   // 16
constexpr int kInvWideFrom = 4;                      // the level (in blocks) from which a piece sums 64 terms
constexpr int kInvDeepFrom = 8;                      // and from which it sums 128
constexpr int kInvMaxLevels = 4;                     // hb = 1, 2, 4, 8 blocks at s <= 1024
// A diagonal item's shared memory (floats): L's block transposed (row stride
// 65: the transposing stores meet no bank twice), W's block (row stride 68:
// rows 16-byte aligned), the level's T (32 x 36) and the 64 pivots'
// reciprocals; a piece's two staged chunks fit in it.
constexpr int kInvLtLd = kInvBase + 1, kInvWsLd = kInvBase + 4, kInvTsLd = kInvNb + 4;
constexpr int kInvSmemFloats = kInvBase * kInvLtLd + kInvBase * kInvWsLd + kInvNb * kInvTsLd + kInvBase;
static_assert(kInvSmemFloats >= 2 * kInvK * kInvLd, "a piece's chunks fit the diagonal item's memory");
// Flags (ints): the ticket, the count of CTAs that found no item left, then
// four arrays over the 64-tiles (R, C) of the leaf, at R * 16 + C: T's
// pieces published, W_CA's pieces published, W_CA's pieces done with their
// count (the last adds the partials into W), W's tile written.  Zero at rest:
// the last CTA out zeroes them.
constexpr int kInvTiles = kInvMaxBlocks * kInvMaxBlocks;
constexpr int kInvFlagInts = 2 + 4 * kInvTiles;

// The doubling level of hb 64-blocks (hb = 1, 2, 4, .. < nb): its pairs, the
// rows of pair p's D (hd <= hb blocks; only the last pair is ragged), the
// 32-deep chunks a piece sums, 2^inv_pcl (one where the level's pieces are
// few and their depth is the phase's pace; four from kInvDeepFrom on, where
// 128-term pieces keep the phase to one wave of the card), and the most
// pieces of a tile's sum.
inline int inv_pairs(int nb, int hb) { return (nb - hb + 2 * hb - 1) / (2 * hb); }
inline int inv_hd(int nb, int hb, int p) {
  const int rest = nb - (2 * p + 1) * hb;
  return rest < hb ? rest : hb;
}
__host__ __device__ constexpr int inv_pcl(int hb) { return hb >= kInvDeepFrom ? 2 : hb >= kInvWideFrom ? 1 : 0; }
// The pieces that cover the chunks [0, n) at level hb
__host__ __device__ constexpr int inv_cover(int n, int hb) { return (n + (1 << inv_pcl(hb)) - 1) >> inv_pcl(hb); }
__host__ __device__ constexpr int inv_mp(int hb) { return inv_cover(2 * hb, hb); }
constexpr int inv_max_pieces() {
  int m = 1;
  for (int hb = 1; hb < kInvMaxBlocks; hb *= 2) m = inv_mp(hb) > m ? inv_mp(hb) : m;
  return m;
}
constexpr int kInvMaxPieces = inv_max_pieces();  // 4
static_assert(kInvMaxPieces <= 8 && kInvMaxBlocks <= 16, "a packed item's fields fit 3 bits");
constexpr int kInvMaxItems = 1024;               // 560 at s = 1024
// T's pieces in the output tile of column block j (it sums the chunks
// [2 j, 2 hb) of A), and X's in the tile of row block i (the chunks
// [0, 2 i + 2) of D); pieces are aligned to their size.
__host__ __device__ constexpr int inv_t_pieces(int hb, int j) { return inv_mp(hb) - (2 * j >> inv_pcl(hb)); }
__host__ __device__ constexpr int inv_x_pieces(int hb, int i) { return inv_cover(2 * i + 2, hb); }

// A launch's plan, made on the host: each ticket's item, packed (kind | l
// << 2 | p << 4 | i << 7 | j << 10 | m << 13: kind 0 the diagonal block q =
// the ticket; kind 1 (T) or 2 (X) piece m of the output tile (i, j) of pair
// p at the level of hb = 2^l blocks), each level's first slot, and the
// number of items and of slots.  Each output tile of a level has 2 mp
// slots, T's pieces then W_CA's.  The ticket order: the diagonal items, then
// level by level T's pieces (pair, row, column, piece), then X's (pair, row,
// column, piece).
struct InvPlan {
  int nb, items, slots;
  int base[kInvMaxLevels];
  unsigned short item[kInvMaxItems];
};

// The plan at leaf size s; items = 0 if it does not fit (s out of range).
inline InvPlan inv_plan(int s) {
  InvPlan pl = {};
  pl.nb = s / kInvBase;
  pl.items = pl.nb;
  auto add = [&](int kind, int l, int p, int i, int j, int m) {
    if (pl.items < kInvMaxItems) pl.item[pl.items] = (unsigned short)(kind | l << 2 | p << 4 | i << 7 | j << 10 | m << 13);
    ++pl.items;
  };
  for (int hb = 1, l = 0; hb < pl.nb; hb *= 2, ++l) {
    pl.base[l] = pl.slots;
    pl.slots += inv_pairs(pl.nb, hb) * hb * hb * 2 * inv_mp(hb);
    for (int p = 0; p < inv_pairs(pl.nb, hb); ++p)
      for (int i = 0; i < inv_hd(pl.nb, hb, p); ++i)
        for (int j = 0; j < hb; ++j)
          for (int m = inv_mp(hb) - inv_t_pieces(hb, j); m < inv_mp(hb); ++m) add(1, l, p, i, j, m);
    for (int p = 0; p < inv_pairs(pl.nb, hb); ++p)
      for (int i = 0; i < inv_hd(pl.nb, hb, p); ++i)
        for (int j = 0; j < hb; ++j)
          for (int m = 0; m < inv_x_pieces(hb, i); ++m) add(2, l, p, i, j, m);
  }
  if (pl.items > kInvMaxItems || pl.nb > kInvMaxBlocks) pl.items = 0;
  return pl;
}

// A work item.  kind 0: the diagonal block q.  kind 1 (T) or 2 (X): piece m
// of the output tile (i, j) of pair p at level l (hb = 2^l blocks), which
// joins A (at block c0) and D (at block r0 = c0 + hb); the piece sums the
// 32-deep chunks [ka, kb) (A's local coordinates for T, D's for X).  The
// tile has np pieces, the first of them m = first; the level's slots start
// at base.
struct InvItem {
  int kind, q, l, hb, p, c0, r0, i, j, m, first, np, ka, kb, base;
};

__device__ __forceinline__ InvItem inv_item(int t, const InvPlan& pl) {
  InvItem it = {};
  it.q = t;
  if (t < pl.nb) return it;
  const unsigned e = pl.item[t];
  it.kind = e & 3;
  it.l = e >> 2 & 3;
  it.p = e >> 4 & 7;
  it.i = e >> 7 & 7;
  it.j = e >> 10 & 7;
  it.m = e >> 13 & 7;
  it.hb = 1 << it.l;
  it.base = pl.base[it.l];
  it.c0 = 2 * it.p * it.hb;
  it.r0 = it.c0 + it.hb;
  const int pc = 1 << inv_pcl(it.hb);  // chunks a piece
  if (it.kind == 1) {
    it.np = inv_t_pieces(it.hb, it.j);
    it.first = inv_mp(it.hb) - it.np;
    it.ka = 2 * it.j > it.m * pc ? 2 * it.j : it.m * pc;
    it.kb = 2 * it.hb < (it.m + 1) * pc ? 2 * it.hb : (it.m + 1) * pc;
  } else {
    it.np = inv_x_pieces(it.hb, it.i);
    it.ka = it.m * pc;
    it.kb = 2 * it.i + 2 < it.ka + pc ? 2 * it.i + 2 : it.ka + pc;
  }
  return it;
}

// The first slot of the output tile (i, j) of pair p at the level of hb
// blocks whose slots start at base.
__device__ __forceinline__ int inv_tile_slot(int base, int hb, int p, int i, int j) {
  return base + ((p * hb + i) * hb + j) * 2 * inv_mp(hb);
}

// Where a 32-row chunk of a product's right operand comes from: B(k, c) =
// sign * sum_{m < n} p[m * kInvSlot + k * ld + c], the n partials of a tile
// in the slots (ld = 64), added in their order, or a tile of W itself (n = 1,
// ld = ldw, rows of any alignment).
struct InvSrc {
  const float* p;
  int ld, n;
  float sign;
  bool slots;
};

// W's tile (R, C), R > C, as its producer's partials: the X pieces of the
// level at which R and C fall in the two halves of one pair (W_CA = minus
// their sum), and how many there are.
__device__ __forceinline__ InvSrc inv_w_partials(const float* WS, const InvPlan& pl, int R, int C) {
  const int l = 31 - __clz(R ^ C), hb = 1 << l, p = R >> (l + 1), i = R - (2 * p + 1) * hb, j = C - 2 * p * hb;
  return {WS + (size_t)(inv_tile_slot(pl.base[l], hb, p, i, j) + inv_mp(hb)) * kInvSlot, kInvBase,
          inv_x_pieces(hb, i), -1.0f, true};
}

// A chunk of B from src (32 rows x 64 columns; thread t the 4 columns 4 (t %
// 16) .. of rows t / 16 and t / 16 + 16), read through L2 in two halves, so
// that the loads stay in flight while the block computes: inv_load_src,
// every partial's loads into x (16 bytes a load from the slots, whose rows
// are aligned; W's rows may not be); inv_put_src, their sums (in the
// partials' order, then the sign) into Bs.
__device__ __forceinline__ void inv_load_src(float4 x[kInvMaxPieces][2], const InvSrc& b) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = threadIdx.x + u * kInvThreads, k = f / 16, c = f % 16 * 4;
    if (b.slots) {
#pragma unroll
      for (int m = 0; m < kInvMaxPieces; ++m)
        x[m][u] = m < b.n ? __ldcg(reinterpret_cast<const float4*>(b.p + (size_t)m * kInvSlot + k * kInvBase + c))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      const float* q = b.p + (size_t)k * b.ld + c;
      x[0][u] = make_float4(__ldcg(q), __ldcg(q + 1), __ldcg(q + 2), __ldcg(q + 3));
    }
  }
}

__device__ __forceinline__ void inv_put_src(float* Bs, const float4 x[kInvMaxPieces][2], const InvSrc& b) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = threadIdx.x + u * kInvThreads;
    float4 sum = x[0][u];
#pragma unroll
    for (int m = 1; m < kInvMaxPieces; ++m)
      if (m < b.n) sum.x += x[m][u].x, sum.y += x[m][u].y, sum.z += x[m][u].z, sum.w += x[m][u].w;
    *reinterpret_cast<float4*>(Bs + f / 16 * kInvLd + f % 16 * 4) =
        make_float4(b.sign * sum.x, b.sign * sum.y, b.sign * sum.z, b.sign * sum.w);
  }
}

// Lane c of the calling warp: column c of the inverse of the 32x32
// lower-triangular block whose transpose is at Lt (row stride kInvLtLd: Lt[i
// ld + r] = L[r][i]; zeros above L's diagonal), its pivots' reciprocals at
// rd, into w (w[r] = inv[r][c]).  Forward substitution, right-looking: w[i] =
// s[i] / L[i][i], then s[r] -= L[r][i] w[i] for r > i; the 32 steps' chain is
// a multiply and an FMA, the rest independent FMAs on registers with L from
// shared memory (a broadcast).  Entries above the diagonal are not exact
// zeros where a pivot failed (0 * inf); the caller masks them.
__device__ __forceinline__ void warp_tri_inv32_cols(const float* Lt, const float* rd, float w[kInvNb]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kInvNb; ++r) w[r] = r == lane ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < kInvNb; ++i) {
    w[i] *= rd[i];
#pragma unroll
    for (int r = i + 1; r < kInvNb; ++r) w[r] = fmaf(-Lt[i * kInvLtLd + r], w[i], w[r]);
  }
}

// The diagonal block q of L into W's: the block of L staged transposed in
// shared memory through a mask, two warps its 32-wide diagonal blocks (lane c
// a column, warp_tri_inv32_cols), then the doubling level h = 32 in shared
// memory, X = -inv(D) (C inv(A)), four outputs a thread (sums of 32 terms, a
// partial of the first level); the block written with exact zeros above its
// diagonal.
__device__ inline void inv_diag(const float* __restrict__ L, size_t ldl, float* W, size_t ldw, int q,
                                float* sm) {
  float* Lt = sm;                       // L's block transposed, its lower triangle
  float* Ws = Lt + kInvBase * kInvLtLd;  // W's block
  float* Ts = Ws + kInvBase * kInvWsLd;  // the level's T
  float* rd = Ts + kInvNb * kInvTsLd;    // 1 / L[r][r]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t d0 = (size_t)q * kInvBase;
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
      Lt[c * kInvLtLd + r] = v[u];
      Ws[r * kInvWsLd + c] = 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x < kInvBase) rd[threadIdx.x] = 1.0f / Lt[threadIdx.x * (kInvLtLd + 1)];
  __syncthreads();
  if (warp < kInvBase / kInvNb) {
    const int o = warp * kInvNb;  // the block's first row and column
    float w[kInvNb];
    warp_tri_inv32_cols(Lt + o * (kInvLtLd + 1), rd + o, w);
#pragma unroll
    for (int r = 0; r < kInvNb; ++r) Ws[(o + r) * kInvWsLd + o + lane] = r >= lane ? w[r] : 0.0f;
  }
  __syncthreads();
  // T = C inv(A) into Ts, then W_CA = -inv(D) T into Ws (A the first 32 rows
  // and columns, D the last): a thread takes 4 adjacent outputs of a row and
  // sums over the whole depth h; the entries of inv(A) above its diagonal
  // and of inv(D) right of it are exact zeros, which leave the sums as they are
  constexpr int h = kInvNb;
  const int r = threadIdx.x / 8, c = threadIdx.x % 8 * 4;
  float a[h], t[4] = {};
#pragma unroll
  for (int k = 0; k < h; ++k) a[k] = Lt[k * kInvLtLd + h + r];  // every load in flight before the chain
#pragma unroll
  for (int k = 0; k < h; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(Ws + k * kInvWsLd + c);
    t[0] = fmaf(a[k], b.x, t[0]), t[1] = fmaf(a[k], b.y, t[1]), t[2] = fmaf(a[k], b.z, t[2]);
    t[3] = fmaf(a[k], b.w, t[3]);
  }
  *reinterpret_cast<float4*>(Ts + r * kInvTsLd + c) = make_float4(t[0], t[1], t[2], t[3]);
  __syncthreads();
  float x[4] = {};
#pragma unroll
  for (int k = 0; k < h; ++k) a[k] = Ws[(h + r) * kInvWsLd + h + k];
#pragma unroll
  for (int k = 0; k < h; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(Ts + k * kInvTsLd + c);
    x[0] = fmaf(a[k], b.x, x[0]), x[1] = fmaf(a[k], b.y, x[1]), x[2] = fmaf(a[k], b.z, x[2]);
    x[3] = fmaf(a[k], b.w, x[3]);
  }
  *reinterpret_cast<float4*>(Ws + (h + r) * kInvWsLd + c) = make_float4(-x[0], -x[1], -x[2], -x[3]);
  __syncthreads();
  for (int e = threadIdx.x; e < kInvBase * kInvBase; e += kInvThreads) {
    const int rr = e / kInvBase, cc = e % kInvBase;
    W[(d0 + rr) * ldw + d0 + cc] = Ws[rr * kInvWsLd + cc];
  }
}

// acc = the sum over `chunks` 32-deep chunks of A(r, k) B(k, c) for a 64x64
// tile, thread (ty, tx) rows 4 ty .., columns 4 tx ..: chunk n's A at a(n)
// (row-major, row stride lda, staged transposed; chunk 0's already in va),
// its B from the source b(n); read through L2.  The next chunk's loads are in
// flight while the block computes on this one.
template <class FA, class FB>
__device__ __forceinline__ void inv_piece(float* As, float* Bs, FA a, size_t lda, FB b, int chunks, float va[8],
                                          float acc[4][4]) {
  float4 xb[kInvMaxPieces][2];
  InvSrc src = b(0);
  inv_load_src(xb, src);
  for (int n = 0; n < chunks; ++n) {
    __syncthreads();  // the shared memory is free (the last chunk, or the last item, is done)
    inv_put_t(As, va);
    inv_put_src(Bs, xb, src);
    __syncthreads();
    if (n + 1 < chunks) {
      inv_load_t<true>(va, a(n + 1), lda, kInvCb, kInvK);
      src = b(n + 1);
      inv_load_src(xb, src);
    }
    inv_chunk(As, Bs, acc);
  }
}

// A thread's 4x4 of a 64x64 slot: rows 4 ty + a, columns 4 tx ...
__device__ __forceinline__ void inv_put_slot(float* S, const float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(S + (4 * ty + a) * kInvBase + 4 * tx) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

// acc = the sum of the n slots at S in their order, slot `mine` (this CTA's
// own piece) taken from acc: the same values, so the sum does not depend on
// which piece came last, and it is the sum inv_load_src forms.
__device__ __forceinline__ void inv_sum_slots(const float* S, int n, int mine, float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sum[4][4];
  for (int m = 0; m < n; ++m) {
    float v[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (m == mine) {
#pragma unroll
        for (int b = 0; b < 4; ++b) v[a][b] = acc[a][b];
      } else {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(S + (size_t)m * kInvSlot + (4 * ty + a) * kInvBase) + tx);
        v[a][0] = f.x, v[a][1] = f.y, v[a][2] = f.z, v[a][3] = f.w;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) sum[a][b] = m == 0 ? v[a][b] : sum[a][b] + v[a][b];
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = sum[a][b];
}

// W_CA's tile at block (R, C) = -acc, and its mirror (C, R) in W's strict
// upper as exact zeros.
__device__ __forceinline__ void inv_put_w(float* W, size_t ldw, int R, int C, const float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = W + (size_t)R * kInvBase * ldw + (size_t)C * kInvBase;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[(size_t)(4 * ty + a) * ldw + 4 * tx + b] = -acc[a][b];
  float* mirror = W + (size_t)C * kInvBase * ldw + (size_t)R * kInvBase;
  for (int e = threadIdx.x; e < kInvSlot; e += kInvThreads) mirror[(size_t)(e / kInvBase) * ldw + e % kInvBase] = 0.0f;
}

// This item's writes are visible card-wide before thread 0 adds one to *flag
// (the CTA's barrier, then thread 0's fence, as a grid barrier publishes).
__device__ __forceinline__ void inv_publish(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1);
  }
}

// After this piece's partial is published: whether it is the last of the
// tile's n pieces to count itself at *done (then the others' slots are
// visible: each published before it counted).
__device__ __forceinline__ bool inv_last(int* done, int n, int* last_sh) {
  if (threadIdx.x == 0) {
    *last_sh = atomicAdd(done, 1) == n - 1;
    __threadfence();
  }
  __syncthreads();
  return *last_sh;
}

// grid: at most as many CTAs as the card holds at once, at most one an item;
// block (256); dynamic shared memory kInvSmemFloats floats.  WS: the slots,
// pl.slots x 64 x 64 floats; flags: kInvFlagInts ints, zero at the launch and
// again at its end.  A piece waits on the tiles it reads: T's pieces on
// inv(A)'s, each W's diagonal tile written or W_CA's partials all published
// (the operand stages their sum); X's on inv(D)'s tiles written, then on T's
// partials all published.  The operand that does not wait on the phase before
// (C of L for T, inv(D) for X) has its first chunk in flight during the wait.
__global__ void __launch_bounds__(kInvThreads, 1)
    leaf_inv(const float* __restrict__ L, size_t ldl, float* W, size_t ldw, float* WS, int* flags,
             const __grid_constant__ InvPlan pl) {
  extern __shared__ __align__(16) float ism[];
  __shared__ int item_sh, last_sh;
  int* tcount = flags + 2;
  int* xcount = tcount + kInvTiles;
  int* xdone = xcount + kInvTiles;
  int* wready = xdone + kInvTiles;
  float* As = ism;
  float* Bs = ism + kInvK * kInvLd;
  for (;;) {
    __syncthreads();  // the last item is done with the shared memory and item_sh
    if (threadIdx.x == 0) item_sh = atomicAdd(flags, 1);
    __syncthreads();
    if (item_sh >= pl.items) break;
    const InvItem it = inv_item(item_sh, pl);
    if (it.kind == 0) {
      inv_diag(L, ldl, W, ldw, it.q, ism);
      inv_publish(&wready[it.q * (kInvMaxBlocks + 1)]);
      continue;
    }
    const int R = it.r0 + it.i, C = it.c0 + it.j, tile = R * kInvMaxBlocks + C;  // the output tile, in blocks
    const int chunks = it.kb - it.ka, k0 = it.ka * kInvK, b0 = it.ka / 2, b1 = (it.kb + 1) / 2;  // its blocks
    float* slots = WS + (size_t)inv_tile_slot(it.base, it.hb, it.p, it.i, it.j) * kInvSlot;  // the tile's
    float acc[4][4] = {}, va[8];
    if (it.kind == 1) {  // T = C inv(A): C's rows R, inv(A)'s column block j, the terms from chunk ka of A
      const float* Cp = L + (size_t)R * kInvBase * ldl + (size_t)it.c0 * kInvBase + k0;
      inv_load_t<true>(va, Cp, ldl, kInvCb, kInvK);
      if (threadIdx.x == 0)
        for (int b = b0; b < b1; ++b) {
          if (b == it.j) {
            flag_wait(&wready[C * (kInvMaxBlocks + 1)], 1);  // the diagonal block j
          } else {
            flag_wait(&xcount[(it.c0 + b) * kInvMaxBlocks + C], inv_w_partials(WS, pl, it.c0 + b, C).n);
          }
        }
      __syncthreads();
      inv_piece(
          As, Bs, [&](int n) { return Cp + n * kInvK; }, ldl,
          [&](int n) {
            const int k = k0 + n * kInvK, Rk = it.c0 + k / kInvBase;  // inv(A)'s rows k .., W's block row Rk
            if (Rk == C) return InvSrc{W + (size_t)(it.c0 * kInvBase + k) * ldw + (size_t)C * kInvBase, (int)ldw, 1,
                                       1.0f, false};
            InvSrc src = inv_w_partials(WS, pl, Rk, C);
            src.p += (k % kInvBase) * kInvBase;
            return src;
          },
          chunks, va, acc);
      inv_put_slot(slots + (size_t)it.m * kInvSlot, acc);
      inv_publish(&tcount[tile]);
    } else {  // W_CA = -inv(D) T: inv(D)'s row block i, T's tiles (b, j), the terms from chunk ka of D
      const float* ID = W + (size_t)R * kInvBase * ldw + (size_t)it.r0 * kInvBase + k0;
      const int tp = inv_t_pieces(it.hb, it.j);  // T's pieces in column block j
      if (threadIdx.x == 0)
        for (int b = b0; b < b1; ++b) flag_wait(&wready[R * kInvMaxBlocks + it.r0 + b], 1);
      __syncthreads();
      inv_load_t<true>(va, ID, ldw, kInvCb, kInvK);
      if (threadIdx.x == 0)
        for (int b = b0; b < b1; ++b) flag_wait(&tcount[(it.r0 + b) * kInvMaxBlocks + C], tp);
      __syncthreads();
      inv_piece(
          As, Bs, [&](int n) { return ID + n * kInvK; }, ldw,
          [&](int n) {
            const int k = k0 + n * kInvK;  // T's rows k .., in its tile of row block k / 64
            const float* T = WS + (size_t)(inv_tile_slot(it.base, it.hb, it.p, k / kInvBase, it.j) +
                                           inv_mp(it.hb) - tp) * kInvSlot;
            return InvSrc{T + (k % kInvBase) * kInvBase, kInvBase, tp, 1.0f, true};
          },
          chunks, va, acc);
      const int mp = inv_mp(it.hb);
      inv_put_slot(slots + (size_t)(mp + it.m) * kInvSlot, acc);
      inv_publish(&xcount[tile]);
      if (!inv_last(&xdone[tile], it.np, &last_sh)) continue;
      inv_sum_slots(slots + (size_t)mp * kInvSlot, it.np, it.m, acc);
      inv_put_w(W, ldw, R, C, acc);
      inv_publish(&wready[tile]);
    }
  }
  // Every CTA that gets here has drawn its last ticket; the last of them
  // zeroes the ticket and the flags for the next launch
  if (threadIdx.x == 0) {
    __threadfence();
    last_sh = atomicAdd(flags + 1, 1) == (int)gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (last_sh)
    for (int e = threadIdx.x; e < kInvFlagInts; e += kInvThreads) flags[e] = 0;
}

constexpr int kInvDevices = 64;  // the cards whose resident-CTA count a process keeps

// W = L^-1 on the stream: the grid as many CTAs as the current card holds at
// once (asked once a card), at most one an item.
inline cudaError_t inv_launch(const float* L, int ldl, float* W, int ldw, float* WS, int* flags, int s,
                              cudaStream_t stream) {
  static int resident[kInvDevices] = {};
  const int smem = kInvSmemFloats * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kInvDevices) return cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, leaf_inv, kInvThreads, smem);
    if (err != cudaSuccess) return err;
    resident[dev] = per_sm * sms;
  }
  const InvPlan pl = inv_plan(s);
  if (pl.items == 0) return cudaErrorInvalidValue;
  const int grid = resident[dev] < pl.items ? resident[dev] : pl.items;
  leaf_inv<<<grid, kInvThreads, smem, stream>>>(L, (size_t)ldl, W, (size_t)ldw, WS, flags, pl);
  return cudaGetLastError();
}

}  // namespace gpr

// A, L: (s, s) row-major views, row strides lda and ldl (L may be A); WS: a
// workspace of nt (nt * 1024 + 32) floats, nt = s / 32.  s % 64 == 0, s <=
// 1024.  One cluster of s / 64 CTAs (16 at s = 1024, non-portable); a cluster
// the card cannot place fails the launch.
extern "C" int gpr_leaf_chol(const float* A, int lda, float* L, int ldl, float* WS, int s, void* stream) {
  if (!gpr::leaf_size_ok(s) || lda < s || ldl < s) return (int)cudaErrorInvalidValue;
  gpr::LeafClusterLaunch launch(s, stream);
  if (launch.err != cudaSuccess) return (int)launch.err;
  cudaError_t err = cudaLaunchKernelEx(&launch.cfg, gpr::leaf_chol_cluster, A, (size_t)lda, L, (size_t)ldl, WS, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many of K12's clusters the card can hold at once at leaf size s
// (cudaOccupancyMaxActiveClusters; 0: it cannot place one) into *out.
extern "C" int gpr_leaf_chol_clusters(int s, int* out) {
  if (!gpr::leaf_size_ok(s)) return (int)cudaErrorInvalidValue;
  gpr::LeafClusterLaunch launch(s, nullptr);
  if (launch.err != cudaSuccess) return (int)launch.err;
  return (int)cudaOccupancyMaxActiveClusters(out, gpr::leaf_chol_cluster, &launch.cfg);
}

// How much scratch K14 takes at leaf size s, in floats, into *out (K13 takes
// the larger of this and K12's workspace).
extern "C" int gpr_tri_inv_leaf_scratch(int s, int* out) {
  if (!gpr::leaf_size_ok(s)) return (int)cudaErrorInvalidValue;
  *out = gpr::inv_plan(s).slots * gpr::kInvSlot;
  return 0;
}

// How many ints K14's ticket, counts and flags take, into *out (the same at
// every leaf size).
extern "C" int gpr_tri_inv_leaf_flags(int* out) {
  *out = gpr::kInvFlagInts;
  return 0;
}

// As gpr_leaf_chol, then W = L^-1 of the L it wrote by K14's launch: W (s,
// s), row stride ldw, sharing no memory with A, L or WS; WS K12's workspace
// and K14's scratch, at least the larger of the two; flags as
// gpr_tri_inv_leaf's.
extern "C" int gpr_leaf_chol_wi(const float* A, int lda, float* L, int ldl, float* W, int ldw, float* WS,
                                int* flags, int s, void* stream) {
  if (!gpr::leaf_size_ok(s) || lda < s || ldl < s || ldw < s) return (int)cudaErrorInvalidValue;
  const int rc = gpr_leaf_chol(A, lda, L, ldl, WS, s, stream);
  if (rc != 0) return rc;
  return (int)gpr::inv_launch(L, ldl, W, ldw, WS, flags, s, static_cast<cudaStream_t>(stream));
}

// L: (s, s) lower-triangular (only its lower triangle is read), W: (s, s),
// row strides ldl and ldw, sharing no memory; s % 64 == 0, s <= 1024.  WS:
// gpr_tri_inv_leaf_scratch(s) floats; flags: gpr_tri_inv_leaf_flags ints, zero
// at the launch and left zero by it, one set a stream.  One launch.
extern "C" int gpr_tri_inv_leaf(const float* L, int ldl, float* W, int ldw, float* WS, int* flags, int s,
                                void* stream) {
  if (!gpr::leaf_size_ok(s) || ldl < s || ldw < s) return (int)cudaErrorInvalidValue;
  return (int)gpr::inv_launch(L, ldl, W, ldw, WS, flags, s, static_cast<cudaStream_t>(stream));
}
