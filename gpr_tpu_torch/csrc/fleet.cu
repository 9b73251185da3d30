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
// written), so the fleet is FLOP bound by the bytes-to-FLOP ratio; but a
// member's work runs on one SM (n = 512: ~92 us of FP32 FMA at 1980 MHz), each
// panel's diagonal step is a chain of p dependent pivots, and a right-looking
// update reads and writes the trailing matrix once a panel (16 FLOP a byte at
// p = 64, near the card's 20 for FP32): neither the card's peak nor its bytes
// alone set the pace.
//
// Design: one CTA of 256 threads a member (B = 128 is one wave over 132 SMs;
// B = 256 two, since a CTA takes more than half an SM's shared memory).  The
// member's factor is built in its slice of L, panel by panel (width p <= 128):
//   0. there is no copy of A: the first panel step reads A's lower triangle
//      and writes L, later steps read and write L; L's strict upper is
//      written as zeros, block row by block row during the updates;
//   1. the diagonal step: the p x p diagonal block, padded with the identity
//      to a multiple of 32, factored with its inverse in shared memory by
//      crout.cuh (K7's blocked factor, W^T in the tile's rows E, K8's code);
//      L_kk goes back to L, W_k = L_kk^-1 to the (B, n / p, p, p) output W;
//   2. the panel solve P = S_pk W_k^T, in place, a warp a 32-row tile (S's
//      rows staged in shared memory, a column-major copy of W_k beside them,
//      sums of at most p terms), written to L and kept in shared memory as
//      32-row tiles, column-major (32 x min(p, 64) floats, 8 KB at p = 64:
//      14 tiles at n = 512); for q <= 16 and p <= 64 the forward
//      substitution rides along: y_k = W_k b_k in step 1, b[o:] -= P y_k here;
//   3. the trailing update S22 -= P P^T over S22's lower 32x32 tiles, a warp a
//      tile (lane (rg, cg): rows 4 rg .. + 3, columns 8 cg .. + 7, one float4
//      of P's row tile and two of its column tile a step for 32 FMAs, all
//      from shared memory): the tile of S22 streams in by cp.async into the
//      lane's own 8 chunks of a per-warp buffer, issued before the FMAs of
//      the tile that needs it, so that one tile's loads are in flight while
//      the previous one's FMAs run; S22 - (a partial of at most 64 terms) is
//      written back (two-level sums: every panel's product is its own
//      partial).
//      Every P tile stays in shared memory while it fits (n <= 704 at p =
//      64); past that P goes through it in groups of G tiles, every pair of
//      groups in turn (a barrier a pair; P 64 columns deep at a time).  Then
//      the whole CTA runs step 1 for the next block.  Tried and slower
//      (PERF.md section 6): a lookahead, warp 0 factoring the next block while
//      warps 1-7 update (one warp's diagonal step took 100-195k cycles
//      against 37-73k on eight); 64x32 warp tasks, 8x8 outputs a lane.
//   4. alpha by the backward substitution x_i = W_i^T (y_i - L[i+1:, i]^T
//      x[i+1:]) (and before it the forward one, y_i = W_i (b_i - L[i, :i]
//      y[:i]), where step 2 did not take it), 8 right-hand sides a pass held
//      in shared memory, L read as float4 columns (backward) or rows
//      (forward) by all threads, a block's partial sums joined in shared
//      memory.
// __syncthreads() between the stages orders the block's own global-memory
// writes; no other block touches the member, so no grid-wide sync is needed.
// No pointer is __restrict__: the block reads back what it wrote.
// A failed pivot makes its member's L and alpha NaN from that pivot on (W_k's
// rows from it are NaN, so P's columns and every later Schur complement);
// the other members are untouched.
#include "cluster.cuh"
#include "crout.cuh"

namespace gpr {

constexpr int kFusedMaxPanel = 128;
constexpr int kFusedMaxN = 2048;
constexpr int kFusedThreads = kCroutThreads;
constexpr int kFusedWarps = kCroutWarps;
constexpr int kFusedDepth = 64;             // P columns a shared tile holds, the deepest partial sum
constexpr int kFusedSmemFloats = 232448 / 4;  // the most shared memory a block may have
constexpr int kRhs = 8;                     // right-hand sides per substitution pass
constexpr int kFwdMaxQ = 16;                // q up to this: the forward substitution rides in the panel steps

// Shared memory, in floats: the diagonal tile S with its rows E (bp x ld,
// crout.cuh with INV), the scales rd, a warp's S22 tile buffer (1024 each;
// between a diagonal step and the update they hold W_k column-major, b_k and
// y_k for the panel solve), cap tiles of P (32 x dc each); the substitution
// reuses it from 0.
struct FusedLayout {
  int bp, ld, dc, cap, rd, ring, slots, total;
};

__host__ __device__ inline FusedLayout fused_layout(int n, int p) {
  FusedLayout f;
  f.bp = kCholNb * ((p + kCholNb - 1) / kCholNb);
  f.ld = 2 * f.bp + kCholPad;
  f.dc = p < kFusedDepth ? p : kFusedDepth;
  f.rd = f.bp * f.ld;
  f.ring = f.rd + kCholNb;
  f.slots = f.ring + kFusedWarps * kCholNb * kCholNb;
  const int mt = (n - p + kCholNb - 1) / kCholNb, room = (kFusedSmemFloats - f.slots) / (kCholNb * f.dc);
  f.cap = mt < room ? mt : room;
  const int used = f.slots + f.cap * kCholNb * f.dc;
  const int subst = p * (p | 1) + kRhs * n + 4 * kFusedThreads * kRhs + kFusedMaxPanel * kRhs;
  f.total = used > subst ? used : subst;
  return f;
}

// The trailing matrix of a panel step: S22 = src[(o + r) n + o + c] for r, c <
// m, read from src, written to L.
struct Trailing {
  const float* src;
  float* L;
  size_t n;
  int o, m;
  bool vec;  // n and p multiples of 4: 16-byte chunks
};

// Lane (rg, cg)'s part of S22 tile (i, j): rows 4 rg + x, columns 8 cg + 4 h
// + (0..3), chunk (x, h) at ring[4 ((2 x + h) 32 + lane)], by cp.async.
__device__ __forceinline__ void tile_fetch(const Trailing& T, int i, int j, float* ring, int lane) {
  if (!T.vec) return;
  const int rg = lane & 7, cg = lane >> 3;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = kCholNb * i + 4 * rg + x, c = kCholNb * j + 8 * cg + 4 * h;
      if (r < T.m && c < T.m)
        cp_async16(ring + 4 * ((2 * x + h) * 32 + lane), T.src + (T.o + r) * T.n + T.o + c);
    }
  cp_async_commit();
}

// acc[x][y] += sum_{m < depth} Pi[m 32 + 4 rg + x] Pj[m ldj + 8 cg + y], lane
// (rg, cg) = (lane % 8, lane / 8): a 32x32 product of two column-major
// operands in shared memory, one float4 of Pi and two of Pj a step for 32
// FMAs.
__device__ __forceinline__ void warp_mm(const float* Pi, const float* Pj, int ldj, int depth, float acc[4][8],
                                        int lane) {
  const float* pa = Pi + 4 * (lane & 7);
  const float* pb = Pj + 8 * (lane >> 3);
#pragma unroll 4
  for (int mm = 0; mm < depth; ++mm) {
    const float4 a = *reinterpret_cast<const float4*>(pa + mm * kCholNb);
    const float4 b0 = *reinterpret_cast<const float4*>(pb + mm * ldj);
    const float4 b1 = *reinterpret_cast<const float4*>(pb + mm * ldj + 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// The warp's tiles e = e0, e0 + es, .. < ne of a list: tile_of(e, i, j, Pi,
// Pj) gives each tile and its P row tiles in shared memory (depth columns);
// S22 tile -= Pi Pj^T.  The next tile's fetch is issued as soon as this
// tile's chunks are read, before the next tile's FMAs: each lane reads only
// its own chunks, so no barrier guards the buffer.
template <class TileOf>
__device__ __forceinline__ void update_tiles(const Trailing& T, const TileOf& tile_of, int e0, int es, int ne,
                                             int depth, float* ring, int lane) {
  if (e0 >= ne) return;
  const int rg = lane & 7, cg = lane >> 3;
  int i, j;
  const float *Pi, *Pj;
  tile_of(e0, &i, &j, &Pi, &Pj);
  tile_fetch(T, i, j, ring, lane);
  for (int e = e0; e < ne; e += es) {
    float acc[4][8] = {};
    warp_mm(Pi, Pj, kCholNb, depth, acc, lane);
    float s[4][8];
    if (T.vec) {
      cp_async_wait<0>();
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(ring + 4 * ((2 * x + h) * 32 + lane));
          s[x][4 * h] = v.x, s[x][4 * h + 1] = v.y, s[x][4 * h + 2] = v.z, s[x][4 * h + 3] = v.w;
        }
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const int r = kCholNb * i + 4 * rg + x, c = kCholNb * j + 8 * cg + y;
          s[x][y] = r < T.m && c < T.m ? T.src[(T.o + r) * T.n + T.o + c] : 0.0f;
        }
    }
    const int ti = i, tj = j;
    if (e + es < ne) {
      tile_of(e + es, &i, &j, &Pi, &Pj);
      tile_fetch(T, i, j, ring, lane);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = kCholNb * ti + 4 * rg + x;
      if (r >= T.m) continue;
      float* out = T.L + (T.o + r) * T.n + T.o + kCholNb * tj + 8 * cg;
      const int c0 = kCholNb * tj + 8 * cg;
      if (T.vec && ti != tj && c0 + 8 <= T.m) {
        reinterpret_cast<float4*>(out)[0] =
            make_float4(s[x][0] - acc[x][0], s[x][1] - acc[x][1], s[x][2] - acc[x][2], s[x][3] - acc[x][3]);
        reinterpret_cast<float4*>(out)[1] =
            make_float4(s[x][4] - acc[x][4], s[x][5] - acc[x][5], s[x][6] - acc[x][6], s[x][7] - acc[x][7]);
      } else {
#pragma unroll
        for (int y = 0; y < 8; ++y)
          if (c0 + y < T.m && c0 + y <= r) out[y] = s[x][y] - acc[x][y];
      }
    }
  }
}

// P = S_pk W_k^T for rows [o, o + m) of block column k (at column k0 of src;
// in place when src is L), W_k[r][c] = E[r ld + c].  For p <= 64 a warp a
// 32-row tile: its rows of S staged into the tile's shared slot (row tile t <
// pre; later ones through the warp's scratch slot), then for the 32-column
// blocks cb from the last to the first, sum_{j < 32 (cb + 1)} S[r][j]
// W[32 cb + c][j] (at most p terms, warp_mm on Wc, W's column-major copy, ldw)
// written over the slot's columns 32 cb .. (which no block after it reads)
// and to L; with ys (y_k, p x q), the tile's rows of the right-hand sides b
// in Xm less P y_k (the column-oriented forward substitution).  A wider
// panel (the shared tiles hold 64 columns): a thread a row, its blocks cb
// from the last to the first, S read from src as it goes and W broadcast
// from E.
__device__ __forceinline__ void panel_solve(const float* src, float* Lm, size_t n, int k0, int o, int m, int p,
                                            const float* E, int ld, const float* Wc, int ldw, float* slots, int pre,
                                            float* scratch, int dc, bool vec, float* Xm, const float* ys, int q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ncb = (p + kCholNb - 1) / kCholNb;
  if (dc < p) {  // p > 64
    for (int r = threadIdx.x; r < m; r += kFusedThreads) {
      const float* Sr = src + (o + r) * n + k0;
      float* Lr = Lm + (o + r) * n + k0;
      for (int cb = ncb - 1; cb >= 0; --cb) {
        float acc[kCholNb] = {};
        const int jmax = min(kCholNb * (cb + 1), p), cw = min(kCholNb, p - kCholNb * cb);
        for (int j = 0; j < jmax; ++j) {
          const float sv = Sr[j];
#pragma unroll
          for (int c = 0; c < kCholNb; ++c) acc[c] = fmaf(sv, E[(kCholNb * cb + c) * ld + j], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < kCholNb; ++c)
          if (c < cw) Lr[kCholNb * cb + c] = acc[c];
        if (r / kCholNb < pre && kCholNb * cb < dc) {
          float* sl = slots + (r / kCholNb) * kCholNb * dc + r % kCholNb;
#pragma unroll
          for (int c = 0; c < kCholNb; ++c)
            if (c < cw && kCholNb * cb + c < dc) sl[(kCholNb * cb + c) * kCholNb] = acc[c];
        }
      }
    }
    return;
  }
  const int rg = lane & 7, cg = lane >> 3, mt = (m + kCholNb - 1) / kCholNb;
  for (int t = warp; t < mt; t += kFusedWarps) {
    float* sl = t < pre ? slots + t * kCholNb * dc : scratch;
    const int r = kCholNb * t + lane;
    const float* Sr = src + (o + r) * n + k0;
    if (vec) {
      float4 v[kFusedDepth / 4];
#pragma unroll
      for (int c = 0; c < kFusedDepth / 4; ++c)
        if (4 * c < p)
          v[c] = r < m ? *reinterpret_cast<const float4*>(&Sr[4 * c]) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int c = 0; c < kFusedDepth / 4; ++c)
        if (4 * c < p) {
          sl[(4 * c) * kCholNb + lane] = v[c].x;
          sl[(4 * c + 1) * kCholNb + lane] = v[c].y;
          sl[(4 * c + 2) * kCholNb + lane] = v[c].z;
          sl[(4 * c + 3) * kCholNb + lane] = v[c].w;
        }
    } else {
      for (int c = 0; c < p; ++c) sl[c * kCholNb + lane] = r < m ? Sr[c] : 0.0f;
    }
    __syncwarp();
    for (int cb = ncb - 1; cb >= 0; --cb) {
      float acc[4][8] = {};
      for (int jb = 0; jb <= cb; ++jb)
        warp_mm(sl + kCholNb * jb * kCholNb, Wc + kCholNb * (jb * ldw + cb), ldw, min(kCholNb, p - kCholNb * jb),
                acc, lane);
      __syncwarp();  // the block's columns are read before they are written
      const int c0 = kCholNb * cb + 8 * cg;
#pragma unroll
      for (int y = 0; y < 8; ++y)
        if (c0 + y < p)
          *reinterpret_cast<float4*>(&sl[(c0 + y) * kCholNb + 4 * rg]) =
              make_float4(acc[0][y], acc[1][y], acc[2][y], acc[3][y]);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int rr = kCholNb * t + 4 * rg + x;
        if (rr >= m) continue;
        float* out = Lm + (o + rr) * n + k0 + c0;
        if (vec && c0 + 8 <= p) {
          reinterpret_cast<float4*>(out)[0] = make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
          reinterpret_cast<float4*>(out)[1] = make_float4(acc[x][4], acc[x][5], acc[x][6], acc[x][7]);
        } else {
#pragma unroll
          for (int y = 0; y < 8; ++y)
            if (c0 + y < p) out[y] = acc[x][y];
        }
      }
    }
    if (ys) {  // the forward substitution: b[o + r] -= P[r] y_k, lane r of the tile
      __syncwarp();
      const int rr = kCholNb * t + lane;
      if (rr < m)
        for (int c = 0; c < q; ++c) {
          float a = 0.0f;
          for (int j = 0; j < p; ++j) a = fmaf(sl[j * kCholNb + lane], ys[j * q + c], a);
          Xm[(size_t)(o + rr) * q + c] -= a;
        }
    }
    __syncwarp();  // the scratch slot is read before the warp's next tile
  }
}

// Tiles t0 .. t0 + nt - 1 of P (rows 32 t), columns d0 .. d0 + w - 1, from L
// into shared tiles dst (32 x dc each, column-major); rows past m are 0.
__device__ __forceinline__ void load_group(float* dst, const float* Lm, size_t n, int o, int k0, int m, int t0,
                                           int nt, int d0, int w, int dc) {
  const int total = nt * w * kCholNb;
  for (int e = threadIdx.x; e < total; e += kFusedThreads) {
    const int r = e % kCholNb, c = (e / kCholNb) % w, tl = e / (kCholNb * w);
    const int row = kCholNb * (t0 + tl) + r;
    dst[tl * kCholNb * dc + c * kCholNb + r] = row < m ? Lm[(o + row) * n + k0 + d0 + c] : 0.0f;
  }
}

// Step 1 for the diagonal block k, read from src (lower triangle): L_kk and
// W_k to the outputs, W_k^T kept in the tile's rows E, W_k column-major in
// Wc for the panel solve; with ys, y_k = W_k b_k (b_k: rows k0 .. of Xm,
// staged in bs) to Xm and to ys.
__device__ __forceinline__ void diag_step(const float* src, float* Lm, float* Wm, int n, int p, int k,
                                          const FusedLayout& f, float* smem, float* Xm, float* bs, float* ys,
                                          int q) {
  const int k0 = k * p;
  crout_load<true>(smem, f.ld, src + (size_t)k0 * n + k0, n, p);
  __syncthreads();
  crout_factor<true>(smem, f.ld, f.bp / kCholNb, smem + f.rd);
  crout_store(smem, f.ld, Lm + (size_t)k0 * n + k0, n, p);
  crout_store_w(smem, f.ld, f.bp, Wm + (size_t)k * p * p, p, p);
  if (f.dc == p) {  // Wc[c ldw + r] = W[r][c] for the panel solve, in the tile buffers (free until the update)
    float* Wc = smem + f.ring;
    for (int e = threadIdx.x; e < f.bp * f.bp; e += kFusedThreads) {
      const int c = e / f.bp, r = e % f.bp;
      Wc[c * (f.bp + kCholPad) + r] = smem[r * f.ld + f.bp + c];
    }
  }
  if (ys) {
    float* Xk = Xm + (size_t)k0 * q;
    for (int e = threadIdx.x; e < p * q; e += kFusedThreads) bs[e] = Xk[e];
    __syncthreads();
    for (int e = threadIdx.x; e < p * q; e += kFusedThreads) {
      const int r = e / q, c = e % q;
      const float* Wr = smem + r * f.ld + f.bp;  // W[r][j]
      float a = 0.0f;
      for (int j = 0; j <= r; ++j) a = fmaf(Wr[j], bs[j * q + c], a);
      Xk[e] = a;
      ys[e] = a;
    }
  }
}

__global__ void __launch_bounds__(kFusedThreads, 1)
    fleet_fused_kernel(const float* A, float* L, const float* Y, float* X, float* W, int n, int p, int q) {
  extern __shared__ __align__(16) float smem[];
  const FusedLayout f = fused_layout(n, p);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nb = n / p, tile = kCholNb * f.dc;
  const bool vec = n % 4 == 0 && p % 4 == 0;
  const size_t member = blockIdx.x;
  const float* Am = A + member * n * n;
  float* Lm = L + member * n * n;
  const float* Ym = Y + member * n * q;
  float* Xm = X + member * n * q;
  float* Wm = W + member * nb * p * p;
  float* ring = smem + f.ring + warp * kCholNb * kCholNb;
  float* slots = smem + f.slots;
  // the forward substitution in the panel steps (p <= 64, q <= 16): b = Y in
  // X, then y_k = W_k b_k and b[o:] -= P_k y_k a step; b_k and y_k in the
  // tile buffers, past Wc
  const bool fwd = f.dc == p && q <= kFwdMaxQ;
  float* bs = fwd ? smem + f.ring + f.bp * (f.bp + kCholPad) : nullptr;
  float* ys = fwd ? bs + p * q : nullptr;
  if (fwd)
    for (int e = t; e < n * q; e += kFusedThreads) Xm[e] = Ym[e];

  diag_step(Am, Lm, Wm, n, p, 0, f, smem, Xm, bs, ys, q);
  for (int k = 0; k + 1 < nb; ++k) {
    const int k0 = k * p, o = k0 + p, m = n - o, mt = (m + kCholNb - 1) / kCholNb;
    const int G = mt <= f.cap ? mt : f.cap / 2;  // P tiles a group
    __syncthreads();  // W_k in E; the trailing matrix written
    const float* src = k == 0 ? Am : Lm;
    panel_solve(src, Lm, n, k0, o, m, p, smem + f.bp, f.ld, smem + f.ring, f.bp + kCholPad, slots, G,
                slots + (G + warp) * tile, f.dc, vec, Xm, ys, q);
    // L's strict upper right of the diagonal block, which nothing else writes: 0,
    // stored while the update runs
    for (int r = k0 + warp; r < o; r += kFusedWarps)
      for (int c = o + lane; c < n; c += 32) Lm[(size_t)r * n + c] = 0.0f;
    const int ng = (mt + G - 1) / G;
    for (int d0 = 0; d0 < p; d0 += f.dc) {
      const int w = min(f.dc, p - d0);
      const Trailing T{d0 == 0 ? src : Lm, Lm, (size_t)n, o, m, vec};  // a later depth reads what the earlier wrote
      for (int b = 0; b < ng; ++b) {
        const int nj = min(G, mt - b * G);
        if (d0 > 0 || b > 0) {
          __syncthreads();  // the shared tiles are read
          load_group(slots, Lm, n, o, k0, m, b * G, nj, d0, w, f.dc);
        }
        for (int a = b; a < ng; ++a) {
          const int ni = min(G, mt - a * G);
          if (a > b) {
            __syncthreads();
            load_group(slots + G * tile, Lm, n, o, k0, m, a * G, ni, d0, w, f.dc);
          }
          __syncthreads();  // P in L and in the shared tiles
          if (a == b) {
            auto tri = [&](int e, int* i, int* j, const float** Pi, const float** Pj) {
              crout_tile(e, i, j);
              *Pi = slots + *i * tile;
              *Pj = slots + *j * tile;
              *i += b * G;
              *j += b * G;
            };
            update_tiles(T, tri, warp, kFusedWarps, ni * (ni + 1) / 2, w, ring, lane);
          } else {
            auto rect = [&](int e, int* i, int* j, const float** Pi, const float** Pj) {
              *Pi = slots + (G + e / nj) * tile;
              *Pj = slots + (e % nj) * tile;
              *i = a * G + e / nj;
              *j = b * G + e % nj;
            };
            update_tiles(T, rect, warp, kFusedWarps, ni * nj, w, ring, lane);
          }
        }
      }
    }
    __syncthreads();  // S22 written
    diag_step(Lm, Lm, Wm, n, p, k + 1, f, smem, Xm, bs, ys, q);
  }
  __syncthreads();

  // 4. alpha, kRhs columns at a time, the pass's columns in shared memory
  const int sld = p | 1;
  float* Ws = smem;                          // W_i
  float* xs = Ws + p * sld;                  // (kRhs, n): the pass's y, then x
  float* part = xs + kRhs * n;               // (groups p <= 4 kFusedThreads, kRhs)
  float* rhs = part + 4 * kFusedThreads * kRhs;  // (p, kRhs)
  int tpr = 1;                               // forward: threads a row, a power of 2
  while (tpr * 2 * p <= kFusedThreads && tpr < 32) tpr *= 2;
  const int c4 = (p + 3) / 4, groups = kFusedThreads / c4;  // backward: 4 columns a thread
  for (int c0 = 0; c0 < q; c0 += kRhs) {
    const int qc = min(kRhs, q - c0);
    for (int e = t; e < kRhs * n; e += kFusedThreads) {  // b, or y from the panel steps
      const int c = e / n, j = e % n;
      xs[e] = c < qc ? (fwd ? Xm : Ym)[(size_t)j * q + c0 + c] : 0.0f;
    }
    // forward: rhs = Y_i - L[i, :i] y[:i], then y_i = W_i rhs
    for (int i = 0; i < (fwd ? 0 : nb); ++i) {
      const int R = i * p, r = t / tpr, g = t % tpr;
      float acc[kRhs] = {};
      __syncthreads();  // y[:i] in xs
      if (r < p) {
        const float* Lr = Lm + (size_t)(R + r) * n;
        if (vec) {
#pragma unroll 4
          for (int j = 4 * g; j < R; j += 4 * tpr) {
            const float4 l = *reinterpret_cast<const float4*>(&Lr[j]);
#pragma unroll
            for (int c = 0; c < kRhs; ++c) {
              const float4 y = *reinterpret_cast<const float4*>(&xs[c * n + j]);
              acc[c] = fmaf(l.x, y.x, fmaf(l.y, y.y, fmaf(l.z, y.z, fmaf(l.w, y.w, acc[c]))));
            }
          }
        } else {
#pragma unroll 4
          for (int j = g; j < R; j += tpr) {
            const float l = Lr[j];
#pragma unroll
            for (int c = 0; c < kRhs; ++c) acc[c] = fmaf(l, xs[c * n + j], acc[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kRhs; ++c)
        for (int off = tpr / 2; off > 0; off /= 2) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
      if (r < p && g == 0)
        for (int c = 0; c < kRhs; ++c) rhs[r * kRhs + c] = xs[c * n + R + r] - acc[c];
      for (int e = t; e < p * p; e += kFusedThreads) Ws[(e / p) * sld + e % p] = Wm[(size_t)i * p * p + e];
      __syncthreads();
      for (int e = t; e < p * qc; e += kFusedThreads) {
        const int rr = e / qc, c = e % qc;
        float a = 0.0f;
        for (int j = 0; j <= rr; ++j) a = fmaf(Ws[rr * sld + j], rhs[j * kRhs + c], a);
        xs[c * n + R + rr] = a;
      }
    }
    // backward: rhs = y_i - L[i+1:, i]^T x[i+1:], then x_i = W_i^T rhs
    for (int i = nb - 1; i >= 0; --i) {
      const int R = i * p, cq = t % c4, g = t / c4;
      float acc[4][kRhs] = {};
      __syncthreads();  // x[i+1:] in xs
      if (g < groups) {
#pragma unroll 4
        for (int s = R + p + g; s < n; s += groups) {
          const float* Ls = Lm + (size_t)s * n + R + 4 * cq;
          float l[4];
          if (vec) {
            const float4 v = *reinterpret_cast<const float4*>(Ls);
            l[0] = v.x, l[1] = v.y, l[2] = v.z, l[3] = v.w;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) l[u] = 4 * cq + u < p ? Ls[u] : 0.0f;
          }
#pragma unroll
          for (int c = 0; c < kRhs; ++c) {
            const float x = xs[c * n + s];
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[u][c] = fmaf(l[u], x, acc[u][c]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * cq + u < p)
#pragma unroll
            for (int c = 0; c < kRhs; ++c) part[(g * p + 4 * cq + u) * kRhs + c] = acc[u][c];
      }
      for (int e = t; e < p * p; e += kFusedThreads) Ws[(e / p) * sld + e % p] = Wm[(size_t)i * p * p + e];
      __syncthreads();
      for (int e = t; e < p * qc; e += kFusedThreads) {
        const int rr = e / qc, c = e % qc;
        float sum = 0.0f;
        for (int gg = 0; gg < groups; ++gg) sum += part[(gg * p + rr) * kRhs + c];
        rhs[rr * kRhs + c] = xs[c * n + R + rr] - sum;
      }
      __syncthreads();
      for (int e = t; e < p * qc; e += kFusedThreads) {
        const int rr = e / qc, c = e % qc;
        float a = 0.0f;
        for (int j = rr; j < p; ++j) a = fmaf(Ws[j * sld + rr], rhs[j * kRhs + c], a);
        xs[c * n + R + rr] = a;
      }
    }
    __syncthreads();
    for (int e = t; e < qc * n; e += kFusedThreads) {
      const int j = e / qc, c = e % qc;
      Xm[(size_t)j * q + c0 + c] = xs[c * n + j];
    }
    __syncthreads();
  }
}

}  // namespace gpr

// A, L: (B, n, n), Y, X: (B, n, q), W: (B, n / p, p, p), all float32 and
// contiguous; L, X and W share no memory with A, Y or each other.
// n % p == 0, p <= 128, n <= 2048, q >= 1.
extern "C" int gpr_fleet_fused(const float* A, float* L, const float* Y, float* X, float* W,
                               int B, int n, int p, int q, void* stream) {
  using namespace gpr;
  if (B < 1 || p < 1 || p > kFusedMaxPanel || n < p || n > kFusedMaxN || n % p || q < 1)
    return (int)cudaErrorInvalidValue;
  const FusedLayout f = fused_layout(n, p);
  // a step that pairs groups needs two tiles, and for p <= 64 a scratch tile a warp beside a group
  const int mt = (n - p + kCholNb - 1) / kCholNb;
  if (f.cap < mt && (f.cap < 2 || (f.dc == p && f.cap < 2 * kFusedWarps))) return (int)cudaErrorInvalidValue;
  const int smem = f.total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fleet_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fleet_fused_kernel<<<B, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, L, Y, X, W, n, p, q);
  return (int)cudaGetLastError();
}
