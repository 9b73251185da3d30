// K1: the tiled Gram kernel K[i, j] = k(X[i], Y[j]) + diag * [i == j].
// K6: the fleet Gram K[b] = k(X[b], X[b]) + diag[b] I, one launch for B members.
//
// K1 replaces the TPU kernel gpr_tpu/ops/pallas_gram.py::_tile_body (line
// 38), launched through _gram_kernel (133) and _gram_tril_kernel (117) by
// gram_pallas (219).  K6 replaces _gram_batched_kernel (142), launched by
// gram_pallas_batched (155).  The FP32 tile math is gram_tile.cuh's, shared
// with the fused factorization; the tensor-core pieces are tc_tile.cuh's.
//
// K6 is a write stream: at the fleet's d = 8 an entry is 16 FMA and one exp
// against 4 bytes written.  Its grid is persistent (the card's SMs times the
// blocks an SM holds, 3 at <= 85 registers) and block c takes the items that
// start in the c-th of gridDim.x equal shares of the write volume, in order:
// an item is a (member, lower 64-tile) with tj <= ti, a diagonal tile one
// unit of volume and an off-diagonal tile two, since it is written twice, in
// place and mirrored.  So the upper tiles cost no arithmetic, and any B fills
// the card.  The mirror is bit for bit the upper tile computed on its own:
// the sums are the same fmaf chains in the same k order, and fmaf's product,
// xx + yy and sinf(-x) == -sinf(x) (periodic) commute.  Features are staged
// without padding; at d <= 16 the next item's features ride in registers
// while this one computes and stores, its row block's only when the row block
// changes.  The in-place tile goes out from the registers (a thread's 4
// columns are one 16-byte store, so a warp's instruction writes two whole
// 256-byte tile rows); the mirror through shared memory as 16-byte granules,
// swizzled by the row so that neither the transposed staging nor the copy-out
// meets a bank conflict.  A row stride n % 4 != 0 takes masked scalar stores.
//
// K1 has two paths, chosen by form and shape (and 16-byte aligned X and Y):
//  * the tensor cores (gaussian, rq, matern32, matern52 and sqdist with
//    d % 4 == 0 and d >= 32): 128x128 tiles, the cross term x.y in 3xTF32 on
//    tc_tile.cuh's split, its layout of split tiles and wgmma.m64n128k8 with
//    both operands in shared memory, and its two-level sums (a fresh partial
//    per 32-deep k-slice, folded into an FP32 running tile); the norms |x|^2,
//    |y|^2 summed in FP32 from the values the splits load; the clamp, form
//    (on the SFU's exp2 / log2 / sqrt) and diagonal term on the accumulator
//    registers.  One block an SM walks the c-th equal run of the tiles in
//    order as one stream of k-slices.  A row block's split slices stay in
//    shared memory for all of its tiles when d <= 128 (4 slots of 32 KB),
//    else every tile streams them.  While a slice's products run, its block
//    splits the next slice into shared memory (between the wgmma groups),
//    loads the one after into registers and writes the tile finished at the
//    last slice; B's rows are loaded permuted (gt_col) so that a lane's
//    accumulators hold 4 adjacent columns, one 16-byte store.  The JAX
//    reference runs this cross term at its f32-grade bf16x3 tier
//    (pallas_gram.py:60-81); 3xTF32 is the port's f32-grade tier.
//  * FP32 FMA (matern12, whose sqrt(d2) cusp turns a d2 error e into
//    sqrt(e), as JAX keeps HIGHEST for it; periodic, which has no GEMM
//    identity; any other d): gram_tile on 64x64 tiles, one tile a block, bit
//    for bit the entries of the one-tile-a-block kernel it replaces, stored
//    from the registers as K6's in-place tile.
// Tril mode walks the lower tiles only and writes no entry above the
// diagonal; those entries stay undefined, as on the TPU.
#include "gram_tile.cuh"
#ifdef __CUDACC__
#include <stdint.h>

#include "tc_tile.cuh"
#endif

namespace gpr {

constexpr int kGran = kTile / 4;  // 16-byte granules per row of a 64-wide tile

// the granule (r, g) of a staged 64x64 tile
__device__ __forceinline__ int gran(int r, int g) { return r * kGran + (g ^ ((r >> 2) & 7)); }

// diag onto thread (ty, tx)'s entries of the tile at (row0, col0) where row
// == column (+ 0.0f elsewhere, as the one-tile-a-block kernel added it)
__device__ __forceinline__ void add_diag(float val[kPer][kPer], int row0, int col0, float diag) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      val[i][j] = val[i][j] + (row0 + ty * kPer + i == col0 + tx * kPer + j ? diag : 0.0f);
}

// Thread (ty, tx)'s entries straight from its registers into rows
// [row0, row0 + 64) x columns [col0, col0 + 64) of the row-major K (row
// stride ld): its 4 columns of a row are one 16-byte store, so a warp's
// instruction writes two whole 256-byte tile rows.  Rows past nr and columns
// past nc are dropped, and with tril every entry above the diagonal.  vec:
// ld % 4 == 0.
__device__ __forceinline__ void store_regs(const float val[kPer][kPer], float* K, size_t ld, int nr, int nc,
                                           int row0, int col0, bool tril, bool vec) {
  const int col = col0 + (threadIdx.x % 16) * kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = row0 + (threadIdx.x / 16) * kPer + i;
    if (row >= nr || col >= nc || (tril && col > row)) continue;
    float* dst = K + (size_t)row * ld + col;
    if (vec && !(tril && col + 3 > row)) {
      *reinterpret_cast<float4*>(dst) = make_float4(val[i][0], val[i][1], val[i][2], val[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (col + j < nc && !(tril && col + j > row)) dst[j] = val[i][j];
    }
  }
}

// The transpose of thread (ty, tx)'s entries (the tile at (col0, row0))
// staged into `out`: granule (tx * 4 + j, ty) holds column j of its block.
__device__ __forceinline__ void stage_mirror(float4* out, const float val[kPer][kPer]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    out[gran(tx * kPer + j, ty)] = make_float4(val[0][j], val[1][j], val[2][j], val[3][j]);
}

// A staged tile into rows [row0, row0 + 64) x columns [col0, col0 + 64) of
// the row-major (n, n) K: a warp's instruction writes two whole 256-byte tile
// rows.  Rows and columns past n are dropped.  vec: n % 4 == 0.
__device__ __forceinline__ void store_staged(const float4* t, float* K, int n, int row0, int col0, bool vec) {
#pragma unroll
  for (int p = 0; p < kTile * kGran / kThreads; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int r = e / kGran;
    const int g = e % kGran;
    const int row = row0 + r;
    const int col = col0 + 4 * g;
    if (row >= n || col >= n) continue;
    const float4 v = t[gran(r, g)];
    float* dst = K + (size_t)row * n + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < n) dst[q] = w[q];
    }
  }
}

// ------------------------------------------------------------------ K6 ----

struct __align__(16) FleetSmem {
  float a[kChunk][kLd];            // the row block's features, k-major
  float b[kChunk][kLd];            // the column block's
  float4 mirror[kTile * kGran];     // the tile's transpose, staged
};

// Rows [r0, r0 + 64) x features [k0, k0 + kc) of the row-major (nrows, d)
// src into dst[k][r]; rows past nrows read as zero.
__device__ __forceinline__ void stage_cols(float (*dst)[kLd], const float* src, int d, int nrows, int r0,
                                           int k0, int kc) {
  for (int e = threadIdx.x; e < kTile * kc; e += kThreads) {
    const int r = e / kc;
    const int kk = e % kc;
    const int gr = r0 + r;
    dst[kk][r] = gr < nrows ? src[(size_t)gr * d + k0 + kk] : 0.0f;
  }
}

// gram_tile's sums over the kc staged features, in its order.
template <int FORM>
__device__ __forceinline__ void tile_sums(const FleetSmem& sm, int kc, float third, float acc[kPer][kPer],
                                          float xx[kPer], float yy[kPer]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int kk = 0; kk < kc; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][ty * kPer]);
    const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * kPer]);
    const float a[kPer] = {av.x, av.y, av.z, av.w};
    const float b[kPer] = {bv.x, bv.y, bv.z, bv.w};
    if (FORM == kPeriodic) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float s = sinf(third * (a[i] - b[j]));
          acc[i][j] = fmaf(s, s, acc[i][j]);
        }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        xx[i] = fmaf(a[i], a[i], xx[i]);
        yy[i] = fmaf(b[i], b[i], yy[i]);
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ int isqrt(long long v) {
  int r = (int)sqrt((double)v);
  while ((long long)r * r > v) --r;
  while ((long long)(r + 1) * (r + 1) <= v) ++r;
  return r;
}

// an item of K6's walk: member b's lower tile (ti, tj), which starts at unit
// u = b nt^2 + ti^2 + 2 tj of the write volume
struct FleetItem {
  long long b, u;
  int ti, tj;
  __device__ __forceinline__ void next(int nt) {
    if (tj < ti) {
      ++tj;
      u += 2;
    } else {
      tj = 0;
      ++u;
      if (++ti == nt) {
        ti = 0;
        ++b;
      }
    }
  }
};

constexpr int kPf = kTile * kChunk / kThreads;  // features a thread carries for a 64-row block at d <= 16

// Features [0, d) of rows [r0, r0 + 64) of the (n, d) Xb, this thread's share
// e = threadIdx.x + i kThreads as (row e / d, feature e % d); rows past n read
// as zero.
__device__ __forceinline__ void fetch_rows(float v[kPf], const float* Xb, int n, int d, int r0) {
#pragma unroll
  for (int i = 0; i < kPf; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = r0 + e / d;
    v[i] = (e < kTile * d && r < n) ? Xb[(size_t)r * d + e % d] : 0.0f;
  }
}

__device__ __forceinline__ void put_rows(float (*dst)[kLd], const float v[kPf], int d) {
#pragma unroll
  for (int i = 0; i < kPf; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < kTile * d) dst[e % d][e / d] = v[i];
  }
}

// Block c takes the items that start in its share of the write volume.  At
// d <= 16 the next item's features ride in registers (the row block's only
// when it changes) while this one computes and stores.
template <int FORM>
__global__ void __launch_bounds__(kThreads, 3)
    gram_batched_kernel(const float* __restrict__ X, const float* __restrict__ P, float* __restrict__ K,
                        int B, int n, int d) {
  __shared__ FleetSmem sm;
  const int nt = (n + kTile - 1) / kTile;
  const long long per = (long long)nt * nt;
  const long long units = per * B;
  const long long hi = units * (blockIdx.x + 1) / gridDim.x;
  FleetItem it;
  {
    const long long lo = units * blockIdx.x / gridDim.x;
    it.b = lo / per;
    const long long rem = lo - it.b * per;
    it.ti = isqrt(rem);
    it.tj = (int)((rem - (long long)it.ti * it.ti + 1) / 2);
    it.u = it.b * per + (long long)it.ti * it.ti + 2 * it.tj;
  }
  const bool vec = n % 4 == 0;
  const bool whole = d <= kChunk;
  float pa[kPf], pb[kPf];
  bool a_new = true;
  if (whole && it.u < hi) {
    fetch_rows(pa, X + (size_t)it.b * n * d, n, d, it.ti * kTile);
    fetch_rows(pb, X + (size_t)it.b * n * d, n, d, it.tj * kTile);
  }
  while (it.u < hi) {
    const FleetItem cur = it;
    const float* Xb = X + (size_t)cur.b * n * d;
    const GramParams par{P[4 * cur.b], P[4 * cur.b + 1], P[4 * cur.b + 2]};
    const int row0 = cur.ti * kTile;
    const int col0 = cur.tj * kTile;
    float acc[kPer][kPer], xx[kPer], yy[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      xx[i] = 0.0f;
      yy[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
    }
    it.next(nt);
    if (whole) {
      if (a_new) put_rows(sm.a, pa, d);
      put_rows(sm.b, pb, d);
      __syncthreads();
      if (it.u < hi) {
        a_new = it.b != cur.b || it.ti != cur.ti;
        const float* Xn = X + (size_t)it.b * n * d;
        if (a_new) fetch_rows(pa, Xn, n, d, it.ti * kTile);
        fetch_rows(pb, Xn, n, d, it.tj * kTile);
      }
      tile_sums<FORM>(sm, d, par.third, acc, xx, yy);
    } else {
      for (int k0 = 0; k0 < d; k0 += kChunk) {
        const int kc = d - k0 < kChunk ? d - k0 : kChunk;
        stage_cols(sm.a, Xb, d, n, row0, k0, kc);
        stage_cols(sm.b, Xb, d, n, col0, k0, kc);
        __syncthreads();
        tile_sums<FORM>(sm, kc, par.third, acc, xx, yy);
        __syncthreads();
      }
    }
    float val[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float d2 =
            (FORM == kPeriodic) ? acc[i][j] : fmaxf(xx[i] + yy[j] - 2.0f * acc[i][j], 0.0f);
        val[i][j] = gram_value<FORM>(d2, par);
      }
    const bool off = cur.ti != cur.tj;
    float* Kb = K + (size_t)cur.b * n * n;
    add_diag(val, row0, col0, P[4 * cur.b + 3]);
    if (off) stage_mirror(sm.mirror, val);
    store_regs(val, Kb, n, n, n, row0, col0, false, vec);
    __syncthreads();
    if (off) store_staged(sm.mirror, Kb, n, col0, row0, vec);
  }
}

// --------------------------------------------------------- K1, FP32 ----

// the tile walk: row-major over all tiles, or over the lower ones (tj <= ti)
struct TileWalk {
  int ti, tj, cols;  // cols: tiles a row (full mode), 0 in tril mode
  __device__ __forceinline__ TileWalk(long long t, int mt, bool tril) : cols(tril ? 0 : mt) {
    if (tril) {
      ti = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
      while ((long long)ti * (ti + 1) / 2 > t) --ti;
      while ((long long)(ti + 1) * (ti + 2) / 2 <= t) ++ti;
      tj = (int)(t - (long long)ti * (ti + 1) / 2);
    } else {
      ti = (int)(t / mt);
      tj = (int)(t % mt);
    }
  }
  __device__ __forceinline__ void next() {
    if (++tj > (cols ? cols - 1 : ti)) {
      tj = 0;
      ++ti;
    }
  }
};

// One 64x64 tile a block (a persistent walk measured slower here: the tile
// is FP32-FMA bound, and resident blocks already overlap one tile's stores
// with another's sums).
template <int FORM>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ X, const float* __restrict__ Y, float* __restrict__ K, int n, int m,
                int d, GramParams par, float diag, int tril) {
  __shared__ TileSmem sm;
  const TileWalk w(blockIdx.x, (m + kTile - 1) / kTile, tril);
  const int row0 = w.ti * kTile;
  const int col0 = w.tj * kTile;
  float val[kPer][kPer];
  gram_tile<FORM>(X, n, row0, Y, m, col0, d, par, sm, val);
  add_diag(val, row0, col0, diag);
  store_regs(val, K, m, n, m, row0, col0, tril, m % 4 == 0);
}

constexpr int kDevices = 64;  // the cards whose launch facts a process keeps

// the current card, as an index into the per-card facts
static cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev >= 0 && *dev < kDevices ? cudaSuccess : cudaErrorInvalidValue;
}

// the persistent grid on card dev: one block for each item, at most per_sm
// blocks on each of its multiprocessors (asked once a card)
static cudaError_t persistent_grid(int dev, int per_sm, long long items, int* grid) {
  static int sms[kDevices] = {};
  if (sms[dev] <= 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long slots = (long long)sms[dev] * per_sm;
  *grid = (int)(items < slots ? items : slots);
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------ K1, tensor cores ----
#ifdef __CUDACC__

constexpr int kGtSlots = 4;  // A's split slices held: a row block of d <= 128 stays for all its tiles
constexpr size_t kGtSmem = ((kGtSlots + 2) * (size_t)kTcBufFloats + 4 * kTcRows) * sizeof(float);  // 198656 B
static_assert((kGtSlots & (kGtSlots - 1)) == 0, "A's slot is a ring position modulo a power of 2");

// d (64 x 128, this warpgroup's rows) += a (64 x 8) b (8 x 128), both split
// tf32 tiles in shared memory (tc_desc); scale_d = 0 overwrites d instead.
__device__ __forceinline__ void wgmma_tf32_ss(float d[64], uint64_t adesc, uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// The tile column at position p of the accumulator: 16 C + 8 b + 2 t + e
// (t = lane % 4, n8 block 2 C + b) holds column 16 C + 4 t + 2 b + e, so that a
// lane's entries of blocks 2 C and 2 C + 1 are 4 adjacent columns of a row.
__device__ __forceinline__ int gt_col(int p) { return (p & ~15) | ((p & 6) << 1) | ((p & 8) >> 2) | (p & 1); }

// This thread's pieces of k-slice [k0, k0 + 32) of 128 rows of the row-major
// (rows, d) X, raw: piece p is position u / 4 at k = k0 + 8 (u % 4) .. + 7, u
// = threadIdx.x + p kTcThreads (tc_put_split's pieces), and position i is row
// r0 + i, or r0 + gt_col(i) with cols.  Rows past `rows` and features past d
// read as zero (d % 4 == 0: a 16-byte piece is all in or all out).
__device__ __forceinline__ void gt_load(float4 raw[kTcBRows][2], const float* X, int rows, int d, int r0, int k0,
                                        bool cols) {
#pragma unroll
  for (int p = 0; p < kTcBRows; ++p) {
    const int u = threadIdx.x + p * kTcThreads;
    const int r = r0 + (cols ? gt_col(u / 4) : u / 4);
    const int k = k0 + 8 * (u % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      raw[p][h] = r < rows && k + 4 * h < d ? __ldg(reinterpret_cast<const float4*>(X + (size_t)r * d + k + 4 * h))
                                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Piece p split into buf's big and small tiles, the squares of its 8
// features added to nrm[p].
__device__ __forceinline__ void gt_put(const float4 raw[kTcBRows][2], float* buf, float nrm[kTcBRows], int p) {
  const float v[8] = {raw[p][0].x, raw[p][0].y, raw[p][0].z, raw[p][0].w,
                      raw[p][1].x, raw[p][1].y, raw[p][1].z, raw[p][1].w};
#pragma unroll
  for (int q = 0; q < 8; ++q) nrm[p] = fmaf(v[q], v[q], nrm[p]);
  tc_put_split(buf, threadIdx.x + p * kTcThreads, v);
}

// The form on d2 with its constants folded once a launch (f.c, f.e below), on
// the SFU's exp2 / log2 / sqrt (flushing results below 2^-126 to 0): within a
// few ulp of gram_value's expf / powf / sqrtf.
struct TcForm {
  float s2;  // scale^2
  float c;   // gaussian: -log2(e) / (2 sigma^2); rq: 1 / (2 sigma^2 alpha); matern: sqrt(3 or 5) / sigma
  float e;   // rq: -alpha
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int FORM>
__device__ __forceinline__ float tc_value(float d2, const TcForm& f) {
  if (FORM == kGaussian) {
    return f.s2 * ex2(d2 * f.c);
  } else if (FORM == kRQ) {
    return f.s2 * ex2(f.e * lg2(fmaf(d2, f.c, 1.0f)));
  } else if (FORM == kMatern32 || FORM == kMatern52) {
    const float a = sqrt_approx(d2) * f.c;
    const float ex = f.s2 * ex2(a * -1.4426950408889634f);
    return (FORM == kMatern32 ? 1.0f + a : fmaf(a, a * (1.0f / 3.0f), 1.0f + a)) * ex;
  } else {  // kSqdist
    return d2;
  }
}

// the sum over the 4 lanes that share a row (lane % 4)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The finished tile at (r0, c0) (run, in wgmma's accumulator layout: warp w
// holds rows 16 w + g and 16 w + g + 8, g = lane / 4, and for each n8 block
// c the entries run[4 c + 2 h + e] at position 8 c + 2 t + e of row 16 w + g +
// 8 h, t = lane % 4, which is column gt_col of it; nrm the tile's 128 row
// norms, then its 128 column norms by position) through the clamp, the form
// and the diagonal term into K, straight from the registers: a lane's 4
// adjacent columns are one 16-byte store, so each quad of lanes fills two
// 32-byte sectors.  An interior tile stores unmasked; an edge tile drops rows
// past n and columns past m, and in tril mode every entry above the diagonal.
template <int FORM, bool DIAG>
__device__ __forceinline__ void gt_epilogue_(const float run[64], const float* nrm, float* K, int n, int m, int r0,
                                             int c0, const TcForm& f, float diag, bool tril) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bool whole = m % 4 == 0 && r0 + kTcRows <= n && c0 + kTcRows <= m && !(tril && DIAG);
  const float xa[2] = {nrm[warp * 16 + g], nrm[warp * 16 + g + 8]};
  const float* yy = nrm + kTcRows;
#pragma unroll
  for (int C = 0; C < kTcRows / 16; ++C) {
    const int col = c0 + 16 * C + 4 * t;
    const float2 y0 = *reinterpret_cast<const float2*>(yy + 16 * C + 2 * t);
    const float2 y1 = *reinterpret_cast<const float2*>(yy + 16 * C + 8 + 2 * t);
    const float yb[4] = {y0.x, y0.y, y1.x, y1.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + warp * 16 + g + 8 * h;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d2 = fmaxf(xa[h] + yb[q] - 2.0f * run[4 * (2 * C + q / 2) + 2 * h + q % 2], 0.0f);
        v[q] = tc_value<FORM>(d2, f);
        if (DIAG) v[q] += row == col + q ? diag : 0.0f;
      }
      float* dst = K + (size_t)row * m + col;
      if (whole) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else if (row < n) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < m && !(tril && col + q > row)) dst[q] = v[q];
      }
    }
  }
}

// the diagonal tiles (r0 == c0) are the only ones with diagonal entries
template <int FORM>
__device__ __forceinline__ void gt_epilogue(const float run[64], const float* nrm, float* K, int n, int m, int r0,
                                            int c0, const TcForm& f, float diag, bool tril) {
  if (r0 == c0)
    gt_epilogue_<FORM, true>(run, nrm, K, n, m, r0, c0, f, diag, tril);
  else
    gt_epilogue_<FORM, false>(run, nrm, K, n, m, r0, c0, f, diag, tril);
}

// Which tiles take a fresh A: a row block is loaded once for all its tiles
// when its nk slices fit A's slots, else every tile streams its slices.  A's
// slices go into the slots as a ring, one position a slice loaded, so the
// loads (two slices ahead) and the products agree on every slot.
struct ARing {
  int row = -1, pos = 0, base = 0;  // the row block held, the next position, the tile's first
  __device__ __forceinline__ bool tile(int ti, int nk, bool resident) {
    const bool fresh = !resident || ti != row;
    row = ti;
    if (fresh) {
      base = pos;
      pos += nk;
    }
    return fresh;
  }
};

template <int FORM>
__global__ void __launch_bounds__(kTcThreads, 1)
    gram_tc_kernel(const float* __restrict__ X, const float* __restrict__ Y, float* __restrict__ K, int n, int m,
                   int d, TcForm f, float diag, int tril) {
  extern __shared__ __align__(128) float smem[];
  float* bbuf = smem + kGtSlots * kTcBufFloats;  // B's split slices, double-buffered
  float* nrm = bbuf + 2 * kTcBufFloats;          // by tile parity: 128 row norms, then 128 column norms
  const int nt = (n + kTcRows - 1) / kTcRows;
  const int mt = (m + kTcRows - 1) / kTcRows;
  const int nk = (d + kTcK - 1) / kTcK;
  const bool resident = nk <= kGtSlots;
  const long long tiles = tril ? (long long)nt * (nt + 1) / 2 : (long long)nt * mt;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long S = (tiles * (blockIdx.x + 1) / gridDim.x - t0) * nk;  // this block's k-slices
  if (S == 0) return;

  // the loads: slice s's raw pieces in registers from slice s - 2, split into
  // shared memory during slice s - 1 (its A only where its tile takes a fresh A)
  TileWalk lw(t0, mt, tril);
  ARing la;
  int lk = 0;
  float4 ra[kTcBRows][2], rb[kTcBRows][2];
  bool pa = false;  // the pending slice has an A
  int pslot = 0;    // ... into this slot
  auto load = [&]() {
    if (lk == 0) pa = la.tile(lw.ti, nk, resident);
    if (pa) {
      pslot = (la.base + lk) & (kGtSlots - 1);
      gt_load(ra, X, n, d, lw.ti * kTcRows, lk * kTcK, false);
    }
    gt_load(rb, Y, m, d, lw.tj * kTcRows, lk * kTcK, true);
    if (++lk == nk) {
      lk = 0;
      lw.next();
    }
  };
  float na[kTcBRows] = {0.0f, 0.0f}, nb[kTcBRows] = {0.0f, 0.0f};  // partial row norms of A's and B's pieces
  float xrow[kTcBRows] = {0.0f, 0.0f};                             // A's pieces' row norms, whole
  auto put = [&](long long s, int p) {  // piece p of the pending slice s: its B and, where it has one, its A
    gt_put(rb, bbuf + (int)(s & 1) * kTcBufFloats, nb, p);
    if (pa) gt_put(ra, smem + pslot * kTcBufFloats, na, p);
  };
  load();
  for (int p = 0; p < kTcBRows; ++p) put(0, p);
  if (S > 1) load();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // split tiles -> wgmma
  __syncthreads();

  float run[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    run[i] = 0.0f;
    part[i] = 0.0f;
  }
  TileWalk cw(t0, mt, tril), ew = cw;  // the tile being summed; the finished one
  ARing ca;
  bool fresh = false;   // the tile being summed took a fresh A
  bool ready = false;   // run holds the finished tile ew, to go out under the next slice's products
  int par = 0;          // the tile being summed's parity (its norms' half of nrm)
  int kk = 0;
  for (long long s = 0; s < S; ++s, kk = kk + 1 == nk ? 0 : kk + 1) {
    if (kk == 0) fresh = ca.tile(cw.ti, nk, resident);
    const bool last = kk == nk - 1;
    if (last) {  // the tile's norms, complete: its slices are all split
      const float b0 = quad_sum(nb[0]), b1 = quad_sum(nb[1]);
      if (fresh) {
        xrow[0] = quad_sum(na[0]);
        xrow[1] = quad_sum(na[1]);
        na[0] = na[1] = 0.0f;
      }
      nb[0] = nb[1] = 0.0f;
      if (threadIdx.x % 4 == 0) {
        float* h = nrm + par * 2 * kTcRows;
        h[threadIdx.x / 4] = xrow[0];
        h[64 + threadIdx.x / 4] = xrow[1];
        h[kTcRows + threadIdx.x / 4] = b0;
        h[kTcRows + 64 + threadIdx.x / 4] = b1;
      }
    }
    const float* a_big = smem + ((ca.base + kk) & (kGtSlots - 1)) * kTcBufFloats +
                         (threadIdx.x / 128) * 8 * (kTcSbo / 4);  // this warpgroup's 64 rows
    const float* a_small = a_big + kTcTileFloats;
    const float* b_big = bbuf + (int)(s & 1) * kTcBufFloats;
    const float* b_small = b_big + kTcTileFloats;
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kTcK / 8; ++st) {  // the small terms first, into a fresh partial
      const int o = st * 2 * (kTcLbo / 4);
      wgmma_tf32_ss(part, tc_desc(a_small + o), tc_desc(b_big + o), st > 0);
      wgmma_tf32_ss(part, tc_desc(a_big + o), tc_desc(b_small + o), 1);
      wgmma_tf32_ss(part, tc_desc(a_big + o), tc_desc(b_big + o), 1);
      if (st < kTcBRows && s + 1 < S) put(s + 1, st);  // the next slice split between the groups
    }
    wgmma_commit();
    // while the products run: the slice after the next loaded, the last tile out
    if (s + 2 < S) load();
    if (ready) {
      gt_epilogue<FORM>(run, nrm + (par ^ 1) * 2 * kTcRows, K, n, m, ew.ti * kTcRows, ew.tj * kTcRows, f, diag,
                        tril);
      ew.next();
      ready = false;
    }
    wgmma_wait_all();
    fence_operands(part);
    if (kk == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = part[i];
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] += part[i];
    }
    if (last) {
      ready = true;
      par ^= 1;
      cw.next();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // slice s + 1 split, the norms written, slice s's tiles free, for all
  }
  gt_epilogue<FORM>(run, nrm + (par ^ 1) * 2 * kTcRows, K, n, m, ew.ti * kTcRows, ew.tj * kTcRows, f, diag, tril);
}

#endif  // __CUDACC__

template <int FORM>
static int launch_gram(bool tc, cudaStream_t s, const float* X, const float* Y, float* K, int n, int m, int d,
                       GramParams par, float diag, int tril) {
#ifdef __CUDACC__
  if constexpr (FORM != kMatern12 && FORM != kPeriodic) {
    if (tc) {
      int dev = 0, grid = 0;
      cudaError_t err = current_device(&dev);
      if (err != cudaSuccess) return (int)err;
      static bool attr[kDevices] = {};  // the dynamic shared memory allowed, on this card
      if (!attr[dev]) {
        err = cudaFuncSetAttribute(gram_tc_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGtSmem);
        if (err != cudaSuccess) return (int)err;
        attr[dev] = true;
      }
      const long long nt = (n + kTcRows - 1) / kTcRows, mt = (m + kTcRows - 1) / kTcRows;
      err = persistent_grid(dev, 1, tril ? nt * (nt + 1) / 2 : nt * mt, &grid);
      if (err != cudaSuccess) return (int)err;
      const double sig2 = (double)par.sigma * par.sigma;
      TcForm f{par.scale * par.scale, 0.0f, -par.third};
      if (FORM == kGaussian) f.c = (float)(-1.4426950408889634 / (2.0 * sig2));
      if (FORM == kRQ) f.c = (float)(1.0 / (2.0 * sig2 * par.third));
      if (FORM == kMatern32) f.c = (float)(1.7320508075688772 / par.sigma);
      if (FORM == kMatern52) f.c = (float)(2.2360679774997898 / par.sigma);
      gram_tc_kernel<FORM><<<grid, kTcThreads, kGtSmem, s>>>(X, Y, K, n, m, d, f, diag, tril);
      return (int)cudaGetLastError();
    }
  }
#endif
  (void)tc;
  const long long nt = (n + kTile - 1) / kTile, mt = (m + kTile - 1) / kTile;
  const int grid = (int)(tril ? nt * (nt + 1) / 2 : nt * mt);
  gram_kernel<FORM><<<grid, kThreads, 0, s>>>(X, Y, K, n, m, d, par, diag, tril);
  return (int)cudaGetLastError();
}

template <int FORM>
static int launch_gram_batched(cudaStream_t s, const float* X, const float* P, float* K, int B, int n, int d) {
  int dev = 0, grid = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  static int per_sm[kDevices] = {};  // the blocks a multiprocessor of this card holds
  if (per_sm[dev] <= 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], gram_batched_kernel<FORM>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nt = (n + kTile - 1) / kTile;
  err = persistent_grid(dev, per_sm[dev], B * nt * (nt + 1) / 2, &grid);
  if (err != cudaSuccess) return (int)err;
  gram_batched_kernel<FORM><<<grid, kThreads, 0, s>>>(X, P, K, B, n, d);
  return (int)cudaGetLastError();
}

}  // namespace gpr

extern "C" int gpr_gram(const float* X, const float* Y, float* K, int n, int m, int d, int form,
                        float sigma, float scale, float third, float diag, int tril,
                        void* stream) {
  using namespace gpr;
  if (n < 1 || m < 1 || d < 1) return (int)cudaErrorInvalidValue;
#ifdef __CUDACC__
  const bool tc = form != kMatern12 && form != kPeriodic && d >= 32 && d % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(X) % 16 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
#else
  const bool tc = false;  // the host build has no tensor cores
#endif
  const GramParams par{sigma, scale, third};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kGaussian: return launch_gram<kGaussian>(tc, s, X, Y, K, n, m, d, par, diag, tril);
    case kRQ: return launch_gram<kRQ>(tc, s, X, Y, K, n, m, d, par, diag, tril);
    case kMatern12: return launch_gram<kMatern12>(tc, s, X, Y, K, n, m, d, par, diag, tril);
    case kMatern32: return launch_gram<kMatern32>(tc, s, X, Y, K, n, m, d, par, diag, tril);
    case kMatern52: return launch_gram<kMatern52>(tc, s, X, Y, K, n, m, d, par, diag, tril);
    case kPeriodic: return launch_gram<kPeriodic>(tc, s, X, Y, K, n, m, d, par, diag, tril);
    case kSqdist: return launch_gram<kSqdist>(tc, s, X, Y, K, n, m, d, par, diag, tril);
    default: return (int)cudaErrorInvalidValue;
  }
}

// X (B, n, d), P (B, 4) = (sigma, scale, third, diag) per member, K (B, n, n);
// all contiguous float32.  B goes in chunks of at most 65535 members, each
// one persistent launch with X, P and K offset to its first member.
extern "C" int gpr_gram_batched(const float* X, const float* P, float* K, int B, int n, int d,
                                int form, void* stream) {
  using namespace gpr;
  constexpr int kMaxMembers = 65535;
  if (B < 1 || n < 1 || d < 1 || form < kGaussian || form > kSqdist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < B; b0 += kMaxMembers) {
    const int Bc = B - b0 < kMaxMembers ? B - b0 : kMaxMembers;
    const float* Xc = X + (size_t)b0 * n * d;
    const float* Pc = P + (size_t)b0 * 4;
    float* Kc = K + (size_t)b0 * n * n;
    int err;
    switch (form) {
      case kGaussian: err = launch_gram_batched<kGaussian>(s, Xc, Pc, Kc, Bc, n, d); break;
      case kRQ: err = launch_gram_batched<kRQ>(s, Xc, Pc, Kc, Bc, n, d); break;
      case kMatern12: err = launch_gram_batched<kMatern12>(s, Xc, Pc, Kc, Bc, n, d); break;
      case kMatern32: err = launch_gram_batched<kMatern32>(s, Xc, Pc, Kc, Bc, n, d); break;
      case kMatern52: err = launch_gram_batched<kMatern52>(s, Xc, Pc, Kc, Bc, n, d); break;
      case kPeriodic: err = launch_gram_batched<kPeriodic>(s, Xc, Pc, Kc, Bc, n, d); break;
      default: err = launch_gram_batched<kSqdist>(s, Xc, Pc, Kc, Bc, n, d); break;
    }
    if (err != cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* gpr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
