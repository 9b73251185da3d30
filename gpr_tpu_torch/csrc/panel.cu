// K15 panel_factor: one (n, 256) Cholesky column panel [D; A21] -> [L_dd; L21],
// L_dd = chol(D) with D read from its upper triangle (as rows), L21 = A21
// L_dd^-T, out of place (gpr_tpu_torch/ops/panel.py).  K17 panel_inplace: the
// same on the 256-wide column panel at tile column c0t of an (n, n) row-major
// buffer S, in place, D read from its lower triangle (its strict upper may
// hold NaN or junk and comes back exactly 0; gpr_tpu_torch/ops/inplace_chol.py).
//
// K15 replaces the TPU kernel gpr_tpu/ops/pallas_panel.py::_panel_kernel
// (line 143), launched by panel_factor (163) for each panel of
// cholesky_panels and cholesky_left_panels (190, 220); K17 replaces
// gpr_tpu/ops/inplace_chol.py::_panel_kernel_inplace (135), launched by
// _panel_call (162) from panel_inplace (184).  They compute what those
// kernels compute, not their blocking (the TPU factors D in VMEM on grid
// step 0 and turns each row tile into R_t U^-1 on the later steps of its
// sequential grid).  Each launch is two kernels in stream order, one counted
// launch, the rows needing W, which exists only when D is done:
//
//   panel_diag_cluster  D on one 8-CTA thread-block cluster, as K19 factors a
//   (K15) and           256 tile (chol.cuh: tile_chol_factor; a block column
//   panel_inplace_diag  of 32 a CTA, a warp a diagonal block; K15 reads D's
//   (K17)               upper triangle as rows of the strided panel, K17 its
//                       lower triangle, a warp 32 columns of a row), then
//                       W = L_dd^-1 while L_dd is still in shared memory: each
//                       CTA b inverts its diagonal block V_b = L_bb^-1 on one
//                       warp (forward substitution, a lane a column) and
//                       publishes it; CTA b forms W's block column b from the
//                       factor's published panels, W_bb = V_b, W_ib = -V_i
//                       sum_{b <= m < i} L_im W_mb, right-looking (a warp a
//                       block row's sum, in registers), and writes it as rows
//                       of W^T to the (256, 256) scratch, with W's zeros; only the V_i come
//                       from the other CTAs, after a cluster barrier (V_7's
//                       its own, awaited at the last step).
//                       L_dd goes to the output's top tile (K17: D itself),
//                       exact zeros above its diagonal.  K17 is in place
//                       because each CTA reads and writes only its own block
//                       columns of D (with the upper read, a CTA would read
//                       other CTAs' columns, which is why K15 is out of
//                       place);
//   panel_factor_rows   L21 = A21 W^T for every 32 rows, one block each (248
//   (K15) and           blocks for the 7936 rows below the first panel of
//   panel_inplace_rows  n = 8192, two to an SM): the block's rows read once
//   (K17)               into shared memory before its first store (so K17
//                       rewrites them in place), W^T streamed from L2 in
//                       32-deep chunks through three-stage cp.async rings; the
//                       four 64-column output tiles (tile j needs depth [0, 64
//                       (j + 1)), W being lower triangular) shared by two
//                       pairs of warps, tiles 3 and 0, 2 and 1, 320 deep each;
//                       4x8 register tiles; sums in two levels (128-term
//                       partials), FP32 FMA.
//
// K15 reads its input, never writes it; K17 rewrites only its panel of S.  A
// non-positive (or NaN) pivot gives NaN through sqrtf with no clamp
// (chol.cuh); it reaches W's later rows and so every row of L21, and through
// the schedules' products every later panel, so the factor's L[-1, -1] is
// NaN.  Sums have a fixed order and there are no atomics: a call is
// deterministic.
//
// What bounds them on the H100, per panel of n rows: 256^3 / 3 FLOP for D and
// (n - 256) 256^2 for the rows' triangular solve (the products with W do 1.25x
// that), against 2 n 256 4 bytes read and written: at n = 8192, 0.53 GFLOP
// (7.9 us at 67 TFLOP/s FP32) against 16.8 MB (5.0 us at 3.35 TB/s).  The
// diagonal kernel is a chain of 8 dependent 32-wide diagonal steps on 8 SMs
// (K19's pace at n = 256, ~0.075 ms) while the rest of the card idles; the
// rows kernel is one wave of FP32 FMA over the card.  K17's 64 panels of an
// n = 16384 factorization take 64 such chains.
#include <cuda_runtime.h>

#include "chol.cuh"

namespace gpr {

constexpr int kPanel = 256;                     // the panel width b (pallas_panel.py: tile)
constexpr int kPanelTile = 64;                  // the rows kernel's output column tile
constexpr int kPanelRows = kPanel / kPanelTile;  // its column tiles
constexpr int kPanelBlocks = kPanel / kCholNb;  // 8 block columns, a CTA each
constexpr int kPanelRowTile = 32;               // rows of a rows-kernel block
// The workspace (floats): the factor's kPanelBlocks - 1 panel slots, then
// the diagonal blocks' inverses V_b (row-major, stride 32).
constexpr int kPanelVOffset = (kPanelBlocks - 1) * kCholSlot;
// Shared memory while W is formed (floats), after the CTA's block column
// has gone to the output: two staging buffers for the factor's published
// panels (32 columns of at most 224 rows, column stride rows + 4), W's block
// column (8 tiles, row-major), T and the V_m (row-major, stride 36).
constexpr int kPanelBufLd = (kPanelBlocks - 1) * kCholNb + 4;
constexpr int kPanelVLd = kCholNb + 4;  // a staged V_m's row stride
constexpr int kPanelBuf = kCholNb * kPanelBufLd;
constexpr int kPanelW = 2 * kPanelBuf;
constexpr int kPanelT = kPanelW + kPanelBlocks * kCholNb * kCholNb;
constexpr int kPanelV = kPanelT + kCholNb * kCholNb;
static_assert(kPanelV + kPanelBlocks * kCholNb * kPanelVLd <= kCholOwn + kCholSlot, "W's staging fits");

// V = L_bb^-1 of the diagonal block at D (column stride ld) on one warp: lane
// c solves column c by forward substitution, right-looking (each new v_r
// updates the sums of the rows below it at once, so the chain a row is a
// multiply and an FMA), scaled by 1 / L_rr computed ahead; entries above the
// diagonal are exact zeros.  V goes to Vg and Wb (row-major, stride 32; each
// store a row, coalesced).
__device__ __forceinline__ void diag_block_inverse(const float* D, int ld, float* Vg, float* Wb, int lane) {
  float s[kCholNb], inv[kCholNb];
#pragma unroll
  for (int r = 0; r < kCholNb; ++r) {
    s[r] = r == lane ? 1.0f : 0.0f;
    inv[r] = 1.0f / D[r * ld + r];
  }
#pragma unroll
  for (int r = 0; r < kCholNb; ++r) {
    s[r] = r < lane ? 0.0f : s[r] * inv[r];  // v_r
#pragma unroll
    for (int u = r + 1; u < kCholNb; ++u) s[u] = fmaf(-D[r * ld + u], s[r], s[u]);
  }
#pragma unroll
  for (int r = 0; r < kCholNb; ++r) {
    Vg[r * kCholNb + lane] = s[r];
    Wb[r * kCholNb + lane] = s[r];
  }
}

// acc += Pi Pj for one 32x32 tile on one warp, Pi column-major (stride ldi),
// Pj row-major (stride 32): lane (rg, cg) holds rows 4 rg .. + 3 and columns
// 8 cg .. + 7; the 32-term product is summed apart, then added.
__device__ __forceinline__ void tile_acc(float acc[4][8], const float* Pi, int ldi, const float* Pj, int lane) {
  const int rg = lane & 7, cg = lane >> 3;
  float part[4][8] = {};
#pragma unroll 8
  for (int t = 0; t < kCholNb; ++t) {
    const float4 a = *reinterpret_cast<const float4*>(&Pi[t * ldi + 4 * rg]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Pj[t * kCholNb + 8 * cg]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Pj[t * kCholNb + 8 * cg + 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) part[x][y] = fmaf(av[x], bv[y], part[x][y]);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[x][y] += part[x][y];
}

// The factor's published panel m (its rows below block m: 32 (7 - m) rows by
// 32 columns, chol.cuh's slot layout) into a staging buffer with column
// stride 32 (7 - m) + 4: 16-byte copies, one commit group.
__device__ __forceinline__ void panel_stage(float* buf, const float* WS, int m) {
  const int rows = kCholNb * (kPanelBlocks - 1 - m), ld = rows + 4, per = rows / 4;
  const float* src = WS + (size_t)m * kCholSlot;
  for (int e = threadIdx.x; e < kCholNb * per; e += kCholThreads) {
    const int c = e / per, q = e % per;
    cp_async16(buf + c * ld + 4 * q, src + c * kCholLdp + 4 * q);
  }
  cp_async_commit();
}

// Run by every thread of the diagonal kernels: grid (8) as one cluster of 8;
// block (256); dynamic shared memory kCholSmemBytes.  P: D, row stride ldp,
// read from its upper triangle (LOWER: its lower one); out: L_dd, row stride
// ldo (may be P with LOWER); W: (256, 256) scratch for W^T; WS: the workspace
// (gpr_panel_factor).
//
// W's block column b, right-looking over the block rows m = b .. 7: W_mb =
// -V_m T_m (W_bb = V_b), then T_i += L_im W_mb for every i > m at once, warp
// i - b - 1 holding T_i in registers.  Only the V_m (m > b) come from other
// CTAs.  Each CTA inverts its diagonal block, stores its block column of L_dd
// and takes the step m = b before the cluster barrier that publishes V_0 ..
// V_6 (phase A); V_7, whose block the factor ends with, has a phase of its
// own (B), awaited only before the last step, so that CTA 7's last factor
// and inverse overlap the others' steps.
template <bool LOWER>
__device__ __forceinline__ void panel_diag_body(const float* P, size_t ldp, float* out, size_t ldo, float* W,
                                                float* WS, float* smem) {
  int own[2], no;
  tile_chol_factor<1, LOWER>(P, ldp, WS, kPanel, smem, own, &no);
  const int b = own[0], lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kLast = kPanelBlocks - 1;
  float* Lb = smem + col_offset(b, kPanelBlocks);  // block column b, its diagonal block on top
  float* Wc = smem + kPanelW;                      // W_mb, m = b .. 7, at Wc + 1024 m
  float* Tt = smem + kPanelT;
  float* Vs = smem + kPanelV;                      // V_m at Vs + 32 * 36 m
  float* Vg = WS + kPanelVOffset;
  if (b == kLast) {  // the factor's last phase, then phase A at once: V_7 is B's
    cluster_wait();
    cluster_arrive();
  }
  if (warp == 0) {
    diag_block_inverse(Lb, col_ld(b, kPanelBlocks), Vg + b * kCholNb * kCholNb, Wc + b * kCholNb * kCholNb, lane);
    __threadfence();  // V_b is published before this thread's arrive
  }
  __syncthreads();
  store_column(out, ldo, kPanel, b, kPanelBlocks, Lb);
  __syncthreads();  // the block column is read: its shared memory holds the staging buffers from here

  if (b == kLast) {  // no rows below: W_77 = V_7
    cluster_wait();    // A
    cluster_arrive();  // B: V_7 is published
    cluster_wait();
  } else {
    panel_stage(smem, WS, b);
    float acc[4][8] = {};  // T_i, i = b + 1 + warp
    const int r = threadIdx.x >> 3, c0 = 4 * (threadIdx.x & 7);
    for (int m = b; m < kPanelBlocks; ++m) {
      // the next panel into the other buffer (last read at step m - 1)
      if (m + 2 < kPanelBlocks) panel_stage(smem + ((m + 1 - b) & 1) * kPanelBuf, WS, m + 1);
      if (m == kLast) {  // V_7 is published
        cluster_wait();  // B
        for (int e = threadIdx.x; e < kCholNb * kCholNb / 4; e += kCholThreads) {
          const int row = kLast * kCholNb + e / 8;
          cp_async16(Vs + row * kPanelVLd + 4 * (e % 8), Vg + row * kCholNb + 4 * (e % 8));
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      if (m > b) {  // W_mb = -V_m T_m, thread t a row t / 8 and columns 4 (t % 8) .. + 3
        if (warp == m - b - 1)
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y) Tt[(4 * (lane & 7) + x) * kCholNb + 8 * (lane >> 3) + y] = acc[x][y];
        __syncthreads();
        const float* Vm = Vs + m * kCholNb * kPanelVLd;
        float w4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
        for (int t = 0; t < kCholNb; ++t) {
          const float a = Vm[r * kPanelVLd + t];
          const float4 x = *reinterpret_cast<const float4*>(&Tt[t * kCholNb + c0]);
          w4[0] = fmaf(a, x.x, w4[0]);
          w4[1] = fmaf(a, x.y, w4[1]);
          w4[2] = fmaf(a, x.z, w4[2]);
          w4[3] = fmaf(a, x.w, w4[3]);
        }
        *reinterpret_cast<float4*>(&Wc[m * kCholNb * kCholNb + r * kCholNb + c0]) =
            make_float4(-w4[0], -w4[1], -w4[2], -w4[3]);
      }
      if (m == kLast) break;
      if (m + 2 < kPanelBlocks)  // panel m is in; the next may still be in flight
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // panel m is staged and W_mb written, for every thread
      const int i = b + 1 + warp, ld = kCholNb * (kPanelBlocks - 1 - m) + 4;
      if (i > m && i < kPanelBlocks)
        tile_acc(acc, smem + ((m - b) & 1) * kPanelBuf + kCholNb * (i - m - 1), ld, Wc + m * kCholNb * kCholNb, lane);
      if (m == b) {        // V_0 .. V_6 are published after phase A; stage those of the rows below
        cluster_wait();    // the factor's last phase
        cluster_arrive();  // A: V_b is published
        cluster_wait();
        cluster_arrive();  // B: nothing of this CTA's
        for (int e = threadIdx.x; e < (kLast - 1 - b) * kCholNb * kCholNb / 4; e += kCholThreads) {
          const int row = (b + 1) * kCholNb + e / 8;  // the rows of V_b+1 .. V_6, one after another
          cp_async16(Vs + row * kPanelVLd + 4 * (e % 8), Vg + row * kCholNb + 4 * (e % 8));
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();  // Tt and the buffer of panel m are read before they are written again
    }
  }

  __syncthreads();  // W_7b is written
  // W's block column b as rows 32 b .. 32 b + 31 of W^T: zeros left of column
  // 32 b, then tile i of the column transposed, thread t a row t / 8 and four
  // columns of the tile (conflict-free float4 reads of Wc)
  for (int e = threadIdx.x; e < kCholNb * kCholNb * b; e += kCholThreads)
    W[(size_t)(kCholNb * b + e / (kCholNb * b)) * kPanel + e % (kCholNb * b)] = 0.0f;
  const int r = threadIdx.x >> 3, c0 = 4 * (threadIdx.x & 7);
  for (int i = b; i < kPanelBlocks; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(&Wc[i * kCholNb * kCholNb + r * kCholNb + c0]);
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int y = 0; y < 4; ++y) W[(size_t)(kCholNb * b + c0 + y) * kPanel + kCholNb * i + r] = vs[y];
  }
}

// K15's diagonal kernel: D the top of the panel P, L_dd the top of out.
__global__ void __launch_bounds__(kCholThreads, 1)
    panel_diag_cluster(const float* __restrict__ P, size_t ldp, float* __restrict__ out, float* __restrict__ W,
                       float* __restrict__ WS) {
  extern __shared__ __align__(16) float smem[];
  panel_diag_body<false>(P, ldp, out, kPanel, W, WS, smem);
}

// K17's diagonal kernel: D, row stride ld, factored in place.
__global__ void __launch_bounds__(kCholThreads, 1)
    panel_inplace_diag(float* D, size_t ld, float* __restrict__ W, float* __restrict__ WS) {
  extern __shared__ __align__(16) float smem[];
  panel_diag_body<true>(D, ld, D, ld, W, WS, smem);
}

// The rows kernel: 128 threads, two pairs of warps.  Pair 0 takes output
// column tiles 3 then 0, pair 1 tiles 2 then 1 (tile j needs depth [0, 64 (j
// + 1)) of W^T, W being lower triangular): 320 deep each, in ten 32-deep
// chunks, so that the pairs walk in step.  Shared memory: the block's 32
// rows, depth-major (sA[k][r], stride 36), and for each pair a ring of
// kRowStages chunks of W^T (32 rows by 64 columns, stride 68).
constexpr int kRowThreads = 128;
constexpr int kRowDepth = 32;
constexpr int kRowStages = 3;
constexpr int kRowSteps = 10;
constexpr int kRowALd = kPanelRowTile + 4;
constexpr int kRowWLd = kPanelTile + 4;
constexpr int kRowChunk = kRowDepth * kRowWLd;
constexpr int kRowSmemBytes = (kPanel * kRowALd + 2 * kRowStages * kRowChunk) * (int)sizeof(float);

// Pair p's chunk g: its column tile j and depth t0.
__device__ __forceinline__ void row_chunk(int p, int g, int* j, int* t0) {
  const int first = kPanelRows - 1 - p, n1 = (first + 1) * kPanelTile / kRowDepth;  // 8 or 6 chunks
  *j = g < n1 ? first : kPanelRows - 1 - first;
  *t0 = (g < n1 ? g : g - n1) * kRowDepth;
}

// Chunk g of both pairs into their ring slots: W^T's rows t0 .. t0 + 31,
// columns 64 j .. 64 j + 63, eight 16-byte copies a thread, one commit group
// (empty past the last chunk).
__device__ __forceinline__ void row_stage(const float* Wt, float* sW, int g) {
  if (g < kRowSteps)
    for (int e = threadIdx.x; e < 2 * kRowDepth * kPanelTile / 4; e += kRowThreads) {
      const int p = e / (kRowDepth * kPanelTile / 4), q = e % (kRowDepth * kPanelTile / 4), kk = q / 16, part = q % 16;
      int j, t0;
      row_chunk(p, g, &j, &t0);
      cp_async16(sW + (p * kRowStages + g % kRowStages) * kRowChunk + kk * kRowWLd + 4 * part,
                 Wt + (size_t)(t0 + kk) * kPanel + kPanelTile * j + 4 * part);
    }
  cp_async_commit();
}

// Run by every thread of the rows kernels: grid (n - 256) / 32 blocks, block
// g the rows 256 + 32 g .. of P (row stride ldp) into the same rows of out
// (row stride ldo); block (128); dynamic shared memory kRowSmemBytes.  L21 =
// A21 W^T, Wt = W^T.  The block's rows are read once into shared memory
// before its first store, so out may be P (K17).  In a pair, thread (rg, cg) takes rows 4 rg .. + 3 and
// columns 8 cg .. + 7 of the pair's 32x64 output tile: a step of depth one is
// three 16-byte shared loads for 32 FMAs (shared memory serves a 16-byte load
// of a warp in four passes: those loads, not the FMAs, set the pace);
// 128-term partials folded into the sum.
__device__ __forceinline__ void panel_rows_body(const float* P, size_t ldp, float* out, size_t ldo, const float* Wt,
                                                float* smem) {
  float* sA = smem;
  float* sW = smem + kPanel * kRowALd;
  const size_t r0 = kPanel + (size_t)blockIdx.x * kPanelRowTile;
  row_stage(Wt, sW, 0);
  row_stage(Wt, sW, 1);
  for (int c = threadIdx.x; c < kPanel; c += kRowThreads) {
    float v[kPanelRowTile];  // column c of the 32 rows: every load in flight
#pragma unroll
    for (int u = 0; u < kPanelRowTile; ++u) v[u] = P[(r0 + u) * ldp + c];
#pragma unroll
    for (int u = 0; u < kPanelRowTile; ++u) sA[c * kRowALd + u] = v[u];
  }
  const int p = threadIdx.x >> 6, rg = threadIdx.x & 7, cg = (threadIdx.x >> 3) & 7;
  float acc[4][8] = {}, part[4][8] = {};
  for (int g = 0; g < kRowSteps; ++g) {
    row_stage(Wt, sW, g + 2);
    cp_async_wait<2>();
    __syncthreads();  // chunk g (and the rows) are in shared memory for every thread
    int j, t0;
    row_chunk(p, g, &j, &t0);
    const float* w = sW + (p * kRowStages + g % kRowStages) * kRowChunk;
#pragma unroll 4
    for (int kk = 0; kk < kRowDepth; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sA[(t0 + kk) * kRowALd + 4 * rg]);
      const float4 b0 = *reinterpret_cast<const float4*>(&w[kk * kRowWLd + 8 * cg]);
      const float4 b1 = *reinterpret_cast<const float4*>(&w[kk * kRowWLd + 8 * cg + 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) part[x][y] = fmaf(av[x], bv[y], part[x][y]);
    }
    __syncthreads();  // the slot is read before chunk g + 3 refills it
    const bool last = t0 + kRowDepth == (j + 1) * kPanelTile;
    if (last || (t0 / kRowDepth) % 4 == 3)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          acc[x][y] += part[x][y];
          part[x][y] = 0.0f;
        }
    if (last) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float* dst = out + (r0 + 4 * rg + x) * ldo + kPanelTile * j + 8 * cg;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[x][4], acc[x][5], acc[x][6], acc[x][7]);
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
}

// K15's rows kernel: out (n, 256) contiguous.
__global__ void __launch_bounds__(kRowThreads)
    panel_factor_rows(const float* __restrict__ P, size_t ldp, float* __restrict__ out, const float* __restrict__ Wt) {
  extern __shared__ __align__(16) float smem[];
  panel_rows_body(P, ldp, out, kPanel, Wt, smem);
}

// K17's rows kernel: the panel's rows below D (the top of P, row stride ld),
// in place.
__global__ void __launch_bounds__(kRowThreads) panel_inplace_rows(float* P, size_t ld, const float* __restrict__ Wt) {
  extern __shared__ __align__(16) float smem[];
  panel_rows_body(P, ld, P, ld, Wt, smem);
}

// One 8-CTA cluster of a diagonal kernel on stream s.
template <class... Exp, class... Act>
cudaError_t launch_panel_diag(void (*kernel)(Exp...), cudaStream_t s, Act... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCholSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCholCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCholCluster);
  cfg.blockDim = dim3(kCholThreads);
  cfg.dynamicSmemBytes = kCholSmemBytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace gpr

// P: (n, 256) row stride ldp (read only); out: (n, 256) contiguous, sharing no
// memory with P; W: a (256, 256) float scratch (it receives W^T); WS: a workspace of
// 7 * 32 * 480 + 8 * 1024 floats.  n % 256 == 0.
extern "C" int gpr_panel_factor(const float* P, int ldp, float* out, float* W, float* WS, int n, void* stream) {
  using namespace gpr;
  if (n < kPanel || n % kPanel || ldp < kPanel) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_panel_diag(panel_diag_cluster, s, P, (size_t)ldp, out, W, WS);
  if (err != cudaSuccess || n == kPanel) return (int)err;
  err = cudaFuncSetAttribute(panel_factor_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmemBytes);
  if (err != cudaSuccess) return (int)err;
  panel_factor_rows<<<(n - kPanel) / kPanelRowTile, kRowThreads, kRowSmemBytes, s>>>(P, (size_t)ldp, out, W);
  return (int)cudaGetLastError();
}

// S: (n, n) contiguous and 16-byte aligned, n % 256 == 0, 0 <= c0t < n / 256;
// W and WS as gpr_panel_factor's.
extern "C" int gpr_panel_inplace(float* S, int n, int c0t, float* W, float* WS, void* stream) {
  using namespace gpr;
  const int c0 = c0t * kPanel;
  if (n < kPanel || n % kPanel || c0t < 0 || c0 >= n || reinterpret_cast<size_t>(S) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* D = S + (size_t)c0 * (n + 1);
  cudaError_t err = launch_panel_diag(panel_inplace_diag, s, D, (size_t)n, W, WS);
  if (err != cudaSuccess || c0 + kPanel == n) return (int)err;
  err = cudaFuncSetAttribute(panel_inplace_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmemBytes);
  if (err != cudaSuccess) return (int)err;
  panel_inplace_rows<<<(n - c0 - kPanel) / kPanelRowTile, kRowThreads, kRowSmemBytes, s>>>(D, (size_t)n, W);
  return (int)cudaGetLastError();
}
