// Kernel-function tile math shared by the Gram kernel (gram.cu) and the
// fused factorization's strip build (fullchol.cu), so that the tile math
// exists once, as it does in the JAX package (gpr_tpu/ops/pallas_gram.py::
// _tile_body and its inlined copy pallas_fullchol.py::_gram_tile).
//
// One 256-thread block produces one 64x64 output tile.  Thread (ty, tx) of
// the 16x16 grid owns rows ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3.  The
// feature axis is walked in chunks of 16 staged through shared memory; the
// ragged edge of rows, columns and features is masked to zero, so no input
// needs padding.
//
// What bounds it on the H100: at d = 128 the cross term is 2*d FLOPs per
// output against one exp, so the tile is FP32-FMA bound with the SFU close
// behind.  This simple version keeps the cross term in plain FP32 FMA (at
// least the f32 grade the JAX package asks of its bf16x3 "high" tier) and
// reads each staged value through 128-bit shared loads, so the FMA pipe and
// not shared memory sets the pace.  K1's 3xTF32 tensor-core path is gram.cu's.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gpr {

// Form codes; the order matches gpr_tpu_torch/ops/gram.py::FORMS.
enum Form : int {
  kGaussian = 0,
  kRQ = 1,
  kMatern12 = 2,
  kMatern32 = 3,
  kMatern52 = 4,
  kPeriodic = 5,
  kSqdist = 6,
};

constexpr int kTile = 64;      // output tile edge
constexpr int kChunk = 16;     // feature (or update) depth staged per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPer = 4;        // outputs per thread along each axis
constexpr int kLd = kTile + 4; // padded row of a staged chunk (16-byte aligned)

struct GramParams {
  float sigma;
  float scale;
  float third;  // rq: alpha; periodic: b; unused otherwise
};

struct __align__(16) TileSmem {
  float a[kChunk][kLd];  // staged rows of the left operand, k-major
  float b[kChunk][kLd];  // staged rows of the right operand, k-major
};

template <int FORM>
__device__ __forceinline__ float gram_value(float d2, const GramParams& p) {
  const float s2 = p.scale * p.scale;
  if (FORM == kGaussian || FORM == kPeriodic) {
    return s2 * expf(-0.5f * d2 / (p.sigma * p.sigma));
  } else if (FORM == kRQ) {
    return s2 * powf(1.0f + 0.5f * d2 / (p.sigma * p.sigma * p.third), -p.third);
  } else if (FORM == kMatern12) {
    return s2 * expf(-sqrtf(d2) / p.sigma);
  } else if (FORM == kMatern32) {
    const float a = 1.7320508075688772f * sqrtf(d2) / p.sigma;
    return s2 * (1.0f + a) * expf(-a);
  } else if (FORM == kMatern52) {
    const float a = 2.2360679774997898f * sqrtf(d2) / p.sigma;
    return s2 * (1.0f + a + a * a / 3.0f) * expf(-a);
  } else {  // kSqdist
    return d2;
  }
}

// Stage rows [r0, r0+64) x columns [k0, k0+16) of a row-major (nrows, ncols)
// matrix with row stride ld into dst[k][r]; out-of-range entries read as zero.
__device__ __forceinline__ void stage_rows(float (*dst)[kLd], const float* src,
                                           size_t ld, int nrows, int ncols, int r0, int k0) {
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int r = e / kChunk;
    const int kk = e % kChunk;
    const int gr = r0 + r;
    const int k = k0 + kk;
    dst[kk][r] = (gr < nrows && k < ncols) ? src[gr * ld + k] : 0.0f;
  }
}

// val[i][j] = k(X[row0 + ty*4 + i], Y[col0 + tx*4 + j]) for one 64x64 tile,
// without any diagonal term.  Rows of X at or past nx, and of Y at or past
// ny, act as all-zero feature vectors (the caller masks or drops them).
template <int FORM>
__device__ __forceinline__ void gram_tile(const float* __restrict__ X, int nx, int row0,
                                          const float* __restrict__ Y, int ny, int col0,
                                          int d, const GramParams& par, TileSmem& sm,
                                          float val[kPer][kPer]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[kPer][kPer];
  float xx[kPer], yy[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    xx[i] = 0.0f;
    yy[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    stage_rows(sm.a, X, d, nx, d, row0, k0);
    stage_rows(sm.b, Y, d, ny, d, col0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][ty * kPer]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * kPer]);
      const float a[kPer] = {av.x, av.y, av.z, av.w};
      const float b[kPer] = {bv.x, bv.y, bv.z, bv.w};
      if (FORM == kPeriodic) {
        // sum_k sin^2(b (x_k - y_k)): per-feature differences, no GEMM
        // identity (as pallas_gram.py's static feature loop)
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const float s = sinf(par.third * (a[i] - b[j]));
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
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float d2 =
          (FORM == kPeriodic) ? acc[i][j] : fmaxf(xx[i] + yy[j] - 2.0f * acc[i][j], 0.0f);
      val[i][j] = gram_value<FORM>(d2, par);
    }
}

}  // namespace gpr
