// K1: the tiled Gram kernel K[i, j] = k(X[i], Y[j]) + diag * [i == j].
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_gram.py::_tile_body (line 38),
// launched through _gram_kernel (133) and _gram_tril_kernel (117) by
// gram_pallas (219).  The tile math lives in gram_tile.cuh, shared with the
// fused factorization.
//
// What bounds it on the H100: FP32 FMA for the cross term at d = 128 and the
// SFU for the exp, then the 4-byte-per-entry write of K.  Design: one block
// per 64x64 tile; in tril mode the grid is one-dimensional over the lower
// tiles only and each block decodes its (ti, tj) from its linear index, which
// takes the place of the TPU's scalar-prefetched tile list
// (pallas_gram.py:262-296).  Tril mode writes no strict-upper tile; those
// entries stay undefined, as on the TPU.
#include "gram_tile.cuh"

namespace gpr {

template <int FORM>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ X, const float* __restrict__ Y, float* __restrict__ K,
                int n, int m, int d, GramParams par, float diag, int tril) {
  __shared__ TileSmem sm;
  int ti, tj;
  if (tril) {
    const int t = blockIdx.x;
    ti = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > t) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    tj = t - ti * (ti + 1) / 2;
  } else {
    ti = blockIdx.y;
    tj = blockIdx.x;
  }
  const int row0 = ti * kTile;
  const int col0 = tj * kTile;
  float val[kPer][kPer];
  gram_tile<FORM>(X, n, row0, Y, m, col0, d, par, sm, val);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty * kPer + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx * kPer + j;
      if (c < m) K[(size_t)r * m + c] = val[i][j] + (r == c ? diag : 0.0f);
    }
  }
}

template <int FORM>
static void launch_gram(dim3 grid, cudaStream_t s, const float* X, const float* Y, float* K,
                        int n, int m, int d, GramParams par, float diag, int tril) {
  gram_kernel<FORM><<<grid, kThreads, 0, s>>>(X, Y, K, n, m, d, par, diag, tril);
}

}  // namespace gpr

extern "C" int gpr_gram(const float* X, const float* Y, float* K, int n, int m, int d, int form,
                        float sigma, float scale, float third, float diag, int tril,
                        void* stream) {
  using namespace gpr;
  const int nt = (n + kTile - 1) / kTile;
  const int mt = (m + kTile - 1) / kTile;
  const dim3 grid = tril ? dim3(nt * (nt + 1) / 2) : dim3(mt, nt);
  const GramParams par{sigma, scale, third};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kGaussian: launch_gram<kGaussian>(grid, s, X, Y, K, n, m, d, par, diag, tril); break;
    case kRQ: launch_gram<kRQ>(grid, s, X, Y, K, n, m, d, par, diag, tril); break;
    case kMatern12: launch_gram<kMatern12>(grid, s, X, Y, K, n, m, d, par, diag, tril); break;
    case kMatern32: launch_gram<kMatern32>(grid, s, X, Y, K, n, m, d, par, diag, tril); break;
    case kMatern52: launch_gram<kMatern52>(grid, s, X, Y, K, n, m, d, par, diag, tril); break;
    case kPeriodic: launch_gram<kPeriodic>(grid, s, X, Y, K, n, m, d, par, diag, tril); break;
    case kSqdist: launch_gram<kSqdist>(grid, s, X, Y, K, n, m, d, par, diag, tril); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gpr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
