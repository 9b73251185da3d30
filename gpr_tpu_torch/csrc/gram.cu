// K1: the tiled Gram kernel K[i, j] = k(X[i], Y[j]) + diag * [i == j].
// K6: the fleet Gram K[b] = k(X[b], X[b]) + diag[b] I, one launch for B members.
//
// K1 replaces the TPU kernel gpr_tpu/ops/pallas_gram.py::_tile_body (line
// 38), launched through _gram_kernel (133) and _gram_tril_kernel (117) by
// gram_pallas (219).  K6 replaces _gram_batched_kernel (142), launched by
// gram_pallas_batched (155).  The tile math lives in gram_tile.cuh, shared
// with the fused factorization.
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

// Thread (ty, tx)'s 4x4 entries of the tile at (row0, col0) into the
// row-major (n, m) matrix K, with diag added where row == column.
__device__ __forceinline__ void store_tile(float* __restrict__ K, int n, int m, int row0,
                                           int col0, const float val[kPer][kPer], float diag) {
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
  store_tile(K, n, m, row0, col0, val, diag);
}

// K6: grid (nt, nt, members), one 64x64 tile of member blockIdx.z per
// block; the launcher sends B in chunks of at most 65535 members (gridDim.z's
// limit), each with X, P and K offset to its first member.  Member b's (sigma, scale, third, diag) are row b of the (B, 4) device
// tensor P, so a fleet with per-member hyperparameters is one launch.
//
// What bounds it on the H100: at the fleet's small d (8 at full width) the
// cross term is 2 d FLOP per entry against one exp, so it is bound by the
// 4-byte write of each entry of the (B, n, n) output; ragged n and d are
// masked in the tile code, so X needs no padded copy (the TPU pads d to 128
// and n to its block, pallas_gram.py:177).
template <int FORM>
__global__ void __launch_bounds__(kThreads)
    gram_batched_kernel(const float* __restrict__ X, const float* __restrict__ P,
                        float* __restrict__ K, int n, int d) {
  __shared__ TileSmem sm;
  const size_t b = blockIdx.z;
  const float* Xb = X + b * n * d;
  const GramParams par{P[4 * b], P[4 * b + 1], P[4 * b + 2]};
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float val[kPer][kPer];
  gram_tile<FORM>(Xb, n, row0, Xb, n, col0, d, par, sm, val);
  store_tile(K + b * n * n, n, n, row0, col0, val, P[4 * b + 3]);
}

template <int FORM>
static void launch_gram(dim3 grid, cudaStream_t s, const float* X, const float* Y, float* K,
                        int n, int m, int d, GramParams par, float diag, int tril) {
  gram_kernel<FORM><<<grid, kThreads, 0, s>>>(X, Y, K, n, m, d, par, diag, tril);
}

template <int FORM>
static void launch_gram_batched(dim3 grid, cudaStream_t s, const float* X, const float* P,
                                float* K, int n, int d) {
  gram_batched_kernel<FORM><<<grid, kThreads, 0, s>>>(X, P, K, n, d);
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

// X (B, n, d), P (B, 4) = (sigma, scale, third, diag) per member, K (B, n, n);
// all contiguous float32.
extern "C" int gpr_gram_batched(const float* X, const float* P, float* K, int B, int n, int d,
                                int form, void* stream) {
  using namespace gpr;
  constexpr int kMaxMembers = 65535;
  const int nt = (n + kTile - 1) / kTile;
  if (B < 1 || n < 1 || d < 1 || form < kGaussian || form > kSqdist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < B; b0 += kMaxMembers) {
    const dim3 grid(nt, nt, B - b0 < kMaxMembers ? B - b0 : kMaxMembers);
    const float* Xc = X + (size_t)b0 * n * d;
    const float* Pc = P + (size_t)b0 * 4;
    float* Kc = K + (size_t)b0 * n * n;
    switch (form) {
      case kGaussian: launch_gram_batched<kGaussian>(grid, s, Xc, Pc, Kc, n, d); break;
      case kRQ: launch_gram_batched<kRQ>(grid, s, Xc, Pc, Kc, n, d); break;
      case kMatern12: launch_gram_batched<kMatern12>(grid, s, Xc, Pc, Kc, n, d); break;
      case kMatern32: launch_gram_batched<kMatern32>(grid, s, Xc, Pc, Kc, n, d); break;
      case kMatern52: launch_gram_batched<kMatern52>(grid, s, Xc, Pc, Kc, n, d); break;
      case kPeriodic: launch_gram_batched<kPeriodic>(grid, s, Xc, Pc, Kc, n, d); break;
      default: launch_gram_batched<kSqdist>(grid, s, Xc, Pc, Kc, n, d); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* gpr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
