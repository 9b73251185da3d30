// K7: L = chol(A), and K8: (L, W = L^-1), for a batch of small SPD tiles A
// (B, b, b), 1 <= b <= 128.
//
// K7 replaces the TPU kernel gpr_tpu/ops/pallas_batched.py::_crout_l_kernel
// (line 205), the W-free _crout_sweep (47-196, with_w=False), launched by
// crout_chol (211) once per panel step of the fleet factorization for the
// diagonal blocks of every member.  K8 replaces ::_crout_wi_kernel (199), the
// with-W sweep (97-117, step2 119-173), launched by crout_chol_wi (253) from
// the fleet solve without the diagonal-block inverses (cho_solve_batched,
// 494-506: one launch on the (B n / p, p, p) tiles D D^T) and per panel step
// under GPR_FLEET_DIAG=crout (392-393).
//
// What bounds them on the H100: neither bytes nor FLOP.  A tile is b^3/3 FLOP
// for L (2 b^3 / 3 with W) and 4 (b(b+1)/2 + b^2) bytes (4 (b(b+1)/2 + 2 b^2)
// with W): the lower triangle read, the whole tiles written.  The pace is the
// chain of b dependent pivots.
//
// K7 is a blocked right-looking factor, one CTA of 256 threads per tile, on
// chol.cuh's warp pieces (those of K19, K12, K15 and K17).  The tile's lower
// triangle sits in shared memory column-major, padded with the identity to
// bp = 32 ceil(b / 32) rows and columns (column stride bp + 4: 67.7 KB at b =
// 128, three CTAs an SM), so that every b runs the same code.  By nt = bp / 32
// block columns k:
//   factor   warp 0 subtracts panel k - 1's product from the diagonal block
//            (the lookahead) and factors it in registers, a lane a row, with
//            shuffles and no barrier per pivot (diag_factor); meanwhile the
//            other warps subtract panel k - 1 from the other trailing lower
//            32x32 tiles, a warp a tile, 32-term sums in registers
//            (tile_update);
//   solve    a thread a row solves the rows below the diagonal block
//            (row_solve).
// Two barriers a block column, eight at b = 128, where the first design took
// one per pivot.  K8 keeps crout.cuh's column sweep (one barrier a pivot) and
// forms W in a second shared tile by a column-parallel forward substitution
// that needs no barrier (tri_inverse), 2 b (b | 1) * 4 bytes of shared memory,
// 132 KB at b = 128.
//
// Contracts kept from the TPU kernels:
//   * only A[r, c] with r >= c is read;
//   * the strict upper triangles of L and W are written as exact zeros;
//   * a non-positive (or NaN) pivot gives NaN through sqrtf (the scale is
//     1.0f / sqrtf, never rsqrtf: crout.cuh), with no clamp and no early exit,
//     in its tile only: its L[-1, -1] and W[-1, -1] are NaN.  K7's identity
//     padding lies after every real pivot, so it never hides a failure.
//     Other tiles are untouched.
// A and L may be one tensor (in place): a block reads its whole tile before
// it writes any of it.  W must share no memory with A.  Each is addressed with
// a batch and a row stride, so the tiles may be the diagonal blocks of a
// larger (B, n, n) buffer.
#include "chol.cuh"
#include "crout.cuh"

namespace gpr {

constexpr int kCroutMaxTile = 128;
constexpr int kK7Threads = 256;
constexpr int kK7Warps = kK7Threads / 32;

// Lower 32x32 tile t, numbered row by row: (i, j), j <= i.
__device__ __forceinline__ void k7_tile(int t, int* i, int* j) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  *i = r;
  *j = t - r * (r + 1) / 2;
}

// grid (B); dynamic shared memory bp (bp + 4) + 32 floats.  S[c ld + r] =
// A[r, c] for c <= r < b, the identity beyond b, 0 above the diagonal of the
// diagonal blocks; a warp reads 32 columns of one row of A (coalesced).
__global__ void __launch_bounds__(kK7Threads)
    crout_chol_kernel(const float* A, long long a_bs, int a_ld, float* L, long long l_bs, int l_ld,
                      int b) {  // A and L may alias: no __restrict__
  extern __shared__ __align__(16) float S[];
  const int nt = (b + kCholNb - 1) / kCholNb, bp = kCholNb * nt, ld = bp + kCholPad;
  float* rd = S + bp * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* At = A + blockIdx.x * a_bs;
  const int total = nt * (nt + 1) / 2 * kCholNb * kCholNb;
  constexpr int kB = 8;
  for (int base = threadIdx.x; base < total; base += kB * kK7Threads) {
    float v[kB];
    int at[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * kK7Threads;
      int ti, tj;
      k7_tile(idx >> 10, &ti, &tj);
      const int r = kCholNb * ti + ((idx >> 5) & 31), c = kCholNb * tj + (idx & 31);
      at[u] = c * ld + r;
      if (idx >= total) v[u] = 0.0f;
      else if (r < b && c < b) v[u] = r >= c ? At[(size_t)r * a_ld + c] : 0.0f;
      else v[u] = r == c ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u)
      if (base + u * kK7Threads < total) S[at[u]] = v[u];
  }
  __syncthreads();

  for (int k = 0; k < nt; ++k) {
    float* Ck = S + kCholNb * k * ld;  // block column k, indexed by the tile's row
    float* Dk = Ck + kCholNb * k;
    const float* Pk = Ck - kCholNb * ld;  // panel k - 1
    if (warp == 0) {
      if (k > 0) {
        tile_update(Dk, ld, Pk + kCholNb * k, ld, Pk + kCholNb * k, ld, lane);
        __syncwarp();
      }
      diag_factor<1>(Dk, ld, rd, lane);
    } else if (k > 0) {
      int t = 0;
      for (int j = k; j < nt; ++j)
        for (int i = j; i < nt; ++i) {
          if (i == k && j == k) continue;
          if (t++ % (kK7Warps - 1) == warp - 1)
            tile_update(S + kCholNb * (j * ld + i), ld, Pk + kCholNb * i, ld, Pk + kCholNb * j, ld, lane);
        }
    }
    __syncthreads();
    for (int r = kCholNb * (k + 1) + threadIdx.x; r < bp; r += kK7Threads)
      row_solve<1>(Ck, ld, r, Dk, ld, rd, nullptr, 0, 0);
    __syncthreads();
  }

  float* Lt = L + blockIdx.x * l_bs;
  for (int e = threadIdx.x; e < b * b; e += kK7Threads) {
    const int r = e / b, c = e % b;
    Lt[(size_t)r * l_ld + c] = c <= r ? S[c * ld + r] : 0.0f;
  }
}

__global__ void __launch_bounds__(kCroutThreads)
    crout_chol_wi_kernel(const float* A, long long a_bs, int a_ld, float* L, long long l_bs,
                         int l_ld, float* W, long long w_bs, int w_ld, int b) {
  extern __shared__ float S[];
  const int ld = b | 1;
  float* Ws = S + b * ld;
  load_lower(S, ld, A + blockIdx.x * a_bs, a_ld, b);
  crout_sweep(S, ld, b);
  tri_inverse(S, Ws, ld, b);
  store_lower(S, ld, L + blockIdx.x * l_bs, l_ld, b);
  store_lower(Ws, ld, W + blockIdx.x * w_bs, w_ld, b);
}

}  // namespace gpr

// A, L: (B, b, b) float32 tiles, element [t, r, c] at t * bs + r * ld + c.
extern "C" int gpr_crout_chol(const float* A, long long a_bs, int a_ld, float* L, long long l_bs,
                              int l_ld, int B, int b, void* stream) {
  using namespace gpr;
  if (B < 1 || b < 1 || b > kCroutMaxTile) return (int)cudaErrorInvalidValue;
  const int bp = kCholNb * ((b + kCholNb - 1) / kCholNb);
  const int smem = (bp * (bp + kCholPad) + kCholNb) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(crout_chol_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  crout_chol_kernel<<<B, kK7Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, a_bs, a_ld, L, l_bs, l_ld, b);
  return (int)cudaGetLastError();
}

// A, L, W: (B, b, b) float32 tiles addressed as above.
extern "C" int gpr_crout_chol_wi(const float* A, long long a_bs, int a_ld, float* L,
                                 long long l_bs, int l_ld, float* W, long long w_bs, int w_ld,
                                 int B, int b, void* stream) {
  using namespace gpr;
  if (B < 1 || b < 1 || b > kCroutMaxTile) return (int)cudaErrorInvalidValue;
  const int smem = 2 * b * (b | 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(crout_chol_wi_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  crout_chol_wi_kernel<<<B, kCroutThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, a_bs, a_ld, L, l_bs, l_ld, W, w_bs, w_ld, b);
  return (int)cudaGetLastError();
}
