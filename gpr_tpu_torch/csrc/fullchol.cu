// K2-K4: left-looking panel Cholesky of K(X, X) + diag*I (Gram mode) or of a
// given SPD matrix A (matrix mode), one panel of 128 columns at a time.
//
// Replaces the TPU kernel gpr_tpu/ops/pallas_fullchol.py::_fused_kernel
// (line 722), launched once per factorization by _call_fused (1125).  On the
// TPU the whole factorization is one dispatch whose sequential grid walks
// the panels; here the host walks them and launches three kernels per panel
// on PyTorch's current stream, whose order takes the place of the TPU grid's
// "arbitrary" (sequential) semantics:
//
//   K2 panel_update     P = S - L[rows, :jp] L[panel, :jp]^T, written into
//                       column block j of L; zeros into L[:jp, panel].
//   K3 diag_factor_inv  L_jj = chol(P_jj) and W_j = inv(L_jj) in shared memory.
//   K4 panel_solve      L[r, panel] = P[r, :] W_j^T for the rows below.
//
// The TPU's bf16 hi|lo slab, its DMA/semaphore choreography and its chunk,
// group and diagonal-scheme knobs are TPU artifacts and have no counterpart.
//
// What bounds it on the H100: the left-looking update of K2 is n^3/3 FLOPs
// and compute bound; K3 is a latency-bound chain of 128 pivots per panel;
// K4 is a small GEMM per panel.  This simple version runs every product in
// plain FP32 FMA on the CUDA cores with 64x64 register-blocked tiles (K2)
// and keeps the whole 128x128 diagonal block and its inverse in one block's
// shared memory (K3).  Tensor cores (3xTF32 / wgmma), split-K for the narrow
// late panels and a CUDA graph over the panel loop are later work.
//
// Contracts kept from the TPU kernel:
//   * matrix mode reads only A[r, c] with r >= c (potrf 'L');
//   * the strict upper triangle of L is written as exact zeros;
//   * a non-positive pivot gives NaN through sqrtf (no clamp, no early exit),
//     which reaches W_j, every later panel and so L[-1, -1];
//   * in Gram mode rows and columns >= n_true are the pad block: the strip is
//     [[K, 0], [0, scale^2 I]] + diag*I, so L[:n_true, :n_true] is exact.
#include "gram_tile.cuh"

namespace gpr {

constexpr int kPanel = 128;
constexpr int kMatrixMode = -1;
constexpr int kDiagThreads = 512;
constexpr int kDiagLd = kPanel + 1;  // odd stride: column writes hit distinct banks
constexpr size_t kDiagSmem = 2 * kPanel * kDiagLd * sizeof(float);
constexpr int kSolveRows = 64;
constexpr int kSolveLd = kPanel + 4;

// ---------------------------------------------------------------- K2 -------
// grid (kPanel / kTile, n_pad / kTile); block (kThreads).
template <int FORM>
__global__ void __launch_bounds__(kThreads)
    panel_update_kernel(const float* __restrict__ src, float* __restrict__ L, int n_pad,
                        int n_true, int d, int j, GramParams par, float diag) {
  __shared__ TileSmem sm;
  const int jp = j * kPanel;
  const int row0 = blockIdx.y * kTile;
  const int col0 = jp + blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  if (row0 < jp) {  // strict upper of this column block: exact zeros
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(&L[(size_t)(row0 + ty * kPer + i) * n_pad + col0 + tx * kPer]) = z;
    }
    return;
  }

  // 1. the strip S
  float acc[kPer][kPer];
  if constexpr (FORM == kMatrixMode) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c4 = 0; c4 < kPer; ++c4) {
        const int r = row0 + ty * kPer + i;
        const int c = col0 + tx * kPer + c4;
        // mirror the diagonal block from its lower half
        acc[i][c4] = (r >= c) ? src[(size_t)r * n_pad + c] : src[(size_t)c * n_pad + r];
      }
  } else {
    gram_tile<FORM>(src, n_true, row0, src, n_true, col0, d, par, sm, acc);
    const float pad_diag = diag + par.scale * par.scale;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c4 = 0; c4 < kPer; ++c4) {
        const int r = row0 + ty * kPer + i;
        const int c = col0 + tx * kPer + c4;
        float v = (r >= n_true || c >= n_true) ? 0.0f : acc[i][c4];
        if (r == c) v += (r >= n_true) ? pad_diag : diag;
        acc[i][c4] = v;
      }
  }

  // 2. left-looking update with every factored panel: acc -= L[r, :jp] . L[c, :jp]
  float part[kPer][kPer] = {};
  for (int k0 = 0, c = 1; k0 < jp; k0 += kChunk, ++c) {
    {
      const int r = threadIdx.x / 4;  // 64 rows x 4 float4 = 256 loads per operand
      const int q = threadIdx.x % 4;
      const float4 a = *reinterpret_cast<const float4*>(&L[(size_t)(row0 + r) * n_pad + k0 + 4 * q]);
      const float4 b = *reinterpret_cast<const float4*>(&L[(size_t)(col0 + r) * n_pad + k0 + 4 * q]);
      sm.a[4 * q + 0][r] = a.x;
      sm.a[4 * q + 1][r] = a.y;
      sm.a[4 * q + 2][r] = a.z;
      sm.a[4 * q + 3][r] = a.w;
      sm.b[4 * q + 0][r] = b.x;
      sm.b[4 * q + 1][r] = b.y;
      sm.b[4 * q + 2][r] = b.z;
      sm.b[4 * q + 3][r] = b.w;
    }
    __syncthreads();
    rank_update_chunk(sm, part);
    __syncthreads();
    if (c % kFold == 0) fold_update(acc, part);
  }
  fold_update(acc, part);

  // 3. P into column block j of L
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&L[(size_t)(row0 + ty * kPer + i) * n_pad + col0 + tx * kPer]) = v;
  }
}

// ---------------------------------------------------------------- K3 -------
// grid (1); block (kDiagThreads); dynamic shared memory kDiagSmem.
//
// Right-looking on the 128x128 block in shared memory.  Thread t owns column
// l = t % 128 of the trailing update and rows rg + 4 s (rg = t / 128, s < 32),
// so the 32 updates of a thread are independent and need no index
// arithmetic.  Pivot k: scale column k below the diagonal, barrier, update
// the trailing lower triangle (and store the pivot), barrier.  W = inv(L_jj)
// comes from the same sweep applied to the rows of I.
__global__ void __launch_bounds__(kDiagThreads)
    diag_factor_inv_kernel(float* __restrict__ L, float* __restrict__ W, int n_pad, int j) {
  extern __shared__ float smem[];
  float* A = smem;                     // P_jj, factored in place (lower triangle)
  float* V = smem + kPanel * kDiagLd;  // I, turned into inv(L_jj) in place
  const int jp = j * kPanel;
  float* Ljj = L + (size_t)jp * n_pad + jp;
  float* Wj = W + (size_t)j * kPanel * kPanel;
  constexpr int kGroups = kDiagThreads / kPanel;  // 4 row groups
  constexpr int kRows = kPanel / kGroups;         // 32 rows per thread
  const int l = threadIdx.x % kPanel;
  const int rg = threadIdx.x / kPanel;

#pragma unroll 4
  for (int s = 0; s < kRows; ++s) {
    const int r = rg + kGroups * s;
    A[r * kDiagLd + l] = Ljj[(size_t)r * n_pad + l];
    V[r * kDiagLd + l] = (r == l) ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int k = 0; k < kPanel; ++k) {
    const float piv = sqrtf(A[k * kDiagLd + k]);  // < 0 or NaN -> NaN, kept
    if (threadIdx.x > k && threadIdx.x < kPanel)
      A[threadIdx.x * kDiagLd + k] /= piv;
    __syncthreads();
    if (threadIdx.x == k) A[k * kDiagLd + k] = piv;  // nobody reads it in this phase
    if (l > k) {
      const float alk = A[l * kDiagLd + k];
#pragma unroll 8
      for (int s = 0; s < kRows; ++s) {
        const int i = rg + kGroups * s;
        if (i >= l) A[i * kDiagLd + l] = fmaf(-A[i * kDiagLd + k], alk, A[i * kDiagLd + l]);
      }
    }
    __syncthreads();
  }

  // W: solve L W = I by rows: W[k, :] /= L[k][k]; W[i, :] -= L[i][k] W[k, :].
  // W is lower triangular: its strict upper stays the 0 of I and is skipped.
  for (int k = 0; k < kPanel; ++k) {
    if (threadIdx.x <= k) V[k * kDiagLd + threadIdx.x] /= A[k * kDiagLd + k];
    __syncthreads();
    if (l <= k) {
      const float vk = V[k * kDiagLd + l];
#pragma unroll 8
      for (int s = 0; s < kRows; ++s) {
        const int i = rg + kGroups * s;
        if (i > k) V[i * kDiagLd + l] = fmaf(-A[i * kDiagLd + k], vk, V[i * kDiagLd + l]);
      }
    }
    __syncthreads();
  }

#pragma unroll 4
  for (int s = 0; s < kRows; ++s) {
    const int r = rg + kGroups * s;
    Ljj[(size_t)r * n_pad + l] = (l <= r) ? A[r * kDiagLd + l] : 0.0f;
    Wj[r * kPanel + l] = (l <= r) ? V[r * kDiagLd + l] : 0.0f;
  }
}

// ---------------------------------------------------------------- K4 -------
// grid ((n_pad - (j+1)*kPanel) / kSolveRows); block (kThreads).  Each block
// owns whole rows of the panel: it reads its 64 x 128 slice of P into shared
// memory before it writes any of it, so the in-place update is race free.
__global__ void __launch_bounds__(kThreads)
    panel_solve_kernel(float* __restrict__ L, const float* __restrict__ W, int n_pad, int j) {
  __shared__ __align__(16) float Ps[kSolveRows][kSolveLd];
  __shared__ __align__(16) float Ws[kChunk][kSolveLd];  // Ws[k][c] = W_j[c][k0 + k]
  const int jp = j * kPanel;
  const int row0 = (j + 1) * kPanel + blockIdx.x * kSolveRows;
  float* Lp = L + (size_t)row0 * n_pad + jp;
  const float* Wj = W + (size_t)j * kPanel * kPanel;
  const int tx = threadIdx.x % 16;  // columns tx*8 .. tx*8+7
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3

  for (int e = threadIdx.x; e < kSolveRows * kPanel / 4; e += kThreads) {
    const int r = e / (kPanel / 4), q = e % (kPanel / 4);
    *reinterpret_cast<float4*>(&Ps[r][4 * q]) =
        *reinterpret_cast<const float4*>(&Lp[(size_t)r * n_pad + 4 * q]);
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < kPanel; k0 += kChunk) {
    for (int e = threadIdx.x; e < kPanel * kChunk / 4; e += kThreads) {
      const int c = e / (kChunk / 4), q = e % (kChunk / 4);
      const float4 w = *reinterpret_cast<const float4*>(&Wj[(size_t)c * kPanel + k0 + 4 * q]);
      Ws[4 * q + 0][c] = w.x;
      Ws[4 * q + 1][c] = w.y;
      Ws[4 * q + 2][c] = w.z;
      Ws[4 * q + 3][c] = w.w;
    }
    __syncthreads();  // also orders the Ps fill before its first read
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 8]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 8 + 4]);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[ty * 4 + i][k0 + kk];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p, w[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* dst = &Lp[(size_t)(ty * 4 + i) * n_pad + tx * 8];
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <int FORM>
static void launch_update(cudaStream_t s, const float* src, float* L, int n_pad, int n_true,
                          int d, int j, GramParams par, float diag) {
  const dim3 grid(kPanel / kTile, n_pad / kTile);
  panel_update_kernel<FORM><<<grid, kThreads, 0, s>>>(src, L, n_pad, n_true, d, j, par, diag);
}

}  // namespace gpr

// form: a gpr::Form code (Gram mode, src = X (n_true, d)) or -1 (matrix
// mode, src = A (n_pad, n_pad)).  n_pad % 128 == 0.
extern "C" int gpr_panel_update(const float* src, float* L, int n_pad, int n_true, int d, int j,
                                int form, float sigma, float scale, float third, float diag,
                                void* stream) {
  using namespace gpr;
  const GramParams par{sigma, scale, third};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kMatrixMode: launch_update<kMatrixMode>(s, src, L, n_pad, n_true, d, j, par, diag); break;
    case kGaussian: launch_update<kGaussian>(s, src, L, n_pad, n_true, d, j, par, diag); break;
    case kRQ: launch_update<kRQ>(s, src, L, n_pad, n_true, d, j, par, diag); break;
    case kMatern12: launch_update<kMatern12>(s, src, L, n_pad, n_true, d, j, par, diag); break;
    case kMatern32: launch_update<kMatern32>(s, src, L, n_pad, n_true, d, j, par, diag); break;
    case kMatern52: launch_update<kMatern52>(s, src, L, n_pad, n_true, d, j, par, diag); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gpr_diag_factor_inv(float* L, float* W, int n_pad, int j, void* stream) {
  using namespace gpr;
  cudaError_t err = cudaFuncSetAttribute(diag_factor_inv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDiagSmem);
  if (err != cudaSuccess) return (int)err;
  diag_factor_inv_kernel<<<1, kDiagThreads, kDiagSmem, static_cast<cudaStream_t>(stream)>>>(L, W, n_pad, j);
  return (int)cudaGetLastError();
}

extern "C" int gpr_panel_solve(float* L, const float* W, int n_pad, int j, void* stream) {
  using namespace gpr;
  const int rows = n_pad - (j + 1) * kPanel;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  panel_solve_kernel<<<rows / kSolveRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(L, W, n_pad, j);
  return (int)cudaGetLastError();
}
