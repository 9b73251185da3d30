// K19 tile_chol and K20 tile_chol_strips: L = U^T for one small SPD tile A
// (n <= 512), U the Cholesky factor computed from A's upper triangle only
// (gpr_tpu_torch/ops/chol.py).
//
// They replace the TPU kernels of gpr_tpu/ops/pallas_chol.py: K19
// _chol_kernel (line 29, launched by cholesky_pallas, 62; the one the
// dispatcher leaf_cholesky, 72, runs for n <= 512 on the accelerator) and K20
// _chol_strip_kernel (83, launched by cholesky_pallas_v2, 140).  Both TPU
// kernels keep the whole tile in VMEM and factor U = L^T row by row: K19 by
// n rank-1 updates, K20 by n / sw strips of sw rows, each factored by rank-1
// steps confined to the strip and followed by one rank-sw update of the
// trailing rows.
//
// Here the tile stays on chip in one thread-block cluster of 8 CTAs of 256
// threads on neighbouring SMs.  The lower triangle of a 512 tile (525 KB)
// does not fit one block's 227 KB; cut into 32-column block columns, two to
// a CTA (columns b and 15 - b of CTA b: 17 of the 136 32x32 tiles each at n =
// 512), it takes at most 69 KB of a CTA's shared memory.  A block column is
// stored column-major, so that its columns are rows of A's upper triangle.
// Blocked right-looking, by nt = ceil(n / 32) diagonal blocks k:
//
//   load     each CTA reads its block columns' part of A's upper triangle
//            (A's rows, coalesced) once; A's strict lower triangle is never
//            read, so NaN there leaves L bit-identical; a partial last
//            block is padded with the identity in shared memory;
//   factor   the owner of block column k factors the diagonal block on one
//            warp, a lane a row, in registers with shuffles (no barrier per
//            pivot), then its threads solve the rows below, a thread a row,
//            and publish the panel once to a workspace slot (L2);
//   sync     cluster barrier (arrive, then wait): panel k is published;
//   update   every CTA that holds a block column j > k copies the panel's
//            rows it needs from the slot into its shared memory once and
//            subtracts L_ik L_jk^T from its tiles: a warp a 32x32 tile, a
//            lane 4 x 8 of it, 32-term sums in registers subtracted at the
//            end;
//   look-    the owner of block column k + 1 takes that column first: warp 0
//   ahead    updates and factors its diagonal block while the other warps
//            update the blocks below; it solves, publishes and arrives
//            before it updates its other column, so that the others'
//            updates overlap the next diagonal step;
//   store    each CTA writes its output columns whole: the factor below the
//            diagonal, exact zeros above.
//
// The panels go through L2 and not through distributed shared memory:
// seven CTAs reading a 60 KB panel from its owner's shared memory at once
// drew ~20 bytes a cycle from that one SM (chip_tools/k19_probe.py, PERF.md),
// where each CTA reads L2 at several times that.
//
// K20's strip: inside a diagonal block, and in the rows' solve against it,
// the columns go by strips of SW: SW rank-1 steps confined to the strip, then
// one rank-SW update (SW-term sums) of the block's later columns.  K19 is SW
// = 1.  Between diagonal blocks both update by rank 32.  Every sum has a fixed
// order and there are no atomics: a call is deterministic.
//
// The pivot scale is 1.0f / sqrtf(pivot), both correctly rounded, as in
// crout.cuh (JAX's K19 uses rsqrt, its K20 1 / sqrt).  A non-positive (or
// NaN) pivot at j gives NaN through sqrtf, with no clamp and no early exit:
// rows before j stay finite, every row from j on holds a non-finite entry,
// and L[-1, -1] is NaN.  The strict upper triangle of L is exactly 0.
//
// What bounds them on the H100: n^3 / 3 FLOP against the upper triangle read
// and L written, 4 (n (n + 1) / 2 + n^2) bytes: at n = 256, 0.12 us (bytes);
// at n = 512, 0.67 us (FLOP at 67 TFLOP/s FP32).  The FLOP are spread over 8
// SMs (~6 MFLOP each at n = 512); the pace is set by the chain of nt
// dependent diagonal steps, each a warp's 32 pivots, the rows' solve, the
// panel's way through L2 and the cluster barrier.  Plain FP32 FMA: the work
// is too small for the tensor cores to matter.
#include <cuda_runtime.h>

#include "chol.cuh"

namespace gpr {

// grid (8) as one cluster of 8; block (256); dynamic shared memory
// kCholSmemBytes; W the workspace, nt - 1 slots.
template <int SW>
__global__ void __launch_bounds__(kCholThreads, 1)
    tile_chol_kernel(const float* __restrict__ A, float* __restrict__ L, float* __restrict__ W, int n) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (n + kCholNb - 1) / kCholNb;
  int own[2], no;
  tile_chol_factor<SW>(A, n, W, n, smem, own, &no);
  for (int s = 0; s < no; ++s) store_column(L, n, n, own[s], nt, smem + col_offset(own[s], nt));
  cluster_wait();  // each thread waits on its last arrive
}

template <int SW>
int launch_tile_chol(const float* A, float* L, float* W, int n, void* stream) {
  if (n < 1 || n > kCholMaxN || n % SW) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tile_chol_kernel<SW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kCholSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCholCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCholCluster);
  cfg.blockDim = dim3(kCholThreads);
  cfg.dynamicSmemBytes = kCholSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tile_chol_kernel<SW>, A, L, W, n);  // a cluster the card cannot place fails here
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace gpr

// A: (n, n) contiguous, only its upper triangle read; L: (n, n) contiguous,
// sharing no memory with A; W: a workspace of max(nt - 1, 1) * 32 * 480
// floats, nt = ceil(n / 32).  1 <= n <= 512.
extern "C" int gpr_tile_chol(const float* A, float* L, float* W, int n, void* stream) {
  return gpr::launch_tile_chol<1>(A, L, W, n, stream);
}

// As gpr_tile_chol, by strips of sw columns inside each diagonal block: sw in
// {8, 16}, sw | n.
extern "C" int gpr_tile_chol_strips(const float* A, float* L, float* W, int n, int sw, void* stream) {
  if (sw == 8) return gpr::launch_tile_chol<8>(A, L, W, n, stream);
  if (sw == 16) return gpr::launch_tile_chol<16>(A, L, W, n, stream);
  return (int)cudaErrorInvalidValue;
}
