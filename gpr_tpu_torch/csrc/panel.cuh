// One Cholesky column panel of width kPanel = 256: the device code of K17
// panel_inplace (inplace.cu), as the JAX package's panel kernels share
// _strip_factor and _inv_upper (gpr_tpu/ops/pallas_panel.py:42, 92;
// inplace_chol.py:45).  K15 panel_factor (panel.cu) takes kPanel and the
// tile sizes from here and factors its diagonal tile on a thread-block
// cluster instead (chol.cuh).
//
// A panel is the (b, b) diagonal tile D over row tiles R_1, R_2, ... of b rows
// each.  The TPU kernel factors D to U = L_dd^T in VMEM on grid step 0, parks
// U^-1 in scratch, and turns each row tile into R_t U^-1 on the later steps of
// its sequential grid.  Here:
//
//   panel_diag   one block factors D in place and writes W = L_dd^-1 (so
//                U^-1 = W^T) to a (b, b) scratch: K13's walk (leaf.cuh:
//                leaf_body) on 64-wide diagonal blocks with a grid of one, so
//                its grid barriers are block barriers.  The TPU's 8-row strips
//                and one-hot gather matmuls are its sublane idiom and are not
//                carried over.  D stays in device memory (L2 holds it): the
//                256 KiB tile does not fit the 227 KB a Hopper block may have
//                in shared memory, and W could not sit beside it;
//   panel_rows   L_t = R_t W^T for every row tile, one block per 64 rows, the
//                four 64-column output tiles of those rows computed from the
//                right (column tile j reads the row's columns [0, 64 (j + 1)),
//                since W is lower triangular), so the rows may be rewritten in
//                place: a tile is stored only after every read of the columns
//                it overwrites.  Sums in two levels (gram_tile.cuh:
//                fold_update, 128-term partials).
//
// The row tiles need W, which exists only when the diagonal tile is done: the
// TPU's sequential grid gave that order.  A panel is here two kernels ordered
// by the stream, counted as one launch, as K10 counts one launch per block
// row (solve.cu): one block cannot host both steps, and a cooperative launch
// would put a grid barrier on every step of the diagonal walk for no gain,
// since at most six 64-tiles of D are ever independent.
//
// K17 reads D's lower triangle (the strict upper may hold junk).
// A non-positive (or NaN) pivot gives NaN through sqrtf with no clamp
// (crout.cuh); it reaches W's later rows and so every row tile, and through
// the trailing updates every later panel, so the factor's L[-1, -1] is NaN.
#pragma once

#include <cuda_runtime.h>

#include "leaf.cuh"

namespace gpr {

constexpr int kPanel = 256;                 // the panel width b (pallas_panel.py: tile)
constexpr int kPanelRows = kPanel / kTile;  // 64-tiles along the panel's width

// T (kPanel x kPanel, row stride ldt): its lower triangle -> L_dd, exact-zero
// strict upper; W (kPanel x kPanel, contiguous) = L_dd^-1, exact-zero upper.
// Called by every thread of a grid of one block.
__device__ inline void panel_diag(float* T, size_t ldt, float* W, LeafSmem& sm) {
  leaf_body<true, true>(T, ldt, T, ldt, W, kPanel, W, kPanel, (long long)kTile * (kPanel + 1),
                        kPanel, nullptr, sm);
}

// dst rows = src rows W^T for the 64 rows at src and dst (kPanel columns
// each); dst may be src.
__device__ inline void panel_row_strip(const float* src, size_t lds, float* dst, size_t ldd,
                                       const float* W, TileSmem& sm) {
  for (int j = kPanelRows - 1; j >= 0; --j) {
    float acc[kPer][kPer] = {};
    tile_product<false, false>(src, lds, W + (size_t)j * kTile * kPanel, kPanel, 0,
                               (j + 1) * kTile, sm, acc);
    store_tile(dst + (size_t)j * kTile, ldd, acc, -1.0f);
  }
}

}  // namespace gpr
