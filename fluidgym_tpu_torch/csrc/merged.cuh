// The merged super-block frame of a multi-block domain, as the kernels see
// it (K3 in cg.cu, K2 in bicgstab_mb.cu when a neighbour table is given).
//
// block_merge.merge_plan rewrites a multi-block topology into S axis-aligned
// super-blocks whose operator is an exact permutation of the original: rolls
// inside each super-block (ring closures wrap) plus a few residual seams,
// which the TPU kernels apply as static slab read-modify-writes after the
// roll stencil (cg_pallas_mb.py `_mb_matvec_into`).  On the card the frame
// is ONE flat buffer per lane: the super-blocks back to back (cells total
// n), and the seams live in a per-cell neighbour table built once per plan
// on the host (ops/cg_cuda_mb.py `neighbor_table`):
//
//   nbr[f * n + c] = flat index of cell c's neighbour across face f
//
// = the circular roll inside c's super-block, replaced on a seam slab by the
// matching cell of the source super-block.  A flip seam (the reflected wake
// cut of an airfoil C-grid, cg_pallas_mb.py `_mb_matvec_into` :230-247, an
// anti-diagonal matmul on the TPU) is the same replacement with the source
// slab reversed along the seam, done once when the table is built; the
// kernels have no flip-specific code.  So a seam costs nothing extra
// per iteration, every dot product over the flat buffer is joint over the
// super-blocks, and the matvec is one gather per face.  The table holds
// 2*ndims int32 per cell (the cylinder: 4 x 14,232 x 4 B = 228 KB), read
// from L2 like the coefficients.
#pragma once

#include <cuda_runtime.h>

// (A v)_c = diag_c v_c + sum_f off_f,c v_nbr_f(c), summed in face order.
template <int ND>
__device__ __forceinline__ float fg_table_matvec(const float* __restrict__ diag,
                                                 const float* __restrict__ off,
                                                 const int* __restrict__ nbr,
                                                 const float* __restrict__ v,
                                                 int c, int n) {
  float y = diag[c] * v[c];
#pragma unroll
  for (int f = 0; f < 2 * ND; ++f) y = y + off[f * n + c] * v[nbr[f * n + c]];
  return y;
}
