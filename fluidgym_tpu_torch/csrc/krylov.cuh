// Shared device helpers for the whole-solve Krylov kernels (K1/K3 cg.cu,
// K2 bicgstab_mb.cu): the stencil applies and block-wide sums.
//
// Layout (identical to the PyTorch side): a lane's field is a contiguous
// (nz, ny, nx) array (nz = 1 in 2D), x the minor axis; the stencil
// coefficients are diag (n) and off (2*ndims, n) with the face order
// -x,+x,-y,+y[,-z,+z].  Every neighbour wraps circularly; FIXED faces carry
// off = 0, so the wrapped value is masked and needs no special case.
#pragma once

#include <cuda_runtime.h>

#define FG_THREADS 1024
// lanes of one thread block (one lockstep chunk); a solve takes any number
// of lanes, spread over a grid of ceil(lanes / chunk) blocks
#define FG_MAX_LANES 64

struct FgGrid {
  int nz, ny, nx, n;
};

// (A v)_c = diag_c v_c + sum_f off_f,c v_nbr_f(c), summed in face order as
// the PyTorch version does.
template <int ND>
__device__ __forceinline__ float fg_matvec(const float* __restrict__ diag,
                                           const float* __restrict__ off,
                                           const float* __restrict__ v,
                                           int c, const FgGrid& g) {
  const int nx = g.nx, ny = g.ny, n = g.n;
  const int i = c % nx;
  const int j = (c / nx) % ny;
  const int k = c / (nx * ny);
  const int row = c - i;
  const int plane = k * nx * ny;
  const int im = (i == 0) ? nx - 1 : i - 1;
  const int ip = (i == nx - 1) ? 0 : i + 1;
  const int jm = (j == 0) ? ny - 1 : j - 1;
  const int jp = (j == ny - 1) ? 0 : j + 1;
  float y = diag[c] * v[c];
  y = y + off[c] * v[row + im];
  y = y + off[n + c] * v[row + ip];
  y = y + off[2 * n + c] * v[plane + jm * nx + i];
  y = y + off[3 * n + c] * v[plane + jp * nx + i];
  if (ND == 3) {
    const int nz = g.nz;
    const int km = (k == 0) ? nz - 1 : k - 1;
    const int kp = (k == nz - 1) ? 0 : k + 1;
    y = y + off[4 * n + c] * v[(km * ny + j) * nx + i];
    y = y + off[5 * n + c] * v[(kp * ny + j) * nx + i];
  }
  return y;
}

__device__ __forceinline__ float fg_warp_sum(float v) {
  // butterfly: every lane ends with the bitwise-same total
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum two per-thread values over the block; every thread gets both totals.
// `sh` holds 64 floats of shared memory.  Must be reached by all threads.
__device__ __forceinline__ void fg_block_sum2(float& a, float& b, float* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  a = fg_warp_sum(a);
  b = fg_warp_sum(b);
  __syncthreads();  // the previous call's readers are done with sh
  if (lane == 0) {
    sh[warp] = a;
    sh[32 + warp] = b;
  }
  __syncthreads();
  a = (lane < nwarps) ? sh[lane] : 0.0f;
  b = (lane < nwarps) ? sh[32 + lane] : 0.0f;
  a = fg_warp_sum(a);
  b = fg_warp_sum(b);
}

// The chunk grid: block b solves lanes [b * chunk, min(lanes, (b + 1) *
// chunk)) as its own lockstep group, with its own loop, iteration counter
// and per-lane scalars.  Per-lane freeze keeps a lane's x independent of its
// chunk mates, so this computes what the TPU's sequential chunks (lax.map)
// compute, lane for lane, with the chunks side by side on the SMs.  Returns
// the first lane of this block and sets `lanes` to the block's lane count.
__device__ __forceinline__ int fg_chunk(int& lanes, int chunk) {
  const int l0 = blockIdx.x * chunk;
  lanes = min(chunk, lanes - l0);
  return l0;
}

// Launch shape of a solve over `lanes` lanes in chunks of `chunk`: the
// number of blocks, or 0 when the arguments are out of range.
inline int fg_chunk_blocks(int lanes, int chunk) {
  if (lanes < 1 || chunk < 1 || chunk > FG_MAX_LANES) return 0;
  return (lanes + chunk - 1) / chunk;
}

__device__ __forceinline__ float fg_guard(float x) {
  const float tiny = 1e-30f;
  return (fabsf(x) < tiny) ? tiny : x;
}

#include "merged.cuh"

// The stencil apply of either frame: roll-form over one (nz, ny, nx) grid
// (nbr == nullptr), or the merged frame's neighbour table.
template <int ND, bool TABLE>
__device__ __forceinline__ float fg_apply(const float* __restrict__ diag,
                                          const float* __restrict__ off,
                                          const int* __restrict__ nbr,
                                          const float* __restrict__ v, int c,
                                          const FgGrid& g) {
  if (TABLE) return fg_table_matvec<ND>(diag, off, nbr, v, c, g.n);
  return fg_matvec<ND>(diag, off, v, c, g);
}
