// K4: the fused 2D stencil apply of one block, for k columns at once,
//   y = diag*x + off[0]*nbr(-x) + off[1]*nbr(+x) + off[2]*nbr(-y)
//       + off[3]*nbr(+y)
// where nbr_f is the face-f neighbour inside the block and, on the boundary
// layer, the halo value (the CONNECTED halo slab, or the wrapped opposite
// layer) that the caller gathered.
//
// Replaces fluidgym_tpu/ops/stencil_pallas.py `_kernel_2d` (entry
// `stencil_apply_pallas`), the TPU kernel that loads the block and its four
// halo layers into VMEM once and accumulates every face term in registers
// instead of materialising each shifted operand.  Semantics are that
// kernel's: the sum runs in face order -x, +x, -y, +y after diag*x, each
// product and sum rounded (--fmad=false), so the result is the plain
// PyTorch version's bit for bit.  The column form (k, ny, nx) is the port's
// written-out form of the JAX package's vmap over deflation columns (there
// one pallas_call per column); the coefficients are shared by the columns.
//
// What bounds it on the H100: bytes.  Per output cell it reads 6 floats
// (diag, 4 off, x) and writes 1, plus the halo layers: a block of the
// cylinder's wake (24 x 445) is ~300 KB, ~0.1 us at 3.35 TB/s, so at these
// sizes the launch itself (a few us) is the cost.  The design is the
// simple one for that: one thread per output cell, neighbouring threads on
// neighbouring x cells (coalesced), coefficients and neighbours read
// through L1/L2, no shared-memory tiling.
#include <cuda_runtime.h>

#define FG_STENCIL_THREADS 256

__global__ void __launch_bounds__(FG_STENCIL_THREADS)
fg_stencil2d_kernel(const float* __restrict__ diag,
                    const float* __restrict__ off,
                    const float* __restrict__ x,
                    const float* __restrict__ hxm,
                    const float* __restrict__ hxp,
                    const float* __restrict__ hym,
                    const float* __restrict__ hyp, float* __restrict__ y,
                    int k, int ny, int nx) {
  const int n = ny * nx;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)k * n) return;
  const int col = (int)(t / n);
  const int c = (int)(t - (long long)col * n);
  const int i = c % nx;
  const int j = c / nx;
  const float* xc = x + (size_t)col * n;
  const float v = xc[c];
  const float xm = (i > 0) ? xc[c - 1] : hxm[(size_t)col * ny + j];
  const float xp = (i < nx - 1) ? xc[c + 1] : hxp[(size_t)col * ny + j];
  const float ym = (j > 0) ? xc[c - nx] : hym[(size_t)col * nx + i];
  const float yp = (j < ny - 1) ? xc[c + nx] : hyp[(size_t)col * nx + i];
  float out = diag[c] * v;
  out = out + off[c] * xm;
  out = out + off[n + c] * xp;
  out = out + off[2 * n + c] * ym;
  out = out + off[3 * n + c] * yp;
  y[t] = out;
}

// diag (ny, nx), off (4, ny, nx), x / y (k, ny, nx); halos (k, ny, 1) for
// -x / +x and (k, 1, nx) for -y / +y; all contiguous float32.
extern "C" int fg_stencil2d_apply(const float* diag, const float* off,
                                  const float* x, const float* hxm,
                                  const float* hxp, const float* hym,
                                  const float* hyp, float* y, int k, int ny,
                                  int nx, void* stream) {
  if (k < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)k * ny * nx;
  const int blocks =
      (int)((total + FG_STENCIL_THREADS - 1) / FG_STENCIL_THREADS);
  fg_stencil2d_kernel<<<blocks, FG_STENCIL_THREADS, 0,
                        (cudaStream_t)stream>>>(diag, off, x, hxm, hxp, hym,
                                                hyp, y, k, ny, nx);
  return (int)cudaGetLastError();
}
