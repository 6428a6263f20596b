// K1 (and K3): the whole Jacobi-preconditioned CG solve in one launch, for
// a lockstep batch of stencil systems.  K1 (entry fg_cg_solve) takes one
// block with a roll-form matvec; K3 (entry fg_cg_mb_solve, at the end of
// this file) takes the merged super-block frame of a multi-block domain
// through its neighbour table (merged.cuh).
//
// Replaces fluidgym_tpu/ops/cg_pallas.py `_kernel` (entry `fused_cg`), the
// TPU kernel that keeps every lane's x, r, p resident in VMEM for the whole
// Krylov loop.  Semantics are that kernel's, lane for lane:
//   * NORM2_NORMALIZED stopping per lane (sum r^2 <= tol^2 * n);
//   * Jacobi preconditioning, optional warm start;
//   * per-lane freeze: converged or stalled lanes take zero-length steps;
//   * stall patience and return-best per lane;
//   * one matvec per iteration; every 100th iteration spends it on A@x and
//     replaces r by the true residual b - A x, for frozen lanes too (this
//     can reactivate a lane);
//   * ONE iteration counter shared by the lanes of a lockstep chunk,
//     reported for every lane of it;
//   * every division guarded by tiny = 1e-30.
// (The zero-RHS rule lives in the Python wrapper, as in the JAX package.)
//
// What bounds it on the H100: not bytes or flops (one RBC2D solve is ~6k
// cells, some 100k flops per iteration, a few hundred iterations) but the
// latency of the iteration chain: three dependent passes over the field and
// three block-wide reductions per iteration.  The design answers that the
// simple way: one thread block carries a lockstep chunk of lanes, so the
// loop, the dot products and the stopping test stay on the device with no
// host round-trip and no grid-wide synchronisation; the working set (x, r,
// p, Av, best, coefficients: ~0.3 MB per 6k-cell lane) stays in the 50 MB
// L2.  A batch of lanes is one launch of a grid of chunks
// (krylov.cuh fg_chunk; the TPU ran its chunks one after another, lax.map
// in cg_pallas.py `_lane_solver`): with one lane per block, a batch of up
// to 132 lanes runs side by side on the SMs and costs its slowest lane.
// One lane on more SMs (clusters, distributed shared memory) is later work.
//
// K3-coarse (entry fg_cg_mb_coarse_solve, the COARSE arm of the template):
// replaces the strip-coarse form of cg_pallas_mb.py `_kernel` (`coarse=`,
// `apply_precond` :329-370), the two-level preconditioner of
// solver/coarse_strips.py.  At init and after every residual update, the
// refresh iteration included,
//   z = D^-1 r + W Einv W^T r        (per lane, before <r, z>)
// with W the piecewise-constant strips along each super-block's long axis
// and Einv = (E + eps I)^-1, E = W^T A W, computed by the wrapper on every
// call.  z needs a reduction over all of r first, so the pass that updates
// r stops at r, and per lane:
//   * restriction: one warp per strip over the strip's cell list (CSR,
//     built once per plan), lanes of the warp strided, then a butterfly
//     sum: a fixed order, no float atomics, the same bits on every run;
//   * coarse solve: thread k forms row k of Einv rc, reading Einv from
//     global memory in transposed layout (coalesced; 14 KB per lane at
//     K = 59, which stays in L2);
//   * prolongation, fused into the pass that forms z (stored in q, free
//     until the next matvec) and the <r,z>, <r,r> sums, through a per-cell
//     coarse index (-1 outside every strip space).
// It costs one more pass over r (the restriction) and three more block
// barriers per iteration; the next pass reads z from q instead of forming
// it again.  K is capped at FG_MAX_K (shared memory); the entry refuses
// more.  The flip form (K3-coarse-flip) needs nothing more: the neighbour
// table carries the reflected seams, and E the flipped seam couplings.
#include "krylov.cuh"

#define FG_MAX_K 128

// The strip-coarse space of K3's coarse arm (unused when COARSE is false).
struct FgCoarse {
  const float* einv_t;     // (1|lanes, K, K), transposed: [j * K + k] = Einv[k][j]
  const int* strip_ptr;    // (K + 1): strip k owns strip_cells[ptr[k]:ptr[k+1]]
  const int* strip_cells;  // flat cell indices, ascending within a strip
  const int* cidx;         // (n): strip of each cell, -1 outside every space
  int K;
  int per_lane;            // einv_t has one matrix per lane
};

// z = M^-1 r for one lane (Jacobi + strip-coarse), written to `dst`; every
// thread returns <r, z> in a1 and <r, r> in a2.  Must be reached by all
// threads, after a barrier that publishes r.
__device__ __forceinline__ void fg_coarse_precond(
    const float* __restrict__ r, const float* __restrict__ dg,
    float* __restrict__ dst, int n, const FgCoarse& cz, int l,
    int precondition, float* s_rc, float* s_xc, float* sh, float& a1,
    float& a2) {
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int wl = tid & 31;
  const int nw = T >> 5;
  const int K = cz.K;
  for (int k = tid >> 5; k < K; k += nw) {
    float s = 0.0f;
    for (int i = cz.strip_ptr[k] + wl; i < cz.strip_ptr[k + 1]; i += 32)
      s += r[cz.strip_cells[i]];
    s = fg_warp_sum(s);
    if (wl == 0) s_rc[k] = s;
  }
  __syncthreads();
  const float* et = cz.einv_t + (size_t)l * K * K * cz.per_lane;
  for (int k = tid; k < K; k += T) {
    float s = 0.0f;
    for (int j = 0; j < K; ++j) s = s + et[j * K + k] * s_rc[j];
    s_xc[k] = s;
  }
  __syncthreads();
  a1 = 0.0f;
  a2 = 0.0f;
  for (int c = tid; c < n; c += T) {
    const float rr = r[c];
    float zz = precondition ? (1.0f / dg[c]) * rr : rr;
    const int ci = cz.cidx[c];
    if (ci >= 0) zz = zz + s_xc[ci];
    dst[c] = zz;
    a1 += rr * zz;
    a2 += rr * rr;
  }
  fg_block_sum2(a1, a2, sh);
}

template <int ND, bool TABLE, bool COARSE>
__global__ void __launch_bounds__(FG_THREADS)
fg_cg_kernel(const float* __restrict__ b, const float* __restrict__ diag,
             const float* __restrict__ off, const int* __restrict__ nbr,
             const float* __restrict__ x0,
             float* __restrict__ x, int* __restrict__ iters_out,
             float* __restrict__ rs_out, float* __restrict__ r,
             float* __restrict__ p, float* __restrict__ q,
             float* __restrict__ best, int lanes, int chunk, FgGrid g,
             int op_per_lane, float tol2, int maxiter, int stall_iters,
             int precondition, int return_best, int warm_start, FgCoarse cz) {
  __shared__ float sh[64];
  __shared__ float s_rc[COARSE ? FG_MAX_K : 1], s_xc[COARSE ? FG_MAX_K : 1];
  __shared__ float s_rz[FG_MAX_LANES], s_rs[FG_MAX_LANES];
  __shared__ float s_best_rs[FG_MAX_LANES];
  __shared__ float s_alpha[FG_MAX_LANES], s_beta[FG_MAX_LANES];
  __shared__ float s_red1[FG_MAX_LANES], s_red2[FG_MAX_LANES];
  __shared__ int s_best_it[FG_MAX_LANES], s_done[FG_MAX_LANES];
  __shared__ int s_better[FG_MAX_LANES];
  __shared__ int s_go;

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int n = g.n;
  const int nf = 2 * ND;

  // this block's chunk of lanes: every per-lane pointer starts at its first
  const int l0 = fg_chunk(lanes, chunk);
  const size_t lo = (size_t)l0 * n;
  b += lo;
  x0 += lo;
  x += lo;
  r += lo;
  p += lo;
  q += lo;
  best += lo;
  diag += lo * op_per_lane;
  off += lo * nf * op_per_lane;
  iters_out += l0;
  rs_out += l0;
  if (COARSE) cz.einv_t += (size_t)l0 * cz.K * cz.K * cz.per_lane;

  // ---- init: r = b - A x0 (or b), z = M^-1 r, p = z, best = x ----------
  for (int l = 0; l < lanes; ++l) {
    const float* dg = diag + (size_t)l * n * op_per_lane;
    const float* of = off + (size_t)l * nf * n * op_per_lane;
    const size_t o = (size_t)l * n;
    float a1 = 0.0f, a2 = 0.0f;
    for (int c = tid; c < n; c += T) {
      float rr, xx;
      if (warm_start) {
        xx = x0[o + c];
        rr = b[o + c] - fg_apply<ND, TABLE>(dg, of, nbr, x0 + o, c, g);
      } else {
        xx = 0.0f;
        rr = b[o + c];
      }
      x[o + c] = xx;
      best[o + c] = xx;
      r[o + c] = rr;
      if (!COARSE) {
        const float zz = precondition ? (1.0f / dg[c]) * rr : rr;
        p[o + c] = zz;
        a1 += rr * zz;
        a2 += rr * rr;
      }
    }
    if (COARSE) {
      __syncthreads();  // r of this lane is complete
      fg_coarse_precond(r + o, dg, p + o, n, cz, l, precondition, s_rc, s_xc,
                        sh, a1, a2);
    } else {
      fg_block_sum2(a1, a2, sh);
    }
    if (tid == 0) {
      s_rz[l] = a1;
      s_rs[l] = a2;
      s_best_rs[l] = a2;
      s_best_it[l] = 0;
    }
  }

  int it = 0;
  for (;;) {
    __syncthreads();
    if (tid == 0) {
      int any = 0;
      for (int l = 0; l < lanes; ++l) {
        const int stalled = (it - s_best_it[l]) >= stall_iters;
        any |= (s_rs[l] > tol2) && !stalled;
        // a NaN residual counts as frozen: it never holds its chunk
        s_done[l] = !(s_rs[l] > tol2) || stalled;
      }
      s_go = (it < maxiter) && any;
    }
    __syncthreads();
    if (!s_go) break;
    const int recompute = ((it + 1) % 100) == 0;

    // ---- pass A: q = A (recompute ? x : p), denom = <p, q> --------------
    for (int l = 0; l < lanes; ++l) {
      const float* dg = diag + (size_t)l * n * op_per_lane;
      const float* of = off + (size_t)l * nf * n * op_per_lane;
      const size_t o = (size_t)l * n;
      const float* src = (recompute ? x : p) + o;
      float a1 = 0.0f, a2 = 0.0f;
      for (int c = tid; c < n; c += T) {
        const float av = fg_apply<ND, TABLE>(dg, of, nbr, src, c, g);
        q[o + c] = av;
        a1 += p[o + c] * av;
      }
      fg_block_sum2(a1, a2, sh);
      if (tid == 0) s_red1[l] = a1;
    }
    __syncthreads();
    for (int l = tid; l < lanes; l += T) {
      s_alpha[l] = (s_done[l] || recompute)
                         ? 0.0f
                         : s_rz[l] / fg_guard(s_red1[l]);
    }
    __syncthreads();

    // ---- pass B: x += alpha p; r update or refresh; <r,z>, <r,r> --------
    // (COARSE: the pass stops at r; z = M^-1 r goes to q, free until the
    // next matvec, and the sums come from fg_coarse_precond)
    for (int l = 0; l < lanes; ++l) {
      const float* dg = diag + (size_t)l * n * op_per_lane;
      const size_t o = (size_t)l * n;
      const float al = s_alpha[l];
      float a1 = 0.0f, a2 = 0.0f;
      for (int c = tid; c < n; c += T) {
        x[o + c] = x[o + c] + al * p[o + c];
        const float rr =
            recompute ? b[o + c] - q[o + c] : r[o + c] - al * q[o + c];
        r[o + c] = rr;
        if (!COARSE) {
          const float zz = precondition ? (1.0f / dg[c]) * rr : rr;
          a1 += rr * zz;
          a2 += rr * rr;
        }
      }
      if (COARSE) {
        __syncthreads();  // r of this lane is complete
        fg_coarse_precond(r + o, dg, q + o, n, cz, l, precondition, s_rc,
                          s_xc, sh, a1, a2);
      } else {
        fg_block_sum2(a1, a2, sh);
      }
      if (tid == 0) {
        s_red1[l] = a1;
        s_red2[l] = a2;
      }
    }
    __syncthreads();
    for (int l = tid; l < lanes; l += T) {
      const float rz_new = s_red1[l], rs_new = s_red2[l];
      s_beta[l] = s_done[l] ? 0.0f : rz_new / fg_guard(s_rz[l]);
      const int better = (rs_new < s_best_rs[l]) && !s_done[l];
      s_better[l] = better;
      if (better) {
        s_best_rs[l] = rs_new;
        s_best_it[l] = it + 1;
      }
      s_rz[l] = rz_new;
      s_rs[l] = rs_new;
    }
    __syncthreads();

    // ---- pass C: p = z + beta p; best = x where better ------------------
    for (int l = 0; l < lanes; ++l) {
      const float* dg = diag + (size_t)l * n * op_per_lane;
      const size_t o = (size_t)l * n;
      const float be = s_beta[l];
      const int keep = return_best && s_better[l];
      for (int c = tid; c < n; c += T) {
        float zz;
        if (COARSE) {
          zz = q[o + c];
        } else {
          const float rr = r[o + c];
          zz = precondition ? (1.0f / dg[c]) * rr : rr;
        }
        p[o + c] = zz + be * p[o + c];
        if (keep) best[o + c] = x[o + c];
      }
    }
    ++it;
  }

  // ---- finish: return-best, per-lane stats ------------------------------
  for (int l = 0; l < lanes; ++l) {
    const size_t o = (size_t)l * n;
    const int use_best = return_best && !(s_rs[l] <= tol2);
    if (use_best) {
      for (int c = tid; c < n; c += T) x[o + c] = best[o + c];
    }
    if (tid == 0) {
      iters_out[l] = it;
      rs_out[l] = use_best ? s_best_rs[l] : s_rs[l];
    }
  }
}

extern "C" int fg_cg_solve(const float* b, const float* diag, const float* off,
                           const float* x0, float* x, int* iters, float* rs,
                           float* r, float* p, float* q, float* best,
                           int lanes, int chunk, int nz, int ny, int nx,
                           int ndims, int op_per_lane, float tol2, int maxiter,
                           int stall_iters, int precondition, int return_best,
                           int warm_start, void* stream) {
  const int blocks = fg_chunk_blocks(lanes, chunk);
  if (blocks == 0 || (ndims != 2 && ndims != 3))
    return (int)cudaErrorInvalidValue;
  FgGrid g;
  g.nz = nz;
  g.ny = ny;
  g.nx = nx;
  g.n = nz * ny * nx;
  cudaStream_t s = (cudaStream_t)stream;
  if (ndims == 2) {
    fg_cg_kernel<2, false, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nullptr, x0, x, iters, rs, r, p, q, best, lanes, chunk,
        g, op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
        warm_start, FgCoarse{});
  } else {
    fg_cg_kernel<3, false, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nullptr, x0, x, iters, rs, r, p, q, best, lanes, chunk,
        g, op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
        warm_start, FgCoarse{});
  }
  return (int)cudaGetLastError();
}

// K3: the same solve over the merged super-block frame of a multi-block
// domain (replaces cg_pallas_mb.py `_kernel`, entry `fused_cg_mb`): every
// lane is one flat buffer of n cells holding all super-blocks, the matvec
// goes through the plan's neighbour table (merged.cuh), so every dot
// product is joint over the super-blocks.  Semantics as K1 above.
extern "C" int fg_cg_mb_solve(const float* b, const float* diag,
                              const float* off, const int* nbr,
                              const float* x0, float* x, int* iters, float* rs,
                              float* r, float* p, float* q, float* best,
                              int lanes, int chunk, int n, int ndims,
                              int op_per_lane, float tol2, int maxiter,
                              int stall_iters, int precondition,
                              int return_best, int warm_start, void* stream) {
  const int blocks = fg_chunk_blocks(lanes, chunk);
  if (blocks == 0 || (ndims != 2 && ndims != 3) || nbr == nullptr)
    return (int)cudaErrorInvalidValue;
  FgGrid g;
  g.nz = 1;
  g.ny = 1;
  g.nx = n;
  g.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  if (ndims == 2) {
    fg_cg_kernel<2, true, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, lanes, chunk,
        g, op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
        warm_start, FgCoarse{});
  } else {
    fg_cg_kernel<3, true, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, lanes, chunk,
        g, op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
        warm_start, FgCoarse{});
  }
  return (int)cudaGetLastError();
}

// K3-coarse: K3 with the strip-coarse preconditioner (see the note at the
// top of this file), 2D plans only (the strip plan is None in 3D, as in the
// JAX package).  Returns cudaErrorInvalidValue when K exceeds FG_MAX_K.
extern "C" int fg_cg_mb_coarse_solve(
    const float* b, const float* diag, const float* off, const int* nbr,
    const float* x0, float* x, int* iters, float* rs, float* r, float* p,
    float* q, float* best, const float* einv_t, const int* strip_ptr,
    const int* strip_cells, const int* cidx, int lanes, int chunk, int n,
    int ndims, int op_per_lane, int K, float tol2, int maxiter, int stall_iters,
    int precondition, int return_best, int warm_start, void* stream) {
  const int blocks = fg_chunk_blocks(lanes, chunk);
  if (blocks == 0 || ndims != 2 || nbr == nullptr || K < 1 || K > FG_MAX_K)
    return (int)cudaErrorInvalidValue;
  FgGrid g;
  g.nz = 1;
  g.ny = 1;
  g.nx = n;
  g.n = n;
  FgCoarse cz;
  cz.einv_t = einv_t;
  cz.strip_ptr = strip_ptr;
  cz.strip_cells = strip_cells;
  cz.cidx = cidx;
  cz.K = K;
  cz.per_lane = op_per_lane;
  fg_cg_kernel<2, true, true><<<blocks, FG_THREADS, 0, (cudaStream_t)stream>>>(
      b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, lanes, chunk, g,
      op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
      warm_start, cz);
  return (int)cudaGetLastError();
}
