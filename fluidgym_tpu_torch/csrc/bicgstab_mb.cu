// K2: the whole right-Jacobi-preconditioned BiCGStab solve in one launch,
// over the merged super-block frame, for a lockstep batch of lanes.
//
// Replaces fluidgym_tpu/ops/cg_pallas_mb.py `_kernel_bicg` (entry
// `fused_bicgstab_mb`) in both of its forms: the single super-block of
// `block_merge.trivial_plan` (one grid, roll-form matvec: entry
// fg_bicgstab_solve) and the merged multi-super-block form of
// `block_merge.merge_plan` with identity seams (one flat buffer per lane,
// neighbour-table matvec, merged.cuh: entry fg_bicgstab_mb_solve).  Flip
// seams (C-grid cuts) are not taken: the wrapper raises for them.  Solve
// components (the velocity components of the joint advection solve) and
// batch entries are lanes sharing one operator.  Semantics are the TPU
// kernel's, lane for lane:
//   * NORM2_NORMALIZED stopping PER LANE (sum r^2 <= tol^2 * n_lane, n_lane
//     the cells of all super-blocks), which is tighter than
//     linsolve.bicgstab's joint test over all components;
//   * every dot product joint over the super-blocks of a lane;
//   * RIGHT Jacobi preconditioning (r stays the true residual), warm start;
//   * per-lane freeze (alpha = omega = beta = 0, rho and rs held), stall
//     patience, return-best; no residual refresh;
//   * ONE iteration counter shared by the lanes of a lockstep chunk (one
//     thread block each, krylov.cuh fg_chunk), all chunks in one launch;
//   * every division guarded by tiny = 1e-30.
//
// What bounds it on the H100: the latency of the iteration chain (five
// dependent passes, two of them stencil applies, and three block-wide
// reductions per iteration over a 6k-14k-cell lane), not bytes or flops.  The
// design keeps the loop, the dot products and the stopping test of a chunk
// on the device in one thread block, with no host round-trip and no
// grid-wide synchronisation; the scratch (r/s, r_hat, p, p_hat, v, s_hat,
// t, best) stays in L2.
#include "krylov.cuh"

template <int ND, bool TABLE>
__global__ void __launch_bounds__(FG_THREADS)
fg_bicg_kernel(const float* __restrict__ b, const float* __restrict__ diag,
               const float* __restrict__ off, const int* __restrict__ nbr,
               const float* __restrict__ x0,
               float* __restrict__ x, int* __restrict__ iters_out,
               float* __restrict__ rs_out, float* __restrict__ r,
               float* __restrict__ rhat, float* __restrict__ p,
               float* __restrict__ phat, float* __restrict__ v,
               float* __restrict__ shat, float* __restrict__ t,
               float* __restrict__ best, int lanes, int chunk, FgGrid g,
               int op_per_lane, float tol2, int maxiter, int stall_iters,
               int precondition, int return_best, int warm_start) {
  __shared__ float sh[64];
  __shared__ float s_rho[FG_MAX_LANES], s_rs[FG_MAX_LANES];
  __shared__ float s_best_rs[FG_MAX_LANES];
  __shared__ float s_alpha[FG_MAX_LANES], s_omega[FG_MAX_LANES];
  __shared__ float s_beta[FG_MAX_LANES];
  __shared__ float s_red1[FG_MAX_LANES], s_red2[FG_MAX_LANES];
  __shared__ int s_best_it[FG_MAX_LANES], s_done[FG_MAX_LANES];
  __shared__ int s_better[FG_MAX_LANES];
  __shared__ int s_go;

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int n = g.n;
  const int nf = 2 * ND;

  // this block's chunk of lanes (krylov.cuh fg_chunk)
  const int l0 = fg_chunk(lanes, chunk);
  const size_t lo = (size_t)l0 * n;
  b += lo;
  x0 += lo;
  x += lo;
  r += lo;
  rhat += lo;
  p += lo;
  phat += lo;
  v += lo;
  shat += lo;
  t += lo;
  best += lo;
  diag += lo * op_per_lane;
  off += lo * nf * op_per_lane;
  iters_out += l0;
  rs_out += l0;

  // ---- init: r = r_hat = p = b - A x0 (or b); best = x ------------------
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
      rhat[o + c] = rr;
      p[o + c] = rr;
      phat[o + c] = precondition ? (1.0f / dg[c]) * rr : rr;
      a1 += rr * rr;
    }
    fg_block_sum2(a1, a2, sh);
    if (tid == 0) {
      s_rho[l] = a1;
      s_rs[l] = a1;
      s_best_rs[l] = a1;
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

    // ---- pass 1: v = A p_hat, denom = <r_hat, v> -------------------------
    for (int l = 0; l < lanes; ++l) {
      const float* dg = diag + (size_t)l * n * op_per_lane;
      const float* of = off + (size_t)l * nf * n * op_per_lane;
      const size_t o = (size_t)l * n;
      float a1 = 0.0f, a2 = 0.0f;
      for (int c = tid; c < n; c += T) {
        const float vv = fg_apply<ND, TABLE>(dg, of, nbr, phat + o, c, g);
        v[o + c] = vv;
        a1 += rhat[o + c] * vv;
      }
      fg_block_sum2(a1, a2, sh);
      if (tid == 0) s_red1[l] = a1;
    }
    __syncthreads();
    for (int l = tid; l < lanes; l += T) {
      s_alpha[l] = s_done[l] ? 0.0f : s_rho[l] / fg_guard(s_red1[l]);
    }
    __syncthreads();

    // ---- pass 2: s = r - alpha v (kept in r), s_hat = M^-1 s -------------
    for (int l = 0; l < lanes; ++l) {
      const float* dg = diag + (size_t)l * n * op_per_lane;
      const size_t o = (size_t)l * n;
      const float al = s_alpha[l];
      for (int c = tid; c < n; c += T) {
        const float ss = r[o + c] - al * v[o + c];
        r[o + c] = ss;
        shat[o + c] = precondition ? (1.0f / dg[c]) * ss : ss;
      }
    }
    __syncthreads();

    // ---- pass 3: t = A s_hat, <t, t>, <t, s> ------------------------------
    for (int l = 0; l < lanes; ++l) {
      const float* dg = diag + (size_t)l * n * op_per_lane;
      const float* of = off + (size_t)l * nf * n * op_per_lane;
      const size_t o = (size_t)l * n;
      float a1 = 0.0f, a2 = 0.0f;
      for (int c = tid; c < n; c += T) {
        const float tv = fg_apply<ND, TABLE>(dg, of, nbr, shat + o, c, g);
        t[o + c] = tv;
        a1 += tv * tv;
        a2 += tv * r[o + c];
      }
      fg_block_sum2(a1, a2, sh);
      if (tid == 0) {
        s_red1[l] = a1;
        s_red2[l] = a2;
      }
    }
    __syncthreads();
    for (int l = tid; l < lanes; l += T) {
      s_omega[l] = s_done[l] ? 0.0f : s_red2[l] / fg_guard(s_red1[l]);
    }
    __syncthreads();

    // ---- pass 4: x += alpha p_hat + omega s_hat; r = s - omega t ----------
    for (int l = 0; l < lanes; ++l) {
      const size_t o = (size_t)l * n;
      const float al = s_alpha[l], om = s_omega[l];
      float a1 = 0.0f, a2 = 0.0f;
      for (int c = tid; c < n; c += T) {
        x[o + c] = x[o + c] + al * phat[o + c] + om * shat[o + c];
        const float rr = r[o + c] - om * t[o + c];
        r[o + c] = rr;
        a1 += rhat[o + c] * rr;
        a2 += rr * rr;
      }
      fg_block_sum2(a1, a2, sh);
      if (tid == 0) {
        s_red1[l] = a1;
        s_red2[l] = a2;
      }
    }
    __syncthreads();
    for (int l = tid; l < lanes; l += T) {
      const int done = s_done[l];
      const float rho_new = done ? s_rho[l] : s_red1[l];
      const float rs_new = done ? s_rs[l] : s_red2[l];
      s_beta[l] = done ? 0.0f
                       : (rho_new / fg_guard(s_rho[l])) *
                             (s_alpha[l] / fg_guard(s_omega[l]));
      const int better = (rs_new < s_best_rs[l]) && !done;
      s_better[l] = better;
      if (better) {
        s_best_rs[l] = rs_new;
        s_best_it[l] = it + 1;
      }
      s_rho[l] = rho_new;
      s_rs[l] = rs_new;
    }
    __syncthreads();

    // ---- pass 5: p = r + beta (p - omega v); p_hat; best -----------------
    for (int l = 0; l < lanes; ++l) {
      const float* dg = diag + (size_t)l * n * op_per_lane;
      const size_t o = (size_t)l * n;
      const float be = s_beta[l], om = s_omega[l];
      const int keep = return_best && s_better[l];
      for (int c = tid; c < n; c += T) {
        const float pp = r[o + c] + be * (p[o + c] - om * v[o + c]);
        p[o + c] = pp;
        phat[o + c] = precondition ? (1.0f / dg[c]) * pp : pp;
        if (keep) best[o + c] = x[o + c];
      }
    }
    ++it;
  }

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

extern "C" int fg_bicgstab_solve(const float* b, const float* diag,
                                 const float* off, const float* x0, float* x,
                                 int* iters, float* rs, float* r, float* rhat,
                                 float* p, float* phat, float* v, float* shat,
                                 float* t, float* best, int lanes, int chunk,
                                 int nz, int ny, int nx, int ndims,
                                 int op_per_lane,
                                 float tol2, int maxiter, int stall_iters,
                                 int precondition, int return_best,
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
    fg_bicg_kernel<2, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nullptr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t,
        best, lanes, chunk, g, op_per_lane, tol2, maxiter, stall_iters,
        precondition, return_best, warm_start);
  } else {
    fg_bicg_kernel<3, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nullptr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t,
        best, lanes, chunk, g, op_per_lane, tol2, maxiter, stall_iters,
        precondition, return_best, warm_start);
  }
  return (int)cudaGetLastError();
}

// K2 over the merged frame of a multi-block plan (S >= 2 super-blocks, seam
// fixups): each lane is one flat buffer of n cells, the matvec goes through
// the plan's neighbour table (merged.cuh) and every lane's dot products are
// joint over the super-blocks.  Semantics as above.
extern "C" int fg_bicgstab_mb_solve(const float* b, const float* diag,
                                    const float* off, const int* nbr,
                                    const float* x0, float* x, int* iters,
                                    float* rs, float* r, float* rhat, float* p,
                                    float* phat, float* v, float* shat,
                                    float* t, float* best, int lanes,
                                    int chunk, int n, int ndims,
                                    int op_per_lane, float tol2,
                                    int maxiter, int stall_iters,
                                    int precondition, int return_best,
                                    int warm_start, void* stream) {
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
    fg_bicg_kernel<2, true><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best,
        lanes, chunk, g, op_per_lane, tol2, maxiter, stall_iters, precondition,
        return_best, warm_start);
  } else {
    fg_bicg_kernel<3, true><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best,
        lanes, chunk, g, op_per_lane, tol2, maxiter, stall_iters, precondition,
        return_best, warm_start);
  }
  return (int)cudaGetLastError();
}
