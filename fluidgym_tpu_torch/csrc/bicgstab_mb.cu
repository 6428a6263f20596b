// K2: the whole right-Jacobi-preconditioned BiCGStab solve in one launch,
// over the merged super-block frame, for a lockstep batch of lanes.
//
// Replaces fluidgym_tpu/ops/cg_pallas_mb.py `_kernel_bicg` (entry
// `fused_bicgstab_mb`) in both of its forms: the single super-block of
// `block_merge.trivial_plan` (one grid, roll-form matvec: entry
// fg_bicgstab_solve) and the merged multi-super-block form of
// `block_merge.merge_plan` with identity seams (one flat buffer per lane,
// neighbour-table matvec, merged.cuh: entry fg_bicgstab_mb_solve), whose
// seams may be flip seams (the reflected C-grid cut): the neighbour table
// carries them, so the body is the same.  Solve components (the velocity
// components of the joint advection solve) and batch entries are lanes
// sharing one operator.  Semantics are the TPU
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
// dependent passes, two of them stencil applies, and three reductions per
// iteration), not bytes or flops.  The design keeps the loop, the dot
// products and the stopping test of a chunk on the device, with no host
// round-trip; the scratch (r/s, r_hat, p, p_hat, v, s_hat, t, best) stays
// in L2.  In the chunk grid (cluster = 1) one thread block carries a chunk
// of lanes, so one lane runs on one SM: 1.3 ms for a 7-iteration airfoil
// velocity solve whose passes would stream through HBM in ~40 us.  The
// cluster arm (merged form, cluster = C in 2, 4, 8, 16, one lane per
// cluster) spreads a lane over C SMs as K3's does (see cg.cu): each block
// owns a range and keeps its operator rows in shared memory, and every sum
// is the one-block form's, bit for bit (krylov.cuh fg_lane_sum2), so the
// arm computes what a one-lane launch of the chunk grid computes.  Cluster
// barriers (release/acquire) close the init and pass 5 (pass 1 gathers
// p_hat) and pass 2 (pass 3 gathers s_hat); with two per sum that is eight
// per iteration.
//
// The resident arm (trivial plan, template RESIDENT; entry
// fg_bicgstab_solve with resident = 1, chunk 1), as K1's (see cg.cu): the
// chunk grid's one SM is bound by its traffic through L2, and an RBC2D
// lane fits one SM.  The block stages its lane's diag and off rows
// (117 KB) and keeps four of the eight vectors in shared memory (94 KB):
// the two a matvec gathers (p_hat, s_hat) and the two own-cell vectors
// read most (r: six accesses per cell-iteration; v: three).  x, r_hat, p,
// t and best stay in global memory (L2).  The arithmetic and the sums are
// the chunk grid's, so it returns the same bits.  (Unlike K1's arm it
// divides by diag on every pass: with its eight vectors' pointers live,
// 1 / diag in registers did not fit 64 registers without spills.)  As in
// cg.cu, thread 0 updates a lane's scalars right after the lane's sum.
//
// The spread arm (trivial plan, template SPREAD; entry fg_bicgstab_solve
// with spread = G, chunk 1), as K1's (see cg.cu): one lane over G
// co-resident blocks, rows from L2, the one-block form's sums.  Its lane
// barriers close the loop's top (pass 1 gathers p_hat), pass 2 (pass 3
// gathers s_hat) and each of the three sums: five per iteration in the
// chains layout, eight in the range layout.  RBC3D's velocity solve (3
// lanes) takes G = 32, its temperature solve G = 128.  The merged form
// over a 3D plan (entry fg_bicgstab_mb_solve with spread = G) takes the
// same arm with the neighbour-table matvec, the table read from L2:
// CylinderJet3D's velocity solve (3 lanes) at G = 32.
#include "krylov.cuh"

// one 1024-thread block per SM: see fg_cg_kernel's launch bounds; SPREAD
// as there
template <int ND, bool TABLE, bool CLUSTER = false, bool RESIDENT = false,
          int SPREAD = 0>
__global__ void __launch_bounds__(FG_THREADS, 1)
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
               int precondition, int return_best, int warm_start,
               FgSpread sp) {
  static_assert(!CLUSTER || TABLE, "cluster arm: K2-mb only");
  static_assert(!RESIDENT || (ND == 2 && !TABLE && !CLUSTER),
                "resident arm: K2 over the trivial plan, in 2D only");
  static_assert(!SPREAD || (!CLUSTER && !RESIDENT && (!TABLE || ND == 3)),
                "spread arm: K2 over the trivial plan, and over a 3D merged "
                "plan");
  static_assert(SPREAD != FG_ARM_RING || (TABLE && ND == 3),
                "the ring: K2-mb over a 3D plan");
  constexpr int ARM = SPREAD    ? SPREAD
                     : CLUSTER ? FG_ARM_CLUSTER
                               : FG_ARM_BLOCK;
  // the spread arm reads the vectors other blocks write through L2
  constexpr bool CG = SPREAD != 0;
  __shared__ float sh[64];
  __shared__ float s_rho[FG_MAX_LANES], s_rs[FG_MAX_LANES];
  __shared__ float s_best_rs[FG_MAX_LANES];
  __shared__ float s_alpha[FG_MAX_LANES], s_omega[FG_MAX_LANES];
  __shared__ float s_beta[FG_MAX_LANES];
  __shared__ int s_best_it[FG_MAX_LANES], s_done[FG_MAX_LANES];
  __shared__ int s_better[FG_MAX_LANES];
  __shared__ float2 s_chain[CLUSTER ? FG_THREADS / 2 : 1];  // fg_lane_sum2
  extern __shared__ __align__(16) float s_rows[];  // staged operator rows

  const int tid = threadIdx.x;
  const int n = g.n;
  const int nf = 2 * ND;

  // this block's lanes and cells (krylov.cuh fg_lane_init)
  FgLane L;
  const int l0 = fg_lane_init<ARM>(L, lanes, chunk, n, sp);
  const bool lead = tid == 0 && L.rank == 0;  // writes the lane stats
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

  FgRows staged{};
  if constexpr (CLUSTER) {
    staged = fg_stage_rows<ND>(diag, off, nbr, n, L.c0, L.c1, L.c1 - L.c0,
                               s_rows);
    L.buf = fg_chain_buf(s_rows, n, fg_lane_blocks<ARM>(sp), ND);
    L.slot = s_chain;
    __syncthreads();
  }
  // the chain terms alone, or the ring's tiles
  if constexpr (SPREAD) L.buf = s_rows;
  // the resident arm (one lane, chunk 1): the lane's rows, the two gathered
  // vectors p_hat and s_hat, and r and v (the own-cell vectors read most)
  // in shared memory for the whole solve
  if constexpr (RESIDENT) {
    staged = fg_stage_rows<ND, false>(diag, off, nullptr, n, 0, n, n, s_rows);
    float* w = fg_resident_vecs(s_rows, n, ND);
    phat = w;
    shat = w + n;
    r = w + 2 * n;
    v = w + 3 * n;
    __syncthreads();
  }
  // the operator rows of lane l
  auto rows = [&](int l) {
    if constexpr (CLUSTER || RESIDENT) return staged;
    else
      return FgRows{diag + (size_t)l * n * op_per_lane,
                    off + (size_t)l * nf * n * op_per_lane, nbr, n, 0};
  };

  // ---- init: r = r_hat = p = b - A x0 (or b); best = x ------------------
  for (int l = 0; l < lanes; ++l) {
    const FgRows R = rows(l);
    const size_t o = (size_t)l * n;
    float a1 = 0.0f, a2 = 0.0f;
    fg_sum_cells<ARM, false, 1>(L, sp, n, [&](int c, int, int e) {
      float rr, xx;
      if (warm_start) {
        xx = x0[o + c];
        rr = b[o + c] - fg_apply<ND, TABLE, CG>(R, x0 + o, c, g);
      } else {
        xx = 0.0f;
        rr = b[o + c];
      }
      x[o + c] = xx;
      best[o + c] = xx;
      r[o + c] = rr;
      rhat[o + c] = rr;
      p[o + c] = rr;
      phat[o + c] = precondition ? (1.0f / R.dg[c - R.base]) * rr : rr;
      fg_put<ARM>(L, e, rr * rr, a1);
    });
    fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
      const float rr = __ldcg(r + o + c);
      u = rr * rr;
      w = 0.0f;
    });
    if (tid == 0) {
      s_rho[l] = a1;
      s_rs[l] = a1;
      s_best_rs[l] = a1;
      s_best_it[l] = 0;
    }
  }

  int it = 0;
  for (;;) {
    // several blocks per lane: publishes p_hat before pass 1 gathers it
    fg_lane_sync<ARM>(L, sp);
    // every thread reads the lanes' state and takes the same branch; thread
    // 0, which alone computes the lanes' scalars, keeps which are frozen
    // (as in cg.cu)
    int any = 0;
    for (int l = 0; l < lanes; ++l) {
      const int stalled = (it - s_best_it[l]) >= stall_iters;
      any |= (s_rs[l] > tol2) && !stalled;
      // a NaN residual counts as frozen: it never holds its chunk
      if (tid == 0) s_done[l] = !(s_rs[l] > tol2) || stalled;
    }
    if (!(it < maxiter && any)) break;

    // ---- pass 1: v = A p_hat, denom = <r_hat, v> -------------------------
    for (int l = 0; l < lanes; ++l) {
      const FgRows R = rows(l);
      const size_t o = (size_t)l * n;
      float a1 = 0.0f, a2 = 0.0f;
      fg_sum_cells<ARM, false, 1>(L, sp, n, [&](int c, int, int e) {
        const float vv = fg_apply<ND, TABLE, CG>(R, phat + o, c, g);
        v[o + c] = vv;
        fg_put<ARM>(L, e, rhat[o + c] * vv, a1);
      });
      fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
        u = __ldcg(rhat + o + c) * __ldcg(v + o + c);
        w = 0.0f;
      });
      if (tid == 0) s_alpha[l] = s_done[l] ? 0.0f : s_rho[l] / fg_guard(a1);
    }
    __syncthreads();

    // ---- pass 2: s = r - alpha v (kept in r), s_hat = M^-1 s -------------
    for (int l = 0; l < lanes; ++l) {
      const FgRows R = rows(l);
      const size_t o = (size_t)l * n;
      const float al = s_alpha[l];
      fg_cells<ARM, false>(L, sp, n, [&](int c, int, int) {
        const float ss = r[o + c] - al * v[o + c];
        r[o + c] = ss;
        shat[o + c] = precondition ? (1.0f / R.dg[c - R.base]) * ss : ss;
      });
    }
    // several blocks per lane: publishes s_hat before pass 3 gathers it
    fg_lane_sync<ARM>(L, sp);

    // ---- pass 3: t = A s_hat, <t, t>, <t, s> ------------------------------
    for (int l = 0; l < lanes; ++l) {
      const FgRows R = rows(l);
      const size_t o = (size_t)l * n;
      float a1 = 0.0f, a2 = 0.0f;
      fg_sum_cells<ARM, false, 2>(L, sp, n, [&](int c, int, int e) {
        const float tv = fg_apply<ND, TABLE, CG>(R, shat + o, c, g);
        t[o + c] = tv;
        fg_put<ARM>(L, e, tv * tv, tv * r[o + c], a1, a2);
      });
      fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
        const float tv = __ldcg(t + o + c);
        u = tv * tv;
        w = tv * __ldcg(r + o + c);
      });
      if (tid == 0) s_omega[l] = s_done[l] ? 0.0f : a2 / fg_guard(a1);
    }
    __syncthreads();

    // ---- pass 4: x += alpha p_hat + omega s_hat; r = s - omega t ----------
    for (int l = 0; l < lanes; ++l) {
      const size_t o = (size_t)l * n;
      const float al = s_alpha[l], om = s_omega[l];
      float a1 = 0.0f, a2 = 0.0f;
      fg_sum_cells<ARM, false, 2>(L, sp, n, [&](int c, int, int e) {
        x[o + c] = x[o + c] + al * phat[o + c] + om * shat[o + c];
        const float rr = r[o + c] - om * t[o + c];
        r[o + c] = rr;
        fg_put<ARM>(L, e, rhat[o + c] * rr, rr * rr, a1, a2);
      });
      fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
        const float rr = __ldcg(r + o + c);
        u = __ldcg(rhat + o + c) * rr;
        w = rr * rr;
      });
      if (tid == 0) {
        const int done = s_done[l];
        const float rho_new = done ? s_rho[l] : a1;
        const float rs_new = done ? s_rs[l] : a2;
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
    }
    __syncthreads();

    // ---- pass 5: p = r + beta (p - omega v); p_hat; best -----------------
    for (int l = 0; l < lanes; ++l) {
      const FgRows R = rows(l);
      const size_t o = (size_t)l * n;
      const float be = s_beta[l], om = s_omega[l];
      const int keep = return_best && s_better[l];
      fg_cells<ARM, false>(L, sp, n, [&](int c, int, int) {
        const float pp = r[o + c] + be * (p[o + c] - om * v[o + c]);
        p[o + c] = pp;
        phat[o + c] = precondition ? (1.0f / R.dg[c - R.base]) * pp : pp;
        if (keep) best[o + c] = x[o + c];
      });
    }
    ++it;
  }

  for (int l = 0; l < lanes; ++l) {
    const size_t o = (size_t)l * n;
    const int use_best = return_best && !(s_rs[l] <= tol2);
    if (use_best)
      fg_cells<ARM, false>(L, sp, n,
                           [&](int c, int, int) { x[o + c] = best[o + c]; });
    if (lead) {
      iters_out[l] = it;
      rs_out[l] = use_best ? s_best_rs[l] : s_rs[l];
    }
  }
  // no block leaves while another may still read its shared memory (the
  // cluster arm) or the lane's chains (the spread arm)
  if constexpr (ARM != FG_ARM_BLOCK) fg_lane_sync<ARM>(L, sp);
}

// K2's entry over the trivial plan (one grid, roll-form matvec).
// `resident`, `spread`, `chains`, `bar` and `slot` as in cg.cu fg_cg_solve:
// the resident arm, the spread arm, or (both 0) the chunk grid.
using FgBicgKernel = decltype(&fg_bicg_kernel<2, true>);

static FgBicgKernel fg_bicg_roll_kernel(int ndims, int resident, int spread,
                                        int chains) {
  if (spread) {
    if (ndims == 3)
      return chains ? fg_bicg_kernel<3, false, false, false, FG_ARM_CHAINS>
                    : fg_bicg_kernel<3, false, false, false, FG_ARM_RANGE>;
    return fg_bicg_kernel<2, false, false, false, FG_ARM_CHAINS>;
  }
  if (ndims == 3) return fg_bicg_kernel<3, false>;
  return resident ? fg_bicg_kernel<2, false, false, true>
                  : fg_bicg_kernel<2, false>;
}

extern "C" int fg_bicgstab_solve(const float* b, const float* diag,
                                 const float* off, const float* x0, float* x,
                                 int* iters, float* rs, float* r, float* rhat,
                                 float* p, float* phat, float* v, float* shat,
                                 float* t, float* best, unsigned* bar,
                                 float* slot, int lanes, int chunk,
                                 int resident, int spread, int chains, int nz,
                                 int ny, int nx, int ndims, int op_per_lane,
                                 float tol2, int maxiter, int stall_iters,
                                 int precondition, int return_best,
                                 int warm_start, void* stream) {
  const FgGrid g = fg_grid(nz, ny, nx);
  if (!fg_roll_args_ok(lanes, chunk, resident, spread, chains, g.n, ndims,
                       bar, slot))
    return (int)cudaErrorInvalidValue;
  const FgBicgKernel k = fg_bicg_roll_kernel(ndims, resident, spread, chains);
  cudaStream_t s = (cudaStream_t)stream;
  const FgSpread sp{bar, reinterpret_cast<float2*>(slot), spread};
  if (spread)
    return (int)fg_launch_spread(
        k, lanes, spread, fg_spread_bytes(g.n, spread), bar, s, b, diag, off,
        nullptr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best, lanes,
        1, g, op_per_lane, tol2, maxiter, stall_iters, precondition,
        return_best, warm_start, sp);
  return (int)fg_launch_smem(
      k, fg_chunk_blocks(lanes, chunk),
      resident ? fg_resident_bytes(g.n, ndims) : 0, s, b, diag, off, nullptr,
      x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best, lanes, chunk, g,
      op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
      warm_start, sp);
}

// How many blocks of K2's spread arm the card holds at once, into *out (as
// cg.cu fg_cg_spread_capacity).
extern "C" int fg_bicgstab_spread_capacity(int ndims, int spread, int chains,
                                           int n, int* out) {
  if ((ndims != 2 && ndims != 3) || !fg_spread_ok(spread) ||
      !fg_spread_layout_ok(ndims, chains) ||
      chains == FG_CHAINS_RING)
    return (int)cudaErrorInvalidValue;
  return (int)fg_resident_blocks(
      fg_bicg_roll_kernel(ndims, 0, spread, chains),
      fg_spread_bytes(n, spread), out);
}

// K2 over the merged frame of a multi-block plan (S >= 2 super-blocks, seam
// fixups, identity or flip): each lane is one flat buffer of n cells, the
// matvec goes through the plan's neighbour table (merged.cuh) and every
// lane's dot products are joint over the super-blocks.  Semantics as above.
// `cluster`, `spread`, `chains`, `bar` and `slot` as in cg.cu
// fg_cg_mb_solve: 1 and 0 is the chunk grid, C in 2, 4, 8, 16 (chunk 1) the
// cluster arm, G in 32, 64, 128 (chunk 1, a 3D plan) the spread arm (its
// chain terms through the ring with `chains` = FG_CHAINS_RING: cg.cu).
static FgBicgKernel fg_bicg_cluster_kernel(int ndims) {
  return ndims == 2 ? fg_bicg_kernel<2, true, true>
                    : fg_bicg_kernel<3, true, true>;
}

static FgBicgKernel fg_bicg_mb_spread_kernel(int chains) {
  if (chains == FG_CHAINS_RING)
    return fg_bicg_kernel<3, true, false, false, FG_ARM_RING>;
  return chains ? fg_bicg_kernel<3, true, false, false, FG_ARM_CHAINS>
                : fg_bicg_kernel<3, true, false, false, FG_ARM_RANGE>;
}

extern "C" int fg_bicgstab_mb_solve(const float* b, const float* diag,
                                    const float* off, const int* nbr,
                                    const float* x0, float* x, int* iters,
                                    float* rs, float* r, float* rhat, float* p,
                                    float* phat, float* v, float* shat,
                                    float* t, float* best, unsigned* bar,
                                    float* slot, int lanes, int chunk,
                                    int cluster, int spread, int chains, int n,
                                    int ndims, int op_per_lane, float tol2,
                                    int maxiter, int stall_iters,
                                    int precondition, int return_best,
                                    int warm_start, void* stream) {
  if (!fg_merged_args_ok(lanes, chunk, cluster, spread, chains, ndims, nbr,
                         bar, slot))
    return (int)cudaErrorInvalidValue;
  const int blocks = fg_chunk_blocks(lanes, chunk);
  const FgGrid g = fg_grid(1, 1, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (spread)
    return (int)fg_launch_spread(
        fg_bicg_mb_spread_kernel(chains), lanes, spread,
        fg_spread_smem(n, spread, chains), bar, s, b, diag, off, nbr, x0, x,
        iters, rs, r, rhat, p, phat, v, shat, t, best, lanes, 1, g,
        op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
        warm_start, FgSpread{bar, reinterpret_cast<float2*>(slot), spread});
  if (cluster > 1) {
    return (int)fg_launch_clusters(
        fg_bicg_cluster_kernel(ndims), lanes, cluster,
        fg_stage_bytes(n, cluster, ndims), s, b,
        diag, off, nbr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best,
        lanes, 1, g, op_per_lane, tol2, maxiter, stall_iters, precondition,
        return_best, warm_start, FgSpread{});
  }
  if (ndims == 2) {
    fg_bicg_kernel<2, true><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best,
        lanes, chunk, g, op_per_lane, tol2, maxiter, stall_iters, precondition,
        return_best, warm_start, FgSpread{});
  } else {
    fg_bicg_kernel<3, true><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, rhat, p, phat, v, shat, t, best,
        lanes, chunk, g, op_per_lane, tol2, maxiter, stall_iters, precondition,
        return_best, warm_start, FgSpread{});
  }
  return (int)cudaGetLastError();
}

// How many blocks of K2-mb's spread arm (a 3D plan) the card holds at once,
// into *out (as cg.cu fg_cg_mb_spread_capacity).
extern "C" int fg_bicgstab_mb_spread_capacity(int ndims, int spread,
                                              int chains, int n, int* out) {
  if (ndims != 3 || !fg_spread_ok(spread) ||
      !fg_spread_layout_ok(ndims, chains))
    return (int)cudaErrorInvalidValue;
  return (int)fg_resident_blocks(fg_bicg_mb_spread_kernel(chains),
                                 fg_spread_smem(n, spread, chains), out);
}

// How many C-block clusters of K2-mb's cluster arm the card holds at once,
// into *out (as fg_cg_mb_cluster_occupancy).
extern "C" int fg_bicgstab_mb_cluster_occupancy(int ndims, int cluster,
                                                int n, int* out) {
  if ((ndims != 2 && ndims != 3) || cluster < 2 || !fg_cluster_ok(cluster, 1))
    return (int)cudaErrorInvalidValue;
  return (int)fg_max_clusters(fg_bicg_cluster_kernel(ndims), cluster,
                              fg_stage_bytes(n, cluster, ndims), out);
}
