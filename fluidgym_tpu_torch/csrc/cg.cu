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
//
// The resident arm of K1 (template RESIDENT; entry fg_cg_solve with
// resident = 1, chunk 1, 2D).  An RBC2D lane (5,856 cells) fits one SM
// whole, as the TPU kernel keeps x, r, p in VMEM: at init the block stages
// its lane's diag and off rows (117 KB) and keeps x, r, p, q (94 KB) in
// shared memory for the whole solve (krylov.cuh fg_resident_vecs), so a
// pass touches global memory only for b (init and refresh) and best.  On
// the H100 that alone took an RBC solve from 8.2 to 6.2 us per iteration
// (scripts/port_resident_ab.py --rev): the one-block form was bound less
// by its L2 traffic than by instruction issue and barriers.  So the arm
// also unrolls each thread's (at most 7) cells and keeps 1 / diag of them
// in registers, divided once per solve where the chunk grid divides twice
// per cell-iteration (fg_cells): 4.4 us per iteration; and every roll
// form's matvec divides its cell index by multiply-and-shift (krylov.cuh
// fg_div), which took the chunk grid from 10.2 to 8.2.  The thread -> cell
// map, the per-cell arithmetic and the sums are the chunk grid's, so the
// arm returns its x, iterations and residual bit for bit; no cluster
// barrier, no new reduction order.  ops/cg_cuda.py `default_resident`
// picks it by shape (chunk 1, a 2D lane whose bytes fit 227 KB less the
// static reserve); a lane that does not fit (RBC2D-wide's 11,712 cells,
// RBC3D) takes the spread arm below.
//
// The spread arm of K1 (template SPREAD; entry fg_cg_solve with spread = G
// in 32, 64, 128, chunk 1).  An RBC3D lane (167,936 or 671,744 cells, 7-30
// MB of rows and vectors) fits neither one SM nor a cluster's shared
// memory, and on one SM the chunk grid ran at ~1.5 ns per cell-iteration,
// bound by instruction issue (250 and 1,118 us per iteration).  So one lane
// runs on G blocks of one cooperative launch, one per SM, all resident at
// once (the launch is refused otherwise), the rows read from L2:
//   * block r takes its share of the cells with each pass's per-cell
//     arithmetic: the cells of its sum chains [r T/G, (r+1) T/G) (row k of
//     them the T/G cells from k T + r T/G; krylov.cuh FG_ARM_CHAINS), or
//     at G = 128 on big 3D lanes a contiguous range (FG_ARM_RANGE; ops/
//     cg_cuda.py `spread_chains` says why);
//   * every dot product is the one-block form's sum, bit for bit
//     (fg_lane_sum2): the chains layout puts each cell's terms in shared
//     memory as the pass computes them, one thread per chain adds them in
//     chain order, the chains go to global memory, and after a lane barrier
//     every block runs the same tree over all T of them;
//   * the barrier (fg_spread_sync) is a counter per lane in global memory:
//     release add, acquire spin, then the block's threads read the gathered
//     vectors, chain terms and chains with __ldcg (through L2, never a
//     read-only or stale L1 path); lanes do not wait on each other.  It
//     closes the loop's top (pass A gathers p) and each sum: three per
//     iteration in the chains layout, five in the range layout;
//   * thread 0 of every block computes the lanes' scalars from the same
//     bits, so every block takes the same branches; rank 0 writes the stats.
// So it returns the chunk grid's x, iterations and residual at any G.  The
// serial part is each chain: ceil(n / T) dependent adds per sum (164 at
// (64, 41, 64), 656 at (128, 41, 128)).
//
// K3 over a 3D merged plan (CylinderJet3D: 341,568 or 749,568 cells, whose
// rows no cluster's shared memory holds) takes the same spread arm (entry
// fg_cg_mb_solve with spread = G): the matvec goes through the neighbour
// table (merged.cuh), the rows and the table (13 words per cell) read from
// L2 with read-only loads, the gathered vector through L2 (fg_ld<true>).
// On one SM per lane (the chunk grid) its pass ran ~1.5 ns per cell, the
// issue of one SM's gathers; the arm spreads that issue over G SMs with
// the chunk grid's arithmetic and sums.
//
// In every form thread 0 updates a lane's scalars (alpha; beta, the best
// residual) right after the lane's sum, and every thread reads the lanes'
// state at the top of the loop to decide whether to go on: one barrier per
// pass besides the sums', where a second pass over the lanes needed two.
//
// The cluster arm of K3 (template CLUSTER; entry fg_cg_mb_solve with
// cluster = C in 2, 4, 8, 16): one block per lane bounds a single solve by
// what one SM of 132 pulls through its dependent gathers: ~130-150 us per
// iteration at the airfoil's 73,456 cells, where the same work streamed
// through HBM once per pass takes ~1.3 us.  So a lane is spread over a
// thread-block cluster of C blocks, one per SM (krylov.cuh):
//   * block r owns a contiguous range of the flat buffer (fg_block_cells)
//     and keeps each pass's arithmetic and per-cell order;
//   * it stages its range's diag, off and neighbour rows in shared memory
//     once per solve (fg_stage_rows), so a matvec reads only the gathered
//     vector from L2; a size whose rows do not fit is refused.  Plain loads
//     do it: each thread stages the rows it later reads, so no copy engine
//     or mbarrier is needed, and the copy is one pass against three per
//     iteration (a TMA bulk copy would also need the off / nbr face planes
//     16-B aligned, which a flat buffer of n cells does not give);
//   * a dot product is the one-block form's sum, bit for bit
//     (fg_lane_sum2): the blocks form its per-thread chains again from the
//     vectors in L2, each block a share of them, and every block runs the
//     same tree over all of them.  So the arm computes exactly what a
//     one-lane launch of the chunk grid computes (x, iterations, residual),
//     at any C, run after run;
//   * the barrier that closes pass C (and the init) is a cluster barrier
//     with release/acquire semantics (fg_cluster_sync): pass A gathers p
//     (x on a refresh) across ranges.  That and two per sum make five
//     cluster barriers per iteration;
//   * the kernel ends on a cluster barrier: no block leaves while another
//     may still read its shared memory.
// C = 1 is the chunk grid above, unchanged.  ops/cg_cuda_mb.py
// `default_cluster` picks C from the card's own occupancy answer
// (fg_cg_mb_cluster_occupancy; fg_cg_mb_coarse_cluster_occupancy for the
// COARSE instances below, K3-coarse's and K3-agg's, whose registers and
// shared memory are their own).
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
//
// On one SM per lane (the chunk grid) K3-coarse-flip runs ~115-125 us per
// iteration on the H100 at the airfoil's 73,456 cells, where Jacobi-only
// K3-flip on its cluster arm runs ~16-18.  So the COARSE instance has the
// cluster arm too (entry fg_cg_mb_coarse_solve with cluster = C in 2, 4,
// 8, 16): the passes, rows and sums as K3's above, and the preconditioner
// split so that every step keeps the one-block form's order
// (fg_coarse_precond<FG_ARM_CLUSTER>):
//   * a cluster barrier publishes r (a strip's cells span several ranges);
//   * restriction: strip k is summed by one warp of block k mod C, its
//     lanes strided by 32 over the strip's cells as in the one-block form,
//     r read through L2, then the same butterfly: the same bits whichever
//     block's warp sums it.  A strip is never split over warps;
//   * a cluster barrier, then every block gathers the K strip sums from
//     their owners' shared memory (distributed shared memory) and forms
//     Einv rc itself, thread k row k in the one-block order: every block
//     holds the same bits (K^2 <= 16,384 multiply-adds, Einv from L2);
//   * z for the block's own range, into q (p at init), from the staged
//     diag; <r, z> and <r, r> are fg_lane_sum2's, whose chains (cells t,
//     t + T, ...) are this loop's chains in the one-block form followed by
//     fg_block_sum2: the same bits.
// Seven cluster barriers per iteration: K3's five, r and the strip sums.
// So every C returns the chunk grid's x, iterations and residual; at C =
// 16 the airfoil's lane runs ~26 us per iteration.  What it spends beyond
// K3-flip's arm was mostly the serial gathers (one warp's pass over a
// strip, one thread's row of Einv), so each thread issues its loads
// FG_BATCH at a time, added in the same order.
//
// K3-agg (entry fg_cg_mb_agg_solve, the COARSE arm with AGG): the additive
// two-level preconditioner of the aggregation coarse space, which replaces
// no TPU kernel: the JAX package solves this system with linsolve.cg over
// the blocks and its aggregation coarse_fn (fluidgym_tpu/solver/piso.py
// `_agg_coarse_from_cache`, the Airfoil2D medium and hard tiers), where the
// port runs every main-path solve on the card in a kernel.  The same z =
// D^-1 r + W Einv W^T r, with W the indicators of 8 x 8 index-space tiles
// of every block, so the strips' structure holds with the tiles as strips:
// per-tile cell lists in CSR form (a flip seam scatters a tile's cells in
// the merged frame), each cell's tile for the prolongation.  Two things
// differ.  K is large (1,194 tiles on the airfoil, where the strips stop
// at FG_MAX_K = 128), so the restricted and coarse vectors live in dynamic
// shared memory (2 K floats, after the cluster arm's rows and chain
// terms; K <= FG_MAX_AGG_K, the entry refuses more), and Einv (K x K, 5.7
// MB at K = 1,194: fixed for the env, built from its state at reset and
// folded with d in float64 by ops/cg_cuda_mb.py's caller) stays in the 50
// MB L2.  And Einv rc (1.43 M multiply-adds per iteration there) is not
// formed in every block: row k is formed by one warp, its lanes strided by
// 32 over the row (FG_BATCH loads in flight, row-major Einv, coalesced),
// then the butterfly, on block k mod C of the cluster (the one block of
// the chunk grid), into its owner's s_xc; a cluster barrier, then every
// block gathers the K values from their owners' shared memory, as it
// gathers the tile sums.  A row's order is the same whichever warp or
// block forms it, so every C returns the chunk grid's x, iterations and
// residual.  Eight cluster barriers per iteration: K3-coarse's seven and
// the coarse rows.  What bounds it: per iteration each block of a C = 16
// cluster streams ~K / 16 rows of Einv (~360 KB at K = 1,194) from L2
// beside K3-coarse's passes; the field passes are K3-flip's.
#include "krylov.cuh"

#define FG_MAX_K 128
// K3-agg's tiles: two floats each of a block's dynamic shared memory
// (ops/cg_cuda_mb.py AGG_MAX_K)
#define FG_MAX_AGG_K 2048
// loads in flight per thread in the coarse preconditioner's gathers
#define FG_BATCH 8

// The strip-coarse space of K3's coarse arm (unused when COARSE is false).
struct FgCoarse {
  const float* einv_t;     // (1|lanes, K, K), transposed: [j * K + k] = Einv[k][j]
                           // (K3-agg: row-major, [k * K + j] = Einv[k][j])
  const int* strip_ptr;    // (K + 1): strip k owns strip_cells[ptr[k]:ptr[k+1]]
  const int* strip_cells;  // flat cell indices, ascending within a strip
  const int* cidx;         // (n): strip of each cell, -1 outside every space
  int K;
  int per_lane;            // einv_t has one matrix per lane
};

// z = M^-1 r for one lane (Jacobi + strip-coarse, or with AGG Jacobi +
// aggregation-coarse), written to `dst`; every thread returns <r, z> in a1
// and <r, r> in a2.  FG_ARM_BLOCK: the whole lane in this block, reached
// after a block barrier that publishes r.  FG_ARM_CLUSTER: one lane over
// the cluster (see the notes at the top of this file), this block's range
// [L.c0, L.c1) of z, its rows `R` staged; it publishes r itself.  `s_rc`,
// `s_xc`: K floats each of this block's shared memory.  Must be reached by
// all threads of the lane.
template <int ARM, bool AGG>
__device__ __forceinline__ void fg_coarse_precond(
    const float* __restrict__ r, const FgRows& R, float* __restrict__ dst,
    int n, const FgCoarse& cz, int l, int precondition, float* s_rc,
    float* s_xc, float* sh, FgLane& L, const FgSpread& sp, float& a1,
    float& a2) {
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int wl = tid & 31;
  const int nw = T >> 5;
  const int K = cz.K;
  constexpr bool CG = ARM == FG_ARM_CLUSTER;  // r of other blocks: via L2
  // strip k: one warp, its lanes strided over the strip's cells, then the
  // butterfly; the one-block form's warps take the strips in turn, the
  // cluster's blocks the strips k = rank mod C.  A lane's loads go out
  // FG_BATCH at a time (a chain of dependent gathers otherwise) and are
  // added in the same order.
  auto restrict_strip = [&](int k) {
    const int* __restrict__ cells = cz.strip_cells;
    const int end = cz.strip_ptr[k + 1];
    float s = 0.0f;
    int i = cz.strip_ptr[k] + wl;
    for (; i + 32 * (FG_BATCH - 1) < end; i += 32 * FG_BATCH) {
      float v[FG_BATCH];
#pragma unroll
      for (int u = 0; u < FG_BATCH; ++u)
        v[u] = fg_ld<CG>(r + cells[i + 32 * u]);
#pragma unroll
      for (int u = 0; u < FG_BATCH; ++u) s += v[u];
    }
    for (; i < end; i += 32) s += fg_ld<CG>(r + cells[i]);
    s = fg_warp_sum(s);
    if (wl == 0) s_rc[k] = s;
  };
  if constexpr (ARM == FG_ARM_CLUSTER) {
    auto cl = cooperative_groups::this_cluster();
    const int C = (int)cl.num_blocks();
    const int rank = (int)cl.block_rank();
    fg_cluster_sync();  // r of every range is complete
    for (int k = rank + C * (tid >> 5); k < K; k += C * nw) restrict_strip(k);
    fg_cluster_sync();  // every strip sum is in its owner's s_rc
    // the strips other blocks own: no block reads them here, and an owner
    // writes its own again only after the sum below has met every block
    for (int k = tid; k < K; k += T)
      if (k % C != rank) s_rc[k] = *cl.map_shared_rank(s_rc + k, k % C);
  } else {
    for (int k = tid >> 5; k < K; k += nw) restrict_strip(k);
  }
  __syncthreads();
  const float* et = cz.einv_t + (size_t)l * K * K * cz.per_lane;
  if constexpr (AGG) {
    // row k of Einv rc on one warp of block k mod C: its lanes strided by
    // 32 over the row (FG_BATCH loads in flight, added in order), then the
    // butterfly; into the owner's s_xc
    int C = 1, rank = 0;
    if constexpr (ARM == FG_ARM_CLUSTER) {
      C = (int)cooperative_groups::this_cluster().num_blocks();
      rank = (int)cooperative_groups::this_cluster().block_rank();
    }
    for (int k = rank + C * (tid >> 5); k < K; k += C * nw) {
      const float* __restrict__ row = et + (size_t)k * K;
      float s = 0.0f;
      int j = wl;
      for (; j + 32 * (FG_BATCH - 1) < K; j += 32 * FG_BATCH) {
        float e[FG_BATCH];
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u) e[u] = row[j + 32 * u];
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u) s = s + e[u] * s_rc[j + 32 * u];
      }
      for (; j < K; j += 32) s = s + row[j] * s_rc[j];
      s = fg_warp_sum(s);
      if (wl == 0) s_xc[k] = s;
    }
    if constexpr (ARM == FG_ARM_CLUSTER) {
      auto cl = cooperative_groups::this_cluster();
      fg_cluster_sync();  // every row is in its owner's s_xc
      // as the tile sums above: an owner writes its rows again only after
      // the sum below has met every block
      for (int k = tid; k < K; k += T)
        if (k % C != rank) s_xc[k] = *cl.map_shared_rank(s_xc + k, k % C);
    }
  } else {
    // row k of Einv rc, its loads FG_BATCH at a time, summed in order
    for (int k = tid; k < K; k += T) {
      float s = 0.0f;
      int j = 0;
      for (; j + FG_BATCH <= K; j += FG_BATCH) {
        float e[FG_BATCH];
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u) e[u] = et[(j + u) * K + k];
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u) s = s + e[u] * s_rc[j + u];
      }
      for (; j < K; ++j) s = s + et[j * K + k] * s_rc[j];
      s_xc[k] = s;
    }
  }
  __syncthreads();
  a1 = 0.0f;
  a2 = 0.0f;
  for (int c = L.c0 + tid; c < L.c1; c += T) {
    const float rr = r[c];
    float zz = precondition ? (1.0f / R.dg[c - R.base]) * rr : rr;
    const int ci = cz.cidx[c];
    if (ci >= 0) zz = zz + s_xc[ci];
    dst[c] = zz;
    a1 += rr * zz;
    a2 += rr * rr;
  }
  // the cluster arm forms the chains again from r and z in L2
  fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
    const float rr = __ldcg(r + c);
    u = rr * __ldcg(dst + c);
    w = rr * rr;
  });
}

// One 1024-thread block per SM (the second launch bound): without it ptxas
// cut the resident arm to 32 registers, with spills, to fit two blocks of
// whose dynamic shared memory it knows nothing.  SPREAD: 0, or the spread
// arm's layout (FG_ARM_RANGE, FG_ARM_CHAINS; krylov.cuh).  AGG (with
// COARSE): K3-agg, the coarse vectors in dynamic shared memory.
template <int ND, bool TABLE, bool COARSE, bool CLUSTER = false,
          bool RESIDENT = false, int SPREAD = 0, bool AGG = false>
__global__ void __launch_bounds__(FG_THREADS, 1)
fg_cg_kernel(const float* __restrict__ b, const float* __restrict__ diag,
             const float* __restrict__ off, const int* __restrict__ nbr,
             const float* __restrict__ x0,
             float* __restrict__ x, int* __restrict__ iters_out,
             float* __restrict__ rs_out, float* __restrict__ r,
             float* __restrict__ p, float* __restrict__ q,
             float* __restrict__ best, int lanes, int chunk, FgGrid g,
             int op_per_lane, float tol2, int maxiter, int stall_iters,
             int precondition, int return_best, int warm_start, FgCoarse cz,
             FgSpread sp) {
  static_assert(!CLUSTER || (TABLE && (!COARSE || ND == 2)),
                "cluster arm: K3, and K3-coarse in 2D");
  static_assert(!RESIDENT || (ND == 2 && !TABLE && !COARSE && !CLUSTER),
                "resident arm: K1 in 2D only");
  static_assert(!SPREAD || (!COARSE && !CLUSTER && !RESIDENT &&
                            (!TABLE || ND == 3)),
                "spread arm: K1, and K3 over a 3D plan");
  static_assert(SPREAD != FG_ARM_CHAINS_GLOBAL || (TABLE && ND == 3),
                "chain terms in global memory: K3 over a 3D plan");
  static_assert(!AGG || (COARSE && TABLE && ND == 2 && !RESIDENT && !SPREAD),
                "K3-agg: the merged frame in 2D");
  constexpr int ARM = SPREAD == FG_ARM_CHAINS_GLOBAL ? FG_ARM_CHAINS
                     : SPREAD                        ? SPREAD
                     : CLUSTER                       ? FG_ARM_CLUSTER
                                                     : FG_ARM_BLOCK;
  // the spread arm reads the vectors other blocks write through L2
  constexpr bool CG = SPREAD != 0;
  __shared__ float sh[64];
  __shared__ float s_rc[COARSE && !AGG ? FG_MAX_K : 1];
  __shared__ float s_xc[COARSE && !AGG ? FG_MAX_K : 1];
  __shared__ float s_rz[FG_MAX_LANES], s_rs[FG_MAX_LANES];
  __shared__ float s_best_rs[FG_MAX_LANES];
  __shared__ float s_alpha[FG_MAX_LANES], s_beta[FG_MAX_LANES];
  __shared__ int s_best_it[FG_MAX_LANES], s_done[FG_MAX_LANES];
  __shared__ int s_better[FG_MAX_LANES];
  __shared__ float2 s_chain[CLUSTER ? FG_THREADS / 2 : 1];  // fg_lane_sum2
  extern __shared__ __align__(16) float s_rows[];  // staged operator rows

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int n = g.n;
  const int nf = 2 * ND;

  // this block's lanes and cells: a chunk of whole lanes, or one lane's
  // range or chains over several blocks (krylov.cuh fg_lane_init)
  FgLane L;
  const int l0 = fg_lane_init<ARM>(L, lanes, chunk, n, sp);
  const bool lead = tid == 0 && L.rank == 0;  // writes the lane stats
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

  FgRows staged{};
  if constexpr (CLUSTER) {
    staged = fg_stage_rows<ND>(diag, off, nbr, n, L.c0, L.c1, L.c1 - L.c0,
                               s_rows);
    L.buf = fg_chain_buf(s_rows, n, fg_lane_blocks<ARM>(sp), ND);
    L.slot = s_chain;
    __syncthreads();
  }
  // the chain terms alone, in shared or global memory
  if constexpr (SPREAD) L.buf = fg_spread_buf<SPREAD>(sp, s_rows, n);
  // the coarse vectors: K3-coarse's static arrays, or K3-agg's 2 K floats
  // after the cluster arm's rows and chain terms (fg_agg_bytes)
  float* rc_buf = s_rc;
  float* xc_buf = s_xc;
  if constexpr (AGG) {
    const int C = fg_lane_blocks<ARM>(sp);
    rc_buf = CLUSTER ? fg_chain_buf(s_rows, n, C, ND) + fg_chain_floats(n, C)
                     : s_rows;
    xc_buf = rc_buf + cz.K;
  }
  // the resident arm (one lane, chunk 1): the lane's rows and x, r, p, q
  // in shared memory for the whole solve; x goes out to x_out at the end
  float* const x_out = x;
  if constexpr (RESIDENT) {
    staged = fg_stage_rows<ND, false>(diag, off, nullptr, n, 0, n, n, s_rows);
    float* w = fg_resident_vecs(s_rows, n, ND);
    x = w;
    r = w + n;
    p = w + 2 * n;
    q = w + 3 * n;
    __syncthreads();
  }
  // the operator rows of lane l
  auto rows = [&](int l) {
    if constexpr (CLUSTER || RESIDENT) return staged;
    else
      return FgRows{diag + (size_t)l * n * op_per_lane,
                    off + (size_t)l * nf * n * op_per_lane, nbr, n, 0};
  };
  // 1 / diag of cell c, this thread's k-th: divided here, or in the
  // resident arm kept from one division per solve (the same bits)
  float dinv[RESIDENT ? FG_RESIDENT_CELLS : 1];
  if constexpr (RESIDENT)
    fg_cells<ARM, true>(L, sp, n, [&](int c, int k, int) {
      dinv[k] = 1.0f / staged.dg[c];
    });
  auto inv_dg = [&](const FgRows& R, int c, int k) {
    if constexpr (RESIDENT) return dinv[k];
    else return 1.0f / R.dg[c - R.base];
  };
  // lane l's diag in global memory (the range arms' sums read every cell)
  auto gdiag = [&](int l) { return diag + (size_t)l * n * op_per_lane; };

  // ---- init: r = b - A x0 (or b), z = M^-1 r, p = z, best = x ----------
  for (int l = 0; l < lanes; ++l) {
    const FgRows R = rows(l);
    const size_t o = (size_t)l * n;
    float a1 = 0.0f, a2 = 0.0f;
    fg_cells<ARM, RESIDENT>(L, sp, n, [&](int c, int k, int e) {
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
      if (!COARSE) {
        const float zz = precondition ? inv_dg(R, c, k) * rr : rr;
        p[o + c] = zz;
        fg_put<ARM>(L, e, rr * zz, rr * rr, a1, a2);
      }
    });
    if constexpr (COARSE) {
      if constexpr (!CLUSTER) __syncthreads();  // r of this lane is complete
      fg_coarse_precond<ARM, AGG>(r + o, R, p + o, n, cz, l, precondition,
                                  rc_buf, xc_buf, sh, L, sp, a1, a2);
    } else {
      fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
        const float rr = __ldcg(r + o + c);
        const float zz = __ldcg(p + o + c);
        u = rr * zz;
        w = rr * rr;
      });
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
    // several blocks per lane: publishes p (x) before pass A gathers it
    // across blocks
    fg_lane_sync<ARM>(L, sp);
    // every thread reads the lanes' state (last written before pass C's
    // barrier) and takes the same branch; thread 0, which alone computes
    // the lanes' scalars, keeps which lanes are frozen
    int any = 0;
    for (int l = 0; l < lanes; ++l) {
      const int stalled = (it - s_best_it[l]) >= stall_iters;
      any |= (s_rs[l] > tol2) && !stalled;
      // a NaN residual counts as frozen: it never holds its chunk
      if (tid == 0) s_done[l] = !(s_rs[l] > tol2) || stalled;
    }
    if (!(it < maxiter && any)) break;
    const int recompute = ((it + 1) % 100) == 0;

    // ---- pass A: q = A (recompute ? x : p), denom = <p, q> --------------
    for (int l = 0; l < lanes; ++l) {
      const FgRows R = rows(l);
      const size_t o = (size_t)l * n;
      const float* src = (recompute ? x : p) + o;
      float a1 = 0.0f, a2 = 0.0f;
      fg_cells<ARM, RESIDENT>(L, sp, n, [&](int c, int k, int e) {
        const float av = fg_apply<ND, TABLE, CG>(R, src, c, g);
        q[o + c] = av;
        fg_put<ARM>(L, e, p[o + c] * av, a1);
      });
      fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
        u = __ldcg(p + o + c) * __ldcg(q + o + c);
        w = 0.0f;
      });
      if (tid == 0)
        s_alpha[l] = (s_done[l] || recompute) ? 0.0f : s_rz[l] / fg_guard(a1);
    }
    __syncthreads();

    // ---- pass B: x += alpha p; r update or refresh; <r,z>, <r,r> --------
    // (COARSE: the pass stops at r; z = M^-1 r goes to q, free until the
    // next matvec, and the sums come from fg_coarse_precond)
    for (int l = 0; l < lanes; ++l) {
      const FgRows R = rows(l);
      const size_t o = (size_t)l * n;
      const float al = s_alpha[l];
      float a1 = 0.0f, a2 = 0.0f;
      fg_cells<ARM, RESIDENT>(L, sp, n, [&](int c, int k, int e) {
        x[o + c] = x[o + c] + al * p[o + c];
        const float rr =
            recompute ? b[o + c] - q[o + c] : r[o + c] - al * q[o + c];
        r[o + c] = rr;
        if (!COARSE) {
          const float zz =
              precondition ? inv_dg(R, c, k) * rr : rr;
          fg_put<ARM>(L, e, rr * zz, rr * rr, a1, a2);
        }
      });
      if constexpr (COARSE) {
        if constexpr (!CLUSTER) __syncthreads();  // r of this lane is complete
        fg_coarse_precond<ARM, AGG>(r + o, R, q + o, n, cz, l, precondition,
                                    rc_buf, xc_buf, sh, L, sp, a1, a2);
      } else {
        const float* dg = gdiag(l);
        fg_lane_sum2<ARM>(a1, a2, sh, L, sp, n, [&](int c, float& u, float& w) {
          const float rr = __ldcg(r + o + c);
          const float zz = precondition ? (1.0f / __ldcg(dg + c)) * rr : rr;
          u = rr * zz;
          w = rr * rr;
        });
      }
      if (tid == 0) {
        const float rz_new = a1, rs_new = a2;
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
    }
    __syncthreads();

    // ---- pass C: p = z + beta p; best = x where better ------------------
    for (int l = 0; l < lanes; ++l) {
      const FgRows R = rows(l);
      const size_t o = (size_t)l * n;
      const float be = s_beta[l];
      const int keep = return_best && s_better[l];
      fg_cells<ARM, RESIDENT>(L, sp, n, [&](int c, int k, int) {
        float zz;
        if (COARSE) {
          zz = q[o + c];
        } else {
          const float rr = r[o + c];
          zz = precondition ? inv_dg(R, c, k) * rr : rr;
        }
        p[o + c] = zz + be * p[o + c];
        if (keep) best[o + c] = x[o + c];
      });
    }
    ++it;
  }

  // ---- finish: return-best, per-lane stats ------------------------------
  for (int l = 0; l < lanes; ++l) {
    const size_t o = (size_t)l * n;
    const int use_best = return_best && !(s_rs[l] <= tol2);
    if (RESIDENT || use_best) {
      fg_cells<ARM, false>(L, sp, n, [&](int c, int, int) {
        x_out[o + c] = use_best ? best[o + c] : x[o + c];
      });
    }
    if (lead) {
      iters_out[l] = it;
      rs_out[l] = use_best ? s_best_rs[l] : s_rs[l];
    }
  }
  // no block leaves while another may still read its shared memory (the
  // cluster arm) or the lane's chains (the spread arm)
  if constexpr (ARM != FG_ARM_BLOCK) fg_lane_sync<ARM>(L, sp);
}

// K1's entry.  `resident` = 1 (chunk 1): the resident arm, one lane per
// block with its rows and four vectors in shared memory (krylov.cuh); a
// lane whose bytes do not fit is refused.  `spread` = G in 32, 64, 128
// (chunk 1, resident 0): the spread arm, one lane over G co-resident
// blocks of a cooperative launch, `chains` picking its layout (1: each
// block the cells of its sum chains, 0: a contiguous range, 3D only);
// `bar` (lanes unsigned) and `slot` (lanes x 2 x 1024 float2) are its
// global memory.  A grid the card cannot hold at once is refused.  Else
// the chunk grid.
using FgCgKernel = decltype(&fg_cg_kernel<2, true, false>);

static FgCgKernel fg_cg_roll_kernel(int ndims, int resident, int spread,
                                    int chains) {
  if (spread) {
    if (ndims == 3)
      return chains ? fg_cg_kernel<3, false, false, false, false, FG_ARM_CHAINS>
                    : fg_cg_kernel<3, false, false, false, false, FG_ARM_RANGE>;
    return fg_cg_kernel<2, false, false, false, false, FG_ARM_CHAINS>;
  }
  if (ndims == 3) return fg_cg_kernel<3, false, false>;
  return resident ? fg_cg_kernel<2, false, false, false, true>
                  : fg_cg_kernel<2, false, false>;
}

extern "C" int fg_cg_solve(const float* b, const float* diag, const float* off,
                           const float* x0, float* x, int* iters, float* rs,
                           float* r, float* p, float* q, float* best,
                           unsigned* bar, float* slot, int lanes, int chunk,
                           int resident, int spread, int chains, int nz,
                           int ny, int nx, int ndims, int op_per_lane,
                           float tol2, int maxiter, int stall_iters,
                           int precondition, int return_best, int warm_start,
                           void* stream) {
  const FgGrid g = fg_grid(nz, ny, nx);
  if (!fg_roll_args_ok(lanes, chunk, resident, spread, chains, g.n, ndims,
                       bar, slot))
    return (int)cudaErrorInvalidValue;
  const FgCgKernel k = fg_cg_roll_kernel(ndims, resident, spread, chains);
  cudaStream_t s = (cudaStream_t)stream;
  const FgSpread sp{bar, reinterpret_cast<float2*>(slot), spread};
  if (spread)
    return (int)fg_launch_spread(
        k, lanes, spread, fg_spread_bytes(g.n, spread), bar, s, b, diag, off,
        nullptr, x0, x, iters, rs, r, p, q, best, lanes, 1, g, op_per_lane,
        tol2, maxiter, stall_iters, precondition, return_best, warm_start,
        FgCoarse{}, sp);
  return (int)fg_launch_smem(
      k, fg_chunk_blocks(lanes, chunk),
      resident ? fg_resident_bytes(g.n, ndims) : 0, s, b, diag, off, nullptr,
      x0, x, iters, rs, r, p, q, best, lanes, chunk, g, op_per_lane, tol2,
      maxiter, stall_iters, precondition, return_best, warm_start, FgCoarse{},
      sp);
}

// How many blocks of K1's spread arm (ndims, G blocks per lane over n
// cells, layout `chains`) the card holds at once, into *out: the spread
// rule's co-residency (lanes x G must not exceed it).
extern "C" int fg_cg_spread_capacity(int ndims, int spread, int chains, int n,
                                     int* out) {
  if ((ndims != 2 && ndims != 3) || !fg_spread_ok(spread) ||
      !fg_spread_layout_ok(ndims, chains) ||
      chains == FG_CHAINS_GLOBAL)
    return (int)cudaErrorInvalidValue;
  return (int)fg_resident_blocks(fg_cg_roll_kernel(ndims, 0, spread, chains),
                                 fg_spread_bytes(n, spread), out);
}

// K3: the same solve over the merged super-block frame of a multi-block
// domain (replaces cg_pallas_mb.py `_kernel`, entry `fused_cg_mb`): every
// lane is one flat buffer of n cells holding all super-blocks, the matvec
// goes through the plan's neighbour table (merged.cuh), so every dot
// product is joint over the super-blocks.  Semantics as K1 above.
// `cluster` = 1, `spread` = 0: the chunk grid, one block per chunk of
// lanes; `cluster` = C in 2, 4, 8, 16 (chunk 1): the cluster arm, one lane
// over C blocks (lanes * C blocks), each block's operator rows in shared
// memory (a size whose rows do not fit is refused: cudaFuncSetAttribute
// fails); `spread` = G in 32, 64, 128 (chunk 1, cluster 1, a 3D plan):
// the spread arm as K1's, the rows and the table read from L2, `chains`,
// `bar` and `slot` as in fg_cg_solve (a grid the card cannot hold at once
// is refused), and `chains` = FG_CHAINS_GLOBAL the chains layout with its
// chain terms in global memory, after the slots in `slot` (lanes x 2 x
// 1024 float2, then lanes x G x fg_chain_floats(n, G) floats): no dynamic
// shared memory, for a lane whose terms no block's shared memory holds.
static FgCgKernel fg_cg_cluster_kernel(int ndims) {
  return ndims == 2 ? fg_cg_kernel<2, true, false, true>
                    : fg_cg_kernel<3, true, false, true>;
}

static FgCgKernel fg_cg_mb_spread_kernel(int chains) {
  if (chains == FG_CHAINS_GLOBAL)
    return fg_cg_kernel<3, true, false, false, false, FG_ARM_CHAINS_GLOBAL>;
  return chains ? fg_cg_kernel<3, true, false, false, false, FG_ARM_CHAINS>
                : fg_cg_kernel<3, true, false, false, false, FG_ARM_RANGE>;
}

extern "C" int fg_cg_mb_solve(const float* b, const float* diag,
                              const float* off, const int* nbr,
                              const float* x0, float* x, int* iters, float* rs,
                              float* r, float* p, float* q, float* best,
                              unsigned* bar, float* slot, int lanes, int chunk,
                              int cluster, int spread, int chains, int n,
                              int ndims, int op_per_lane, float tol2,
                              int maxiter, int stall_iters, int precondition,
                              int return_best, int warm_start, void* stream) {
  if (!fg_merged_args_ok(lanes, chunk, cluster, spread, chains, ndims, nbr,
                         bar, slot))
    return (int)cudaErrorInvalidValue;
  const int blocks = fg_chunk_blocks(lanes, chunk);
  const FgGrid g = fg_grid(1, 1, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (spread)
    return (int)fg_launch_spread(
        fg_cg_mb_spread_kernel(chains), lanes, spread,
        fg_spread_smem(n, spread, chains), bar, s, b, diag, off, nbr, x0, x,
        iters, rs, r, p, q, best, lanes, 1, g, op_per_lane, tol2, maxiter,
        stall_iters, precondition, return_best, warm_start, FgCoarse{},
        fg_spread_mem(bar, slot, lanes, spread, chains));
  if (cluster > 1) {
    return (int)fg_launch_clusters(
        fg_cg_cluster_kernel(ndims), lanes, cluster,
        fg_stage_bytes(n, cluster, ndims), s, b, diag,
        off, nbr, x0, x, iters, rs, r, p, q, best, lanes, 1, g, op_per_lane,
        tol2, maxiter, stall_iters, precondition, return_best, warm_start,
        FgCoarse{}, FgSpread{});
  }
  if (ndims == 2) {
    fg_cg_kernel<2, true, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, lanes, chunk,
        g, op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
        warm_start, FgCoarse{}, FgSpread{});
  } else {
    fg_cg_kernel<3, true, false><<<blocks, FG_THREADS, 0, s>>>(
        b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, lanes, chunk,
        g, op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
        warm_start, FgCoarse{}, FgSpread{});
  }
  return (int)cudaGetLastError();
}

// How many blocks of K3's spread arm (a 3D plan, G blocks per lane over n
// cells, layout `chains`) the card holds at once, into *out (as
// fg_cg_spread_capacity; the merged instances' registers are their own).
extern "C" int fg_cg_mb_spread_capacity(int ndims, int spread, int chains,
                                        int n, int* out) {
  if (ndims != 3 || !fg_spread_ok(spread) ||
      !fg_spread_layout_ok(ndims, chains))
    return (int)cudaErrorInvalidValue;
  return (int)fg_resident_blocks(fg_cg_mb_spread_kernel(chains),
                                 fg_spread_smem(n, spread, chains), out);
}

// How many C-block clusters of K3's cluster arm (ndims, over n cells) the
// card holds at once, into *out: the cluster rule's occupancy.
extern "C" int fg_cg_mb_cluster_occupancy(int ndims, int cluster, int n,
                                          int* out) {
  if ((ndims != 2 && ndims != 3) || cluster < 2 || !fg_cluster_ok(cluster, 1))
    return (int)cudaErrorInvalidValue;
  return (int)fg_max_clusters(fg_cg_cluster_kernel(ndims), cluster,
                              fg_stage_bytes(n, cluster, ndims), out);
}

// K3-coarse: K3 with the strip-coarse preconditioner (see the note at the
// top of this file), 2D plans only (the strip plan is None in 3D, as in the
// JAX package).  `cluster` = 1: the chunk grid; C in 2, 4, 8, 16 (chunk 1):
// the cluster arm, one lane over C blocks, each block's rows in shared
// memory (a size whose rows do not fit is refused).  Returns
// cudaErrorInvalidValue when K exceeds FG_MAX_K.
static FgCgKernel fg_cg_coarse_kernel(int cluster) {
  return cluster > 1 ? fg_cg_kernel<2, true, true, true>
                     : fg_cg_kernel<2, true, true>;
}

extern "C" int fg_cg_mb_coarse_solve(
    const float* b, const float* diag, const float* off, const int* nbr,
    const float* x0, float* x, int* iters, float* rs, float* r, float* p,
    float* q, float* best, const float* einv_t, const int* strip_ptr,
    const int* strip_cells, const int* cidx, int lanes, int chunk,
    int cluster, int n, int ndims, int op_per_lane, int K, float tol2,
    int maxiter, int stall_iters, int precondition, int return_best,
    int warm_start, void* stream) {
  const int blocks = fg_chunk_blocks(lanes, chunk);
  if (blocks == 0 || ndims != 2 || nbr == nullptr || K < 1 || K > FG_MAX_K ||
      !fg_cluster_ok(cluster, chunk))
    return (int)cudaErrorInvalidValue;
  const FgGrid g = fg_grid(1, 1, n);
  FgCoarse cz;
  cz.einv_t = einv_t;
  cz.strip_ptr = strip_ptr;
  cz.strip_cells = strip_cells;
  cz.cidx = cidx;
  cz.K = K;
  cz.per_lane = op_per_lane;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster > 1)
    return (int)fg_launch_clusters(
        fg_cg_coarse_kernel(cluster), lanes, cluster,
        fg_stage_bytes(n, cluster, ndims), s, b, diag, off, nbr, x0, x, iters,
        rs, r, p, q, best, lanes, 1, g, op_per_lane, tol2, maxiter,
        stall_iters, precondition, return_best, warm_start, cz, FgSpread{});
  fg_cg_kernel<2, true, true><<<blocks, FG_THREADS, 0, s>>>(
      b, diag, off, nbr, x0, x, iters, rs, r, p, q, best, lanes, chunk, g,
      op_per_lane, tol2, maxiter, stall_iters, precondition, return_best,
      warm_start, cz, FgSpread{});
  return (int)cudaGetLastError();
}

// K3-agg: K3 with the aggregation coarse space (see the note at the top of
// this file), 2D plans only: `einv` (1|lanes, K, K) row-major, the tiles'
// cell lists `tile_ptr` (K + 1) / `tile_cells` and each cell's tile `cidx`
// (n; -1: none).  `cluster` = 1: the chunk grid; C in 2, 4, 8, 16 (chunk
// 1): the cluster arm, one lane over C blocks, each block's rows in shared
// memory beside its 2 K coarse floats (a size that does not fit is
// refused).  Returns cudaErrorInvalidValue when K exceeds FG_MAX_AGG_K.
static FgCgKernel fg_cg_agg_kernel(int cluster) {
  return cluster > 1 ? fg_cg_kernel<2, true, true, true, false, 0, true>
                     : fg_cg_kernel<2, true, true, false, false, 0, true>;
}

// dynamic shared memory of a K3-agg block: the cluster arm's rows and
// chain terms (C > 1), then its s_rc and s_xc (ops/cg_cuda_mb.py
// `stage_bytes` with coarse_k mirrors the cluster arm's)
static size_t fg_agg_bytes(int n, int C, int K) {
  return (C > 1 ? fg_stage_bytes(n, C, 2) : 0) + (size_t)2 * K * sizeof(float);
}

extern "C" int fg_cg_mb_agg_solve(
    const float* b, const float* diag, const float* off, const int* nbr,
    const float* x0, float* x, int* iters, float* rs, float* r, float* p,
    float* q, float* best, const float* einv, const int* tile_ptr,
    const int* tile_cells, const int* cidx, int lanes, int chunk,
    int cluster, int n, int ndims, int op_per_lane, int K, float tol2,
    int maxiter, int stall_iters, int precondition, int return_best,
    int warm_start, void* stream) {
  const int blocks = fg_chunk_blocks(lanes, chunk);
  if (blocks == 0 || ndims != 2 || nbr == nullptr || K < 1 ||
      K > FG_MAX_AGG_K || !fg_cluster_ok(cluster, chunk))
    return (int)cudaErrorInvalidValue;
  const FgGrid g = fg_grid(1, 1, n);
  FgCoarse cz;
  cz.einv_t = einv;
  cz.strip_ptr = tile_ptr;
  cz.strip_cells = tile_cells;
  cz.cidx = cidx;
  cz.K = K;
  cz.per_lane = op_per_lane;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster > 1)
    return (int)fg_launch_clusters(
        fg_cg_agg_kernel(cluster), lanes, cluster,
        fg_agg_bytes(n, cluster, K), s, b, diag, off, nbr, x0, x, iters, rs,
        r, p, q, best, lanes, 1, g, op_per_lane, tol2, maxiter, stall_iters,
        precondition, return_best, warm_start, cz, FgSpread{});
  return (int)fg_launch_smem(
      fg_cg_agg_kernel(1), blocks, fg_agg_bytes(n, 1, K), s, b, diag, off,
      nbr, x0, x, iters, rs, r, p, q, best, lanes, chunk, g, op_per_lane,
      tol2, maxiter, stall_iters, precondition, return_best, warm_start, cz,
      FgSpread{});
}

// How many C-block clusters of a coarse form's cluster arm (a 2D plan over
// n cells) the card holds at once, into *out (as
// fg_cg_mb_cluster_occupancy; each coarse instance's registers and shared
// memory are its own): K = 0 asks K3-coarse's (the strips, their vectors
// in static arrays), K in 1..FG_MAX_AGG_K K3-agg's over K tiles.
extern "C" int fg_cg_mb_coarse_cluster_occupancy(int ndims, int cluster,
                                                 int n, int K, int* out) {
  if (ndims != 2 || cluster < 2 || !fg_cluster_ok(cluster, 1) || K < 0 ||
      K > FG_MAX_AGG_K)
    return (int)cudaErrorInvalidValue;
  if (K == 0)
    return (int)fg_max_clusters(fg_cg_coarse_kernel(cluster), cluster,
                                fg_stage_bytes(n, cluster, ndims), out);
  return (int)fg_max_clusters(fg_cg_agg_kernel(cluster), cluster,
                              fg_agg_bytes(n, cluster, K), out);
}
