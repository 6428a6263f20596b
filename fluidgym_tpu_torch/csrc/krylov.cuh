// Shared device helpers for the whole-solve Krylov kernels (K1/K3 cg.cu,
// K2 bicgstab_mb.cu): the stencil applies, block-wide sums, the cluster
// arm of the merged-frame forms (one lane over a thread-block cluster), the
// resident arm of the roll forms (one lane in one block's shared memory)
// and the spread arm of the 3D roll and merged forms (one lane over G
// co-resident blocks).
//
// Layout (identical to the PyTorch side): a lane's field is a contiguous
// (nz, ny, nx) array (nz = 1 in 2D), x the minor axis; the stencil
// coefficients are diag (n) and off (2*ndims, n) with the face order
// -x,+x,-y,+y[,-z,+z].  Every neighbour wraps circularly; FIXED faces carry
// off = 0, so the wrapped value is masked and needs no special case.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <utility>

#define FG_THREADS 1024
// lanes of one thread block (one lockstep chunk); a solve takes any number
// of lanes, spread over a grid of ceil(lanes / chunk) blocks
#define FG_MAX_LANES 64

// A grid of nz x ny x nx cells (n in all), with the numbers that divide a
// cell index by nx and a row index by ny (fg_div; set by fg_grid).
struct FgGrid {
  int nz, ny, nx, n;
  unsigned mx, my;
  int sx, sy;
};

// floor(a / d) for 0 <= a < 2^30, with (m, s) from fg_magic(d): one wide
// multiply and a shift where an integer division costs ~20 instructions
// (the matvec's index arithmetic bounds the roll form's passes).  Exact:
// m = floor(2^s / d) + 1 with s = 30 + ceil(log2 d) gives a m / 2^s = a / d
// + e with 0 < e < 1 / d (tests/test_torch_resident_rule.py checks it).
__host__ __device__ __forceinline__ int fg_div(int a, unsigned m, int s) {
  return (int)(((unsigned long long)(unsigned)a * m) >> s);
}

inline void fg_magic(int d, unsigned* m, int* s) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  *s = 30 + l;
  *m = (unsigned)((1ULL << *s) / (unsigned long long)d + 1);
}

inline FgGrid fg_grid(int nz, int ny, int nx) {
  FgGrid g;
  g.nz = nz;
  g.ny = ny;
  g.nx = nx;
  g.n = nz * ny * nx;
  fg_magic(nx, &g.mx, &g.sx);
  fg_magic(ny, &g.my, &g.sy);
  return g;
}

// A load of `p`: plain, or (CG) through L2 with __ldcg, which no stale L1
// line or read-only path can answer: the spread arm's reads of what other
// blocks wrote during the launch.
template <bool CG>
__device__ __forceinline__ float fg_ld(const float* p) {
  if constexpr (CG) return __ldcg(p);
  else return *p;
}

// (A v)_c = diag_c v_c + sum_f off_f,c v_nbr_f(c), summed in face order as
// the PyTorch version does.  CG: v is read with fg_ld<true> (the spread
// arm, whose v other blocks write).
template <int ND, bool CG = false>
__device__ __forceinline__ float fg_matvec(const float* __restrict__ diag,
                                           const float* __restrict__ off,
                                           const float* __restrict__ v,
                                           int c, const FgGrid& g) {
  const int nx = g.nx, ny = g.ny, n = g.n;
  const int q = fg_div(c, g.mx, g.sx);  // c / nx
  const int i = c - q * nx;
  const int k = fg_div(q, g.my, g.sy);  // c / (nx * ny)
  const int j = q - k * ny;
  const int row = c - i;
  const int plane = k * nx * ny;
  const int im = (i == 0) ? nx - 1 : i - 1;
  const int ip = (i == nx - 1) ? 0 : i + 1;
  const int jm = (j == 0) ? ny - 1 : j - 1;
  const int jp = (j == ny - 1) ? 0 : j + 1;
  const auto V = [&](int idx) { return fg_ld<CG>(v + idx); };
  float y = diag[c] * V(c);
  y = y + off[c] * V(row + im);
  y = y + off[n + c] * V(row + ip);
  y = y + off[2 * n + c] * V(plane + jm * nx + i);
  y = y + off[3 * n + c] * V(plane + jp * nx + i);
  if (ND == 3) {
    const int nz = g.nz;
    const int km = (k == 0) ? nz - 1 : k - 1;
    const int kp = (k == nz - 1) ? 0 : k + 1;
    y = y + off[4 * n + c] * V((km * ny + j) * nx + i);
    y = y + off[5 * n + c] * V((kp * ny + j) * nx + i);
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

// A cluster size the entries take: 1 (the chunk grid), or 2, 4, 8, 16 with
// one lane per cluster (chunk 1).
inline bool fg_cluster_ok(int cluster, int chunk) {
  if (cluster == 1) return true;
  return chunk == 1 && (cluster == 2 || cluster == 4 || cluster == 8 ||
                        cluster == 16);
}

__device__ __forceinline__ float fg_guard(float x) {
  const float tiny = 1e-30f;
  return (fabsf(x) < tiny) ? tiny : x;
}

#include "merged.cuh"

// The operator rows a thread reads: the lane's diag / off (and the merged
// frame's neighbour table) in global memory (stride n, indexed by the cell),
// or the rows of this block's range staged in shared memory (stride = the
// range's length, indexed from its first cell `base`).
struct FgRows {
  const float* dg;
  const float* of;
  const int* nb;
  int stride;
  int base;
};

// The stencil apply of either frame: roll-form over one (nz, ny, nx) grid
// (TABLE false), or the merged frame's neighbour table.  CG: v is read
// through L2 (the spread arm).
template <int ND, bool TABLE, bool CG = false>
__device__ __forceinline__ float fg_apply(const FgRows& R,
                                          const float* __restrict__ v, int c,
                                          const FgGrid& g) {
  if (TABLE)
    return fg_table_matvec<ND, CG>(R.dg, R.of, R.nb, R.stride, v, c,
                                   c - R.base);
  return fg_matvec<ND, CG>(R.dg, R.of, v, c, g);
}

// ---------------------------------------------------------------------------
// One lane over several blocks: the cluster arm and the spread arm
// ---------------------------------------------------------------------------
//
// How the blocks of a kernel share its lanes (template argument ARM of the
// kernels):
//   FG_ARM_BLOCK    one block per chunk of lanes: the chunk grid and the
//                   resident arm (fg_chunk);
//   FG_ARM_CLUSTER  the merged-frame forms (K3, K2-mb): one lane over a
//                   thread-block cluster of C blocks (C in 2, 4, 8, 16), each
//                   block a contiguous range of cells, its operator rows in
//                   shared memory;
//   FG_ARM_RANGE    the 3D roll forms (K1, K2 over the trivial plan) and
//                   the 3D merged forms (K3, K2-mb over a 3D plan): one
//                   lane over G co-resident blocks (G in 32, 64, 128) of a
//                   cooperative launch, each block a contiguous range, the
//                   rows (and the neighbour table) read from global memory
//                   (L2);
//   FG_ARM_CHAINS   the same launch (2D or 3D), each block the cells of its
//                   sum chains (below) instead of a range, all its chain
//                   terms of a sum in dynamic shared memory;
//   FG_ARM_RING     the same cells, for 3D merged lanes whose terms no
//                   block's shared memory holds (Airfoil3D's 7,051,776
//                   cells: 440,768 B per block at G = 128): a sum's terms
//                   pass through a ring of FG_RING_S tiles in shared memory
//                   and are added into the chains tile by tile
//                   (fg_sum_cells), so no term leaves the SM.
// In every arm the per-cell arithmetic is the one-block form's, and every
// dot product is the one-block form's sum, bit for bit (fg_lane_sum2), so
// every block holds the same bits of every scalar and takes the same
// branches, and the arm computes what a one-lane launch of the chunk grid
// computes: the same x, iterations and residual.
//
// The sum chains: in the one-block form thread t adds the terms of cells
// t, t + T, t + 2T, ... one after another (chain t; T = FG_THREADS), and
// fg_block_sum2 adds the T chains in a fixed tree.  Block r of a lane of G
// blocks owns chains [r * T/G, (r + 1) * T/G); row k of its chains' cells
// is the run of T/G consecutive cells from k T + r T/G.
#define FG_ARM_BLOCK 0
#define FG_ARM_CLUSTER 1
#define FG_ARM_RANGE 2
#define FG_ARM_CHAINS 3
#define FG_ARM_RING 4

// the spread arm's layouts, the entries' `chains`: a contiguous range, the
// sum chains with their terms in shared memory, or through the ring
#define FG_CHAINS_RANGE 0
#define FG_CHAINS_SHARED 1
#define FG_CHAINS_RING 2

// The ring: a tile is FG_RING_J steps of a block's chain terms (J T terms,
// J T / per rows of its chains), two floats each; FG_RING_S tiles of them.
// Two are enough: every thread meets one block barrier per tile, and the
// chains' owners add tile i - 1 before they produce their share of tile i,
// so no thread writes a tile's stage again before it has been added.
#define FG_RING_J 4
#define FG_RING_S 2
#define FG_RING_TILE (FG_RING_J * FG_THREADS)

// cells per block of a lane over C blocks in a range arm (ops/cg_cuda.py
// `block_ranges` mirrors it)
__host__ __device__ inline int fg_cluster_seg(int n, int C) {
  return ((n + C - 1) / C + 31) / 32 * 32;
}

// floats of one block's chain terms in fg_lane_sum2 (two values for each
// cell of its T/C chains)
__host__ __device__ inline int fg_chain_floats(int n, int C) {
  return 2 * (FG_THREADS / C) * ((n + FG_THREADS - 1) / FG_THREADS);
}

// dynamic shared memory of a cluster-arm block: its operator rows (diag,
// 2*ND off, 2*ND int32 neighbours), then its chain terms
// (ops/cg_cuda_mb.py `stage_bytes` mirrors it)
__host__ __device__ inline size_t fg_stage_bytes(int n, int C, int nd) {
  return ((size_t)fg_cluster_seg(n, C) * (1 + 4 * nd) + fg_chain_floats(n, C)) *
         4;
}

// the chain terms' place in that memory, after the rows
__device__ __forceinline__ float* fg_chain_buf(float* smem, int n, int C,
                                               int nd) {
  return smem + (size_t)fg_cluster_seg(n, C) * (1 + 4 * nd);
}

// dynamic shared memory of a spread-arm block: its chain terms only
// (ops/cg_cuda.py `spread_bytes` mirrors it)
__host__ __device__ inline size_t fg_spread_bytes(int n, int G) {
  return (size_t)fg_chain_floats(n, G) * 4;
}

// dynamic shared memory of a ring-layout block: FG_RING_S tiles of two
// floats per term, whatever the lane (ops/cg_cuda.py `ring_bytes` mirrors
// it)
__host__ __device__ inline size_t fg_ring_bytes() {
  return (size_t)FG_RING_S * 2 * FG_RING_TILE * 4;
}

// the same for a layout: the ring's tiles, or all of a block's terms
inline size_t fg_spread_smem(int n, int G, int chains) {
  return chains == FG_CHAINS_RING ? fg_ring_bytes() : fg_spread_bytes(n, G);
}

// A blocks-per-lane count the spread arm takes: 32, 64 or 128 (a power of
// two, so a block's chains are T/G of them), one lane per G blocks.
inline bool fg_spread_ok(int G) { return G == 32 || G == 64 || G == 128; }

// The spread arm's memory in global memory, allocated by the wrapper:
// `bar` (lanes) the arrivals at each lane's barrier, zeroed on the stream
// before every launch (fg_launch_spread); `slot` (lanes, 2, T) each lane's
// chains of its current sum, two buffers used in turns.
struct FgSpread {
  unsigned* bar;
  float2* slot;
  int G;
};

// One block's view of its lane: what stays live over the solve (fg_chains
// forms the rest where a sum needs it, as registers are what a 1024-thread
// block is short of).
struct FgLane {
  int c0, c1;       // this block's range (the one-block form: [0, n))
  int rank;         // its place among the lane's blocks
  int lane;         // the spread arm: its lane in the launch
  int terms;        // FG_ARM_CHAINS: its chains' cells (fg_chains)
  float* buf;       // its chains' terms: 2 * terms floats of shared memory
                    // (FG_ARM_RING: the ring's tiles)
  float2* slot;     // the cluster arm: its chains, in its shared memory
  unsigned target;  // the spread arm: arrivals its next barrier waits for
  int parity;       // the spread arm: the slot buffer of the next sum
};

// Blocks per lane: 1, the cluster's size, or the spread arm's G.
template <int ARM>
__device__ __forceinline__ int fg_lane_blocks(const FgSpread& sp) {
  if constexpr (ARM == FG_ARM_BLOCK) return 1;
  else if constexpr (ARM == FG_ARM_CLUSTER)
    return (int)cooperative_groups::this_cluster().num_blocks();
  else return sp.G;
}

// This block's sum chains [t0, t0 + per), per = T / G = 2^ps, and their
// terms: row k of them is the run of per cells from k T + t0 (terms = per
// * ceil(n / T) in all).
struct FgChains {
  int t0, per, ps, terms;
};

template <int ARM>
__device__ __forceinline__ FgChains fg_chains(const FgLane& L,
                                              const FgSpread& sp, int n) {
  FgChains h;
  h.per = FG_THREADS / fg_lane_blocks<ARM>(sp);
  h.ps = 31 - __clz(h.per);
  if constexpr (ARM == FG_ARM_CLUSTER)
    h.t0 = (int)cooperative_groups::this_cluster().block_rank() * h.per;
  else
    h.t0 = L.rank * h.per;
  h.terms = h.per * ((n + FG_THREADS - 1) / FG_THREADS);
  return h;
}

// The cell of this block's e-th chain term: row k = e / per of its chains,
// chain t0 + (e - k per).
__device__ __forceinline__ int fg_chain_cell(const FgChains& h, int e) {
  const int k = e >> h.ps;
  return k * FG_THREADS + h.t0 + (e - k * h.per);
}

// A barrier over the G blocks of a spread lane that publishes memory: the
// block's threads meet, thread 0 arrives (fence, then a release add on the
// lane's counter) and waits until all G blocks of this barrier have
// arrived (acquire loads), and the block's threads meet again; so the
// global writes of every block before it are visible to every block after
// it, as grid.sync() orders them, but lane by lane: lanes do not wait on
// each other.  The counter counts up over the launch (zeroed before it);
// every block meets every barrier, since every block takes the same
// branches.  A wait of more than 2 s traps: a barrier that a block never
// reaches then fails the launch where it would hang the card.  Must be
// reached by all threads of the lane.
__device__ __forceinline__ void fg_spread_sync(FgLane& L, const FgSpread& sp) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* bar = sp.bar + L.lane;
    L.target += (unsigned)sp.G;
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(bar),
                 "r"(1u)
                 : "memory");
    unsigned seen;
    unsigned long long t_start = 0, now;
    for (int spin = 0;; ++spin) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
      if ((int)(seen - L.target) >= 0) break;
      if ((spin & 1023) == 0) {
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
        if (spin == 0) t_start = now;
        else if (now - t_start > 2000000000ull) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// A cluster-wide barrier that publishes memory: every thread of the cluster
// arrives with release semantics and waits with acquire semantics, so the
// global and shared writes of every block before it are visible to every
// block after it (a matvec gathers across ranges).  Must be reached by all
// threads of the cluster.
__device__ __forceinline__ void fg_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The barrier that closes a pass whose writes other blocks read: the
// block's (one-block form), the cluster's, or the spread lane's.
template <int ARM>
__device__ __forceinline__ void fg_lane_sync(FgLane& L, const FgSpread& sp) {
  if constexpr (ARM == FG_ARM_BLOCK) __syncthreads();
  else if constexpr (ARM == FG_ARM_CLUSTER) fg_cluster_sync();
  else fg_spread_sync(L, sp);
}

// This block's share of its lane(s): the whole lane and the chunk grid's
// lanes (fg_chunk) in the one-block form; else one lane over G blocks
// (lanes set to 1), this block's range (and, FG_ARM_CHAINS, the count of
// its chain terms).  Returns the block's first lane.  The caller sets
// L.buf (and the cluster arm's L.slot).
template <int ARM>
__device__ __forceinline__ int fg_lane_init(FgLane& L, int& lanes, int chunk,
                                            int n, const FgSpread& sp) {
  L = FgLane{};
  if constexpr (ARM == FG_ARM_BLOCK) {
    L.c1 = n;
    return fg_chunk(lanes, chunk);
  } else {
    const int G = fg_lane_blocks<ARM>(sp);
    if constexpr (ARM == FG_ARM_CLUSTER)
      L.rank = (int)cooperative_groups::this_cluster().block_rank();
    else
      L.rank = (int)blockIdx.x & (G - 1);  // G is a power of two
    L.lane = (int)blockIdx.x / G;
    if constexpr (ARM == FG_ARM_CHAINS)
      L.terms = fg_chains<ARM>(L, sp, n).terms;
    const int seg = fg_cluster_seg(n, G);
    L.c0 = min(n, L.rank * seg);
    L.c1 = min(n, L.c0 + seg);
    lanes = 1;
    return L.lane;
  }
}

// The slot buffer of the spread lane's current sum: T chains (float2).
__device__ __forceinline__ float2* fg_sum_slot(const FgLane& L,
                                               const FgSpread& sp) {
  return sp.slot + (size_t)(2 * L.lane + L.parity) * FG_THREADS;
}

// A lane's two dot products, summed as the one-block form sums them (see
// above).  One-block form: the caller's per-thread chains a, b go straight
// into the tree.  Else a block's threads hold pieces of chains, so the
// chains are formed again from their terms:
//   * the terms: FG_ARM_CHAINS: the pass put each cell's terms in `L.buf`
//     (fg_put) and a block barrier completes them.  The range arms: a lane
//     barrier publishes the pass's writes, then the block's threads compute
//     its chains' terms with `term(c, u, w)` for cell c, from the vectors in
//     global memory (read through L2 with __ldcg), into `L.buf`;
//   * one thread per chain adds its terms in chain order (the serial part:
//     ceil(n / T) adds) and puts the chain in a slot: the cluster arm's in
//     its shared memory (`L.slot`), the spread arm's in global memory
//     (FG_ARM_RING: the pass did both, tile by tile: fg_sum_cells);
//   * after a lane barrier, thread t loads chain t (the cluster arm: from its
//     owner's shared memory; the spread arm: from global memory) and the
//     block runs the same tree.
// So every block gets the one-block form's bits, with no float atomics.
// The cluster arm's slot (T / 2 entries) is written again only after the
// next sum's first barrier, which no block passes before every block has
// read this sum; the spread arm's chains layouts have no such barrier, so
// the spread arm uses the lane's two buffers of T chains in turns: a block
// writes one again only after the next sum's barrier.  PUT (the cluster
// arm): the caller has put this block's chain terms in `L.buf` itself (and
// `term` is not called), reading only what a lane barrier after every
// block's reads of the previous sum's slots had published; so the sum's
// first barrier is left out.  Every thread gets both totals.  Must be
// reached by all threads of the lane.
template <int ARM, bool PUT = false, typename Term>
__device__ __forceinline__ void fg_lane_sum2(float& a, float& b, float* sh,
                                             FgLane& L, const FgSpread& sp,
                                             int n, Term term) {
  static_assert(!PUT || ARM == FG_ARM_CLUSTER, "put terms: the cluster arm");
  if constexpr (ARM == FG_ARM_RING) {
    const float2* chains = fg_sum_slot(L, sp);
    L.parity ^= 1;
    fg_lane_sync<ARM>(L, sp);
    const float2 v = __ldcg(chains + threadIdx.x);
    a = v.x;
    b = v.y;
  } else if constexpr (ARM != FG_ARM_BLOCK) {
    const int T = FG_THREADS;
    const FgChains h = fg_chains<ARM>(L, sp, n);
    float* bu = L.buf;
    float* bw = L.buf + h.terms;
    if constexpr (ARM == FG_ARM_CHAINS || PUT) {
      __syncthreads();
    } else {
      fg_lane_sync<ARM>(L, sp);
      for (int e = threadIdx.x; e < h.terms; e += T) {
        const int c = fg_chain_cell(h, e);
        float u = 0.0f, w = 0.0f;
        if (c < n) term(c, u, w);
        bu[e] = u;
        bw[e] = w;
      }
      __syncthreads();
    }
    float2* chains;
    if constexpr (ARM == FG_ARM_CLUSTER) {
      chains = L.slot;  // this block's own chains
    } else {
      chains = fg_sum_slot(L, sp);  // all T
      L.parity ^= 1;
    }
    if ((int)threadIdx.x < h.per) {
      float u = 0.0f, w = 0.0f;
#pragma unroll 8
      for (int e = threadIdx.x, c = h.t0 + threadIdx.x; c < n;
           e += h.per, c += T) {
        u = u + bu[e];
        w = w + bw[e];
      }
      if constexpr (ARM == FG_ARM_CLUSTER)
        chains[threadIdx.x] = make_float2(u, w);
      else
        chains[h.t0 + threadIdx.x] = make_float2(u, w);
    }
    fg_lane_sync<ARM>(L, sp);
    float2 v;
    if constexpr (ARM == FG_ARM_CLUSTER) {
      v = *cooperative_groups::this_cluster().map_shared_rank(
          chains + (threadIdx.x & (h.per - 1)), threadIdx.x >> h.ps);
    } else {
      v = __ldcg(chains + threadIdx.x);
    }
    a = v.x;
    b = v.y;
  }
  fg_block_sum2(a, b, sh);
}

// A cell's terms of the pass's sum: added to this thread's chains a, b, or
// (FG_ARM_CHAINS) put at e in the block's chain terms for fg_lane_sum2, or
// (FG_ARM_RING) at e in the ring's current tile (fg_sum_cells).
template <int ARM>
__device__ __forceinline__ void fg_put(const FgLane& L, int e, float u,
                                       float w, float& a, float& b) {
  if constexpr (ARM == FG_ARM_CHAINS) {
    L.buf[e] = u;
    L.buf[L.terms + e] = w;
  } else if constexpr (ARM == FG_ARM_RING) {
    L.buf[e] = u;
    L.buf[FG_RING_TILE + e] = w;
  } else {
    a += u;
    b += w;
  }
}

// The same for a pass with one sum (its second total is 0): the chain b is
// left alone, not carried through the loop as b + 0 (the ring stages no
// second term: its chain b is 0 + 0 + ... = 0, as fg_sum_cells starts it).
template <int ARM>
__device__ __forceinline__ void fg_put(const FgLane& L, int e, float u,
                                       float& a) {
  if constexpr (ARM == FG_ARM_CHAINS) {
    L.buf[e] = u;
    L.buf[L.terms + e] = 0.0f;
  } else if constexpr (ARM == FG_ARM_RING) {
    L.buf[e] = u;
  } else {
    a += u;
  }
}

// Stage the operator rows of cells [c0, c1) (diag, off and, in the merged
// frame (TABLE), the neighbour table of the lane) into dynamic shared
// memory, once per solve, and return them as FgRows; the caller's next
// barrier completes the copy.
template <int ND, bool TABLE = true>
__device__ __forceinline__ FgRows fg_stage_rows(const float* __restrict__ dg,
                                                const float* __restrict__ of,
                                                const int* __restrict__ nb,
                                                int n, int c0, int c1,
                                                int seg, float* smem) {
  constexpr int nf = 2 * ND;
  float* s_dg = smem;
  float* s_of = s_dg + seg;
  int* s_nb = TABLE ? reinterpret_cast<int*>(s_of + nf * seg) : nullptr;
  for (int i = threadIdx.x; i < c1 - c0; i += blockDim.x) {
    s_dg[i] = dg[c0 + i];
#pragma unroll
    for (int f = 0; f < nf; ++f) {
      s_of[f * seg + i] = of[(size_t)f * n + c0 + i];
      if constexpr (TABLE) s_nb[f * seg + i] = nb[(size_t)f * n + c0 + i];
    }
  }
  return FgRows{s_dg, s_of, s_nb, seg, c0};
}

// ---------------------------------------------------------------------------
// The resident arm: one roll-form lane in one block's shared memory
// ---------------------------------------------------------------------------
//
// K1 and K2 over one 2D grid, one lane per block (chunk 1): at
// init the block stages its lane's diag and off rows in dynamic shared
// memory (fg_stage_rows with no table, stride n) and keeps FG_RESIDENT_VECS
// of the lane's vectors there for the whole solve (fg_resident_vecs): every
// vector a matvec gathers, and the own-cell vectors read most often.  The
// rest (b, x0, best; K2's x, r_hat, p, t) stays in global memory.  K1's
// threads also keep 1 / diag of their own cells in registers (fg_cells),
// divided once per solve where the chunk grid divides on every pass.  The
// thread -> cell map, the per-cell arithmetic and the sums are the
// one-block form's, so the arm returns that form's x, iterations and
// residual bit for bit.  A lane whose bytes do not fit is refused.
#define FG_RESIDENT_VECS 4
// cells per thread the resident arm takes (n <= 7,168; the bytes that fit
// one block admit at most 6,229 in 2D)
#define FG_RESIDENT_CELLS 7

// dynamic shared memory of the resident arm over an n-cell lane: the rows
// (diag, 2*nd off), then FG_RESIDENT_VECS vectors of n floats
// (ops/cg_cuda.py `resident_bytes` mirrors it)
__host__ __device__ inline size_t fg_resident_bytes(int n, int nd) {
  return (size_t)n * (1 + 2 * nd + FG_RESIDENT_VECS) * 4;
}

// whether the resident arm takes a lane of n cells: 2D, one lane per block,
// at most FG_RESIDENT_CELLS cells per thread (its bytes are checked when
// the launch asks for them)
inline bool fg_resident_ok(int n, int nd, int chunk) {
  return nd == 2 && chunk == 1 && n <= FG_RESIDENT_CELLS * FG_THREADS;
}

// whether the spread arm has a layout for ndims: the range layout is built
// for 3D only (the rule picks it only for lanes of 524,288 cells and more),
// and so is the ring (the roll forms refuse that layout: fg_roll_args_ok)
inline bool fg_spread_layout_ok(int ndims, int chains) {
  if (chains < FG_CHAINS_RANGE || chains > FG_CHAINS_RING) return false;
  if (chains == FG_CHAINS_RING) return ndims == 3;
  return ndims == 3 || (ndims == 2 && chains);
}

// The arguments the roll-form entries (K1 in cg.cu, K2 in bicgstab_mb.cu)
// take for their arms (chunk grid, resident, spread): whether they hold
// together.
inline bool fg_roll_args_ok(int lanes, int chunk, int resident, int spread,
                            int chains, int n, int ndims, const void* bar,
                            const void* slot) {
  if (fg_chunk_blocks(lanes, chunk) == 0 || (ndims != 2 && ndims != 3))
    return false;
  if (resident && (spread || !fg_resident_ok(n, ndims, chunk))) return false;
  return !spread || (fg_spread_ok(spread) && chunk == 1 && bar != nullptr &&
                     slot != nullptr && fg_spread_layout_ok(ndims, chains) &&
                     chains != FG_CHAINS_RING);
}

// The same for the merged-frame entries (K3 in cg.cu, K2-mb in
// bicgstab_mb.cu) and their arms (chunk grid, cluster, spread): the spread
// arm takes chunk 1, no cluster, G in 32, 64, 128, its global memory and
// a 3D plan (the 2D merged lanes keep the cluster arm).
inline bool fg_merged_args_ok(int lanes, int chunk, int cluster, int spread,
                              int chains, int ndims, const void* nbr,
                              const void* bar, const void* slot) {
  if (fg_chunk_blocks(lanes, chunk) == 0 || (ndims != 2 && ndims != 3) ||
      nbr == nullptr || !fg_cluster_ok(cluster, chunk))
    return false;
  return !spread || (fg_spread_ok(spread) && chunk == 1 && cluster == 1 &&
                     ndims == 3 && bar != nullptr && slot != nullptr &&
                     fg_spread_layout_ok(ndims, chains));
}

// the first of the resident vectors, after the staged rows; vector k starts
// k * n floats further
__device__ __forceinline__ float* fg_resident_vecs(float* smem, int n,
                                                   int nd) {
  return smem + (size_t)n * (1 + 2 * nd);
}

// threadIdx.x.  FG_ARM_RING (and, by VT, K3-agg's cluster instance) reads
// it through a volatile asm, so the compiler forms each pass's per-thread
// addresses in the pass and cannot hoist them out of the solve's loop:
// kept live there they spilled K3's ring instance and K3-agg's (88 B each;
// 0 and 8 B with this, and the passes ran faster).
template <int ARM, bool VT = ARM == FG_ARM_RING>
__device__ __forceinline__ int fg_tid() {
  if constexpr (VT) {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
  } else {
    return threadIdx.x;
  }
}

// The cells of this block that this thread visits, f(c, k, e) for each:
// in a range [c0, c1), c = c0 + tid + k T for k = 0, 1, ... (the order of
// its sum chain); in the resident arm (UNROLLED, at most FG_RESIDENT_CELLS
// cells) a loop the compiler unrolls, so values kept per cell live in
// registers indexed by k; in the chains layouts its chain terms e = tid +
// j T and their cells (fg_chain_cell), e being where fg_put puts their
// terms in FG_ARM_CHAINS.  A pass that puts terms goes through
// fg_sum_cells.
template <int ARM, bool UNROLLED, bool VT = ARM == FG_ARM_RING, typename F>
__device__ __forceinline__ void fg_cells(const FgLane& L, const FgSpread& sp,
                                         int n, F&& f) {
  const int t = fg_tid<ARM, VT>();
  if constexpr (UNROLLED) {
#pragma unroll
    for (int k = 0; k < FG_RESIDENT_CELLS; ++k) {
      const int c = L.c0 + t + k * FG_THREADS;
      if (c < L.c1) f(c, k, 0);
    }
  } else if constexpr (ARM == FG_ARM_CHAINS || ARM == FG_ARM_RING) {
    const FgChains h = fg_chains<ARM>(L, sp, n);
    for (int e = t; e < h.terms; e += FG_THREADS) {
      const int c = fg_chain_cell(h, e);
      if (c < n) f(c, 0, e);
    }
  } else {
    for (int c = L.c0 + t; c < L.c1; c += FG_THREADS) f(c, 0, 0);
  }
}

// The cells of a pass whose f puts the terms of SUMS sums (1 or 2) with
// fg_put: fg_cells, but in FG_ARM_RING the block's chain terms go through
// the ring and never leave the SM.  Tile i is steps [i J, (i + 1) J) of
// the loop above; its threads put their terms in stage i mod FG_RING_S
// (e handed to f is the place there) and meet at a block barrier; then,
// while the block produces tile i + 1, thread t < per adds tile i's rows
// of chain t0 + t in chain order, u = u + term from 0.0f as fg_lane_sum2
// adds them, and after the last tile puts the chain in the lane's slot:
// the one-block form's chains, bit for bit, with one barrier per tile.
// Must be reached by all threads of the block.
template <int ARM, bool UNROLLED, int SUMS, bool VT = ARM == FG_ARM_RING,
          typename F>
__device__ __forceinline__ void fg_sum_cells(const FgLane& L,
                                             const FgSpread& sp, int n,
                                             F&& f) {
  static_assert(SUMS == 1 || SUMS == 2, "a pass puts one or two sums");
  if constexpr (ARM != FG_ARM_RING) {
    fg_cells<ARM, UNROLLED, VT>(L, sp, n, f);
  } else {
    constexpr int T = FG_THREADS, TILE = FG_RING_TILE;
    const FgChains h = fg_chains<ARM>(L, sp, n);
    const int t = fg_tid<ARM>();
    const int tiles = (h.terms + TILE - 1) / TILE;
    const int rows = TILE >> h.ps;  // rows of the chains in a tile
    // chain t0 + t's rows: those whose cell k T + t0 + t is below n
    const int kmax = t < h.per ? (n - h.t0 - t + T - 1) / T : 0;
    float u = 0.0f, w = 0.0f;
    for (int i = 0;; ++i) {
      if (i > 0 && t < h.per) {
        const float* st = L.buf + ((i - 1) % FG_RING_S) * 2 * TILE + t;
        const int m = min(rows, kmax - (i - 1) * rows);
#pragma unroll 8
        for (int k = 0; k < m; ++k) {
          u = u + st[k << h.ps];
          if constexpr (SUMS == 2) w = w + st[TILE + (k << h.ps)];
        }
      }
      if (i == tiles) break;
      const int s0 = (i % FG_RING_S) * 2 * TILE;
#pragma unroll 1
      for (int j = 0; j < FG_RING_J; ++j) {
        const int e = i * TILE + j * T + t;
        const int c = fg_chain_cell(h, e);
        if (e < h.terms && c < n) f(c, 0, s0 + j * T + t);
      }
      __syncthreads();
    }
    if (t < h.per) fg_sum_slot(L, sp)[h.t0 + t] = make_float2(u, w);
  }
}

// Launch `kernel` on a grid of `blocks` blocks with `smem` bytes of dynamic
// shared memory (the opt-in above 48 KB).  A size the card refuses returns
// its error; nothing falls back to another arm.
template <typename... P, typename... A>
static cudaError_t fg_launch_smem(void (*kernel)(P...), int blocks,
                                  size_t smem, cudaStream_t s, A&&... args) {
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, FG_THREADS, smem, s>>>(std::forward<A>(args)...);
  return cudaGetLastError();
}

// Set `fn`'s attributes for clusters of C blocks with `smem` bytes of
// dynamic shared memory (the opt-in above 48 KB; C = 16 is a non-portable
// size) and fill `L` for a grid of `blocks` blocks on stream `s`.
struct FgClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

static cudaError_t fg_cluster_config(const void* fn, int blocks, int C,
                                     size_t smem, cudaStream_t s,
                                     FgClusterLaunch& L) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  L.attr[0].id = cudaLaunchAttributeClusterDimension;
  L.attr[0].val.clusterDim.x = C;
  L.attr[0].val.clusterDim.y = 1;
  L.attr[0].val.clusterDim.z = 1;
  L.cfg = cudaLaunchConfig_t{};
  L.cfg.gridDim = dim3(blocks, 1, 1);
  L.cfg.blockDim = dim3(FG_THREADS, 1, 1);
  L.cfg.dynamicSmemBytes = smem;
  L.cfg.stream = s;
  L.cfg.attrs = L.attr;
  L.cfg.numAttrs = 1;
  return e;
}

// Launch `kernel` as `lanes` clusters of C blocks (one lane each, grid =
// lanes * C) with `smem` bytes of dynamic shared memory.  A refused launch
// returns its error; nothing falls back to C = 1.
template <typename... P, typename... A>
static cudaError_t fg_launch_clusters(void (*kernel)(P...), int lanes, int C,
                                      size_t smem, cudaStream_t s,
                                      A&&... args) {
  FgClusterLaunch L;
  cudaError_t e =
      fg_cluster_config((const void*)kernel, lanes * C, C, smem, s, L);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&L.cfg, kernel, std::forward<A>(args)...);
}

// How many C-block clusters of `kernel` with `smem` bytes of dynamic shared
// memory the card holds at once (cudaOccupancyMaxActiveClusters), into *out.
template <typename... P>
static cudaError_t fg_max_clusters(void (*kernel)(P...), int C, size_t smem,
                                   int* out) {
  FgClusterLaunch L;
  cudaError_t e = fg_cluster_config((const void*)kernel, C, C, smem, 0, L);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &L.cfg);
}

// Launch `kernel` as `lanes` spread lanes of G blocks each (grid = lanes *
// G) with `smem` bytes of dynamic shared memory, cooperatively: the card
// refuses a grid whose blocks cannot all be resident at once
// (cudaErrorCooperativeLaunchTooLarge) where the lane barriers would wait
// forever.  Zeroes the lanes' barrier counters `bar` on the stream first.
// A refused launch returns its error; nothing falls back.
template <typename... P, typename... A>
static cudaError_t fg_launch_spread(void (*kernel)(P...), int lanes, int G,
                                    size_t smem, unsigned* bar,
                                    cudaStream_t s, A&&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(bar, 0, sizeof(unsigned) * (size_t)lanes, s);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * G, 1, 1);
  cfg.blockDim = dim3(FG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

// How many blocks of `kernel` with `smem` bytes of dynamic shared memory
// the card holds at once (blocks per SM times SMs), into *out: the spread
// rule's co-residency.
template <typename... P>
static cudaError_t fg_resident_blocks(void (*kernel)(P...), size_t smem,
                                      int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      FG_THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return e;
}
