// Shared device helpers for the whole-solve Krylov kernels (K1/K3 cg.cu,
// K2 bicgstab_mb.cu): the stencil applies, block-wide sums, the cluster
// arm of the merged-frame forms (one lane over a thread-block cluster) and
// the resident arm of the roll forms (one lane in one block's shared
// memory).
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

// (A v)_c = diag_c v_c + sum_f off_f,c v_nbr_f(c), summed in face order as
// the PyTorch version does.
template <int ND>
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
// (TABLE false), or the merged frame's neighbour table.
template <int ND, bool TABLE>
__device__ __forceinline__ float fg_apply(const FgRows& R,
                                          const float* __restrict__ v, int c,
                                          const FgGrid& g) {
  if (TABLE)
    return fg_table_matvec<ND>(R.dg, R.of, R.nb, R.stride, v, c, c - R.base);
  return fg_matvec<ND>(R.dg, R.of, v, c, g);
}

// ---------------------------------------------------------------------------
// The cluster arm: one lane over a cluster of C blocks (C in 2, 4, 8, 16)
// ---------------------------------------------------------------------------
//
// Block r of a cluster owns cells [r * seg, (r + 1) * seg) of the lane's flat
// buffer (cut at n), seg = ceil(n / C) rounded up to 32; its threads loop
// over that range only, in the order the one-block form uses (thread t takes
// c0 + t, c0 + t + T, ...), and it keeps its range's operator rows in shared
// memory for the whole solve.  Every dot product is the one-block form's sum,
// bit for bit (fg_lane_sum2), so every block holds the same bits of every
// scalar and takes the same branches, and the cluster arm computes what the
// chunk grid computes for the lane: the same x, iterations and residual.

// cells per block of a C-block cluster over n cells (ops/cg_cuda_mb.py
// `cluster_ranges` mirrors it)
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

// A cluster-wide barrier that publishes memory: every thread of the cluster
// arrives with release semantics and waits with acquire semantics, so the
// global and shared writes of every block before it are visible to every
// block after it (a matvec gathers across ranges).  Must be reached by all
// threads of the cluster.
__device__ __forceinline__ void fg_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A lane's two dot products, summed as the one-block form sums them: there
// thread t adds the terms of its cells t, t + T, t + 2T, ... one after
// another (its chain), and fg_block_sum2 adds the T chains in a fixed tree.
// One-block form (CLUSTER false): the caller's per-thread chains a, b go
// straight into the tree.  Cluster arm: a block's threads hold pieces of
// chains, so the chains are formed again from the terms, which
// `term(c, u, w)` computes for cell c from the vectors in global memory:
//   * a cluster barrier publishes the pass's writes;
//   * block r owns chains [r * T/C, (r + 1) * T/C): all its threads compute
//     those chains' terms (row k of a chain's cells is a run of T/C
//     consecutive cells, read through L2 with __ldcg) into shared memory
//     (`buf`, fg_chain_floats), then one thread per chain adds its terms
//     in chain order and puts the chain in the block's `slot`;
//   * after a second barrier thread t loads chain t from its owner's slot
//     (distributed shared memory) and the block runs the same tree.
// So every block gets the one-block form's bits, with no float atomics.
// `slot` needs T / 2 entries; one slot suffices, since a block writes it
// again only after the next sum's first barrier, which no block passes
// before every block has read this sum.  Every thread gets both totals.
// Must be reached by all threads of the block (the cluster).
template <bool CLUSTER, typename Term>
__device__ __forceinline__ void fg_lane_sum2(float& a, float& b, float* sh,
                                             float2* slot, float* buf, int n,
                                             Term term) {
  if constexpr (CLUSTER) {
    namespace cgr = cooperative_groups;
    cgr::cluster_group cl = cgr::this_cluster();
    const int T = blockDim.x;
    const int per = T / (int)cl.num_blocks();
    const int t0 = (int)cl.block_rank() * per;
    const int terms = per * ((n + T - 1) / T);  // rows of T cells x per
    float* bu = buf;
    float* bw = buf + terms;
    fg_cluster_sync();
    for (int e = threadIdx.x; e < terms; e += T) {
      const int k = e / per;
      const int c = k * T + t0 + (e - k * per);
      float u = 0.0f, w = 0.0f;
      if (c < n) term(c, u, w);
      bu[e] = u;
      bw[e] = w;
    }
    __syncthreads();
    if ((int)threadIdx.x < per) {
      float u = 0.0f, w = 0.0f;
#pragma unroll 8
      for (int e = threadIdx.x, c = t0 + threadIdx.x; c < n; e += per, c += T) {
        u = u + bu[e];
        w = w + bw[e];
      }
      slot[threadIdx.x] = make_float2(u, w);
    }
    fg_cluster_sync();
    const float2 v =
        *cl.map_shared_rank(slot + threadIdx.x % per, threadIdx.x / per);
    a = v.x;
    b = v.y;
  }
  fg_block_sum2(a, b, sh);
}

// This block's cells [c0, c1) and its lane: the whole lane (c0 = 0, c1 = n)
// and the chunk grid's lanes (fg_chunk) in the one-block form; one lane per
// cluster and the block's range in the cluster arm (lanes set to 1).
template <bool CLUSTER>
__device__ __forceinline__ int fg_block_cells(int& lanes, int chunk, int n,
                                              int& c0, int& c1) {
  if constexpr (CLUSTER) {
    namespace cgr = cooperative_groups;
    cgr::cluster_group cl = cgr::this_cluster();
    const int C = (int)cl.num_blocks();
    const int seg = fg_cluster_seg(n, C);
    c0 = min(n, (int)cl.block_rank() * seg);
    c1 = min(n, c0 + seg);
    lanes = 1;
    return (int)(blockIdx.x / C);
  } else {
    c0 = 0;
    c1 = n;
    return fg_chunk(lanes, chunk);
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

// the first of the resident vectors, after the staged rows; vector k starts
// k * n floats further
__device__ __forceinline__ float* fg_resident_vecs(float* smem, int n,
                                                   int nd) {
  return smem + (size_t)n * (1 + 2 * nd);
}

// The cells of [c0, c1) this thread visits, c = c0 + tid + k T for k = 0,
// 1, ... (the order of its sum chain): in the resident arm (UNROLLED, at
// most FG_RESIDENT_CELLS cells) a loop the compiler unrolls, so values kept
// per cell live in registers indexed by k; else the plain loop (k unused).
template <bool UNROLLED, typename F>
__device__ __forceinline__ void fg_cells(int c0, int c1, F&& f) {
  const int t = threadIdx.x;
  if constexpr (UNROLLED) {
#pragma unroll
    for (int k = 0; k < FG_RESIDENT_CELLS; ++k) {
      const int c = c0 + t + k * FG_THREADS;
      if (c < c1) f(c, k);
    }
  } else {
    for (int c = c0 + t; c < c1; c += blockDim.x) f(c, 0);
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
