// Paged-KV page gather and scatter for Hopper, sm_90a: the copy stages of
// the live switch's KV migration.
//
// Replaces the Pallas TPU kernels of repro/kernels/kv_pack/kernel.py:
//   gather_pages_rows_pallas  (_pack_rows_kernel)     out[r, i] = pool[r, idx[i]]
//   scatter_pages_rows_pallas (_scatter_rows_kernel)  pool[row0 + r, idx[i]] = vals[r, i]
//   gather_pages_pallas / scatter_pages_pallas: the one-row (R = 1) cases.
//
// Contract, with the ranks of a layout group stacked (distributed/ranks.py):
// a pool is G per-rank regions, rank g's at `pool + g * rank_stride`
// bytes, each an (R_all, pages, M) block in row-major order; idx is
// (G, n) int32 with row stride `idx_stride` (0: one index row for all).
//   gather:  out (G, R, n, M) contiguous,  out[g, r, i] = pool_g[r, idx[g, i]]
//   scatter: vals (G, R, n, M) contiguous, pool_g[row0 + r, idx[g, i]] =
//            vals[g, r, i], written IN PLACE into the caller's buffer
//            (repro's scatter is functional, its pool aliased to its output).
// An index outside [0, pages) zero-fills its gather run and is skipped by
// the scatter, instead of faulting. The switch plans pad with page 0, the
// null page, so the scatter's writes to page 0 race; page 0 is never read
// unmasked (ROADMAP C5). A scatter with duplicate indices is undefined.
//
// What bounds it on the H100: bytes. It does no arithmetic; each run of M
// elements is read once and written once, 2 * G * R * n * M * elem bytes
// over 3.35 TB/s.
//
// What the design does about that. A run (one (rank, row, page) copy) is
// cut into pieces of `piece` bytes, the last one ragged; piece w is part
// w % ppr of run w / ppr. `workers` warps walk the pieces with a stride of
// `workers`, so the card fills whatever the shape: a 16 KB page spreads
// over two to sixteen warps, and a short run is one piece. The geometry
// (piece, workers) is planned in Python (kernels/kv_pack/kernel.py:
// kv_plan), which the CPU tests hold to cover every byte of every run
// exactly once; each piece reads its index once. Positions are 32-bit
// counts split with plain `/` and `%`. A warp moves its piece in
// rounds of 32 lanes x kUnroll words, every load of a round in flight
// before its stores: 4 KB a round in 16-byte words, the unit when runs,
// rank stride and both bases are 16-byte aligned, else the element's own
// width (the small runs of CPU-sized tests). The scatter's source needs
// no index, so its first round's loads are issued before the index read.
// A ring of TMA bulk copies through shared memory was measured against
// this and left out: it tied where bytes set the time and lost where
// latency does (one thread waits on the index, the load's mbarrier and
// the store's read in turn; PERF.md). No library call and no cudaMemcpy.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 8;  // words in flight per lane: 4 KB a warp-round

// Counts are 32-bit: dispatch checks that the pieces fit 31 bits.
struct Geometry {
  unsigned ppr, n, R;  // pieces per run, index row length, rows
  unsigned pages, row0, total;
  int64_t run_bytes, rank_stride, idx_stride, piece;
};

// Piece w: part w % ppr of run q = w / ppr, bytes [off, off + len) of the
// run; the run's contiguous side (out or vals) sits at q * run_bytes.
struct Span {
  unsigned q;
  int64_t off, len;
};

__device__ __forceinline__ Span span_at(const Geometry& g, unsigned w) {
  Span sp;
  sp.q = w / g.ppr;
  sp.off = (int64_t)(w % g.ppr) * g.piece;
  sp.len = g.run_bytes - sp.off < g.piece ? g.run_bytes - sp.off : g.piece;
  return sp;
}

// The pool side of a span: rank g's region, row row0 + r, page idx[g, i]
// for q = (g, r, i) row-major over (G, R, n); null when the index is
// outside [0, pages). The one read of the index for this piece.
__device__ __forceinline__ char* page_at(const Geometry& g, char* pool,
                                         const int* __restrict__ idx,
                                         const Span& sp) {
  const unsigned gr = sp.q / g.n, i = sp.q % g.n;
  const unsigned rank = gr / g.R, r = gr % g.R;
  const int p = __ldg(idx + rank * g.idx_stride + i);
  if (p < 0 || (unsigned)p >= g.pages) return nullptr;
  return pool + rank * g.rank_stride +
         ((int64_t)(g.row0 + r) * g.pages + p) * g.run_bytes + sp.off;
}

template <typename V>
__device__ __forceinline__ void load_round(V (&v)[kUnroll], const V* s,
                                           int64_t k0, int64_t nv, int lane) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t k = k0 + u * 32 + lane;
    if (k < nv) v[u] = s[k];
  }
}

template <typename V>
__device__ __forceinline__ void store_round(const V (&v)[kUnroll], V* d,
                                            int64_t k0, int64_t nv,
                                            int lane) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t k = k0 + u * 32 + lane;
    if (k < nv) d[k] = v[u];
  }
}

// warp `worker` copies pieces worker, worker + workers, ...
template <typename V, bool kScatter>
__global__ void __launch_bounds__(32 * kWarps)
copy_kernel(char* pool, const int* __restrict__ idx, char* other, Geometry g,
            unsigned workers) {
  const unsigned worker = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (worker >= workers) return;
  for (unsigned w = worker; w < g.total; w += workers) {
    const Span sp = span_at(g, w);
    V* flat = reinterpret_cast<V*>(other + sp.q * g.run_bytes + sp.off);
    const int64_t nv = sp.len / (int64_t)sizeof(V);
    V v[kUnroll];
    if (kScatter) load_round(v, flat, 0, nv, lane);
    char* page = page_at(g, pool, idx, sp);
    if (page == nullptr) {  // the gather zero-fills, the scatter skips
      if (!kScatter)
        for (int64_t k = lane; k < nv; k += 32) flat[k] = V{};
      continue;
    }
    const V* s = kScatter ? flat : reinterpret_cast<const V*>(page);
    V* d = kScatter ? reinterpret_cast<V*>(page) : flat;
    if (!kScatter) load_round(v, s, 0, nv, lane);
    for (int64_t k0 = 0;;) {
      store_round(v, d, k0, nv, lane);
      k0 += 32 * kUnroll;
      if (k0 >= nv) break;
      load_round(v, s, k0, nv, lane);
    }
  }
}

template <typename V, bool kScatter>
int launch(char* pool, const int* idx, char* other, const Geometry& g,
           unsigned workers, cudaStream_t s) {
  copy_kernel<V, kScatter><<<(workers + kWarps - 1) / kWarps, 32 * kWarps, 0,
                             s>>>(pool, idx, other, g, workers);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int unit) {
  return reinterpret_cast<uintptr_t>(p) % unit == 0;
}

// geom: G, R, n, pages, row0, run_bytes, rank_stride, idx_stride, piece,
// workers, unit (kernels/kv_pack/kernel.py: _geometry). Checks what the
// planner promises, then launches.
template <bool kScatter>
int dispatch(void* pool, const void* idx, void* other, const long long* geom,
             void* stream) {
  const long long G = geom[0], R = geom[1], n = geom[2], pages = geom[3],
                  row0 = geom[4], run_bytes = geom[5], rank_stride = geom[6],
                  idx_stride = geom[7], piece = geom[8], workers = geom[9],
                  unit = geom[10];
  if (G <= 0 || R <= 0 || n <= 0 || pages <= 0 || pages > INT_MAX ||
      row0 < 0 || row0 > INT_MAX || run_bytes <= 0 || rank_stride < 0 ||
      idx_stride < 0 || piece <= 0 || workers <= 0)
    return (int)cudaErrorInvalidValue;
  if ((unit != 2 && unit != 4 && unit != 16) || run_bytes % unit ||
      rank_stride % unit || piece % unit || !aligned(pool, (int)unit) ||
      !aligned(other, (int)unit))
    return (int)cudaErrorInvalidValue;
  // the pieces must fit 31 bits (the shapes are a tensor's, so the
  // products fit 64)
  const long long ppr = (run_bytes + piece - 1) / piece,
                  total = G * R * n * ppr;
  if (total > INT_MAX || workers > total) return (int)cudaErrorInvalidValue;
  Geometry g;
  g.ppr = (unsigned)ppr;
  g.n = (unsigned)n;
  g.R = (unsigned)R;
  g.pages = (unsigned)pages;
  g.row0 = (unsigned)row0;
  g.total = (unsigned)total;
  g.run_bytes = run_bytes;
  g.rank_stride = rank_stride;
  g.idx_stride = idx_stride;
  g.piece = piece;
  char* pl = static_cast<char*>(pool);
  const int* ix = static_cast<const int*>(idx);
  char* ot = static_cast<char*>(other);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned wk = (unsigned)workers;
  if (unit == 16) return launch<uint4, kScatter>(pl, ix, ot, g, wk, s);
  if (unit == 4) return launch<uint32_t, kScatter>(pl, ix, ot, g, wk, s);
  return launch<uint16_t, kScatter>(pl, ix, ot, g, wk, s);
}

}  // namespace

// pool: G regions of (R, pages, run_bytes) bytes, rank_stride bytes apart;
// idx (G, n) int32, idx_stride apart (0 = shared); out (G, R, n, run_bytes)
// contiguous; geom as for dispatch, row0 = 0. Returns the cudaError_t of
// the launch.
extern "C" int kv_gather_rows_launch(const void* pool, const void* idx,
                                     void* out, const long long* geom,
                                     void* stream) {
  return dispatch<false>(const_cast<void*>(pool), idx, out, geom, stream);
}

// pool: G regions of (R_all, pages, run_bytes) bytes written in place at
// rows [row0, row0 + R); vals (G, R, n, run_bytes) contiguous; the rest as
// for the gather.
extern "C" int kv_scatter_rows_launch(void* pool, const void* idx,
                                      const void* vals, const long long* geom,
                                      void* stream) {
  return dispatch<true>(pool, idx, const_cast<void*>(vals), geom, stream);
}
