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
// elements, each an (R_all, pages, M) block in row-major order; idx is
// (G, n) int32 with row stride `idx_stride` (0: one index row for all).
//   gather:  out (G, R, n, M) contiguous,  out[g, r, i] = pool_g[r, idx[g, i]]
//   scatter: vals (G, R, n, M) contiguous, pool_g[row0 + r, idx[g, i]] =
//            vals[g, r, i], written IN PLACE into the caller's buffer
//            (repro's scatter is functional, its pool aliased to its output).
// An index outside [0, pages) zero-fills its gather run and is skipped by
// the scatter, instead of faulting. The switch plans pad with page 0, the
// null page, so the scatter's writes to page 0 race; page 0 is never read
// unmasked (ROADMAP C5).
//
// What bounds it on the H100: bytes. It does no arithmetic; each run of M
// elements is read once and written once, 2 * G * R * n * M * elem bytes
// over 3.35 TB/s.
//
// What this simple design does about that: one warp per (rank, row, page)
// run, so the index is read once per run and each warp instruction moves
// 512 contiguous bytes (32 lanes x 16-byte vectors); a lane loads four
// vectors before it stores any, keeping four loads in flight. A run whose
// byte length, rank stride or base address is not a multiple of 16 takes
// a scalar path in the element's own width (the small runs of CPU-sized
// tests). No library call and no cudaMemcpy.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // runs per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                // vectors in flight per lane

template <typename V>
__device__ __forceinline__ void warp_copy(V* __restrict__ dst,
                                          const V* __restrict__ src,
                                          int64_t n, int lane) {
  int64_t k = lane;
  for (; k + 32 * (kUnroll - 1) < n; k += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[k + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[k + 32 * u] = v[u];
  }
  for (; k < n; k += 32) dst[k] = src[k];
}

template <typename V>
__device__ __forceinline__ void warp_zero(V* __restrict__ dst, int64_t n,
                                          int lane) {
  const V z{};
  for (int64_t k = lane; k < n; k += 32) dst[k] = z;
}

// Run q is (g, r, i) in row-major order over (G, R, n): the out/vals
// layout, so its contiguous side sits at q * mv.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ pool, const int* __restrict__ idx,
              V* __restrict__ out, int R, int n, int pages, int64_t mv,
              int64_t rank_stride, int64_t idx_stride, int64_t runs) {
  const int64_t q = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (q >= runs) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(q % n);
  const int64_t gr = q / n;
  const int r = (int)(gr % R);
  const int64_t g = gr / R;
  const int p = idx[g * idx_stride + i];
  V* o = out + q * mv;
  if (p < 0 || p >= pages) {
    warp_zero(o, mv, lane);
    return;
  }
  warp_copy(o, pool + g * rank_stride + ((int64_t)r * pages + p) * mv, mv,
            lane);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(V* __restrict__ pool, const int* __restrict__ idx,
               const V* __restrict__ vals, int R, int n, int pages, int row0,
               int64_t mv, int64_t rank_stride, int64_t idx_stride,
               int64_t runs) {
  const int64_t q = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (q >= runs) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(q % n);
  const int64_t gr = q / n;
  const int r = (int)(gr % R);
  const int64_t g = gr / R;
  const int p = idx[g * idx_stride + i];
  if (p < 0 || p >= pages) return;
  warp_copy(pool + g * rank_stride + ((int64_t)(row0 + r) * pages + p) * mv,
            vals + q * mv, mv, lane);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Shared launch: V is the unit of copy, `scatter` picks the body.
template <typename V>
int launch(bool scatter, void* pool, const int* idx, void* other, int G,
           int R, int n, int pages, int row0, int64_t m_bytes,
           int64_t stride_bytes, int64_t idx_stride, cudaStream_t s) {
  const int64_t runs = (int64_t)G * R * n;
  const int64_t blocks = (runs + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int64_t mv = m_bytes / (int64_t)sizeof(V);
  const int64_t sv = stride_bytes / (int64_t)sizeof(V);
  if (scatter)
    scatter_kernel<V><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<V*>(pool), idx, static_cast<const V*>(other), R, n,
        pages, row0, mv, sv, idx_stride, runs);
  else
    gather_kernel<V><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const V*>(pool), idx, static_cast<V*>(other), R, n,
        pages, mv, sv, idx_stride, runs);
  return (int)cudaGetLastError();
}

int dispatch(bool scatter, void* pool, const void* idx, void* other, int G,
             int R, int n, int pages, int row0, long long m,
             long long rank_stride, long long idx_stride, int elem_size,
             void* stream) {
  if (G <= 0 || R <= 0 || n <= 0 || pages <= 0 || m <= 0 || row0 < 0 ||
      rank_stride < 0 || idx_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (elem_size != 2 && elem_size != 4) return (int)cudaErrorInvalidValue;
  const int64_t m_bytes = (int64_t)m * elem_size;
  const int64_t stride_bytes = (int64_t)rank_stride * elem_size;
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_bytes % 16 == 0 && stride_bytes % 16 == 0 && aligned16(pool) &&
      aligned16(other))
    return launch<uint4>(scatter, pool, ix, other, G, R, n, pages, row0,
                         m_bytes, stride_bytes, idx_stride, s);
  if (elem_size == 4)
    return launch<uint32_t>(scatter, pool, ix, other, G, R, n, pages, row0,
                            m_bytes, stride_bytes, idx_stride, s);
  return launch<uint16_t>(scatter, pool, ix, other, G, R, n, pages, row0,
                          m_bytes, stride_bytes, idx_stride, s);
}

}  // namespace

// pool: G regions of (R, pages, m) elements, rank_stride elements apart;
// idx (G, n) int32, idx_stride apart (0 = shared); out (G, R, n, m).
// elem_size in bytes (2 or 4). Returns the cudaError_t of the launch.
extern "C" int kv_gather_rows_launch(const void* pool, const void* idx,
                                     void* out, int G, int R, int n,
                                     int pages, long long m,
                                     long long rank_stride,
                                     long long idx_stride, int elem_size,
                                     void* stream) {
  return dispatch(false, const_cast<void*>(pool), idx, out, G, R, n, pages,
                  0, m, rank_stride, idx_stride, elem_size, stream);
}

// pool: G regions of (R_all, pages, m) elements written in place at rows
// [row0, row0 + R); vals (G, R, n, m) contiguous; idx as for the gather.
extern "C" int kv_scatter_rows_launch(void* pool, const void* idx,
                                      const void* vals, int G, int R, int n,
                                      int pages, int row0, long long m,
                                      long long rank_stride,
                                      long long idx_stride, int elem_size,
                                      void* stream) {
  return dispatch(true, pool, idx, const_cast<void*>(vals), G, R, n, pages,
                  row0, m, rank_stride, idx_stride, elem_size, stream);
}
