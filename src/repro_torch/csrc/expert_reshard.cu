// Expert-weight permutes for Hopper, sm_90a: the local stages of the live
// switch's weight reshard (EP->TP: permute, then exchange; TP->EP:
// exchange, then permute).
//
// Replaces the Pallas TPU kernels of repro/kernels/expert_reshard/kernel.py,
// one body instantiated for their four index maps (Ih = I/G, Ic = I/G):
//   pack_peer_chunks_pallas        w13 (E, 2I, D) -> (G, E, 2Ih, D)
//       out[g, e, h*Ih + j] = in[e, h*I + g*Ih + j]        h in {gate, up}
//   interleave_shards_pallas       (G, E, 2Ih, D) -> (E, 2*G*Ih, D)
//       out[e, h*G*Ih + g*Ih + j] = in[g, e, h*Ih + j]     inverse of the above
//   pack_width_chunks_pallas       w2 (E, D, I) -> (G, E, D, Ic)
//       out[g, e, d, j] = in[e, d, g*Ic + j]
//   interleave_width_shards_pallas (G, E, D, Ic) -> (E, D, G*Ic)
//       out[e, d, g*Ic + j] = in[g, e, d, j]               inverse of the above
// E is every expert the call moves: the switch folds the layer range and
// the stacked ranks into it, so one launch moves a weight tensor of a
// whole layer chunk. Each map is a copy of contiguous runs: a D row for
// w13 (a whole row of the (2I, D) matrix), an Ic-long slice for w2.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once, 2 * numel * elem bytes over 3.35 TB/s; there is no arithmetic.
//
// What this simple design does about that: one warp per output run. The
// run's position (c0, c1, c2, c3) in the output decomposes from the run
// index once per warp, and the input offset is its dot product with the
// map's strides, so each warp reads one contiguous input run and writes
// one contiguous output run; lanes move consecutive 16-byte vectors (512
// bytes per warp instruction) with four loads in flight per lane. Runs
// whose byte length or base address is not a multiple of 16 take a scalar
// path in the element's width. No library call and no cudaMemcpy.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // runs per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;

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

// An index map: output runs in row-major order over (n0, n1, n2, n3);
// run (c0, c1, c2, c3) reads the input run at sum(c_k * s_k) elements.
struct RunMap {
  int64_t n1, n2, n3;
  int64_t s0, s1, s2, s3;
  int64_t runs;
  int64_t run;                // elements per run
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
permute_runs_kernel(const V* __restrict__ in, V* __restrict__ out, RunMap m) {
  const int64_t q = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (q >= m.runs) return;
  int64_t t = q;
  const int64_t c3 = t % m.n3;
  t /= m.n3;
  const int64_t c2 = t % m.n2;
  t /= m.n2;
  const int64_t c1 = t % m.n1;
  const int64_t c0 = t / m.n1;
  const int64_t src = c0 * m.s0 + c1 * m.s1 + c2 * m.s2 + c3 * m.s3;
  warp_copy(out + q * m.run, in + src, m.run, threadIdx.x % 32);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Map strides and run length are given in elements; V is the copy unit.
template <typename V>
int launch(const void* in, void* out, RunMap m, int elem_size,
           cudaStream_t s) {
  const int64_t per = (int64_t)sizeof(V) / elem_size;
  m.s0 /= per;
  m.s1 /= per;
  m.s2 /= per;
  m.s3 /= per;
  m.run /= per;
  const int64_t blocks = (m.runs + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  permute_runs_kernel<V><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const V*>(in), static_cast<V*>(out), m);
  return (int)cudaGetLastError();
}

int run(const void* in, void* out, int64_t n0, int64_t n1, int64_t n2,
        int64_t n3, int64_t s0, int64_t s1, int64_t s2, int64_t s3,
        int64_t run_len, int elem_size, void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || n3 <= 0 || run_len <= 0)
    return (int)cudaErrorInvalidValue;
  if (elem_size != 2 && elem_size != 4) return (int)cudaErrorInvalidValue;
  RunMap m{n1, n2, n3, s0, s1, s2, s3, n0 * n1 * n2 * n3, run_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every stride of the four maps is a multiple of the run length, so a
  // run of whole 16-byte vectors keeps every run aligned
  if ((run_len * elem_size) % 16 == 0 && aligned16(in) && aligned16(out))
    return launch<uint4>(in, out, m, elem_size, s);
  if (elem_size == 4) return launch<uint32_t>(in, out, m, elem_size, s);
  return launch<uint16_t>(in, out, m, elem_size, s);
}

}  // namespace

// in (E, 2I, D) -> out (G, E, 2 * I/G, D); G must divide I.
extern "C" int pack_peer_chunks_launch(const void* in, void* out, int E,
                                       int I, int D, int G, int elem_size,
                                       void* stream) {
  if (G <= 0 || I % G) return (int)cudaErrorInvalidValue;
  const int64_t Ih = I / G, d = D;
  // output runs (g, e, h, j)
  return run(in, out, G, E, 2, Ih, Ih * d, 2LL * I * d, (int64_t)I * d, d, d,
             elem_size, stream);
}

// in (G, E, 2 * Ih, D) -> out (E, 2 * G * Ih, D).
extern "C" int interleave_shards_launch(const void* in, void* out, int G,
                                        int E, int Ih, int D, int elem_size,
                                        void* stream) {
  const int64_t ih = Ih, d = D;
  // output runs (e, h, g, j)
  return run(in, out, E, 2, G, Ih, 2 * ih * d, ih * d, (int64_t)E * 2 * ih * d,
             d, d, elem_size, stream);
}

// in (E, D, I) -> out (G, E, D, I/G); G must divide I.
extern "C" int pack_width_chunks_launch(const void* in, void* out, int E,
                                        int D, int I, int G, int elem_size,
                                        void* stream) {
  if (G <= 0 || I % G) return (int)cudaErrorInvalidValue;
  const int64_t Ic = I / G, d = D;
  // output runs (g, e, d)
  return run(in, out, G, E, D, 1, Ic, d * I, I, 0, Ic, elem_size, stream);
}

// in (G, E, D, Ic) -> out (E, D, G * Ic).
extern "C" int interleave_width_shards_launch(const void* in, void* out,
                                              int G, int E, int D, int Ic,
                                              int elem_size, void* stream) {
  const int64_t ic = Ic, d = D;
  // output runs (e, d, g)
  return run(in, out, E, D, G, 1, d * ic, ic, (int64_t)E * d * ic, 0, ic,
             elem_size, stream);
}
