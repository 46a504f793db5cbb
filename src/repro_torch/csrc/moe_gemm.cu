// Grouped expert GEMM for Hopper, sm_90a: out[e] = x[e] @ w[e]^T.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/moe_gemm/kernel.py:grouped_matmul_pallas (body _gmm_kernel).
//
// Contract (the same for both GEMMs of the grouped SwiGLU FFN):
//   x (E, C, D), w (E, W, D) -> out (E, C, W) in x.dtype, fp32 accumulation.
// E is every (rank, local expert) group of a layer in one launch; C is the
// per-expert capacity, with ragged and zero-token experts carried as zero
// rows. Optional counts (E,) int32: rows at or past counts[e] are taken as
// zero, so their output is written as zero without reading x or w.
//
// What bounds it on the H100: at decode C (a handful of tokens per expert)
// it is the weight bytes, E * W * D elements read once, over 3.35 TB/s; at
// prefill C (tens to hundreds of rows) it is the flops, 2 * E * C * W * D.
//
// What this simple design does about that: a shared-memory tiled GEMM,
// grid (W tiles, C tiles, E groups), 64 x 64 output tile per block of 256
// threads, 4 x 4 outputs per thread in fp32 registers, depth staged 32 at a
// time through shared memory. A weight tile is read once per C tile, so at
// decode C (one C tile) the weights stream through exactly once and every
// SM has blocks in flight. With counts, a row tile past its expert's
// load skips the depth loop, so the work follows the tokens routed, not
// the capacity. fp32 inputs run IEEE fp32 FMA (never TF32);
// bf16 inputs are widened to fp32 on load and run the same FMA path. No
// tensor cores and no library calls: wgmma and TMA pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // rows of C per block
constexpr int kBN = 64;   // columns of W per block
constexpr int kBK = 32;   // depth per shared-memory stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int* __restrict__ counts, T* __restrict__ out, int C, int D,
           int W) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* xe = x + (size_t)e * C * D;
  const T* we = w + (size_t)e * W * D;
  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j: neighbouring
  // threads read neighbouring shared-memory words and store neighbouring
  // output columns
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // rows at or past this expert's load are zero: skip their depth loop
  const int c_end = counts ? min(C, counts[e]) : C;
  const int k_end = c0 < c_end ? D : 0;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int i = tid + s * kThreads;
      const int r = i / kBK, kk = i % kBK, k = k0 + kk;
      const int c = c0 + r, n = n0 + r;
      xs[kk][r] = (c < c_end && k < D) ? to_f32(xe[(size_t)c * D + k]) : 0.f;
      ws[kk][r] = (n < W && k < D) ? to_f32(we[(size_t)n * D + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < W) store(out + ((size_t)e * C + c) * W + n, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* counts, void* out,
           int E, int C, int D, int W, cudaStream_t stream) {
  dim3 grid((W + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                              static_cast<const T*>(w),
                                              counts, static_cast<T*>(out),
                                              C, D, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); counts may be
// null. Returns the cudaError_t of the launch (0 = success).
extern "C" int grouped_matmul_launch(const void* x, const void* w,
                                     const void* counts, void* out, int E,
                                     int C, int D, int W, int dtype,
                                     void* stream) {
  const int* cnt = static_cast<const int*>(counts);
  if (E <= 0 || C <= 0 || D <= 0 || W <= 0 || E > 65535 ||
      (C + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, cnt, out, E, C, D, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, cnt, out, E, C, D, W, s);
  return (int)cudaErrorInvalidValue;
}
