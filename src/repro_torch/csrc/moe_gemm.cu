// Grouped expert GEMM for Hopper, sm_90a: out[e] = x[e] @ w[e]^T.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/moe_gemm/kernel.py:grouped_matmul_pallas (body _gmm_kernel).
//
// Contract (the same for both GEMMs of the grouped SwiGLU FFN):
//   x (E, C, D), w (E, W, D) -> out (E, C, W) in x.dtype, fp32 accumulation.
// E is every (rank, local expert) group of a layer in one launch; C is the
// per-expert buffer rows, with ragged and zero-token experts carried as
// zero rows. Optional counts (E,) int32: rows at or past counts[e] are
// taken as zero, so their output is written as exactly 0 whatever x holds
// there.
//
// What bounds it on the H100: at decode C (a handful of rows per expert)
// the weight bytes, E * W * D elements read once, over 3.35 TB/s; at a
// chunk-wide dispatch (C in the hundreds) bytes and operations meet
// (2 * E * C * W * D over 989 TFLOP/s in bf16).
//
// bf16 design (gmm_wgmma_kernel): swap A and B. A block computes a tile of
// out[e]^T = w[e] (W x D) . x[e]^T (D x C): the weights are wgmma's A
// (128 rows of W, two consumer warpgroups of m64 each) and the C rows are
// its N (rounded up to 8..256), so a decode tile wastes no multiply-adds on
// zero rows of a 64-row C tile. Both operands are K-major as stored, so no
// transpose. A producer warp streams 64-deep D slabs of w and x through a
// ring of shared-memory stages with TMA (128-byte swizzle, completion on
// mbarriers); the consumers issue bf16 wgmma.mma_async with fp32
// accumulators in registers and free a stage as soon as the wgmma that read
// it has retired. 3-D tensor maps (D, W, E) and (D, C, E) zero-fill a
// ragged W, C or D edge inside its own expert. One block owns one
// (C pass, W tile, expert); C > 256 takes more than one pass, whose blocks
// run side by side and share the weight tile through L2. A block whose
// expert has no row past its pass start writes zeros and reads nothing.
// Epilogue: the accumulator tile goes through shared memory as bf16 so that
// out, W-contiguous, is written with 16-byte stores.
//
// f32 design (gmm_kernel, unchanged from the first port): a shared-memory
// tiled IEEE fp32 FMA GEMM (never TF32), grid (W tiles, C tiles, E), 64 x 64
// tile per block of 256 threads. The path is chosen by dtype alone.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// f32: IEEE fp32 FMA tiled GEMM
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBM = 64;   // rows of C per block
constexpr int kBN = 64;   // columns of W per block
constexpr int kBK = 32;   // depth per shared-memory stage

__global__ void __launch_bounds__(kThreads)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ counts, float* __restrict__ out, int C,
           int D, int W) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float* xe = x + (size_t)e * C * D;
  const float* we = w + (size_t)e * W * D;
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
      xs[kk][r] = (c < c_end && k < D) ? xe[(size_t)c * D + k] : 0.f;
      ws[kk][r] = (n < W && k < D) ? we[(size_t)n * D + k] : 0.f;
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
      if (n < W) out[((size_t)e * C + c) * W + n] = acc[i][j];
    }
  }
}

int launch_f32(const void* x, const void* w, const int* counts, void* out,
               int E, int C, int D, int W, cudaStream_t stream) {
  if ((C + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((W + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gmm_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), counts,
      static_cast<float*>(out), C, D, W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: swap-AB wgmma over a TMA ring
// ---------------------------------------------------------------------------

constexpr int kWM = 128;             // W rows per block (2 warpgroups x m64)
constexpr int kWK = 64;              // D depth per stage: 128 B, one swizzle row
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kWThreads = kConsumers + 32;   // + one producer warp
constexpr int kStageA = kWM * kWK * 2;       // 16 KB of weights per stage
constexpr int kPad = 8;              // epilogue row padding (elements)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 3-D TMA tile load, coordinates innermost first
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 B, 8-row atoms 1024 B apart (SBO), the
// leading offset unused; the tile base must be 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// m64nNk16 bf16 x bf16 -> fp32, A and B K-major from shared memory,
// D += A . B (scale-d = 1; the accumulators start at zero)
template <int N>
struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
        "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
        "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
        "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int BN>
struct GmmCfg {
  static constexpr int kStages = BN <= 32 ? 3 : (BN == 128 ? 6 : 4);
  static constexpr int kMinBlocks = BN <= 32 ? 3 : (BN == 64 ? 2 : 1);
  static constexpr int kStage = kStageA + BN * kWK * 2;   // w slab + x slab
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
  static_assert(BN * (kWM + kPad) * 2 <= kStages * kStage,
                "epilogue tile must fit in the ring");
};

// keep the compiler from moving accumulator registers across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// out[c, w] = 0 for c in [c_lo, c_hi), w in [w_lo, w_hi), row pitch W
__device__ __forceinline__ void zero_tile(__nv_bfloat16* o, int c_lo,
                                          int c_hi, int w_lo, int w_hi,
                                          int W, int tid, int nt) {
  const int nc = c_hi - c_lo, nw = w_hi - w_lo;
  if (W % 8 == 0) {
    const int nq = nw / 8;
    for (int i = tid; i < nc * nq; i += nt)
      *reinterpret_cast<uint4*>(o + (size_t)(c_lo + i / nq) * W + w_lo +
                                (i % nq) * 8) = make_uint4(0, 0, 0, 0);
  } else {
    for (int i = tid; i < nc * nw; i += nt)
      o[(size_t)(c_lo + i / nw) * W + w_lo + i % nw] = __float2bfloat16(0.f);
  }
}

template <int BN>
__global__ void __launch_bounds__(kWThreads, GmmCfg<BN>::kMinBlocks)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_x,
                 const int* __restrict__ counts,
                 __nv_bfloat16* __restrict__ out, int C, int D, int W) {
  using Cfg = GmmCfg<BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 B: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Cfg::kStage);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, w0 = blockIdx.y * kWM, e = blockIdx.z;
  const int cnt = counts ? min(C, counts[e]) : C;
  __nv_bfloat16* oe = out + (size_t)e * C * W;
  const int c_hi = min(C, n0 + BN), w_hi = min(W, w0 + kWM);
  if (n0 >= cnt) {          // no routed row in this pass: zeros, no reads
    zero_tile(oe, n0, c_hi, w0, w_hi, W, tid, kWThreads);
    return;
  }
  const int nk = (D + kWK - 1) / kWK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);      // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread keeps S slabs of w and x in flight
    if (tid == kConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        if (kb >= S) mbar_wait(&empty[s], ((kb / S) + 1) & 1);
        uint8_t* st = smem + s * Cfg::kStage;
        mbar_expect_tx(&full[s], Cfg::kStage);
        tma_load_3d(st, &tm_w, &full[s], kb * kWK, w0, e);
        tma_load_3d(st + kStageA, &tm_x, &full[s], kb * kWK, n0, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns W rows [w0 + 64 wg, w0 + 64 wg + 64)
  const int wg = tid / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs<BN / 2>(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S;
    mbar_wait(&full[s], (kb / S) & 1);
    const uint8_t* st = smem + s * Cfg::kStage;
    const uint64_t da = sw128_desc(st + wg * 64 * 128);
    const uint64_t db = sw128_desc(st + kStageA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk)      // 16-deep steps: +32 B
      Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();                 // the previous slab's wgmma retired
    if (kb > 0 && tid % 128 == 0) mbar_arrive(&empty[(kb - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);

  // epilogue: the tile of out^T through shared memory as out (c, w) in bf16
  consumer_sync();                   // both warpgroups are done with the ring
  constexpr int P = kWM + kPad;
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem);   // [BN][P]
  const int lane = tid % 32;
  const int r = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    stg[c * P + r] = __float2bfloat16(acc[4 * j]);
    stg[(c + 1) * P + r] = __float2bfloat16(acc[4 * j + 1]);
    stg[c * P + r + 8] = __float2bfloat16(acc[4 * j + 2]);
    stg[(c + 1) * P + r + 8] = __float2bfloat16(acc[4 * j + 3]);
  }
  consumer_sync();
  const int nc = c_hi - n0, nw = w_hi - w0;
  if (W % 8 == 0) {                  // 16-byte stores along W
    constexpr int Q = kWM / 8;
    for (int i = tid; i < nc * Q; i += kConsumers) {
      const int c = i / Q, q = i % Q;
      if (q * 8 >= nw) continue;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + c < cnt) v = *reinterpret_cast<const uint4*>(stg + c * P + q * 8);
      *reinterpret_cast<uint4*>(oe + (size_t)(n0 + c) * W + w0 + q * 8) = v;
    }
  } else {
    for (int i = tid; i < nc * kWM; i += kConsumers) {
      const int c = i / kWM, q = i % kWM;
      if (q >= nw) continue;
      oe[(size_t)(n0 + c) * W + w0 + q] =
          n0 + c < cnt ? stg[c * P + q] : __float2bfloat16(0.f);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (inner, rows, E) bf16 tensor, box (kWK, box_rows, 1), 128-byte swizzle;
// out-of-bounds rows and depth read as zero
bool make_map(CUtensorMap* map, const void* base, int inner, int rows, int E,
              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)rows * inner * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kWK, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_bf16_n(const void* x, const void* w, const int* counts, void* out,
                  int E, int C, int D, int W, cudaStream_t stream) {
  using Cfg = GmmCfg<BN>;
  CUtensorMap tm_w, tm_x;
  if (!make_map(&tm_w, w, D, W, E, kWM) || !make_map(&tm_x, x, D, C, E, BN))
    return (int)cudaErrorInvalidValue;
  auto kern = gmm_wgmma_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + BN - 1) / BN, (W + kWM - 1) / kWM, E);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, kWThreads, Cfg::kSmem, stream>>>(
      tm_w, tm_x, counts, static_cast<__nv_bfloat16*>(out), C, D, W);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, const int* counts, void* out,
                int E, int C, int D, int W, cudaStream_t s) {
  // TMA: 16-byte aligned bases and row strides
  if (D % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (C <= 8) return launch_bf16_n<8>(x, w, counts, out, E, C, D, W, s);
  if (C <= 16) return launch_bf16_n<16>(x, w, counts, out, E, C, D, W, s);
  if (C <= 32) return launch_bf16_n<32>(x, w, counts, out, E, C, D, W, s);
  if (C <= 64) return launch_bf16_n<64>(x, w, counts, out, E, C, D, W, s);
  if (C <= 128) return launch_bf16_n<128>(x, w, counts, out, E, C, D, W, s);
  return launch_bf16_n<256>(x, w, counts, out, E, C, D, W, s);
}

}  // namespace

// dtype: 0 = float32 (fp32 FMA path), 1 = bfloat16 (wgmma path); x, w and
// out share it; counts may be null. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int grouped_matmul_launch(const void* x, const void* w,
                                     const void* counts, void* out, int E,
                                     int C, int D, int W, int dtype,
                                     void* stream) {
  const int* cnt = static_cast<const int*>(counts);
  if (E <= 0 || C <= 0 || D <= 0 || W <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, w, cnt, out, E, C, D, W, s);
  if (dtype == 1) return launch_bf16(x, w, cnt, out, E, C, D, W, s);
  return (int)cudaErrorInvalidValue;
}
