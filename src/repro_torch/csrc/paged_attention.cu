// Paged attention (flash decoding over a block table) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/paged_attention/kernel.py:paged_attention_pallas
//   (body _paged_attn_kernel).
//
// Contract: q (G,B,Sq,H,dh); K/V pools (G,pages,page,K,dh) read through a
// (G,B,maxp) block table; masks on kv_len, causal (q_offset + i) and the
// optional sliding window, NEG_INF = -1e30; the page walk of a row tile
// stops at min(kv_len, q_offset + last row + 1) and, with a window, starts
// at the first page any row of the tile can see. Page ids are clamped into
// the pool, so a bad table cannot read out of bounds. Rows with no valid
// position are unspecified, as in every backend.
//
// What bounds it on the H100: the live K/V bytes. A decode row does ~4*dh
// flops per (query row, kv position) pair against 4*dh bytes of K/V per
// KV head shared by rep query heads, far below the card's ~295 flop/byte
// ridge; a prefill chunk (rep * Sq rows per KV head) is at or above it and
// needs the tensor cores.
//
// bf16 design (paged_attn_split_kernel + paged_attn_combine_kernel,
// flash-decoding): the KV range of every (rank, row, KV head, row tile) is
// cut into n_split contiguous page ranges (kernel.py:kv_split, a function of
// shapes alone, aiming at about four waves of two resident blocks on 132
// SMs), one block of 4 warps each. A block stages its page ids in shared
// memory, gathers 64-position K and V tiles through them with 16-byte
// cp.async into a three-stage, XOR-swizzled shared-memory ring (two tiles
// in flight while one is computed), and runs S = QK^T and O += PV as
// mma.sync.m16n8k16 bf16 -> fp32 (K through ldmatrix, V through
// ldmatrix.trans), with the online softmax in registers (base 2) and P
// rounded to bf16 for PV. Each warp holds 16 query rows: a decode tile
// (rep * Sq <= 16 rows, e.g. the 16 query heads of one KV head) gives each
// of the four warps its own quarter of every KV tile, which it loads itself
// (no block-wide barrier in the page loop), and merges the four at the end;
// a prefill tile gives each warp its own 16 of 64 rows. A split writes its
// (max, sum, acc) in fp32 to scratch the wrapper allocates, and the combine
// kernel (one block per output row) merges the splits; a single split
// writes the output directly. A split wholly outside the tile's live page
// range loads nothing and writes l = 0, acc = 0; a split whose positions
// are all masked ends with m = NEG_INF and weighs exp2(NEG_INF - m) = 0 in
// the merge whenever any split of the row saw a valid position.
//
// f32 design (paged_attn_kernel, unchanged from the first port): one block
// per (rank, row, KV head, 32-row tile) walks the live pages serially with
// fp32 FMA out of shared memory. The path is chosen by dtype alone.
//
// Head dims: 64, 80, 128 and 256 (zamba2's shared attention has dh 80,
// paligemma-3b's MQA 256). At 80 a K/V row is ten 16-byte chunks, not a
// multiple of eight: the shared-memory swizzle of the bf16 tiles flips the
// chunk's low bit on rows 4-7 of every eight (kv_off), QK^T runs five
// k-steps (the last through ldmatrix.x2), and the f32 kernel's threads past
// kRowsPerPass * DH sit out the PV pass. At 256 the output accumulator
// alone is 128 fp32 registers a thread, and holding Q's fragments as well
// (64 more) would spill: the block stages its Q tile once in shared memory
// behind the page ids (swizzled as the K/V tiles) and each k-step of QK^T
// reads its A fragments there with ldmatrix (kQSmem); the ring keeps its
// three stages (196,608 B) and the Q tile adds 8-32 KB, under the 227 KB
// opt-in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 32;          // query rows per block tile
constexpr int kMaxPage = 64;     // mirrored in kernel.py (MAX_PAGE)
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: serial fp32 FMA kernel
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const float* __restrict__ kpool,
                  const float* __restrict__ vpool, const int* __restrict__ bt,
                  const int* __restrict__ kv_lens,
                  const int* __restrict__ q_off, float* __restrict__ out, int B,
                  int Sq, int H, int K, int pages, int page, int maxp,
                  long long g_stride, int window, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kQT][DH], pre-scaled
  float* k_s = q_s + kQT * DH;          // [page][DH + 1] (padded: no conflicts)
  float* v_s = k_s + page * (DH + 1);   // [page][DH]
  float* s_s = v_s + page * DH;         // [kQT][page] scores -> probabilities
  float* m_s = s_s + kQT * page;        // [kQT] running max
  float* l_s = m_s + kQT;               // [kQT] running sum
  float* c_s = l_s + kQT;               // [kQT] this page's correction

  const int tid = threadIdx.x;
  const int gb = blockIdx.z;            // g * B + b
  const int g = gb / B;
  const int kvh = blockIdx.y;
  const int rep = H / K;
  const int rows = rep * Sq;            // row rr -> (sq = rr / rep, r = rr % rep)
  const int row0 = blockIdx.x * kQT;
  const int kv_len = kv_lens[gb];
  const int qo = q_off[gb];

  for (int i = tid; i < kQT * DH; i += kThreads) {
    const int qi = i / DH, d = i % DH, rr = row0 + qi;
    float v = 0.f;
    if (rr < rows) {
      const int sq = rr / rep, h = kvh * rep + rr % rep;
      v = q[(((size_t)gb * Sq + sq) * H + h) * DH + d] * scale;
    }
    q_s[i] = v;
  }
  if (tid < kQT) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // thread -> (row, d) of the PV pass: kRowsPerPass rows of DH threads;
  // at DH 80 that is 3 rows of 240 threads, and threads 240-255 sit out
  constexpr int kRowsPerPass = kThreads / DH;
  constexpr int kAcc = (kQT + kRowsPerPass - 1) / kRowsPerPass;
  const int d_own = tid % DH;
  const int r_own = tid / DH;
  const bool pv_thread = r_own < kRowsPerPass;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  // live page range of this tile: the reference's early exit at
  // min(kv_len, q_offset + Sq), tightened to the tile's last query row
  const int last_row = min(rows, row0 + kQT) - 1;
  const int sq_lo = row0 / rep, sq_hi = last_row / rep;
  const int hi = min(kv_len, qo + sq_hi + 1);
  const int p_end = min(maxp, (hi + page - 1) / page);
  int p_begin = 0;
  if (window > 0) {
    const int lo = qo + sq_lo - window + 1;   // first position any row sees
    if (lo > 0) p_begin = lo / page;
  }

  const int row_elems = K * DH;               // elements per page slot
  const float* kbase = kpool + (size_t)g * (size_t)g_stride + kvh * DH;
  const float* vbase = vpool + (size_t)g * (size_t)g_stride + kvh * DH;
  const int* btrow = bt + (size_t)gb * maxp;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int pg = p_begin; pg < p_end; ++pg) {
    const int pid = min(max(btrow[pg], 0), pages - 1);
    const float* kp = kbase + (size_t)pid * page * row_elems;
    const float* vp = vbase + (size_t)pid * page * row_elems;
    for (int i = tid; i < page * DH; i += kThreads) {
      const int p = i / DH, d = i % DH;
      k_s[p * (DH + 1) + d] = kp[(size_t)p * row_elems + d];
      v_s[i] = vp[(size_t)p * row_elems + d];
    }
    __syncthreads();

    for (int i = tid; i < kQT * page; i += kThreads) {
      const int qi = i / page, p = i % page;
      const float* qr = q_s + qi * DH;
      const float* kr = k_s + p * (DH + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
      const int kpos = pg * page + p;
      const int qpos = qo + (row0 + qi) / rep;
      const bool ok = kpos < kv_len && kpos <= qpos &&
                      (window <= 0 || kpos > qpos - window);
      s_s[i] = ok ? s : kNegInf;
    }
    __syncthreads();

    for (int qi = warp; qi < kQT; qi += kThreads / 32) {
      float* sr = s_s + qi * page;
      float mx = kNegInf;
      for (int p = lane; p < page; p += 32) mx = fmaxf(mx, sr[p]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[qi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int p = lane; p < page; p += 32) {
        const float e = expf(sr[p] - m_new);
        sr[p] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[qi] = corr;
        l_s[qi] = l_s[qi] * corr + sum;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int qi = r_own + j * kRowsPerPass;
      if (!pv_thread || qi >= kQT) continue;
      const float* pr = s_s + qi * page;
      float a = acc[j] * c_s[qi];
      for (int p = 0; p < page; ++p) a = fmaf(pr[p], v_s[p * DH + d_own], a);
      acc[j] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int qi = r_own + j * kRowsPerPass, rr = row0 + qi;
    if (pv_thread && qi < kQT && rr < rows) {
      const int sq = rr / rep, h = kvh * rep + rr % rep;
      out[(((size_t)gb * Sq + sq) * H + h) * DH + d_own] =
          acc[j] / fmaxf(l_s[qi], 1e-30f);
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const int* bt,
           const int* lens, const int* qoff, void* out, int G, int B, int Sq,
           int H, int K, int pages, int page, int maxp, long long g_stride,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kQT * DH + page * (DH + 1) +
                                       page * DH + kQT * page + 3 * kQT);
  auto kern = paged_attn_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rep = H / K;
  dim3 grid((rep * Sq + kQT - 1) / kQT, K, G * B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bt, lens, qoff, static_cast<float*>(out),
      B, Sq,
      H, K, pages, page, maxp, g_stride, window,
      (float)(1.0 / std::sqrt((double)DH)));
  return (int)cudaGetLastError();
}

int launch_f32_dh(int dh, const void* q, const void* k, const void* v,
              const int* bt, const int* lens, const int* qoff, void* out,
              int G, int B, int Sq, int H, int K, int pages, int page,
              int maxp, long long g_stride, int window, cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch_f32<64>(q, k, v, bt, lens, qoff, out, G, B, Sq, H, K,
                            pages, page, maxp, g_stride, window, s);
    case 80:
      return launch_f32<80>(q, k, v, bt, lens, qoff, out, G, B, Sq, H, K,
                            pages, page, maxp, g_stride, window, s);
    case 128:
      return launch_f32<128>(q, k, v, bt, lens, qoff, out, G, B, Sq, H, K,
                             pages, page, maxp, g_stride, window, s);
    case 256:
      return launch_f32<256>(q, k, v, bt, lens, qoff, out, G, B, Sq, H, K,
                             pages, page, maxp, g_stride, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: split-KV on tensor cores
// ---------------------------------------------------------------------------

constexpr int kSThreads = 128;       // 4 warps
constexpr int kKvTile = 64;          // KV positions per shared-memory stage
constexpr int kStages = 3;           // K/V tiles in the ring
constexpr int kMaxSplitPages = 512;  // mirrored in kernel.py (MAX_SPLIT_PAGES)

struct SplitParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* bt;
  const int* lens;
  const int* qoff;
  __nv_bfloat16* out;
  float* part_acc;     // (tiles, n_split, tile_rows, dh), n_split > 1 only
  float* part_ml;      // (tiles, n_split, tile_rows, 2): max (log2), sum
  int B, Sq, H, K, pages, page, maxp;
  long long g_stride;
  int window;
  float scale_log2;    // 1/sqrt(dh) * log2(e): scores kept in base 2
  int rows, tile_rows, row_tiles, n_split, split_pages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D (16x8 f32) += A (16x16 bf16, row) . B (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk c of K/V tile row r, so that ldmatrix's
// eight row addresses (eight consecutive rows, one chunk) hit the eight
// 16-byte bank groups. Rows of 8k chunks (dh 64, 128): the chunk XOR r % 8.
// Rows of 10 chunks (dh 80, 160 bytes): row r starts 2r groups along, so
// rows r and r + 4 would meet; flipping the chunk's low bit on rows 4-7
// moves those to the odd groups, and c ^ 1 stays inside the row.
template <int DH>
__device__ __forceinline__ uint32_t kv_off(int r, int c) {
  static_assert(DH % 128 == 0 || DH == 64 || DH == 80, "kv_off: head dim");
  if constexpr (DH == 80)
    return (uint32_t)(r * DH * 2 + ((c ^ ((r >> 2) & 1)) << 4));
  else
    return (uint32_t)(r * DH * 2 + ((c ^ (r & 7)) << 4));
}

// Block = (split, KV head x row tile, rank x batch row), 4 warps. Warp w
// holds query rows [16 (w % RG), +16) of the tile (RG = 4 / KS row groups)
// and KV positions [w / RG * 64 / KS, +64 / KS) of every 64-position tile:
// decode tiles (16 rows) spread one tile's positions over the 4 warps
// (KS = 4), prefill tiles (64 rows) give each warp 16 rows (KS = 1).
template <int DH, int KS>
__global__ void __launch_bounds__(kSThreads)
paged_attn_split_kernel(const SplitParams p) {
  constexpr int RG = 4 / KS;           // row groups of 16
  constexpr int NP = kKvTile / KS;     // positions per warp per tile
  constexpr int CPR = DH / 8;          // 16-byte chunks per K/V row
  constexpr int TILE_B = kKvTile * DH * 2;
  // Q's fragments from shared memory (dh 256: see the header)
  constexpr bool kQSmem = DH >= 256;
  extern __shared__ __align__(128) uint8_t split_smem[];
  // ring: [kStages][K, V][64][DH] bf16, then the split's page ids
  // [kMaxSplitPages], then (kQSmem) the tile's Q [RG * 16][DH] bf16; the
  // ring is reused by the epilogue as red_acc [4 warps][16][DH] f32,
  // red_m / red_l [4 warps][16]
  float* red_acc = reinterpret_cast<float*>(split_smem);
  float* red_m = red_acc + 4 * 16 * DH;
  float* red_l = red_m + 4 * 16;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / p.row_tiles, rt = blockIdx.y % p.row_tiles;
  const int gb = blockIdx.z, g = gb / p.B;
  const int rep = p.H / p.K;
  const int row0 = rt * p.tile_rows;
  const int kv_len = p.lens[gb], qo = p.qoff[gb];
  const int tile_id = (gb * p.K + kvh) * p.row_tiles + rt;

  // live page range of this row tile: the reference's early exit at
  // min(kv_len, q_offset + last row + 1), and the window's first page
  const int last_row = min(p.rows, row0 + p.tile_rows) - 1;
  const int sq_lo = row0 / rep, sq_hi = last_row / rep;
  const int hi_pos = min(kv_len, qo + sq_hi + 1);
  const int p_end = min(p.maxp, (hi_pos + p.page - 1) / p.page);
  int p_begin = 0;
  if (p.window > 0) {
    const int lo = qo + sq_lo - p.window + 1;
    if (lo > 0) p_begin = lo / p.page;
  }
  // this split's pages, cut to the live range
  const int s_lo = split * p.split_pages;
  const int s_hi = min(p.maxp, s_lo + p.split_pages);
  const int pg_lo = max(s_lo, p_begin), pg_hi = min(s_hi, p_end);
  const int pos_lo = pg_lo * p.page;
  const int pos_hi = min(pg_hi * p.page, hi_pos);

  const int rg = warp % RG, ks = warp / RG;
  const int gq = lane / 4, tq = lane % 4;
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  if (pg_lo < pg_hi && pos_lo < pos_hi) {
    // this warp's two query rows per thread and their Q fragments
    const int r_lo = row0 + rg * 16 + gq, r_hi = r_lo + 8;
    const int qp_lo = qo + r_lo / rep, qp_hi = qo + r_hi / rep;
    uint32_t qf[kQSmem ? 1 : DH / 16][4];
    if constexpr (!kQSmem) {
      const __nv_bfloat16* q_lo = nullptr;
      const __nv_bfloat16* q_hi = nullptr;
      if (r_lo < p.rows)
        q_lo = p.q + (((size_t)gb * p.Sq + r_lo / rep) * p.H + kvh * rep +
                      r_lo % rep) * DH;
      if (r_hi < p.rows)
        q_hi = p.q + (((size_t)gb * p.Sq + r_hi / rep) * p.H + kvh * rep +
                      r_hi % rep) * DH;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk * 16 + 2 * tq;
        qf[kk][0] = q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + c) : 0u;
        qf[kk][1] = q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + c) : 0u;
        qf[kk][2] =
            q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + c + 8) : 0u;
        qf[kk][3] =
            q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + c + 8) : 0u;
      }
    }

    const size_t row_elems = (size_t)p.K * DH;
    const __nv_bfloat16* kb =
        p.k + (size_t)g * (size_t)p.g_stride + kvh * DH;
    const __nv_bfloat16* vb =
        p.v + (size_t)g * (size_t)p.g_stride + kvh * DH;
    const uint32_t ring = smem_addr(split_smem);
    // the split's page ids, clamped into the pool, staged once
    int* sbt = reinterpret_cast<int*>(split_smem + kStages * 2 * TILE_B);
    const int* btrow = p.bt + (size_t)gb * p.maxp + pg_lo;
    for (int i = tid; i < pg_hi - pg_lo; i += kSThreads)
      sbt[i] = min(max(btrow[i], 0), p.pages - 1);
    // the tile's Q rows (zero past p.rows), one 32-bit word a thread a pass
    const uint32_t qsm =
        ring + kStages * 2 * TILE_B + kMaxSplitPages * 4;
    if constexpr (kQSmem) {
      uint8_t* qs = split_smem + kStages * 2 * TILE_B + kMaxSplitPages * 4;
      constexpr int WPR = DH / 2;                // words a row
      for (int i = tid; i < RG * 16 * WPR; i += kSThreads) {
        const int r = i / WPR, w = i % WPR, rr = row0 + r;
        uint32_t val = 0u;
        if (rr < p.rows)
          val = *reinterpret_cast<const uint32_t*>(
              p.q + (((size_t)gb * p.Sq + rr / rep) * p.H + kvh * rep +
                     rr % rep) * DH + 2 * w);
        *reinterpret_cast<uint32_t*>(qs + kv_off<DH>(r, w / 4) +
                                     (w % 4) * 4) = val;
      }
    }
    __syncthreads();

    // gather one 64-position tile of K and V through the block table. With
    // KS = 4 each warp alone reads its 16 rows of a tile: it loads them
    // itself and the pipeline needs no block-wide barrier.
    constexpr bool kOwn = KS == 4;
    constexpr int LT = kOwn ? 32 : kSThreads;    // loading threads
    constexpr int LR = kOwn ? NP : kKvTile;      // rows they load
    const int lt = kOwn ? lane : tid, lr0 = kOwn ? ks * NP : 0;
    // the LR x CPR chunks of the rows, LT at a time (a thread's chunk
    // column changes between passes when CPR does not divide LT: dh 80)
    static_assert((LR * CPR) % LT == 0, "load_tile: whole passes");
    auto load_tile = [&](int t0, int stage) {
      const uint32_t kdst = ring + stage * 2 * TILE_B;
#pragma unroll
      for (int j = 0; j < LR * CPR / LT; ++j) {
        const int idx = lt + j * LT, c = idx % CPR;
        const int r = lr0 + idx / CPR, pos = t0 + r;
        const __nv_bfloat16* ks_ = kb;
        const __nv_bfloat16* vs_ = vb;
        int nbytes = 0;
        if (pos < pos_hi) {
          const int pg = pos / p.page;
          const size_t off =
              ((size_t)sbt[pg - pg_lo] * p.page + (pos - pg * p.page)) *
                  row_elems + c * 8;
          ks_ = kb + off;
          vs_ = vb + off;
          nbytes = 16;
        }
        cp_async16(kdst + kv_off<DH>(r, c), ks_, nbytes);
        cp_async16(kdst + TILE_B + kv_off<DH>(r, c), vs_, nbytes);
      }
      cp_async_commit();
    };

    // kStages - 1 tiles in flight while one is computed
    const int n_tiles = (pos_hi - pos_lo + kKvTile - 1) / kKvTile;
    load_tile(pos_lo, 0);
    if (n_tiles > 1) load_tile(pos_lo + kKvTile, 1);
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = pos_lo + t * kKvTile;
      if (t + 2 < n_tiles) {
        load_tile(t0 + 2 * kKvTile, (t + 2) % kStages);
        cp_async_wait<2>();
      } else if (t + 1 < n_tiles) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if (kOwn) __syncwarp(); else __syncthreads();
      const uint32_t kt = ring + (t % kStages) * 2 * TILE_B;
      const uint32_t vt = kt + TILE_B;
      const int w0 = ks * NP;          // this warp's first tile row

      // S = Q K^T for the warp's NP positions
      float s[NP / 8][4];
      if constexpr (kQSmem) {
        // k-steps outside: a pair of Q fragments read once serves every
        // position block (each s[nt] still sums its k-steps in order)
#pragma unroll
        for (int nt = 0; nt < NP / 8; ++nt)
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const int qr = rg * 16 + lane % 16;
#pragma unroll
        for (int kk = 0; kk < DH / 16; kk += 2) {
          uint32_t a0[4], a1[4];
          ldsm_x4(qsm + kv_off<DH>(qr, 2 * kk + lane / 16), a0);
          ldsm_x4(qsm + kv_off<DH>(qr, 2 * kk + 2 + lane / 16), a1);
#pragma unroll
          for (int nt = 0; nt < NP / 8; ++nt) {
            uint32_t b[4];
            const int r = w0 + nt * 8 + lane % 8;
            ldsm_x4(kt + kv_off<DH>(r, 2 * kk + lane / 8), b);
            mma16816(s[nt], a0, b[0], b[1]);
            mma16816(s[nt], a1, b[2], b[3]);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NP / 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < DH / 16; kk += 2) {
            uint32_t b[4];
            const int r = w0 + nt * 8 + lane % 8;
            if (kk + 1 < DH / 16) {
              ldsm_x4(kt + kv_off<DH>(r, 2 * kk + lane / 8), b);
              mma16816(s[nt], qf[kk], b[0], b[1]);
              mma16816(s[nt], qf[kk + 1], b[2], b[3]);
            } else {   // an odd last k-step (dh 80): its two chunks only
              ldsm_x2(kt + kv_off<DH>(r, 2 * kk + (lane / 8) % 2), b);
              mma16816(s[nt], qf[kk], b[0], b[1]);
            }
          }
        }
      }
      // masks and the online softmax (base 2), rows lo and hi
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NP / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = t0 + w0 + nt * 8 + 2 * tq + (i & 1);
          const int qpos = i < 2 ? qp_lo : qp_hi;
          const bool ok = kpos < pos_hi && kpos <= qpos &&
                          (p.window <= 0 || kpos > qpos - p.window);
          s[nt][i] = ok ? s[nt][i] * p.scale_log2 : kNegInf;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float c_lo = exp2f(m_lo - mn_lo), c_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= c_lo;
      l_hi *= c_hi;
#pragma unroll
      for (int nt = 0; nt < NP / 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mn_lo);
        s[nt][1] = exp2f(s[nt][1] - mn_lo);
        s[nt][2] = exp2f(s[nt][2] - mn_hi);
        s[nt][3] = exp2f(s[nt][3] - mn_hi);
        l_lo += s[nt][0] + s[nt][1];
        l_hi += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        acc[i][0] *= c_lo;
        acc[i][1] *= c_lo;
        acc[i][2] *= c_hi;
        acc[i][3] *= c_hi;
      }
      // O += P V: P rounded to bf16, V through ldmatrix.trans
#pragma unroll
      for (int j = 0; j < NP / 16; ++j) {
        const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                               pack_bf16(s[2 * j][2], s[2 * j][3]),
                               pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                               pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const int r = w0 + 16 * j + ((lane / 8) & 1) * 8 + lane % 8;
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(vt + kv_off<DH>(r, 2 * dp + lane / 16), b);
          mma16816(acc[2 * dp], a, b[0], b[1]);
          mma16816(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
      // stage t % kStages may be refilled
      if (kOwn) __syncwarp(); else __syncthreads();
    }
  }

  // epilogue: merge the KS warps of each row group in shared memory, then
  // write this split's partial (n_split > 1) or the final rows
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  __syncthreads();
  {
    float* ra = red_acc + warp * 16 * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int d = i * 8 + 2 * tq;
      *reinterpret_cast<float2*>(ra + gq * DH + d) =
          make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(ra + (gq + 8) * DH + d) =
          make_float2(acc[i][2], acc[i][3]);
    }
    if (tq == 0) {
      red_m[warp * 16 + gq] = m_lo;
      red_m[warp * 16 + gq + 8] = m_hi;
      red_l[warp * 16 + gq] = l_lo;
      red_l[warp * 16 + gq + 8] = l_hi;
    }
  }
  __syncthreads();
  const int tr = RG * 16;
  const size_t part = ((size_t)tile_id * p.n_split + split) * p.tile_rows;
  for (int i = tid; i < tr * DH; i += kSThreads) {
    const int r = i / DH, d = i % DH, rr = row0 + r;
    if (r >= p.tile_rows || rr >= p.rows) continue;
    const int rgr = r / 16, rl = r % 16;
    float m = kNegInf;
#pragma unroll
    for (int k = 0; k < KS; ++k) m = fmaxf(m, red_m[(rgr + k * RG) * 16 + rl]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int w = rgr + k * RG;
      const float c = exp2f(red_m[w * 16 + rl] - m);
      l += red_l[w * 16 + rl] * c;
      a += red_acc[(w * 16 + rl) * DH + d] * c;
    }
    if (p.n_split > 1) {
      p.part_acc[(part + r) * DH + d] = a;
      if (d == 0) {
        p.part_ml[(part + r) * 2] = m;
        p.part_ml[(part + r) * 2 + 1] = l;
      }
    } else {
      const int sq = rr / rep, h = kvh * rep + rr % rep;
      p.out[(((size_t)gb * p.Sq + sq) * p.H + h) * DH + d] =
          __float2bfloat16(a / fmaxf(l, 1e-30f));
    }
  }
}

// out = sum_s acc_s 2^(m_s - m) / sum_s l_s 2^(m_s - m), m = max_s m_s: a
// split that saw no valid position (m_s = NEG_INF) weighs 0 as soon as any
// split of the row did; an empty split carries l = 0, acc = 0. One block
// per output row (tile, row): the split weights once into shared memory,
// then one thread per dh element sums the splits' partials.
__device__ __forceinline__ float block_reduce(float v, float* buf, bool mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = mx ? fmaxf(v, u) : v + u;
  }
  if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = v;
  __syncthreads();
  v = buf[0];
  for (int w = 1; w < kSThreads / 32; ++w)
    v = mx ? fmaxf(v, buf[w]) : v + buf[w];
  __syncthreads();
  return v;
}

__device__ __forceinline__ void combine_rows(const SplitParams& p, int dh) {
  extern __shared__ float comb_smem[];   // [n_split] weights, [4] reduce
  float* wts = comb_smem;
  float* buf = comb_smem + p.n_split;
  const int tile_id = blockIdx.x / p.tile_rows, r = blockIdx.x % p.tile_rows;
  const int rt = tile_id % p.row_tiles;
  const int kvh = (tile_id / p.row_tiles) % p.K;
  const int gb = tile_id / (p.row_tiles * p.K);
  const int rep = p.H / p.K;
  const int rr = rt * p.tile_rows + r;
  if (rr >= p.rows) return;
  // partial of split s for this row: ((tile_id * n_split + s) * tile_rows + r)
  const size_t base = (size_t)tile_id * p.n_split * p.tile_rows + r;
  const size_t step = p.tile_rows;
  float m = kNegInf;
  for (int s = threadIdx.x; s < p.n_split; s += kSThreads)
    m = fmaxf(m, p.part_ml[(base + s * step) * 2]);
  m = block_reduce(m, buf, true);
  float l = 0.f;
  for (int s = threadIdx.x; s < p.n_split; s += kSThreads) {
    const size_t o = base + s * step;
    const float w = exp2f(p.part_ml[o * 2] - m);
    wts[s] = w;
    l += p.part_ml[o * 2 + 1] * w;
  }
  l = block_reduce(l, buf, false);      // its barrier publishes wts too
  const int sq = rr / rep, h = kvh * rep + rr % rep;
  __nv_bfloat16* o_row = p.out + (((size_t)gb * p.Sq + sq) * p.H + h) * dh;
  for (int d = threadIdx.x; d < dh; d += kSThreads) {
    float a = 0.f;
    for (int s = 0; s < p.n_split; ++s)
      a += p.part_acc[(base + s * step) * dh + d] * wts[s];
    o_row[d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
}

__global__ void __launch_bounds__(kSThreads)
paged_attn_combine_kernel(const SplitParams p, int dh) {
  combine_rows(p, dh);
}

template <int DH, int KS>
int launch_split(const SplitParams& p, int G, cudaStream_t stream) {
  constexpr int ring = kStages * 2 * kKvTile * DH * 2;
  constexpr int red = (4 * 16 * DH + 2 * 4 * 16) * 4;
  static_assert(red <= ring, "the epilogue reuses the ring");
  constexpr int q_tile = DH >= 256 ? (4 / KS) * 16 * DH * 2 : 0;
  constexpr int smem = ring + kMaxSplitPages * 4 + q_tile;
  auto kern = paged_attn_split_kernel<DH, KS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.n_split, p.K * p.row_tiles, G * p.B);
  kern<<<grid, kSThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return (int)e;
  paged_attn_combine_kernel<<<G * p.B * p.K * p.row_tiles * p.tile_rows,
                              kSThreads, (p.n_split + kSThreads / 32) * 4,
                              stream>>>(p, DH);
  return (int)cudaGetLastError();
}

int launch_bf16(int dh, const SplitParams& p, int G, cudaStream_t s) {
  // cp.async moves 16-byte chunks: K/V rows and rank strides in 8s
  if (p.n_split < 1 || p.n_split > 8192 || p.split_pages < 1 ||
      p.split_pages > kMaxSplitPages ||
      (long long)p.n_split * p.split_pages < p.maxp ||
      p.K * p.row_tiles > 65535 || p.g_stride % 8 != 0 ||
      reinterpret_cast<uintptr_t>(p.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.v) % 16 != 0 ||
      (p.n_split > 1 && (p.part_acc == nullptr || p.part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int key = dh * 100 + p.tile_rows;
  switch (key) {
    case 6416: return launch_split<64, 4>(p, G, s);
    case 6432: return launch_split<64, 2>(p, G, s);
    case 6464: return launch_split<64, 1>(p, G, s);
    case 8016: return launch_split<80, 4>(p, G, s);
    case 8032: return launch_split<80, 2>(p, G, s);
    case 8064: return launch_split<80, 1>(p, G, s);
    case 12816: return launch_split<128, 4>(p, G, s);
    case 12832: return launch_split<128, 2>(p, G, s);
    case 12864: return launch_split<128, 1>(p, G, s);
    case 25616: return launch_split<256, 4>(p, G, s);
    case 25632: return launch_split<256, 2>(p, G, s);
    case 25664: return launch_split<256, 1>(p, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16: latent attention (MLA), absorbed
// ---------------------------------------------------------------------------
//
// One latent pool (G, pages, page, DK) holds [c_kv | k_pe] per position; a
// query row is one head of one query token, [q_nope W_UK | q_pe] of DK
// values. out = softmax(q . k / sqrt(nope + rope)) . k[:, :DV]: V is the
// first DV columns of the K tile already in shared memory, so each latent
// tile crosses HBM once for all the heads of a batch row (a decode row's
// 8 or 16 heads fit one 16-row tile). Block = (split, row tile, rank x
// batch row), 8 warps. A 64-position tile is staged by cp.async into a
// two-stage ring (DK = 576: 72 KB a stage, the 16-row Q tile 18 KB beside
// it). S = Q K^T is split over positions: warp w computes the 16 x 8
// scores of positions [8w, 8w + 8) through all DK/16 k-steps (Q's A
// fragments from shared memory by ldmatrix, K's by ldmatrix); the tile's
// row maxima and sums are merged across the warps in shared memory, and
// P is written there in bf16. O += P V is split over output columns: warp
// w owns columns [64w, 64w + 64) of the DV = 512 (acc[8][4] a thread: a
// warp could not hold all 512), reading P by ldmatrix and V from the K
// tile by ldmatrix.trans. Every warp keeps the same running max and sum,
// so no cross-warp merge is needed at the end. The splits' partials go
// to paged_mla_combine_kernel, the GQA kernel's combine over DV columns.
// With `work` (the tracer's (2,) double counter; null when tracing is
// off) thread 0 of each block adds the bytes and FLOPs of its share:
// the live latent positions once (by the row's last row tile), Q in and
// O out of its rows (by split 0), and 2 (DK + DV) FLOPs per visible
// (row, position) pair.

constexpr int kMThreads = 256;      // 8 warps
constexpr int kMRows = 16;          // query rows per block tile (kernel.py)
constexpr int kMTile = 64;          // positions per stage
constexpr int kMStages = 2;

template <int DK>
__device__ __forceinline__ uint32_t lat_off(int r, int c) {
  static_assert(DK % 64 == 0, "lat_off: rows of whole 128-byte lines");
  return (uint32_t)(r * DK * 2 + ((c ^ (r & 7)) << 4));
}
__device__ __forceinline__ uint32_t p_off(int r, int c) {
  return (uint32_t)(r * kMTile * 2 + ((c ^ (r & 7)) << 4));
}

template <int DK, int DV>
__global__ void __launch_bounds__(kMThreads)
paged_mla_kernel(const SplitParams p, double* work) {
  constexpr int CPR = DK / 8;                  // 16-byte chunks a row
  constexpr int TILE_B = kMTile * DK * 2;
  constexpr int NW = kMThreads / 32;
  constexpr int CW = DV / NW;                  // output columns a warp
  static_assert(kMTile == 8 * NW && CW % 16 == 0, "warp split");
  extern __shared__ __align__(128) uint8_t mla_smem[];
  uint8_t* q_s = mla_smem + kMStages * TILE_B;
  uint8_t* p_s = q_s + kMRows * DK * 2;
  float* red_m = reinterpret_cast<float*>(p_s + kMRows * kMTile * 2);
  float* red_l = red_m + NW * kMRows;
  int* sbt = reinterpret_cast<int*>(red_l + NW * kMRows);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int split = blockIdx.x, rt = blockIdx.y;
  const int gb = blockIdx.z, g = gb / p.B;
  const int H = p.H;
  const int row0 = rt * kMRows;
  const int kv_len = p.lens[gb], qo = p.qoff[gb];
  const int tile_id = gb * p.row_tiles + rt;

  const int last_row = min(p.rows, row0 + kMRows) - 1;
  const int hi_pos = min(kv_len, qo + last_row / H + 1);
  const int p_end = min(p.maxp, (hi_pos + p.page - 1) / p.page);
  const int s_lo = split * p.split_pages;
  const int pg_lo = s_lo, pg_hi = min(min(p.maxp, s_lo + p.split_pages), p_end);
  const int pos_lo = pg_lo * p.page;
  const int pos_hi = min(pg_hi * p.page, hi_pos);

  float acc[CW / 8][4];
#pragma unroll
  for (int i = 0; i < CW / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  const int r_lo = row0 + gq, r_hi = r_lo + 8;
  const int qp_lo = qo + r_lo / H, qp_hi = qo + r_hi / H;

  if (pg_lo < pg_hi && pos_lo < pos_hi) {
    const __nv_bfloat16* base = p.k + (size_t)g * (size_t)p.g_stride;
    const int* btrow = p.bt + (size_t)gb * p.maxp + pg_lo;
    for (int i = tid; i < pg_hi - pg_lo; i += kMThreads)
      sbt[i] = min(max(btrow[i], 0), p.pages - 1);
    // the tile's Q rows (zero past p.rows)
    for (int i = tid; i < kMRows * CPR; i += kMThreads) {
      const int r = i / CPR, c = i % CPR, rr = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (rr < p.rows)
        v = *reinterpret_cast<const uint4*>(
            p.q + (((size_t)gb * p.Sq + rr / H) * H + rr % H) * DK + c * 8);
      *reinterpret_cast<uint4*>(q_s + lat_off<DK>(r, c)) = v;
    }
    __syncthreads();

    const uint32_t ring = smem_addr(mla_smem);
    auto load_tile = [&](int t0, int stage) {
      const uint32_t dst = ring + stage * TILE_B;
#pragma unroll 2
      for (int idx = tid; idx < kMTile * CPR; idx += kMThreads) {
        const int r = idx / CPR, c = idx % CPR, pos = t0 + r;
        const __nv_bfloat16* src = base;
        int nbytes = 0;
        if (pos < pos_hi) {
          const int pg = pos / p.page;
          src = base + ((size_t)sbt[pg - pg_lo] * p.page +
                        (pos - pg * p.page)) * DK + c * 8;
          nbytes = 16;
        }
        cp_async16(dst + lat_off<DK>(r, c), src, nbytes);
      }
      cp_async_commit();
    };

    const uint32_t qsm = smem_addr(q_s), psm = smem_addr(p_s);
    const int n_tiles = (pos_hi - pos_lo + kMTile - 1) / kMTile;
    load_tile(pos_lo, 0);
    if (n_tiles > 1) load_tile(pos_lo + kMTile, 1);
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = pos_lo + t * kMTile;
      if (t + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      const uint32_t kt = ring + (t % kMStages) * TILE_B;

      // S: this warp's 8 positions against the 16 rows, every k-step
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      const int kr = warp * 8 + lane % 8;
#pragma unroll 4
      for (int kk = 0; kk < DK / 16; kk += 2) {
        uint32_t a0[4], a1[4], b[4];
        ldsm_x4(qsm + lat_off<DK>(lane % 16, 2 * kk + lane / 16), a0);
        ldsm_x4(qsm + lat_off<DK>(lane % 16, 2 * kk + 2 + lane / 16), a1);
        ldsm_x4(kt + lat_off<DK>(kr, 2 * kk + lane / 8), b);
        mma16816(sc, a0, b[0], b[1]);
        mma16816(sc, a1, b[2], b[3]);
      }
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = t0 + warp * 8 + 2 * tq + (i & 1);
        const int qpos = i < 2 ? qp_lo : qp_hi;
        const bool ok = kpos < pos_hi && kpos <= qpos;
        sc[i] = ok ? sc[i] * p.scale_log2 : kNegInf;
      }
      mx_lo = fmaxf(sc[0], sc[1]);
      mx_hi = fmaxf(sc[2], sc[3]);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
      }
      if (tq == 0) {
        red_m[warp * kMRows + gq] = mx_lo;
        red_m[warp * kMRows + gq + 8] = mx_hi;
      }
      __syncthreads();
      float tm_lo = kNegInf, tm_hi = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        tm_lo = fmaxf(tm_lo, red_m[w * kMRows + gq]);
        tm_hi = fmaxf(tm_hi, red_m[w * kMRows + gq + 8]);
      }
      const float mn_lo = fmaxf(m_lo, tm_lo), mn_hi = fmaxf(m_hi, tm_hi);
      const float c_lo = exp2f(m_lo - mn_lo), c_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      sc[0] = exp2f(sc[0] - mn_lo);
      sc[1] = exp2f(sc[1] - mn_lo);
      sc[2] = exp2f(sc[2] - mn_hi);
      sc[3] = exp2f(sc[3] - mn_hi);
      float su_lo = sc[0] + sc[1], su_hi = sc[2] + sc[3];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        su_lo += __shfl_xor_sync(0xffffffffu, su_lo, o);
        su_hi += __shfl_xor_sync(0xffffffffu, su_hi, o);
      }
      // P in bf16: row gq and gq + 8, this warp's chunk of 8 positions
      *reinterpret_cast<uint32_t*>(p_s + p_off(gq, warp) + 4 * tq) =
          pack_bf16(sc[0], sc[1]);
      *reinterpret_cast<uint32_t*>(p_s + p_off(gq + 8, warp) + 4 * tq) =
          pack_bf16(sc[2], sc[3]);
      if (tq == 0) {
        red_l[warp * kMRows + gq] = su_lo;
        red_l[warp * kMRows + gq + 8] = su_hi;
      }
      __syncthreads();
      float ts_lo = 0.f, ts_hi = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        ts_lo += red_l[w * kMRows + gq];
        ts_hi += red_l[w * kMRows + gq + 8];
      }
      l_lo = l_lo * c_lo + ts_lo;
      l_hi = l_hi * c_hi + ts_hi;
#pragma unroll
      for (int i = 0; i < CW / 8; ++i) {
        acc[i][0] *= c_lo;
        acc[i][1] *= c_lo;
        acc[i][2] *= c_hi;
        acc[i][3] *= c_hi;
      }
      // O += P V over this warp's CW columns, V = the tile's first DV
#pragma unroll
      for (int j = 0; j < kMTile / 16; ++j) {
        uint32_t a[4];
        ldsm_x4(psm + p_off(lane % 16, 2 * j + lane / 16), a);
        const int r = 16 * j + ((lane / 8) & 1) * 8 + lane % 8;
#pragma unroll
        for (int dp = 0; dp < CW / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(kt + lat_off<DK>(r, warp * (CW / 8) + 2 * dp + lane / 16),
                    b);
          mma16816(acc[2 * dp], a, b[0], b[1]);
          mma16816(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();          // stage t % 2, P and the reductions reused
      if (t + 2 < n_tiles) load_tile(t0 + 2 * kMTile, t % kMStages);
    }
  }

  const size_t part = ((size_t)tile_id * p.n_split + split) * kMRows;
#pragma unroll
  for (int i = 0; i < CW / 8; ++i) {
    const int d = warp * CW + i * 8 + 2 * tq;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = gq + 8 * h2, rr = row0 + r;
      if (rr >= p.rows) continue;
      const float a0 = acc[i][2 * h2], a1 = acc[i][2 * h2 + 1];
      if (p.n_split > 1) {
        *reinterpret_cast<float2*>(p.part_acc + (part + r) * DV + d) =
            make_float2(a0, a1);
      } else {
        const float l = fmaxf(h2 ? l_hi : l_lo, 1e-30f);
        *reinterpret_cast<uint32_t*>(
            p.out + (((size_t)gb * p.Sq + rr / H) * H + rr % H) * DV + d) =
            pack_bf16(a0 / l, a1 / l);
      }
    }
  }
  if (p.n_split > 1 && warp == 0 && tq == 0) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = gq + 8 * h2;
      if (row0 + r >= p.rows) continue;
      p.part_ml[(part + r) * 2] = h2 ? m_hi : m_lo;
      p.part_ml[(part + r) * 2 + 1] = h2 ? l_hi : l_lo;
    }
  }
  if (work != nullptr && tid == 0) {
    double nbytes = 0.0, flops = 0.0;
    const int nrows = min(p.rows, row0 + kMRows) - row0;
    if (rt == p.row_tiles - 1 && pos_hi > pos_lo)
      nbytes += (double)(pos_hi - pos_lo) * DK * 2;
    if (split == 0) nbytes += (double)nrows * (DK + DV) * 2;
    if (pos_hi > pos_lo) {
      long long pairs = 0;
      for (int r = 0; r < nrows; ++r) {
        const int vis = min(pos_hi, qo + (row0 + r) / H + 1) - pos_lo;
        if (vis > 0) pairs += vis;
      }
      flops = 2.0 * (DK + DV) * (double)pairs;
    }
    atomicAdd(&work[0], nbytes);
    atomicAdd(&work[1], flops);
  }
}

__global__ void __launch_bounds__(kSThreads)
paged_mla_combine_kernel(const SplitParams p, int dh) {
  combine_rows(p, dh);
}

template <int DK, int DV>
int launch_mla(const SplitParams& p, int G, double* work, cudaStream_t s) {
  constexpr int smem = kMStages * kMTile * DK * 2 + kMRows * DK * 2 +
                       kMRows * kMTile * 2 + 2 * (kMThreads / 32) * kMRows * 4 +
                       kMaxSplitPages * 4;
  auto kern = paged_mla_kernel<DK, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.n_split, p.row_tiles, G * p.B);
  kern<<<grid, kMThreads, smem, s>>>(p, work);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return (int)e;
  paged_mla_combine_kernel<<<G * p.B * p.row_tiles * p.tile_rows, kSThreads,
                             (p.n_split + kSThreads / 32) * 4, s>>>(p, DV);
  return (int)cudaGetLastError();
}
}  // namespace

// dtype: 0 = float32 (serial fp32 kernel), 1 = bfloat16 (split-KV tensor
// core kernel; tile_rows, n_split, split_pages and the fp32 scratch
// part_acc / part_ml describe its split, kernel.py:kv_split). q, pools and
// out share the dtype. Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* kv_lens, const void* q_offset,
    void* out, int G, int B, int Sq, int H, int K, int dh, int pages,
    int page, int maxp, long long g_stride, int window, int dtype,
    int tile_rows, int n_split, int split_pages, void* part_acc,
    void* part_ml, void* stream) {
  if (K <= 0 || H % K != 0 || page <= 0 || page > kMaxPage || pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* qoff = static_cast<const int*>(q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_dh(dh, q, k_pool, v_pool, bt, lens, qoff, out, G, B,
                         Sq, H, K, pages, page, maxp, g_stride, window, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int rows = (H / K) * Sq;
  SplitParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pool);
  p.v = static_cast<const __nv_bfloat16*>(v_pool);
  p.bt = bt;
  p.lens = lens;
  p.qoff = qoff;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.Sq = Sq;
  p.H = H;
  p.K = K;
  p.pages = pages;
  p.page = page;
  p.maxp = maxp;
  p.g_stride = g_stride;
  p.window = window;
  p.scale_log2 = (float)(1.4426950408889634 / std::sqrt((double)dh));
  p.rows = rows;
  p.tile_rows = tile_rows;
  p.row_tiles = (rows + tile_rows - 1) / tile_rows;
  p.n_split = n_split;
  p.split_pages = split_pages;
  return launch_bf16(dh, p, G, s);
}

// Latent attention (MLA), bf16 only: q (G,B,Sq,H,dk) [q_nope W_UK | q_pe];
// one latent pool (G,pages,page,dk) at rank stride g_stride elements; out
// (G,B,Sq,H,dv) = softmax(q . k * scale) . k[:, :dv], masked on kv_len and
// causal on q_offset. dk 576 and dv 512 (DeepSeek-V3's latent) are
// instantiated. n_split, split_pages and the fp32 scratch part_acc
// (tiles, n_split, 16, dv) / part_ml (tiles, n_split, 16, 2) describe the
// split (kernel.py:mla_split); work: the tracer's (2,) double counter or
// null. Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_mla_launch(
    const void* q, const void* pool, const void* block_table,
    const void* kv_lens, const void* q_offset, void* out, int G, int B,
    int Sq, int H, int dk, int dv, int pages, int page, int maxp,
    long long g_stride, float scale, int n_split, int split_pages,
    void* part_acc, void* part_ml, void* work, void* stream) {
  if (H <= 0 || page <= 0 || page > kMaxPage || pages <= 0 || n_split < 1 ||
      n_split > 8192 || split_pages < 1 || split_pages > kMaxSplitPages ||
      (long long)n_split * split_pages < maxp || g_stride % 8 != 0 ||
      reinterpret_cast<uintptr_t>(pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  SplitParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(pool);
  p.v = p.k;
  p.bt = static_cast<const int*>(block_table);
  p.lens = static_cast<const int*>(kv_lens);
  p.qoff = static_cast<const int*>(q_offset);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.Sq = Sq;
  p.H = H;
  p.K = 1;
  p.pages = pages;
  p.page = page;
  p.maxp = maxp;
  p.g_stride = g_stride;
  p.window = 0;
  p.scale_log2 = (float)(1.4426950408889634 * (double)scale);
  p.rows = H * Sq;
  p.tile_rows = kMRows;
  p.row_tiles = (p.rows + kMRows - 1) / kMRows;
  p.n_split = n_split;
  p.split_pages = split_pages;
  if (p.row_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* w = static_cast<double*>(work);
  if (dk == 576 && dv == 512) return launch_mla<576, 512>(p, G, w, s);
  return (int)cudaErrorInvalidValue;
}
