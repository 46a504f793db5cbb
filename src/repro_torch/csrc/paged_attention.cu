// Paged attention (flash decoding over a block table) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/paged_attention/kernel.py:paged_attention_pallas
//   (body _paged_attn_kernel).
//
// What bounds it on the H100: the KV bytes it reads. A decode row reads
// every live K/V page of its request once per KV head and does ~4*dh flops
// per (query row, kv position) pair, far below the ~295 flop/byte ridge of
// the card, so the bound is live KV bytes over 3.35 TB/s.
//
// What this simple design does about that: one block per (rank, batch row,
// KV head, tile of 32 query rows), with the stacked rank dim G folded into
// the grid so one launch covers every rank of a layer. The block walks the
// row's live pages through the block table and loads each page's K and V
// (page x dh) into shared memory ONCE, then applies them to all rep * Sq
// query rows of its KV head in the tile: GQA never repeats KV. A decode
// row (Sq = 1, rep <= 32) is a single tile, so its KV is read exactly once;
// a prefill chunk re-reads a page once per 32-row tile (from L2). The
// online softmax runs in fp32 (scores in shared memory, running max/sum
// per row, accumulators in registers). The page loop stops at
// min(kv_len, q_offset + last row + 1) -- the reference's early exit -- and,
// with a sliding window, starts at the first page any row of the tile can
// see. Masks and the NEG_INF = -1e30 convention are exactly the Pallas
// kernel's, so fully masked pages contribute exactly zero. Rows with no
// valid position are unspecified, as in every backend. Page 0 is the null
// page; page ids are clamped into the pool, so a bad table cannot read out
// of bounds. Plain fp32 FMA throughout: no tensor cores, no library calls.
// Making it fast (TMA page loads, wgmma for prefill tiles) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 32;          // query rows per block tile
constexpr int kMaxPage = 64;     // mirrored in kernel.py (MAX_PAGE)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool, const int* __restrict__ bt,
                  const int* __restrict__ kv_lens,
                  const int* __restrict__ q_off, T* __restrict__ out, int B,
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
      v = to_f32(q[(((size_t)gb * Sq + sq) * H + h) * DH + d]) * scale;
    }
    q_s[i] = v;
  }
  if (tid < kQT) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  constexpr int kRowsPerPass = kThreads / DH;
  constexpr int kAcc = kQT / kRowsPerPass;
  const int d_own = tid % DH;
  const int r_own = tid / DH;
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
  const T* kbase = kpool + (size_t)g * (size_t)g_stride + kvh * DH;
  const T* vbase = vpool + (size_t)g * (size_t)g_stride + kvh * DH;
  const int* btrow = bt + (size_t)gb * maxp;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int pg = p_begin; pg < p_end; ++pg) {
    const int pid = min(max(btrow[pg], 0), pages - 1);
    const T* kp = kbase + (size_t)pid * page * row_elems;
    const T* vp = vbase + (size_t)pid * page * row_elems;
    for (int i = tid; i < page * DH; i += kThreads) {
      const int p = i / DH, d = i % DH;
      k_s[p * (DH + 1) + d] = to_f32(kp[(size_t)p * row_elems + d]);
      v_s[i] = to_f32(vp[(size_t)p * row_elems + d]);
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
    if (rr < rows) {
      const int sq = rr / rep, h = kvh * rep + rr % rep;
      store(out + (((size_t)gb * Sq + sq) * H + h) * DH + d_own,
            acc[j] / fmaxf(l_s[qi], 1e-30f));
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* lens, const int* qoff, void* out, int G, int B, int Sq,
           int H, int K, int pages, int page, int maxp, long long g_stride,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kQT * DH + page * (DH + 1) +
                                       page * DH + kQT * page + 3 * kQT);
  auto kern = paged_attn_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rep = H / K;
  dim3 grid((rep * Sq + kQT - 1) / kQT, K, G * B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, lens, qoff, static_cast<T*>(out), B, Sq,
      H, K, pages, page, maxp, g_stride, window,
      (float)(1.0 / std::sqrt((double)DH)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const int* bt, const int* lens, const int* qoff, void* out,
              int G, int B, int Sq, int H, int K, int pages, int page,
              int maxp, long long g_stride, int window, cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, bt, lens, qoff, out, G, B, Sq, H, K,
                           pages, page, maxp, g_stride, window, s);
    case 128:
      return launch<T, 128>(q, k, v, bt, lens, qoff, out, G, B, Sq, H, K,
                            pages, page, maxp, g_stride, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* kv_lens, const void* q_offset,
    void* out, int G, int B, int Sq, int H, int K, int dh, int pages,
    int page, int maxp, long long g_stride, int window, int dtype,
    void* stream) {
  if (K <= 0 || H % K != 0 || page <= 0 || page > kMaxPage || pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* qoff = static_cast<const int*>(q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k_pool, v_pool, bt, lens, qoff, out, G, B,
                            Sq, H, K, pages, page, maxp, g_stride, window, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k_pool, v_pool, bt, lens, qoff,
                                    out, G, B, Sq, H, K, pages, page, maxp,
                                    g_stride, window, s);
  return (int)cudaErrorInvalidValue;
}
