// Dense flash attention with causal and sliding-window masks, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel).  q: (B, H, Sq, hd); k, v: (B, Hkv, Sk,
// hd); query head h reads kv head h / (H / Hkv) (GQA, MQA at Hkv = 1).
// Queries are right-aligned to the keys: query row r sits at position
// r + Sk - Sq.  A key at position t is visible to a query at position p
// iff t <= p (causal) and t > p - window (window > 0).  Softmax is online
// in fp32; the output is written in q's dtype.  Any Sq <= Sk (tails are
// masked) and any hd <= 256.
//
// What bounds it on the H100: at the RecurrentGemma-9B prefill shape (B 2,
// H 16, Hkv 1, S 2100, hd 256, window 2048) each call holds 2.2e6
// visible (query, key) pairs per head, 7.2e10 FLOPs against 73 MB of q,
// k, v and output in bf16, so it is bound by operations.
//
// What this first design does about it: one block per (64-row q block,
// head, batch) loops over only the key blocks that intersect the block's
// visible range [p_lo - window + 1, p_hi], so key blocks that the window
// or causality hide wholly are never loaded, and no masked block can
// leave garbage in the accumulator (each probability is zeroed by its own
// mask, not by a later rescale).  256 threads; Q, K and V tiles are
// staged in shared memory as fp32 (214 KB at hd 256, one block per SM).
// Scores are a 4 x 4 register tile per thread (8 shared loads per 16
// FMAs); the output accumulator is 4 rows x hd/16 columns per thread (64
// registers at hd 256), so nothing spills and no thread holds a whole
// row.  Scores and PV use CUDA-core FMAs; tensor-core (wgmma) tiles, TMA
// staging and splitting the key range over more blocks are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per k block
constexpr int THREADS = 256;
constexpr int RPT = BQ / 16;  // rows per thread (4)
constexpr int KPT = BK / 16;  // score keys per thread (4)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Strides {  // element strides over (batch, row, head); the head dim is unit-stride
  long long b, s, h;
};

template <int HD>
constexpr size_t smem_bytes() {
  // Qs[BQ][HD+1], Ks[BK][HD+1], Vs[BK][HD], Ps[BQ][BK+1], then the
  // running max, sum and rescale factor of each query row
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int hd, int group, int causal,
    int window, Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int CPT = HD / 16;  // output columns per thread
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = qb * BQ;
  const int off = sk - sq;  // position of query row r is r + off
  const int kvh = h / group;

  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);      // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);      // [BK][HD]
  float* Ps = Vs + BK * HD;            // [BQ][BK + 1]
  float* m_s = Ps + BQ * (BK + 1);     // [BQ]
  float* l_s = m_s + BQ;               // [BQ]
  float* a_s = l_s + BQ;               // [BQ]

  const T* qbase = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int row = q0 + r;
    float val = 0.f;  // rows past Sq and columns past hd load as zeros
    if (row < sq && c < hd) val = to_float(qbase[static_cast<long long>(row) * qs.s + c]);
    Qs[r * (HD + 1) + c] = val;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  // keys visible to some row of this block: [k_lo, k_hi]
  const int p_lo = q0 + off;
  const int p_hi = min(q0 + BQ, sq) - 1 + off;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_hi = causal ? min(sk - 1, p_hi) : sk - 1;
  const int kb_lo = k_lo / BK;
  const int kb_hi = k_hi >= k_lo ? k_hi / BK : kb_lo - 1;

  const int rg = tid / 16;  // this thread's rows: rg + 16 i
  const int cg = tid % 16;  // its score keys cg + 16 j and output columns cg + 16 c
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous k block's tiles are no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int j = i / HD, c = i % HD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;  // keys past Sk load as zeros (and are masked)
      if (key < sk && c < hd) {
        kv = to_float(kbase[static_cast<long long>(key) * ks.s + c]);
        vv = to_float(vbase[static_cast<long long>(key) * vs.s + c]);
      }
      Ks[j * (HD + 1) + c] = kv;
      Vs[j * HD + c] = vv;
    }
    __syncthreads();

    // scores of a 4 x 4 tile: rows rg + 16 i, keys cg + 16 j
    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; ++c) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg + 16 * i) * (HD + 1) + c];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = Ks[(cg + 16 * j) * (HD + 1) + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + 16 * i;
      const int qpos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = k0 + cg + 16 * j;
        const bool ok = q0 + r < sq && key < sk && (!causal || key <= qpos) &&
                        (window <= 0 || key > qpos - window);
        Ps[r * (BK + 1) + cg + 16 * j] = ok ? sc[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* prow = Ps + r * (BK + 1) + part * 16;
      float mloc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 16; ++j) mloc = fmaxf(mloc, prow[j]);
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mloc);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float s = prow[j];
        const float p = s > NEG_INF / 2 ? expf(s - m_new) : 0.f;  // masked: exactly 0
        prow[j] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      if (part == 0) {
        // a row with nothing visible yet has acc = 0 and l = 0
        const float alpha = m_old > NEG_INF / 2 ? expf(m_old - m_new) : 0.f;
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[rg + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(rg + 16 * i) * (BK + 1) + j];
      const float* vrow = Vs + j * HD + cg;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vrow[16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();  // the final row sums

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + 16 * i;
    const int row = q0 + r;
    if (row >= sq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + b * os.b + static_cast<long long>(row) * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = cg + 16 * c;
      if (col < hd) orow[col] = from_float<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int sq, int sk, int hd, int group, int causal, int window,
           Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hd, group,
      causal, window, qs, ks, vs, os, 1.f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out, int b,
                int h, int sq, int sk, int hd, int group, int causal,
                int window, Strides qs, Strides ks, Strides vs, Strides os,
                cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, b, h, sq, sk, hd, group, causal, window,
                         qs, ks, vs, os, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, b, h, sq, sk, hd, group, causal,
                          window, qs, ks, vs, os, stream);
  return launch<T, 256>(q, k, v, out, b, h, sq, sk, hd, group, causal, window,
                        qs, ks, vs, os, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, out: (B, H, Sq, hd)
// and k, v: (B, Hkv, Sk, hd), each addressed through its (batch, row,
// head) element strides with a unit-stride head dim.  causal: 0/1;
// window: 0 = none.  Returns cudaGetLastError() after launch.
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out, int b,
    int h, int hkv, int sq, int sk, int hd, int causal, int window,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv || sq <= 0 || sk < sq ||
      hd <= 0 || hd > 256 || window < 0 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = h / hkv;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, b, h, sq, sk, hd, group, causal,
                              window, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, b, h, sq, sk, hd, group,
                                      causal, window, qs, ks, vs, os, st);
  if (dtype == 2)
    return dispatch_hd<__half>(q, k, v, out, b, h, sq, sk, hd, group, causal,
                               window, qs, ks, vs, os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
