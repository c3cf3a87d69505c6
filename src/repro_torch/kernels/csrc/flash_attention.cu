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
// masked) and any hd <= 256.  An optional kv_len (B,), read on the device,
// gives batch entry b only the keys [0, kv_len[b]), its queries right-
// aligned to those: a chunk at a device-held offset over the whole gathered
// row of pages, so one captured launch serves every offset (the reference
// traces the offset as a scalar).  The call is then, bit for bit, the call
// on the keys sliced to kv_len[b].
//
// What bounds it on the H100: operations.  RecurrentGemma-9B's prefill (B
// 2, H 16, Hkv 1, S 2100, hd 256, window 2048) holds 2.2e6 visible (query,
// key) pairs a head, 7.2e10 FLOPs against 73 MB of q, k, v and output in
// bf16 (0.073 ms at 989 TFLOP/s); StableLM-12B's 256-query chunk over 1280
// keys (H 32 on Hkv 8, hd 160) 6.0e9 FLOPs (0.006 ms).  Both need the
// tensor cores, and the K/V tiles every q tile re-reads from L2 (64 keys x
// hd per 64 x 64 block of scores) must arrive while the last ones are
// multiplied.
//
// What this design does about it (bf16 and fp16, path "mma"): one block of
// 4 warps per (64-row q tile, head, batch), each warp 16 query rows, on
// the shared tensor-core core of flash_mma.cuh (S = Q K^T and O += P V by
// mma.sync.m16n8k16 with fp32 accumulators in registers, P repacked from
// the S fragments without touching shared memory, online softmax on the
// fragments, O rescaled only when a row maximum moved).  Q sits in shared
// memory; K and V tiles of BK keys flow through a two-stage cp.async ring
// in 16-bit shared memory, so block j+1 loads while block j is
// multiplied; a tensor whose rows are 16-byte aligned loads branch-free,
// one cp.async a 16-byte chunk.  Each q tile loops only over the key
// blocks that intersect its visible range [p_lo - window + 1, p_hi]; the
// q tiles with the longest ranges are launched first.  A warp evaluates
// the mask only on blocks that cut its rows (the diagonal,
// the window edge, the Sq / Sk tails), skips blocks none of its rows can
// see, and runs interior blocks unmasked.  Head dims have their own
// instantiations (64, 128, 160, 256); others are zero-padded in shared
// memory up to the next.  hd 256 takes 32-key blocks so that two blocks
// fit an SM (101 KB of shared memory each) and O (128 fp32 registers a
// lane) does not spill.
//
// What still holds it back (launch/attention_breakdown.py: builds with a
// part cut out): no one part.  At RecurrentGemma's prefill the loads, QK,
// the softmax and PV each take 15-25 % of the time; every warp re-reads
// its Q rows and the whole K and V tiles through ldmatrix, and a warp
// issues its 16-byte cp.async copies one after another, so both shared
// memory and the load issue are busy for what 16 query rows a warp
// compute.  wgmma (64-row warpgroup tiles reading K and V once) and TMA
// (a tile a copy) are the next step.
//
// fp32 (path "simt", the parity dtype) keeps the first design unchanged:
// Q, K and V staged as fp32 in shared memory, 4 x 4 register tiles of
// CUDA-core FMAs for the scores and the output, P through shared memory.
//
// The host wrapper (kernels/flash_attention.py) picks the path, the
// head-dim instantiation, the key-block size and the grid before the
// launch; this file checks that they agree with what it builds.  wgmma, TMA and splitting the key
// range over blocks for short, wide calls are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

// ---- fp32: the CUDA-core kernel ("simt") ----

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per k block
constexpr int THREADS = 256;
constexpr int RPT = BQ / 16;  // rows per thread (4)
constexpr int KPT = BK / 16;  // score keys per thread (4)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

struct Strides {  // element strides over (batch, row, head); the head dim is unit-stride
  long long b, s, h;
};

// The keys batch entry b attends to: kv_len[b] (read on the device, so a
// captured launch serves every chunk offset), or all sk_max without it.
// Everything after reads only this count, so a call with kv_len[b] = n
// computes what a call on the keys sliced to n computes, bit for bit.
__device__ __forceinline__ int keys_of(const int* kv_len, int b, int sk_max) {
  return kv_len == nullptr ? sk_max : min(max(kv_len[b], 0), sk_max);
}

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
    T* __restrict__ out, const int* __restrict__ kv_len, int sk_max, int sq, int hd,
    int group, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
    float scale) {
  constexpr int CPT = HD / 16;  // output columns per thread
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int sk = keys_of(kv_len, b, sk_max);
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
int launch_simt(const void* q, const void* k, const void* v, void* out,
                const int* kv_len, int b, int h, int sq, int sk, int hd, int group,
                int causal, int window,
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
      static_cast<const T*>(v), static_cast<T*>(out), kv_len, sk, sq, hd, group,
      causal, window, qs, ks, vs, os, 1.f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 / fp16: the tensor-core kernel ("mma") ----

constexpr int MMA_BQ = 64;  // query rows a block: 4 warps of 16
constexpr int MMA_THREADS = 128;

// keys a block and stages of the K/V ring at each head-dim instantiation
template <int HDP> struct MmaCfg {
  static constexpr int BK = HDP > 160 ? 32 : 64;
  static constexpr int STAGES = 2;
};

template <int HDP>
constexpr size_t mma_smem_bytes() {
  // Q [64][pitch], then STAGES stages of K [BK][pitch] and V [BK][pitch]
  return 2 * flash_mma::pitch<HDP>() *
         (MMA_BQ + 2 * MmaCfg<HDP>::STAGES * MmaCfg<HDP>::BK);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, const int* __restrict__ kv_len, int sk_max, int sq, int hd,
    int group, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
    float scale_log2) {
  using namespace flash_mma;
  constexpr int BK = MmaCfg<HDP>::BK;
  constexpr int STAGES = MmaCfg<HDP>::STAGES;
  constexpr int P = pitch<HDP>();
  const int qb = gridDim.x - 1 - blockIdx.x;  // the longest key ranges first
  const int h = blockIdx.y, b = blockIdx.z;
  const int sk = keys_of(kv_len, b, sk_max);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qb * MMA_BQ;
  const int off = sk - sq;  // position of query row r is r + off
  const int kvh = h / group;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [MMA_BQ][P]
  T* ring = Qs + MMA_BQ * P;  // stage s: K at 2 s BK P, V at (2 s + 1) BK P

  const T* qbase = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  const void* fill = reinterpret_cast<const void*>(
      reinterpret_cast<uintptr_t>(kbase) & ~uintptr_t(15));

  // keys visible to some row of this block: [k_lo, k_hi]
  const int p_lo = q0 + off;
  const int p_hi = min(q0 + MMA_BQ, sq) - 1 + off;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_hi = causal ? min(sk - 1, p_hi) : sk - 1;
  const int kb_lo = k_lo / BK;
  const int n_kb = k_hi >= k_lo ? k_hi / BK - kb_lo + 1 : 0;

  // this warp's rows [w0, w0 + 16) and their positions
  const int w0 = q0 + 16 * warp;
  const bool warp_live = w0 < sq;
  const bool warp_whole = w0 + 16 <= sq;
  const int wp_lo = w0 + off;
  const int wp_hi = min(w0 + 16, sq) - 1 + off;

  const bool q_aligned = rows_aligned(qbase, qs.s, hd);
  const bool kv_aligned = rows_aligned(kbase, ks.s, hd) && rows_aligned(vbase, vs.s, hd);
  load_tile<T, MMA_BQ, HDP, MMA_THREADS>(Qs, tid, hd, q_aligned, fill, qbase, q0, qs.s,
                                         [&](int r) { return q0 + r < sq; });
  auto load_kv = [&](int stage, int kb) {
    const int k0 = kb * BK;
    T* kt = ring + 2 * stage * BK * P;
    // keys past Sk load as zeros (and are masked)
    auto key_ok = [&](int r) { return k0 + r < sk; };
    load_tile<T, BK, HDP, MMA_THREADS>(kt, tid, hd, kv_aligned, fill, kbase, k0, ks.s, key_ok);
    load_tile<T, BK, HDP, MMA_THREADS>(kt + BK * P, tid, hd, kv_aligned, fill, vbase, k0, vs.s,
                                       key_ok);
  };
  // the ring: blocks i + 1 .. i + STAGES - 1 load while block i is multiplied
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_kb) load_kv(st, kb_lo + st);
    cp_async_commit();  // group st (group 0 also holds Q)
  }

  WarpFlash<T, HDP, BK> acc;
  acc.init();
  const uint32_t q_addr = smem_u32(Qs + 16 * warp * P);
  for (int i = 0; i < n_kb; ++i) {
    cp_async_wait<STAGES - 2>();  // block i (and Q) has landed
    // every warp is past block i - 1: its stage takes block i + STAGES - 1
    __syncthreads();
    if (i + STAGES - 1 < n_kb) load_kv((i + STAGES - 1) % STAGES, kb_lo + i + STAGES - 1);
    cp_async_commit();
    const int k0 = (kb_lo + i) * BK;
    const int k_last = k0 + BK - 1;
    // none of this warp's rows sees a key of the block
    const bool hidden = (causal && k0 > wp_hi) || (window > 0 && k_last <= wp_lo - window);
    // every row of the warp sees every key of the block
    const bool whole = warp_whole && k_last < sk && (!causal || k_last <= wp_lo) &&
                       (window <= 0 || k0 > wp_hi - window);
    const uint32_t k_addr = smem_u32(ring + 2 * (i % STAGES) * BK * P);
    const uint32_t v_addr = k_addr + 2 * BK * P;
    if (warp_live && !hidden) {
      if (whole) {
        acc.step(false, q_addr, k_addr, v_addr, scale_log2, lane,
                 [](int, int) { return true; });
      } else {
        const int qrow = w0 + lane / 4;
        // (short-circuit &&: a bitwise & keeps every term of the 16
        // elements live at once, which spills at hd 256)
        acc.step(true, q_addr, k_addr, v_addr, scale_log2, lane, [&](int half, int key) {
          const int row = qrow + 8 * half;
          const int p = row + off, t = k0 + key;
          return row < sq && t < sk && (!causal || t <= p) && (window <= 0 || t > p - window);
        });
      }
    }
  }
  cp_async_wait<0>();

  acc.store(lane, hd, [&](int half) {
    const int row = w0 + lane / 4 + 8 * half;
    return row < sq ? out + b * os.b + static_cast<long long>(row) * os.s + h * os.h
                    : static_cast<T*>(nullptr);
  });
}

template <typename T, int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int* kv_len, int b, int h, int sq, int sk, int hd, int group,
               int causal, int window,
               Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HDP>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((sq + MMA_BQ - 1) / MMA_BQ, h, b);
  flash_mma_kernel<T, HDP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), kv_len, sk, sq, hd, group,
      causal, window, qs, ks, vs, os,
      flash_mma::LOG2E / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mma(int hdp, const void* q, const void* k, const void* v, void* out,
                 const int* kv_len, int b, int h, int sq, int sk, int hd, int group,
                 int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
                 cudaStream_t stream) {
  switch (hdp) {
    case 64:
      return launch_mma<T, 64>(q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                               window, qs, ks, vs, os, stream);
    case 128:
      return launch_mma<T, 128>(q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                                window, qs, ks, vs, os, stream);
    case 160:
      return launch_mma<T, 160>(q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                                window, qs, ks, vs, os, stream);
    case 256:
      return launch_mma<T, 256>(q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                                window, qs, ks, vs, os, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys a block of the mma kernel at instantiation hdp (0: none)
int mma_block_k(int hdp) {
  switch (hdp) {
    case 64: return MmaCfg<64>::BK;
    case 128: return MmaCfg<128>::BK;
    case 160: return MmaCfg<160>::BK;
    case 256: return MmaCfg<256>::BK;
  }
  return 0;
}

int dispatch_simt(int hdp, const void* q, const void* k, const void* v, void* out,
                  const int* kv_len, int b, int h, int sq, int sk, int hd, int group,
                  int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
                  cudaStream_t stream) {
  switch (hdp) {
    case 64:
      return launch_simt<float, 64>(q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                                    window, qs, ks, vs, os, stream);
    case 128:
      return launch_simt<float, 128>(q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                                     window, qs, ks, vs, os, stream);
    case 256:
      return launch_simt<float, 256>(q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                                     window, qs, ks, vs, os, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (path simt), 1 = bfloat16, 2 = float16 (path mma).
// hdp: the head-dim instantiation (simt 64/128/256, mma 64/128/160/256),
// >= hd; q_tiles: the grid's q tiles, ceil(Sq / 64); block_k: the keys a
// key block holds at that path and instantiation (simt 64; mma 64, 32 at
// 256).  q, out: (B, H, Sq,
// hd) and k, v: (B, Hkv, Sk, hd), each addressed through its (batch, row,
// head) element strides with a unit-stride head dim.  kv_len: null, or
// (B,) int32 on the device: batch entry b sees keys [0, kv_len[b]) only,
// its query row r at position r + kv_len[b] - Sq (the wrapper reads none
// of it; values are clamped to [0, Sk]).  causal: 0/1; window: 0 = none.
// Returns cudaGetLastError() after launch.
extern "C" int flash_attention(
    int dtype, int hdp, int q_tiles, int block_k, const void* q, const void* k,
    const void* v, void* out, const void* kv_len_ptr, int b, int h, int hkv, int sq,
    int sk, int hd, int causal, int window, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv || sq <= 0 || sk < sq ||
      hd <= 0 || hd > hdp || window < 0 || b > 65535 || h > 65535 ||
      q_tiles != (sq + 63) / 64 ||
      block_k != (dtype == 0 ? BK : mma_block_k(hdp)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = h / hkv;
  const int* kv_len = static_cast<const int*>(kv_len_ptr);
  if (dtype == 0)
    return dispatch_simt(hdp, q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                         window, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch_mma<__nv_bfloat16>(hdp, q, k, v, out, kv_len, b, h, sq, sk, hd, group,
                                       causal, window, qs, ks, vs, os, st);
  if (dtype == 2)
    return dispatch_mma<__half>(hdp, q, k, v, out, kv_len, b, h, sq, sk, hd, group, causal,
                                window, qs, ks, vs, os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
