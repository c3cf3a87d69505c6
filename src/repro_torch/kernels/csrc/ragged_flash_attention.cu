// Causal flash attention over a padded ragged row order, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// ragged_flash_attention (body _ragged_kernel, host map
// attention_block_map).  Rows of q/k/v follow a SeqLayout's padded order:
// positions[r] is the real position padded row r holds, -1 for a pad row.
// A valid query attends to valid keys at positions <= its own; softmax is
// online and fp32; GQA reads kv head h / group.  Pad query rows and head
// slots >= valid_heads come out exactly 0, whatever the pad rows hold.
//
// What bounds it on the H100: in the serving path each call is one
// device's (1, 8, ~230, 64) shard: ~60 MFLOP of scores and PV against
// ~0.3 MB of q/k/v in fp16, so it is bound by operations — and with only
// (q blocks x live heads) = ~20 blocks it is bound by too few blocks to
// fill 132 SMs long before either peak.
//
// What this first design does about it: work scales with the live map —
// pad head slots exit at once and (q block, k block) pairs with no
// visible valid pair are skipped, so executed work tracks the device's
// assigned heads and the causal triangle.  One block per (b, head, 64-row
// q block); 128 threads, two per query row, each pair splitting the 64
// keys of a k block for the scores and the head dim for the output.  K/V
// tiles are staged in shared memory as fp32; scores use CUDA-core FMAs.
// Tensor-core (wgmma) tiles, TMA staging and splitting the key axis over
// more blocks are later work.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per k block
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

struct Strides {  // element strides over (batch, row, head); the head dim is unit-stride
  long long b, s, h;
};

template <int HD_MAX>
constexpr size_t smem_bytes() {
  // Qs[BQ][HD_MAX+1], Ks[BKV][HD_MAX+1], Vs[BKV][HD_MAX], Ps[BQ][BKV+1],
  // then the q and k positions
  return sizeof(float) * (BQ * (HD_MAX + 1) + BKV * (HD_MAX + 1) +
                          BKV * HD_MAX + BQ * (BKV + 1)) +
         sizeof(int) * (BQ + BKV);
}

template <typename T, int HD_MAX>
__global__ void __launch_bounds__(THREADS) ragged_flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, const int* __restrict__ positions,
    const int* __restrict__ block_map, int s, int hd, int group,
    int valid_heads, int nkb, Strides qs, Strides ks, Strides vs, Strides os,
    float scale) {
  constexpr int HH = HD_MAX / 2;  // head-dim columns per thread
  constexpr int KH = BKV / 2;     // keys per thread in a k block
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // query row of this thread within the block
  const int half = tid & 1;  // which half of the keys / head dim
  const int row = qb * BQ + r;
  const int hh = (hd + 1) / 2;
  const int c0 = half * hh;
  const int ncols = half ? hd - hh : hh;

  if (h >= valid_heads) {  // pad head slot: exact zeros
    if (row < s)
      for (int c = 0; c < ncols; ++c)
        out[b * os.b + row * os.s + h * os.h + c0 + c] = from_float<T>(0.f);
    return;
  }

  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][HD_MAX + 1]
  float* Ks = Qs + BQ * (HD_MAX + 1);    // [BKV][HD_MAX + 1]
  float* Vs = Ks + BKV * (HD_MAX + 1);   // [BKV][HD_MAX]
  float* Ps = Vs + BKV * HD_MAX;         // [BQ][BKV + 1]
  int* pos_q = reinterpret_cast<int*>(Ps + BQ * (BKV + 1));
  int* pos_k = pos_q + BQ;

  const int kvh = h / group;
  for (int i = tid; i < BQ; i += THREADS) {
    const int rr = qb * BQ + i;
    pos_q[i] = rr < s ? positions[rr] : -1;
  }
  __syncthreads();
  for (int i = tid; i < BQ * HD_MAX; i += THREADS) {
    const int rr = i / HD_MAX, c = i % HD_MAX;
    float val = 0.f;
    if (pos_q[rr] >= 0 && c < hd)
      val = to_float(q[b * qs.b + (long long)(qb * BQ + rr) * qs.s + h * qs.h + c]);
    Qs[rr * (HD_MAX + 1) + c] = val;
  }

  const int qpos = pos_q[r];
  float m_run = NEG_INF, l_run = 0.f;
  float acc[HH];
#pragma unroll
  for (int c = 0; c < HH; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    if (block_map[qb * nkb + kb] == 0) continue;  // uniform over the block
    __syncthreads();  // previous k block's tiles are no longer read
    for (int i = tid; i < BKV; i += THREADS) {
      const int rr = kb * BKV + i;
      pos_k[i] = rr < s ? positions[rr] : -1;
    }
    __syncthreads();
    for (int i = tid; i < BKV * HD_MAX; i += THREADS) {
      const int j = i / HD_MAX, c = i % HD_MAX;
      float kv = 0.f, vv = 0.f;
      if (pos_k[j] >= 0 && c < hd) {  // pad keys load as zeros
        const long long rr = kb * BKV + j;
        kv = to_float(k[b * ks.b + rr * ks.s + kvh * ks.h + c]);
        vv = to_float(v[b * vs.b + rr * vs.s + kvh * vs.h + c]);
      }
      Ks[j * (HD_MAX + 1) + c] = kv;
      Vs[j * HD_MAX + c] = vv;
    }
    __syncthreads();

    // scores of this thread's half of the k block
    float sc[KH];
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) sc[jj] = 0.f;
    const float* qrow = Qs + r * (HD_MAX + 1);
    const float* kbase = Ks + half * KH * (HD_MAX + 1);
    for (int c = 0; c < hd; ++c) {
      const float qv = qrow[c];
#pragma unroll
      for (int jj = 0; jj < KH; ++jj) sc[jj] = fmaf(qv, kbase[jj * (HD_MAX + 1) + c], sc[jj]);
    }
    float mloc = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) {
      const int kpos = pos_k[half * KH + jj];
      const bool ok = qpos >= 0 && kpos >= 0 && kpos <= qpos;
      sc[jj] = ok ? sc[jj] * scale : NEG_INF;
      mloc = fmaxf(mloc, sc[jj]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float m_new = fmaxf(m_run, mloc);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) {
      const float p = sc[jj] > NEG_INF / 2 ? expf(sc[jj] - m_new) : 0.f;
      Ps[r * (BKV + 1) + half * KH + jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = m_run > NEG_INF / 2 ? expf(m_run - m_new) : 0.f;
    l_run = alpha * l_run + psum;
    m_run = m_new;
    __syncwarp();  // the row's other half of P comes from the partner lane

    const float* prow = Ps + r * (BKV + 1);
#pragma unroll
    for (int c = 0; c < HH; ++c) acc[c] *= alpha;
    for (int j = 0; j < BKV; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * HD_MAX + c0;
#pragma unroll
      for (int c = 0; c < HH; ++c) acc[c] = fmaf(p, vrow[c], acc[c]);
    }
  }

  // rows with no live key (pad queries) emit exactly 0
  if (row < s) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    T* orow = out + b * os.b + (long long)row * os.s + h * os.h + c0;
#pragma unroll
    for (int c = 0; c < HH; ++c)
      if (c < ncols) orow[c] = from_float<T>(acc[c] * inv);
  }
}

template <typename T, int HD_MAX>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* positions, const int* block_map, int b, int h, int s,
           int hd, int group, int valid_heads, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD_MAX>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_flash_kernel<T, HD_MAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nqb = (s + BQ - 1) / BQ;
  const int nkb = (s + BKV - 1) / BKV;
  const dim3 grid(nqb, h, b);
  ragged_flash_kernel<T, HD_MAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), positions, block_map, s,
      hd, group, valid_heads, nkb, qs, ks, vs, os, 1.f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                const int* positions, const int* block_map, int b, int h,
                int s, int hd, int group, int valid_heads, Strides qs,
                Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, positions, block_map, b, h, s, hd,
                         group, valid_heads, qs, ks, vs, os, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, positions, block_map, b, h, s, hd,
                         group, valid_heads, qs, ks, vs, os, stream);
  return launch<T, 128>(q, k, v, out, positions, block_map, b, h, s, hd,
                        group, valid_heads, qs, ks, vs, os, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16.  q, out: (B, H, S, hd) and k, v:
// (B, Hkv, S, hd), each addressed through its (batch, row, head) element
// strides with a unit-stride head dim.  positions: (S,) int32 device
// array; block_map: (ceil(S/64), ceil(S/64)) int32 device array of live
// (q block, k block) pairs.  Returns cudaGetLastError() after launch.
extern "C" int ragged_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    const int* positions, const int* block_map, int b, int h, int hkv, int s,
    int hd, int valid_heads, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || hd <= 0 || hd > 128 || hkv <= 0 ||
      h % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, positions, block_map, b, h, s, hd,
                              h / hkv, valid_heads, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch_hd<__half>(q, k, v, out, positions, block_map, b, h, s, hd,
                               h / hkv, valid_heads, qs, ks, vs, os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
