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
// What bounds it on the H100: latency, not bytes or operations.  The
// serving path calls it on one device's (1, 8, 228, 64) shard with 5 valid
// heads: ~40 MFLOP of scores and PV against ~0.3 MB of q/k/v in fp16 (a
// bound of ~0.2 us).  Each block is a short chain of dependent steps (at
// most 4 key blocks), so what counts is how many blocks run side by side
// and how long each step of the chain takes.  The first design's 64-row
// q blocks gave 4 q blocks x 5 heads = 20 blocks for 132 SMs, each a
// chain of CUDA-core loops.
//
// What this design does about it (bf16 and fp16, path "mma"): two warps a
// block, 16 query rows each (a 32-row q tile), so the shard launches 8 q
// tiles x 8 head slots (35 with work; the 24 pad-head blocks write their
// zeros and exit at once), each warp on the tensor-core core of
// flash_mma.cuh (mma.sync m16n8k16, P repacked in registers, online
// softmax on the fragments).  K and V tiles of 64 keys flow through a
// two-stage cp.async ring in 16-bit shared memory, their loads shared by
// the two warps; pad rows load as zeros (cp.async with source size 0), so
// junk in them never enters a sum.  The host's block map at (32, 64)
// (kernels/flash_attention.py: ragged_block_kinds) marks each (q tile,
// key block) pair dead (skipped, never loaded), live and whole (every
// query valid, every key valid and visible to every query: no mask), or
// live and cut (masked, branch-free: the diagonal, pad rows); a window of
// 32 pairs is read at once and searched with warp ballots.  The positions
// of a key block's rows are read one live block ahead of its tiles, so
// their latency hides behind a block of work.  Head dims have their own
// instantiations (32, 64, 128); others are zero-padded in shared memory
// up to the next.
//
// fp32 (path "simt", the parity dtype) keeps the first design unchanged:
// 64-row q blocks of 128 threads, two per query row, K/V staged as fp32,
// CUDA-core FMAs, on the live map at (64, 64).
//
// Splitting the key axis over blocks, wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

// ---- fp32: the CUDA-core kernel ("simt") ----

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per k block
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

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
int launch_simt(const void* q, const void* k, const void* v, void* out,
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

// ---- bf16 / fp16: the tensor-core kernel ("mma") ----

constexpr int MMA_WARPS = 2;
constexpr int MMA_BQ = 16 * MMA_WARPS;  // query rows a block: 16 a warp
constexpr int MMA_BK = 64;              // keys a block
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_KPT = MMA_BK / MMA_THREADS;  // key positions a thread stages

template <int HDP>
constexpr size_t mma_smem_bytes() {
  // Q [16][pitch], then two stages of K [64][pitch] and V [64][pitch]
  return 2 * flash_mma::pitch<HDP>() * (MMA_BQ + 4 * MMA_BK);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(MMA_THREADS) ragged_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, const int* __restrict__ positions,
    const int* __restrict__ block_kinds, int s, int hd, int group,
    int valid_heads, int nkb, Strides qs, Strides ks, Strides vs, Strides os,
    float scale_log2) {
  using namespace flash_mma;
  constexpr int P = pitch<HDP>();
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = qb * MMA_BQ;

  if (h >= valid_heads) {  // pad head slot: exact zeros, nothing loaded
    for (int r = r0; r < min(r0 + MMA_BQ, s); ++r)
      for (int c = tid; c < hd; c += MMA_THREADS)
        out[b * os.b + static_cast<long long>(r) * os.s + h * os.h + c] =
            Mma<T>::from_float(0.f);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [MMA_BQ][P]
  T* ring = Qs + MMA_BQ * P;               // stage s: K at 2 s BK P, V at (2 s + 1) BK P
  // positions of the q tile's rows and of each stage's key rows (-1: pad
  // or past S), read once a tile rather than once a 16-byte chunk
  __shared__ int qpos_s[MMA_BQ];
  __shared__ int kpos_s[2][MMA_BK];

  const int kvh = h / group;
  const T* qbase = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  const void* fill = reinterpret_cast<const void*>(
      reinterpret_cast<uintptr_t>(kbase) & ~uintptr_t(15));
  const bool q_aligned = rows_aligned(qbase, qs.s, hd);
  const bool kv_aligned = rows_aligned(kbase, ks.s, hd) && rows_aligned(vbase, vs.s, hd);
  const int* kinds = block_kinds + qb * nkb;

  // The live key blocks of this q tile, 32 at a time: lane j of each warp
  // reads the kind of block base + j, and two ballots give the window's
  // live and whole blocks, so finding the next live block costs one load a
  // window.
  int win = -32;
  uint32_t live_bits = 0, whole_bits = 0;
  auto next_live = [&](int kb, bool& whole) {
    for (int nk = kb + 1; nk < nkb;) {
      const int base = nk & ~31;
      if (base != win) {
        win = base;
        const int kind = base + lane < nkb ? kinds[base + lane] : 0;
        live_bits = __ballot_sync(0xffffffffu, kind != 0);
        whole_bits = __ballot_sync(0xffffffffu, kind == 2);
      }
      const uint32_t rest = live_bits >> (nk - base);
      if (rest != 0) {
        const int found = nk + __ffs(rest) - 1;
        whole = (whole_bits >> (found - base)) & 1u;
        return found;
      }
      nk = base + 32;
    }
    return nkb;
  };
  // the positions of key block kb's rows tid + i * MMA_THREADS (-1: past
  // S); a block's positions are read one live block ahead of its K/V
  // tiles, so their latency hides behind a block of work
  static_assert(MMA_BK % MMA_THREADS == 0, "key positions divide over the threads");
  auto key_positions = [&](int kb, int (&pk)[MMA_KPT]) {
#pragma unroll
    for (int i = 0; i < MMA_KPT; ++i) {
      const int row = kb * MMA_BK + tid + i * MMA_THREADS;
      pk[i] = row < s ? positions[row] : -1;
    }
  };
  auto load_kv = [&](int stage, int kb, const int (&pk)[MMA_KPT]) {
    const int k0 = kb * MMA_BK;
    int* kpos = kpos_s[stage];
#pragma unroll
    for (int i = 0; i < MMA_KPT; ++i) kpos[tid + i * MMA_THREADS] = pk[i];
    __syncthreads();
    T* kt = ring + 2 * stage * MMA_BK * P;
    auto key_ok = [&](int r) { return kpos[r] >= 0; };
    load_tile<T, MMA_BK, HDP, MMA_THREADS>(kt, tid, hd, kv_aligned, fill, kbase, k0, ks.s,
                                           key_ok);
    load_tile<T, MMA_BK, HDP, MMA_THREADS>(kt + MMA_BK * P, tid, hd, kv_aligned, fill, vbase,
                                           k0, vs.s, key_ok);
  };

  // pad rows (and rows past S) load as zeros
  if (tid < MMA_BQ) qpos_s[tid] = r0 + tid < s ? positions[r0 + tid] : -1;
  bool whole = false, nk_whole = false;
  int kb = next_live(-1, whole);
  int pk[MMA_KPT];
  if (kb < nkb) key_positions(kb, pk);
  __syncthreads();
  load_tile<T, MMA_BQ, HDP, MMA_THREADS>(Qs, tid, hd, q_aligned, fill, qbase, r0, qs.s,
                                         [&](int r) { return qpos_s[r] >= 0; });
  if (kb < nkb) load_kv(0, kb, pk);
  cp_async_commit();
  int nk = kb < nkb ? next_live(kb, nk_whole) : nkb;
  if (nk < nkb) key_positions(nk, pk);

  // this lane's query positions (rows g and g + 8 of the warp's 16; -1 =
  // pad); a warp whose rows are all pad skips the products
  const int w0 = 16 * warp;
  const int qpos[2] = {qpos_s[w0 + lane / 4], qpos_s[w0 + lane / 4 + 8]};
  const bool warp_live = __any_sync(0xffffffffu, qpos[0] >= 0 || qpos[1] >= 0);
  WarpFlash<T, HDP, MMA_BK> acc;
  acc.init();
  const uint32_t q_addr = smem_u32(Qs + w0 * P);
  for (int stage = 0; kb < nkb; stage ^= 1) {
    bool nk2_whole = false;
    const int nk2 = nk < nkb ? next_live(nk, nk2_whole) : nkb;
    if (nk < nkb) load_kv(stage ^ 1, nk, pk);
    cp_async_commit();
    if (nk2 < nkb) key_positions(nk2, pk);
    cp_async_wait<1>();  // block kb (and Q) has landed
    __syncthreads();
    const uint32_t k_addr = smem_u32(ring + 2 * stage * MMA_BK * P);
    const uint32_t v_addr = k_addr + 2 * MMA_BK * P;
    if (!warp_live) {
    } else if (whole) {  // every query valid, every key valid and visible
      acc.step(false, q_addr, k_addr, v_addr, scale_log2, lane,
               [](int, int) { return true; });
    } else {
      const int* kpos = kpos_s[stage];
      // branch-free (bitwise &): a pad key (-1) fails kp >= 0, and a pad
      // query (-1) then fails kp <= qpos
      acc.step(true, q_addr, k_addr, v_addr, scale_log2, lane, [&](int half, int key) {
        const int kp = kpos[key];
        return (kp >= 0) & (kp <= qpos[half]);
      });
    }
    __syncthreads();  // this stage is free for the block after next
    kb = nk;
    whole = nk_whole;
    nk = nk2;
    nk_whole = nk2_whole;
  }
  cp_async_wait<0>();

  // pad query rows have no visible key: exact zeros
  acc.store(lane, hd, [&](int half) {
    const int row = r0 + w0 + lane / 4 + 8 * half;
    return row < s ? out + b * os.b + static_cast<long long>(row) * os.s + h * os.h
                   : static_cast<T*>(nullptr);
  });
}

template <typename T, int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int* positions, const int* block_kinds, int b, int h, int s,
               int hd, int group, int valid_heads, Strides qs, Strides ks,
               Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HDP>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_mma_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nqb = (s + MMA_BQ - 1) / MMA_BQ;
  const int nkb = (s + MMA_BK - 1) / MMA_BK;
  const dim3 grid(nqb, h, b);
  ragged_mma_kernel<T, HDP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), positions, block_kinds, s,
      hd, group, valid_heads, nkb, qs, ks, vs, os,
      flash_mma::LOG2E / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mma(int hdp, const void* q, const void* k, const void* v, void* out,
                 const int* positions, const int* block_kinds, int b, int h,
                 int s, int hd, int group, int valid_heads, Strides qs,
                 Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  switch (hdp) {
    case 32:
      return launch_mma<T, 32>(q, k, v, out, positions, block_kinds, b, h, s, hd,
                               group, valid_heads, qs, ks, vs, os, stream);
    case 64:
      return launch_mma<T, 64>(q, k, v, out, positions, block_kinds, b, h, s, hd,
                               group, valid_heads, qs, ks, vs, os, stream);
    case 128:
      return launch_mma<T, 128>(q, k, v, out, positions, block_kinds, b, h, s, hd,
                                group, valid_heads, qs, ks, vs, os, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_simt(int hdp, const void* q, const void* k, const void* v, void* out,
                  const int* positions, const int* block_map, int b, int h, int s,
                  int hd, int group, int valid_heads, Strides qs, Strides ks,
                  Strides vs, Strides os, cudaStream_t stream) {
  switch (hdp) {
    case 32:
      return launch_simt<float, 32>(q, k, v, out, positions, block_map, b, h, s, hd,
                                    group, valid_heads, qs, ks, vs, os, stream);
    case 64:
      return launch_simt<float, 64>(q, k, v, out, positions, block_map, b, h, s, hd,
                                    group, valid_heads, qs, ks, vs, os, stream);
    case 128:
      return launch_simt<float, 128>(q, k, v, out, positions, block_map, b, h, s, hd,
                                     group, valid_heads, qs, ks, vs, os, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (path simt), 1 = bfloat16, 2 = float16 (path mma).
// hdp: the head-dim instantiation (32/64/128), >= hd.  q, out: (B, H, S,
// hd) and k, v: (B, Hkv, S, hd), each addressed through its (batch, row,
// head) element strides with a unit-stride head dim.  positions: (S,)
// int32 device array.  block_map: the (q_tiles, k_tiles) int32 device
// array of the path's tiles (simt 64 x 64, mma 16 x 64): 0 for a dead
// (q tile, key block) pair, else live (mma: 1 masked, 2 whole).  Returns
// cudaGetLastError() after launch.
extern "C" int ragged_flash_attention(
    int dtype, int hdp, int q_tiles, int k_tiles, const void* q, const void* k,
    const void* v, void* out, const int* positions, const int* block_map, int b,
    int h, int hkv, int s, int hd, int valid_heads, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  const int bq = dtype == 0 ? BQ : MMA_BQ, bk = dtype == 0 ? BKV : MMA_BK;
  if (b <= 0 || h <= 0 || s <= 0 || hd <= 0 || hd > hdp || hkv <= 0 ||
      h % hkv || b > 65535 || h > 65535 || q_tiles != (s + bq - 1) / bq ||
      k_tiles != (s + bk - 1) / bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = h / hkv;
  if (dtype == 0)
    return dispatch_simt(hdp, q, k, v, out, positions, block_map, b, h, s, hd,
                         group, valid_heads, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch_mma<__nv_bfloat16>(hdp, q, k, v, out, positions, block_map, b,
                                       h, s, hd, group, valid_heads, qs, ks, vs, os, st);
  if (dtype == 2)
    return dispatch_mma<__half>(hdp, q, k, v, out, positions, block_map, b, h, s,
                                hd, group, valid_heads, qs, ks, vs, os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
