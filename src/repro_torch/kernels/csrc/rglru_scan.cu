// RG-LRU sequence scan, h_t = a_t * h_{t-1} + b_t, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:
// rglru_scan_kernel.  a, b: (B, S, w) contiguous; h0: (B, w) fp32.  h is
// carried in fp32; h_seq (B, S, w) and h_last (B, w) are written in the
// dtype of a.  Any S >= 1 and any w (the tail block masks its columns),
// where the Pallas kernel asserted that its tiles divide.
//
// What bounds it on the H100: it reads a and b once and writes h_seq
// once — 12 bytes per element in fp32 against 2 FLOPs — so it is bound
// by bytes (RecurrentGemma-9B prefill: (2, 2100, 4096) fp32, 206 MB).
// The recurrence is diagonal, so every (batch, column) is independent
// and sequential only along S.
//
// What this first design does about it: one thread per (batch, column),
// looping over S; neighbouring threads take neighbouring columns, so
// every load and store of a row is coalesced.  The loop loads UNROLL rows
// of a and b before it runs their steps, so each thread keeps that many
// loads in flight instead of one.  Blocks are small (64 threads) so the
// B * w / 64 blocks spread over the SMs.  Each step rounds the product
// and the sum separately (no FMA contraction), as the plain PyTorch
// version does, so fp32 results match it bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 8;

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

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ h0, T* __restrict__ h_seq,
    T* __restrict__ h_last, int s, int w) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (col >= w) return;
  const long long base = static_cast<long long>(bi) * s * w + col;
  float h = h0[static_cast<long long>(bi) * w + col];
  int t = 0;
  for (; t + UNROLL <= s; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + static_cast<long long>(t + u) * w;
      av[u] = to_float(a[i]);
      bv[u] = to_float(b[i]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      h_seq[base + static_cast<long long>(t + u) * w] = from_float<T>(h);
    }
  }
  for (; t < s; ++t) {
    const long long i = base + static_cast<long long>(t) * w;
    h = __fadd_rn(__fmul_rn(to_float(a[i]), h), to_float(b[i]));
    h_seq[i] = from_float<T>(h);
  }
  h_last[static_cast<long long>(bi) * w + col] = from_float<T>(h);
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* h_seq,
           void* h_last, int bsz, int s, int w, cudaStream_t stream) {
  const dim3 grid((w + THREADS - 1) / THREADS, bsz);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h_seq), static_cast<T*>(h_last), s, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of a, b, h_seq, h_last).
// a, b, h_seq: (B, S, w) contiguous; h0: (B, w) float32; h_last: (B, w).
// Returns cudaGetLastError() after launch.
extern "C" int rglru_scan(int dtype, const void* a, const void* b,
                          const void* h0, void* h_seq, void* h_last, int bsz,
                          int s, int w, void* stream) {
  if (bsz <= 0 || s <= 0 || w <= 0 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  if (dtype == 0) return launch<float>(a, b, h0f, h_seq, h_last, bsz, s, w, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0f, h_seq, h_last, bsz, s, w, st);
  if (dtype == 2) return launch<__half>(a, b, h0f, h_seq, h_last, bsz, s, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
