// Dense tiled GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tiled_gemm.py:tiled_gemm (body
// _kernel): out = x @ w for x (M, K) and w (K, N), accumulated in fp32 and
// written in the operands' dtype (fp32, bf16 or fp16).  The TPU kernel's
// block sizes only decide which shapes its wrapper accepts; this kernel
// picks its own tiles and masks ragged edges itself, so it takes any shape.
//
// What bounds it on the H100: at a served width (StableLM-12B's MLP
// up-projection on a 512-row prefill chunk, (512 x 5120) @ (5120 x 13824)
// in bf16) it does 7.2e10 FLOPs against 0.15 GB of operands and output,
// so it is bound by operations: 0.073 ms at the bf16 tensor-core peak.
//
// What this first design does about it: little.  It is a plain CUDA-core
// kernel that is right first: 128 x 128 output tiles, a K step of 16, 256
// threads that each hold an 8 x 8 block of fp32 accumulators (rows ty + 16
// i, columns tx + 16 j, so neighbouring threads read neighbouring shared
// words and write neighbouring output columns).  Operands are converted
// to fp32 as they are staged in shared memory, so every dtype runs the
// same fp32 FMA loop.  It cannot pass the fp32 CUDA-core rate (67
// TFLOP/s, about 15x the bf16 bound); tensor cores (wgmma), TMA staging
// and a pipelined ring of tiles are later work.  No path of the port's
// serving calls it: its entry point is ops.tiled_gemm, as in the reference.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = BM / 16;  // rows per thread (8)
constexpr int TN = BN / 16;  // columns per thread (8)

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
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int m, int n, int k, int lda, int ldw, int ldo) {
  // x tile k-major, rows padded by 4 so the transposing store spreads
  // over banks; w tile row-major
  __shared__ float xs[BK][BM + 4];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // 16 neighbouring threads read 16 neighbouring k of one row of x, and
    // neighbouring threads neighbouring columns of w; edges load as zeros
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int i = tid + l * THREADS;
      const int r = i / BK, kk = i % BK;
      const int gr = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < m && gk < k) ? to_float(x[(size_t)gr * lda + gk]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int i = tid + l * THREADS;
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = n0 + c;
      ws[kk][c] = (gk < k && gc < n) ? to_float(w[(size_t)gk * ldw + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n) out[(size_t)r * ldo + c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int m, int n, int k,
            int lda, int ldw, int ldo, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      m, n, k, lda, ldw, ldo);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Pointers are device
// pointers; row strides are in elements (row-major, unit column stride).
// Returns cudaGetLastError() after launch.
extern "C" int tiled_gemm(int dtype, const void* x, const void* w, void* out,
                          int m, int n, int k, int lda, int ldw, int ldo,
                          void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, w, out, m, n, k, lda, ldw, ldo, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, out, m, n, k, lda, ldw, ldo, s);
  else if (dtype == 2)
    launch<__half>(x, w, out, m, n, k, lda, ldw, ldo, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
