// Valid-length tiled GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tiled_gemm.py:tiled_gemm_valid
// (body _valid_kernel).  It computes out = x @ w for x (M, K) and w (K, N)
// with an fp32 accumulator, where M and N are cut into seg_m / seg_n
// segments that each hold valid_m / valid_n real leading entries and only
// the first valid_k entries of the contraction are real.  Pad outputs are
// exactly zero whatever the pad regions of x and w hold.
//
// What bounds it on the H100: the serving path calls it with a few dozen
// rows (one ring tile of ~57 rows, or a decode batch of 4) against weight
// shards of 1280 x 1536 and similar, so each call reads ~2-5 MB of weight
// for ~0.2 GFLOP: it is bound by the bytes of w (3.35 TB/s), and with
// under 132 output tiles it cannot fill the card either.
//
// What this first design does about it: it reads each live weight element
// once per M tile, never touches dead tiles' operands at all (a tile past
// valid_m/valid_n writes zeros and exits; the K loop stops at
// ceil(valid_k/BK)), so the bytes moved track the device's assigned heads
// and columns, not max(units).  The inner product is plain fp32 FMA on
// CUDA cores from shared-memory tiles; tensor cores (wgmma), TMA, split-K
// for more blocks and pipelining are later work.
//
// Layout: 64 x 64 output tiles, K step 32, 256 threads computing 4 x 4
// outputs each.  A tile never straddles a segment: each segment is tiled
// on its own (its last tile may be partial), and the kernel masks ragged
// edges itself, so block sizes need not divide the axes.  When asked, one
// thread of each live tile adds its number of K steps to a device counter
// (one count per live (m, n, k) step, as the TPU kernel counts).
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) valid_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int* __restrict__ counter, int lda, int ldw, int ldo, int seg_m, int seg_n,
    int tiles_per_seg_m, int tiles_per_seg_n, int valid_m, int valid_n,
    int valid_k) {
  const int seg_row = blockIdx.y / tiles_per_seg_m;
  const int seg_col = blockIdx.x / tiles_per_seg_n;
  const int r0 = (blockIdx.y % tiles_per_seg_m) * BM;  // offset in segment
  const int c0 = (blockIdx.x % tiles_per_seg_n) * BN;
  const int rows = min(BM, seg_m - r0);  // tile extent inside its segment
  const int cols = min(BN, seg_n - c0);
  const int vrows = max(0, min(rows, valid_m - r0));  // real rows / columns
  const int vcols = max(0, min(cols, valid_n - c0));
  const size_t row_base = (size_t)seg_row * seg_m + r0;
  const size_t col_base = (size_t)seg_col * seg_n + c0;
  const int tid = threadIdx.x;

  if (vrows == 0 || vcols == 0) {  // dead tile: pure padding
    for (int i = tid; i < rows * cols; i += THREADS) {
      const int r = i / cols, c = i % cols;
      out[(row_base + r) * ldo + col_base + c] = from_float<T>(0.f);
    }
    return;
  }

  __shared__ float xs[BK][BM + 1];  // x tile, k-major
  __shared__ float ws[BK][BN];
  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j: neighbouring
  // threads read neighbouring shared-memory words and write neighbouring
  // output columns
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (valid_k + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // the K tail and the pad rows / columns load as zeros, so garbage in
    // the pad regions never enters the sum
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      float v = 0.f;
      if (r < vrows && k0 + kk < valid_k) v = to_float(x[(row_base + r) * lda + k0 + kk]);
      xs[kk][r] = v;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      float v = 0.f;
      if (c < vcols && k0 + kk < valid_k) v = to_float(w[(size_t)(k0 + kk) * ldw + col_base + c]);
      ws[kk][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
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
  if (counter != nullptr && tid == 0 && nk > 0) atomicAdd(counter, nk);

  // epilogue: straddling tiles write exact zeros past the valid prefix
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c >= cols) continue;
      const float v = (r < vrows && c < vcols) ? acc[i][j] : 0.f;
      out[(row_base + r) * ldo + col_base + c] = from_float<T>(v);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int* counter, int m, int n,
            int lda, int ldw, int ldo, int seg_m, int seg_n, int valid_m,
            int valid_n, int valid_k, cudaStream_t stream) {
  const int tpm = (seg_m + BM - 1) / BM;
  const int tpn = (seg_n + BN - 1) / BN;
  const dim3 grid((n / seg_n) * tpn, (m / seg_m) * tpm);
  valid_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      counter, lda, ldw, ldo, seg_m, seg_n, tpm, tpn, valid_m, valid_n, valid_k);
}

}  // namespace

// dtype: 0 = float32, 1 = float16.  Pointers are device pointers; strides
// are in elements (row-major, unit column stride).  valid_* are clamped to
// their extents by the caller.  Returns cudaGetLastError() after launch.
extern "C" int tiled_gemm_valid(int dtype, const void* x, const void* w,
                                void* out, int* counter, int m, int n, int k,
                                int lda, int ldw, int ldo, int seg_m, int seg_n,
                                int valid_m, int valid_n, int valid_k,
                                void* stream) {
  if (m <= 0 || n <= 0 || seg_m <= 0 || seg_n <= 0 || m % seg_m || n % seg_n ||
      valid_k > k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, w, out, counter, m, n, lda, ldw, ldo, seg_m, seg_n,
                  valid_m, valid_n, valid_k, s);
  else if (dtype == 1)
    launch<__half>(x, w, out, counter, m, n, lda, ldw, ldo, seg_m, seg_n,
                   valid_m, valid_n, valid_k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
