// RG-LRU sequence scan, h_t = a_t * h_{t-1} + b_t, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:
// rglru_scan_kernel.  a, b: (B, S, w) contiguous; h0: (B, w) fp32.  h is
// carried in fp32; h_seq (B, S, w) and h_last (B, w) are written in the
// dtype of a.  Any S >= 1 and any w, where the Pallas kernel asserted that
// its tiles divide.
//
// What bounds it on the H100: it reads a and b once and writes h_seq
// once — 12 bytes per element in fp32 against 2 FLOPs — so it is bound
// by bytes (RecurrentGemma-9B prefill: (2, 2100, 4096) fp32, 206 MB).
// The recurrence is diagonal, so every (batch, column) is independent
// and sequential only along S; its dependent chain (a multiply and an
// add a step, ~10 us over 2100 steps) is far below the bytes' time.  What
// holds a plain loop back is how few loads it keeps in flight.
//
// Path "tma" (rows of 16-byte multiples, 16-byte-aligned a and b): a
// block owns a strip of STRIP = 32 columns of one batch row and streams it
// along S through a ring of `stages` stages of shared memory, each 8 KB:
// ROWS sequence rows x 32 columns of a, then of b (ROWS = 32 in fp32, 64
// in 16-bit types).  One producer thread fills the stages with TMA (one 3-D
// box per array per stage: 32 columns x ROWS rows x 1 batch row, zeros
// past S) and a full mbarrier per stage; one consumer warp walks the
// stages row by row, each lane owning one column (neighbouring lanes on
// neighbouring words: no bank conflicts), h in a register, and writes
// h_seq straight to device memory, a row of the strip per store
// instruction (coalesced), then frees the stage on its empty mbarrier.
// The launch plan (kernels/rglru_scan.py:plan_scan) picks the stages so
// that the blocks resident on one SM hold up to 64 KB each in flight;
// this file refuses a plan whose strip, rows, stages, grid or shared
// memory differ from what it builds.
//
// Path "simt" (any other shape or alignment): the first port's loop, one
// thread per (batch, column), 64-thread blocks, UNROLL rows of loads in
// flight a thread.
//
// Both paths round the product and the sum separately (no FMA
// contraction), in the order of the plain PyTorch version, so fp32
// results match it bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

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

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// --- path "simt" ---------------------------------------------------------------

constexpr int SIMT_THREADS = 64;
constexpr int UNROLL = 8;

template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS) simt_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ h0, T* __restrict__ h_seq,
    T* __restrict__ h_last, int s, int w) {
  const int col = blockIdx.x * SIMT_THREADS + threadIdx.x;
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
      h = step(av[u], h, bv[u]);
      h_seq[base + static_cast<long long>(t + u) * w] = from_float<T>(h);
    }
  }
  for (; t < s; ++t) {
    const long long i = base + static_cast<long long>(t) * w;
    h = step(to_float(a[i]), h, to_float(b[i]));
    h_seq[i] = from_float<T>(h);
  }
  h_last[static_cast<long long>(bi) * w + col] = from_float<T>(h);
}

template <typename T>
int launch_simt(const void* a, const void* b, const float* h0, void* h_seq,
                void* h_last, int bsz, int s, int w, cudaStream_t stream) {
  const dim3 grid((w + SIMT_THREADS - 1) / SIMT_THREADS, bsz);
  simt_kernel<T><<<grid, SIMT_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h_seq), static_cast<T*>(h_last), s, w);
  return static_cast<int>(cudaGetLastError());
}

// --- path "tma" ----------------------------------------------------------------

constexpr int STRIP = 32;             // columns a block owns: one consumer lane each
constexpr int STAGE_BYTES = 8192;     // a and b of one stage
constexpr int ARRAY_BYTES = STAGE_BYTES / 2;
constexpr int MAX_STAGES = 8;
constexpr int TMA_THREADS = 64;       // the consumer warp, then the producer warp
constexpr int ALIGN = 128;            // TMA destinations sit on 128-byte boundaries
constexpr int MAX_SMEM = MAX_STAGES * STAGE_BYTES + ALIGN;

template <typename T> __host__ __device__ constexpr int rows_per_stage() {
  return ARRAY_BYTES / (STRIP * static_cast<int>(sizeof(T)));
}

template <typename T>
__global__ void __launch_bounds__(TMA_THREADS) tma_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ h0, T* __restrict__ h_seq, T* __restrict__ h_last, int s,
    int w, int stages) {
  constexpr int ROWS = rows_per_stage<T>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  const uint32_t raw = tma::smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const T* tiles = reinterpret_cast<const T*>(smem_raw + (base - raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * STRIP, bi = blockIdx.y;
  const int n_tiles = (s + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      tma::mbar_init(tma::smem_u32(&full[i]), 1);
      tma::mbar_init(tma::smem_u32(&empty[i]), 1);
    }
    tma::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 1) {  // producer: one thread keeps every free stage loading
    if (lane == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int st = k % stages, round = k / stages;
        if (round > 0) tma::mbar_wait(tma::smem_u32(&empty[st]), (round - 1) & 1);
        const uint32_t bar = tma::smem_u32(&full[st]);
        const uint32_t dst = base + st * STAGE_BYTES;
        tma::mbar_expect_tx(bar, STAGE_BYTES);
        tma::load_3d(dst, &map_a, bar, c0, k * ROWS, bi);
        tma::load_3d(dst + ARRAY_BYTES, &map_b, bar, c0, k * ROWS, bi);
      }
    }
    return;
  }

  // consumer warp: lane = column c0 + lane
  const int col = c0 + lane;
  const bool live = col < w;
  float h = live ? h0[static_cast<long long>(bi) * w + col] : 0.f;
  T* out = h_seq + static_cast<long long>(bi) * s * w + col;
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % stages;
    tma::mbar_wait(tma::smem_u32(&full[st]), (k / stages) & 1);
    const T* as = tiles + st * (STAGE_BYTES / sizeof(T)) + lane;
    const T* bs = as + ARRAY_BYTES / sizeof(T);
    const int t0 = k * ROWS;
    T* o = out + static_cast<long long>(t0) * w;
    if (t0 + ROWS <= s) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        h = step(to_float(as[r * STRIP]), h, to_float(bs[r * STRIP]));
        if (live) o[static_cast<long long>(r) * w] = from_float<T>(h);
      }
    } else {
      for (int r = 0; r < s - t0; ++r) {
        h = step(to_float(as[r * STRIP]), h, to_float(bs[r * STRIP]));
        if (live) o[static_cast<long long>(r) * w] = from_float<T>(h);
      }
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(tma::smem_u32(&empty[st]));
  }
  if (live) h_last[static_cast<long long>(bi) * w + col] = from_float<T>(h);
}

// (w, S, B) with rows of w elements, cut into (STRIP, rows, 1) boxes,
// zeros past its edges
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr, int w,
              int s, int bsz, int rows) {
  tma::EncodeTiled fn = tma::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)s, (cuuint64_t)bsz};
  const cuuint64_t strides[2] = {(cuuint64_t)w * esize, (cuuint64_t)w * s * esize};
  const cuuint32_t box[3] = {(cuuint32_t)STRIP, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_tma(CUtensorMapDataType type, const void* a, const void* b, const float* h0,
               void* h_seq, void* h_last, int bsz, int s, int w, int stages,
               cudaStream_t stream) {
  constexpr int esize = static_cast<int>(sizeof(T));
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 ||
      (static_cast<long long>(w) * esize) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, type, esize, a, w, s, bsz, rows_per_stage<T>()) ||
      !make_map(&map_b, type, esize, b, w, s, bsz, rows_per_stage<T>()))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tma_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((w + STRIP - 1) / STRIP, bsz);
  tma_kernel<T><<<grid, TMA_THREADS, stages * STAGE_BYTES + ALIGN, stream>>>(
      map_a, map_b, h0, static_cast<T*>(h_seq), static_cast<T*>(h_last), s, w, stages);
  return static_cast<int>(cudaGetLastError());
}

int esize_of(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of a, b, h_seq, h_last).
// path: 0 = simt, 1 = tma.  a, b, h_seq: (B, S, w) contiguous; h0: (B, w)
// float32; h_last: (B, w).  strip, rows, stages, grid_x and smem are the
// launch plan (kernels/rglru_scan.py:plan_scan): columns a block owns,
// sequence rows a stage holds, stages, column strips, dynamic shared
// bytes a block.  Returns cudaGetLastError() after launch, or
// cudaErrorInvalidValue (before any launch) for arguments or a plan this
// file does not build.
extern "C" int rglru_scan(int dtype, int path, const void* a, const void* b,
                          const void* h0, void* h_seq, void* h_last, int bsz, int s,
                          int w, int strip, int rows, int stages, int grid_x, int smem,
                          void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (bsz <= 0 || s <= 0 || w <= 0 || bsz > 65535 || dtype < 0 || dtype > 2) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  if (path == 0) {
    if (strip != SIMT_THREADS || rows != 0 || stages != 0 || smem != 0 ||
        grid_x != (w + SIMT_THREADS - 1) / SIMT_THREADS)
      return bad;
    if (dtype == 0) return launch_simt<float>(a, b, h0f, h_seq, h_last, bsz, s, w, st);
    if (dtype == 1)
      return launch_simt<__nv_bfloat16>(a, b, h0f, h_seq, h_last, bsz, s, w, st);
    return launch_simt<__half>(a, b, h0f, h_seq, h_last, bsz, s, w, st);
  }
  if (path != 1) return bad;
  if (strip != STRIP || rows != ARRAY_BYTES / (STRIP * esize_of(dtype)) || stages < 1 ||
      stages > MAX_STAGES || smem != stages * STAGE_BYTES + ALIGN ||
      grid_x != (w + STRIP - 1) / STRIP)
    return bad;
  if (dtype == 0)
    return launch_tma<float>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, b, h0f, h_seq, h_last, bsz,
                             s, w, stages, st);
  if (dtype == 1)
    return launch_tma<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, b, h0f, h_seq,
                                     h_last, bsz, s, w, stages, st);
  return launch_tma<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a, b, h0f, h_seq, h_last, bsz,
                            s, w, stages, st);
}
