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
// so it is bound by operations: 0.073 ms at the bf16 tensor-core peak,
// which only wgmma reaches.
//
// What this design does about it (path "wgmma", bf16/fp16):
// - 128 x 128 output tiles, K step 64, blocks of 288 threads, two on each
//   SM: two consumer warpgroups each own 64 rows and run
//   wgmma.mma_async.m64n128k16 with the fp32 accumulator (64 registers a
//   thread) in registers; one producer warp issues the loads.  With two
//   blocks an SM, one block's epilogue and pipeline fill overlap the
//   other's products (on an H100 at the served width, 0.130 ms against
//   0.149 ms for one block of 4 stages an SM).
// - TMA stages the operands into a 3-stage ring of shared memory (32 KB a
//   stage, 97 KB of dynamic shared memory a block) in the 128-byte swizzle
//   the wgmma descriptors name.  x is K-major: one 64 x 128 box a stage.  w is
//   row-major K x N, so MN-major for wgmma (transpose bit set): two boxes
//   of 64 columns x 64 K rows a stage, 8 KB apart (the descriptor's
//   leading byte offset), 8-row K groups 1024 bytes apart (its stride
//   byte offset).  Full and empty mbarriers pass each stage between the
//   producer and the consumers; a consumer keeps one wgmma group in flight
//   and releases a stage once the group that read it has finished.
// - TMA zero-fills boxes past the ragged M, N and K edges, so any shape
//   whose tensor maps exist runs; the epilogue converts and stores with
//   row and column masks.
// - Rasterisation: blockIdx.x walks the M tiles first, so the four M tiles
//   of one N tile run side by side and the 141 MB weight is read from
//   device memory once (an N-first order would read it once per M tile).
// - Wave quantisation at the served width: 4 x 108 = 432 tiles on 132 SMs
//   are 3.27 tiles an SM, so the busiest SMs do 4 while the mean is 3.27
//   (82 %); 128 x 256 tiles (216, 1.64 an SM) or a persistent tile loop
//   quantise the same way (4 rounds of a 128 x 128 tile's work on the
//   busiest SM), and 128 x 128 keeps the accumulator at 64 registers
//   without register reallocation.  That 18 % is most of what separates
//   the kernel from cuBLAS; a split of the last round (stream-K) is
//   later work.
//
// TMA needs 16-byte-aligned base addresses and row strides.  Operands it
// cannot describe (an odd row stride, as 201 x 333 @ 333 x 157 has), and
// fp32, take path "simt": the CUDA-core loop of the first port, 128 x 128
// tiles, a K step of 16, 8 x 8 fp32 accumulators per thread, operands
// converted to fp32 as they are staged (fp32 stays exact fp32 FMA).  The
// wrapper picks the path from dtype and alignment before the launch.  No
// path of the port's serving calls this kernel: its entry point is
// ops.tiled_gemm, as in the reference.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

// --- path "simt": CUDA cores -------------------------------------------------

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
__global__ void __launch_bounds__(THREADS) simt_kernel(
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
int launch_simt(const void* x, const void* w, void* out, int m, int n, int k, int lda,
                int ldw, int ldo, cudaStream_t stream) {
  if ((m + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  simt_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      m, n, k, lda, ldw, ldo);
  return static_cast<int>(cudaGetLastError());
}

// --- path "wgmma": tensor cores, TMA ------------------------------------------

constexpr int WM = 128;                     // block tile rows
constexpr int WN = 128;                     // block tile columns
constexpr int WK = 64;                      // K step: one 128-byte swizzle row
constexpr int WSTAGES = 3;
constexpr int CONSUMERS = 2;                // warpgroups, 64 rows each
constexpr int WTHREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int A_BYTES = WM * WK * 2;        // 16 KB
constexpr int B_BOX_BYTES = 64 * WK * 2;    // one 64-column box of w: 8 KB
constexpr int B_BYTES = WN / 64 * B_BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int WSMEM = WSTAGES * STAGE_BYTES + 1024;  // + room to align to 1024

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += a (64 x 16, K-major) * b (16 x 128, MN-major: transpose bit set)
#define WGMMA_M64N128K16(TY)                                                   \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %66, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                               \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                               \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                               \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                               \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                              \
      "%64, %65, p, 1, 1, 0, 1;\n"                                             \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                     \
      : "l"(da), "l"(db), "r"(1))

template <bool BF16>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (BF16) {
    WGMMA_M64N128K16("bf16");
  } else {
    WGMMA_M64N128K16("f16");
  }
}

template <bool BF16>
__device__ __forceinline__ void store_pair(void* out, size_t off, float a, float b) {
  if constexpr (BF16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off) =
        __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + off) = __floats2half2_rn(a, b);
}
template <bool BF16>
__device__ __forceinline__ void store_one(void* out, size_t off, float a) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(a);
  else
    static_cast<__half*>(out)[off] = __float2half_rn(a);
}

template <bool BF16>
__global__ void __launch_bounds__(WTHREADS, 2) wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
    void* __restrict__ out, int m, int n, int k, int ldo) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t full[WSTAGES], empty[WSTAGES];
  // swizzled tiles sit on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * WM, n0 = blockIdx.y * WN;
  const int nk = (k + WK - 1) / WK;

  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    tma::mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {  // producer warp: one thread issues every load
    if (tid % 32 == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WSTAGES, round = kt / WSTAGES;
        if (round > 0) mbar_wait(smem_u32(&empty[s]), (round - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t a = base + s * STAGE_BYTES, b = a + A_BYTES;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma::load_2d(a, &map_x, bar, kt * WK, m0);
#pragma unroll
        for (int box = 0; box < WN / 64; ++box)
          tma::load_2d(b + box * B_BOX_BYTES, &map_w, bar, n0 + box * 64, kt * WK);
      }
    }
    return;
  }

  // consumer warpgroup g: rows m0 + 64 g .. + 64
  const int g = warp / 4;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WSTAGES;
    mbar_wait(smem_u32(&full[s]), (kt / WSTAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + g * (64 * WK * 2);
    const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)  // 16 K: 32 bytes along x's rows, 16 rows of w
      wgmma_m64n128k16<BF16>(d, desc_sw128(a + kk * 32, 16, 1024),
                             desc_sw128(b + kk * 16 * 128, B_BOX_BYTES, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the group of step kt - 1 has finished: free its stage
    if (kt > 0 && tid % 128 == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % WSTAGES]));
  }
  wgmma_wait<0>();

  // epilogue: fragment j of warp wl holds row 16 wl + lane / 4 (+ 8 for
  // j % 4 >= 2) and columns 8 (j / 4) + 2 (lane % 4) + (j % 2)
  const int wl = warp % 4, lane = tid % 32;
  const int row0 = m0 + g * 64 + wl * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const int r = row0 + 8 * ((j / 2) % 2);
    const int c = n0 + (j / 4) * 8 + (lane % 4) * 2;
    if (r >= m) continue;
    const size_t off = (size_t)r * ldo + c;
    if (c + 1 < n && ldo % 2 == 0) {
      store_pair<BF16>(out, off, d[j], d[j + 1]);
    } else {
      if (c < n) store_one<BF16>(out, off, d[j]);
      if (c + 1 < n) store_one<BF16>(out, off + 1, d[j + 1]);
    }
  }
}

// a row-major (outer x inner) 16-bit matrix cut into (box_outer x
// box_inner) boxes, 128-byte swizzle, zeros past its edges
bool make_map(CUtensorMap* map, bool bf16, const void* ptr, int inner, int outer,
              int row_elems, int box_inner, int box_outer) {
  tma::EncodeTiled fn = tma::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_elems * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool BF16>
int launch_wgmma(const void* x, const void* w, void* out, int m, int n, int k, int lda,
                 int ldw, int ldo, cudaStream_t stream) {
  if (k <= 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      (lda * 2) % 16 || (ldw * 2) % 16 || (n + WN - 1) / WN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, BF16, x, k, m, lda, WK, WM) ||
      !make_map(&map_w, BF16, w, n, k, ldw, 64, WK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((m + WM - 1) / WM, (n + WN - 1) / WN);
  wgmma_kernel<BF16><<<grid, WTHREADS, WSMEM, stream>>>(map_x, map_w, out, m, n, k, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  path: 0 = simt (any
// dtype and layout), 1 = wgmma (bf16/fp16 with 16-byte-aligned pointers
// and row strides, k > 0).  Pointers are device pointers; row strides are
// in elements (row-major, unit column stride).  Returns cudaGetLastError()
// after launch, or cudaErrorInvalidValue for arguments the path refuses.
extern "C" int tiled_gemm(int dtype, const void* x, const void* w, void* out, int m,
                          int n, int k, int lda, int ldw, int ldo, int path,
                          void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype == 1) return launch_wgmma<true>(x, w, out, m, n, k, lda, ldw, ldo, s);
    if (dtype == 2) return launch_wgmma<false>(x, w, out, m, n, k, lda, ldw, ldo, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_simt<float>(x, w, out, m, n, k, lda, ldw, ldo, s);
  if (dtype == 1) return launch_simt<__nv_bfloat16>(x, w, out, m, n, k, lda, ldw, ldo, s);
  if (dtype == 2) return launch_simt<__half>(x, w, out, m, n, k, lda, ldw, ldo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
