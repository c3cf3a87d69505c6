// Valid-length tiled GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tiled_gemm.py:tiled_gemm_valid
// (body _valid_kernel).  It computes out = x @ w for x (M, K) and w (K, N)
// with an fp32 accumulator, where M and N are cut into seg_m / seg_n
// segments that each hold valid_m / valid_n real leading entries and only
// the first valid_k entries of the contraction are real.  Pad outputs are
// exactly zero whatever the pad regions of x and w hold.
//
// What bounds it on the H100: the bytes of w.  The serving path calls it
// with a few dozen rows (a 57-row ring tile, or a decode batch of 4 one-row
// segments) against weight shards of 1280 x 1536 and similar: ~2.5 MB of
// live weight for ~0.15 GFLOP, so 0.0008 ms at 3.35 TB/s and far less on
// the tensor cores.  Reaching the memory rate takes megabytes in flight,
// so the card must be full; a grid of output tiles alone has 15-20 live
// tiles for 132 SMs.
//
// What this design does about it:
// - Split-K in one launch.  The host (plan_valid_gemm in tiled_gemm.py)
//   splits the live K steps into `splits` slices so that live tiles x
//   slices covers the card about once; blockIdx.x is the slice, so a
//   tile's slices are neighbouring blocks and run together.  Each block
//   writes its fp32 partial tile to a workspace (float4s, coalesced), then
//   one thread fences and counts the block's arrival on the tile's int32
//   counter (__syncthreads, __threadfence, atomicAdd).  The last block to
//   arrive reads the partials back past L1 (__ldcg), sums all slices in
//   slice order, writes the epilogue and resets the counter to 0 for the
//   next launch.  The sum's order does not depend on which block came
//   last, so a call's output is bitwise the same every time; no atomics
//   touch the output.
// - Short segments packed.  Where seg_m < 64 (a decode step: seg_m = 1
//   and one segment per slot), one M tile holds 64 / seg_m whole
//   segments, so each weight tile is read once per call, not once per
//   slot.  Prefill tiles (seg_m = 57) keep one segment per tile.  A row is
//   real iff (row % seg_m) < valid_m.
// - fp16 and bf16 on the tensor cores: mma.sync.m16n8k16 (fp32 accumulate) fed by
//   ldmatrix (.trans for the row-major K x N weight tile) from a 4-stage
//   ring of 16-byte cp.async copies, so three K steps of loads stay in
//   flight behind the one being multiplied.  fp32 (the parity dtype) keeps
//   exact fp32 FMAs on the CUDA cores from a 2-stage ring, on the same
//   grid, split and packing.
// - Predicated loads.  A 16-byte chunk wholly inside the real region (and
//   16-byte aligned) is one cp.async; a chunk wholly in padding is a
//   cp.async with source size 0, which writes zeros; a chunk straddling
//   the valid_k / valid_n edge, or misaligned by an odd row stride, is
//   copied element by element with its pad elements zeroed.  Garbage in
//   the pad regions never enters a sum.
// - Dead tiles (no real rows or columns) issue no loads: slice 0 writes
//   their zeros and the other slices exit.  Which rows of a tile are real
//   is worked out once per block into shared memory (32-bit arithmetic),
//   not per element.
//
// What still holds it back: a chain of latencies, not bytes.  On an H100
// at the served QKV ring tile (~13 us against a 0.8 us bound; cuBLAS ~6
// us), builds with parts cut out (launch/gemm_breakdown.py) put ~2 us in
// the launch, ~3 us in the slice's loads, ~1.5 us in the partial stores
// and the arrival, and ~5-6 us in the last block's reduction and
// epilogue, which wait on L2 round trips.
//
// Layout: 64 x 64 output tiles, K step 32, 128 threads.  fp16/bf16: 4 warps in
// 2 x 2, each a 32 x 32 sub-tile of 2 x 4 m16n8 fragments.  fp32: each
// thread owns rows ty + 8 i and columns tx + 16 j (8 x 4 outputs).  Either
// way a thread holds 32 fp32 accumulators, which is also the layout of its
// split-K partial (element-major, thread-minor: coalesced).  When asked,
// thread 0 of each live block adds its slice's K steps once per live
// segment of its tile to a device counter, so the total is the live
// (m, n, k) tile count at 64 x 64 x 32, as the TPU kernel counts.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int NACC = BM * BN / THREADS;  // accumulators per thread (32)

struct Params {
  const void* x;
  const void* w;
  void* out;
  int* counter;   // live-tile counter, or null
  float* ws;      // split-K partials, or null when splits == 1
  int* arrivals;  // per live tile arrival counters, 0 between launches
  int m, n, lda, ldw, ldo, seg_m, seg_n, valid_m, valid_n, valid_k;
  int pack;       // whole segments per M tile (1: a segment is tiled alone)
  int tpm, tpn;   // M tiles per segment (pack == 1), N tiles per segment
  int lmt, lnt;   // live M / N tiles per segment
  int live_n_tiles, k_steps, per, splits;
};

template <typename T> struct Raw;
template <> struct Raw<__half> { using type = uint16_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };
template <> struct Raw<float> { using type = uint32_t; };

template <typename T> struct Cfg {  // the 16-bit types
  static constexpr int STAGES = 4, APITCH = BK + 8, BPITCH = BN + 8;
};
template <> struct Cfg<float> {
  static constexpr int STAGES = 2, APITCH = BK + 4, BPITCH = BN + 4;
};

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte chunk of VEC elements, n_ok of them real (a prefix)
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, const T* base, int n_ok) {
  constexpr int VEC = 16 / sizeof(T);
  if (n_ok == VEC && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(smem_addr(dst), src, 16);
  } else if (n_ok <= 0) {
    // source size 0: zero fill (nothing is read; the address is aligned)
    cp_async16(smem_addr(dst), reinterpret_cast<const void*>(
                                   reinterpret_cast<uintptr_t>(base) & ~uintptr_t(15)), 0);
  } else {
    using R = typename Raw<T>::type;
    const R* s = reinterpret_cast<const R*>(src);
    R* d = reinterpret_cast<R*>(dst);
#pragma unroll
    for (int e = 0; e < VEC; ++e) d[e] = e < n_ok ? s[e] : R(0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__half>(float* c, const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* c, const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the tile row and column of accumulator e of thread tid (the 16-bit
// types' mma fragments; fp32 below)
template <typename T> __device__ __forceinline__ int acc_row(int e, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  return (warp / 2) * 32 + (e / 16) * 16 + lane / 4 + ((e % 4) >= 2 ? 8 : 0);
}
template <typename T> __device__ __forceinline__ int acc_col(int e, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  return (warp % 2) * 32 + ((e / 4) % 4) * 8 + (lane % 4) * 2 + (e % 2);
}
template <> __device__ __forceinline__ int acc_row<float>(int e, int tid) {
  return tid / 16 + 8 * (e / 4);
}
template <> __device__ __forceinline__ int acc_col<float>(int e, int tid) {
  return tid % 16 + 16 * (e % 4);
}

// one K step of the tile from stage buffers As / Bs (the 16-bit types on
// the tensor cores; fp32 below)
template <typename T> struct Compute {
  using C = Cfg<T>;
  static __device__ __forceinline__ void step(const T (*As)[C::APITCH],
                                              const T (*Bs)[C::BPITCH],
                                              float (&acc)[NACC], int tid) {
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &As[wm * 32 + i * 16 + (lane % 16)][ks * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[ks * 16 + (lane % 16)][wn * 32 + p * 16 + (lane / 16) * 8]);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816<T>(&acc[(i * 4 + j) * 4], a[i], b[j][0], b[j][1]);
    }
  }
};

template <> struct Compute<float> {
  using C = Cfg<float>;
  static __device__ __forceinline__ void step(const float (*As)[C::APITCH],
                                              const float (*Bs)[C::BPITCH],
                                              float (&acc)[NACC], int tid) {
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[ty + 8 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) valid_gemm_kernel(const Params p) {
  using C = Cfg<T>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ACPR = BK / VEC;                   // chunks per x-tile row
  constexpr int BCPR = BN / VEC;                   // chunks per w-tile row
  constexpr int A_ITERS = BM * ACPR / THREADS;
  constexpr int B_ITERS = BK * BCPR / THREADS;
  __shared__ alignas(16) T As[C::STAGES][BM][C::APITCH];
  __shared__ alignas(16) T Bs[C::STAGES][BK][C::BPITCH];
  __shared__ int is_last;
  __shared__ bool row_real[BM];  // tile row r is a real row of its segment

  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  T* out = static_cast<T*>(p.out);
  const int tid = threadIdx.x;
  // the slices of a tile are neighbouring blocks, so they run together
  const int z = blockIdx.x, tile_n = blockIdx.y, tile_m = blockIdx.z;

  // N tile: never straddles an N segment
  const int seg_col = tile_n / p.tpn, tin = tile_n % p.tpn;
  const int c0 = tin * BN;
  const int cols = min(BN, p.seg_n - c0);
  const int vcols = max(0, min(cols, p.valid_n - c0));
  const long long col_base = (long long)seg_col * p.seg_n + c0;
  // M tile: `pack` whole segments, or one piece of one segment
  long long row_base;
  int rows, live_segs, lm, r0 = 0;
  if (p.pack > 1) {
    const int s0 = tile_m * p.pack;
    const int segs = min(p.pack, p.m / p.seg_m - s0);
    row_base = (long long)s0 * p.seg_m;
    rows = segs * p.seg_m;
    live_segs = p.valid_m > 0 ? segs : 0;
    lm = tile_m;
  } else {
    const int seg_row = tile_m / p.tpm, tim = tile_m % p.tpm;
    r0 = tim * BM;
    row_base = (long long)seg_row * p.seg_m + r0;
    rows = min(BM, p.seg_m - r0);
    live_segs = r0 < p.valid_m ? 1 : 0;
    lm = seg_row * p.lmt + tim;
  }

  if (live_segs == 0 || vcols == 0) {  // dead tile: pure padding
    if (z != 0) return;
    for (int r = tid / 16; r < rows; r += THREADS / 16)
      for (int c = tid % 16; c < cols; c += 16)
        out[(row_base + r) * p.ldo + col_base + c] = from_float<T>(0.f);
    return;
  }

  // which tile rows are real, once per block (a packed tile starts on a
  // segment boundary; a piece of a segment starts r0 rows into it)
  if (tid < BM) {
    const int in_seg = p.pack > 1 ? tid % p.seg_m : r0 + tid;
    row_real[tid] = tid < rows && in_seg < p.valid_m;
  }
  __syncthreads();
  // this thread's x-tile rows are fixed over K
  bool a_row_ok[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) a_row_ok[i] = row_real[(tid + i * THREADS) / ACPR];

  const int s_begin = z * p.per;
  const int nk = max(0, min(p.per, p.k_steps - s_begin));

  auto load_stage = [&](int buf, int step) {
    const int k0 = step * BK;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / ACPR, c = idx % ACPR;
      const int kb = k0 + c * VEC;
      const int n_ok = a_row_ok[i] ? min(VEC, p.valid_k - kb) : 0;
      const T* src = n_ok > 0 ? x + (row_base + r) * p.lda + kb : x;
      load_chunk(&As[buf][r][c * VEC], src, x, n_ok);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BCPR, c = idx % BCPR;
      const int gk = k0 + kk;
      const int n_ok = gk < p.valid_k ? min(VEC, vcols - c * VEC) : 0;
      const T* src = n_ok > 0 ? w + (long long)gk * p.ldw + col_base + c * VEC : w;
      load_chunk(&Bs[buf][kk][c * VEC], src, w, n_ok);
    }
  };

  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nk) load_stage(st, s_begin + st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int nxt = it + C::STAGES - 1;
    if (nxt < nk) load_stage(nxt % C::STAGES, s_begin + nxt);
    cp_async_commit();
    Compute<T>::step(As[it % C::STAGES], Bs[it % C::STAGES], acc, tid);
  }
  cp_async_wait<0>();
  if (p.counter != nullptr && tid == 0 && nk > 0) atomicAdd(p.counter, nk * live_segs);

  if (p.splits > 1) {
    const int ln = seg_col * p.lnt + tin;
    const int slot = lm * p.live_n_tiles + ln;
    // partials as float4: [slice][quad of accumulators][thread], coalesced
    float4* part = reinterpret_cast<float4*>(p.ws) + (size_t)slot * p.splits * (NACC / 4) * THREADS;
#pragma unroll
    for (int q = 0; q < NACC / 4; ++q)
      part[((size_t)z * (NACC / 4) + q) * THREADS + tid] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    // the block's stores, then one thread's fence and arrival (the
    // barrier orders every thread's stores before that fence)
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      is_last = atomicAdd(&p.arrivals[slot], 1) == p.splits - 1;
      __threadfence();
    }
    __syncthreads();
    if (!is_last) return;
    // every slice in slice order, whichever block arrived last; a slice's
    // partials are loaded together, so the reduction waits on one L2
    // round trip per slice, not one per partial
    float sum[NACC];
#pragma unroll
    for (int e = 0; e < NACC; ++e) sum[e] = 0.f;
    for (int zz = 0; zz < p.splits; ++zz) {
      float v[NACC];
      if (zz == z) {
#pragma unroll
        for (int e = 0; e < NACC; ++e) v[e] = acc[e];
      } else {
#pragma unroll
        for (int q = 0; q < NACC / 4; ++q) {
          const float4 t = __ldcg(&part[((size_t)zz * (NACC / 4) + q) * THREADS + tid]);
          v[4 * q] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
      }
#pragma unroll
      for (int e = 0; e < NACC; ++e) sum[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = sum[e];
    if (tid == 0) p.arrivals[slot] = 0;  // ready for the next launch
  }

  // epilogue: straddling tiles write exact zeros past the valid prefix
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    const int r = acc_row<T>(e, tid), c = acc_col<T>(e, tid);
    if (r >= rows || c >= cols) continue;
    const bool real = c < vcols && row_real[r];
    out[(row_base + r) * p.ldo + col_base + c] = from_float<T>(real ? acc[e] : 0.f);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Pointers are device pointers; strides
// are in elements (row-major, unit column stride).  valid_* are clamped to
// their extents by the caller.  pack, m_tiles, per and splits are the
// host plan's (plan_valid_gemm); ws holds live tiles x splits x 64 x 64
// floats and arrivals one zeroed int per live tile when splits > 1.
// Returns cudaGetLastError() after launch.
extern "C" int tiled_gemm_valid(int dtype, const void* x, const void* w, void* out,
                                int* counter, float* ws, int* arrivals, int m, int n,
                                int k, int lda, int ldw, int ldo, int seg_m, int seg_n,
                                int valid_m, int valid_n, int valid_k, int pack,
                                int m_tiles, int per, int splits, void* stream) {
  if (m <= 0 || n <= 0 || seg_m <= 0 || seg_n <= 0 || m % seg_m || n % seg_n ||
      valid_k > k || pack < 1 || splits < 1 || per < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.counter = counter;
  p.ws = ws;
  p.arrivals = arrivals;
  p.m = m;
  p.n = n;
  p.lda = lda;
  p.ldw = ldw;
  p.ldo = ldo;
  p.seg_m = seg_m;
  p.seg_n = seg_n;
  p.valid_m = valid_m;
  p.valid_n = valid_n;
  p.valid_k = valid_k;
  p.pack = pack;
  p.tpm = pack > 1 ? 1 : (seg_m + BM - 1) / BM;
  p.tpn = (seg_n + BN - 1) / BN;
  p.lmt = (valid_m + BM - 1) / BM;
  p.lnt = (valid_n + BN - 1) / BN;
  p.live_n_tiles = (n / seg_n) * p.lnt;
  p.k_steps = (valid_k + BK - 1) / BK;
  p.per = per;
  p.splits = splits;
  const int want_m_tiles =
      pack > 1 ? (m / seg_m + pack - 1) / pack : (m / seg_m) * p.tpm;
  const long long n_tiles = (long long)(n / seg_n) * p.tpn;
  if (m_tiles != want_m_tiles || m_tiles > 65535 || n_tiles > 65535 ||
      (long long)per * splits < p.k_steps ||
      (splits > 1 && (ws == nullptr || arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(splits, (unsigned)n_tiles, m_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    valid_gemm_kernel<float><<<grid, THREADS, 0, s>>>(p);
  else if (dtype == 1)
    valid_gemm_kernel<__half><<<grid, THREADS, 0, s>>>(p);
  else if (dtype == 2)
    valid_gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
