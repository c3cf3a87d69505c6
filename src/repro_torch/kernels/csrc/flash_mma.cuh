// The tensor-core core of both flash-attention kernels (flash_attention.cu
// and ragged_flash_attention.cu), for bf16 and fp16 on Hopper (sm_90a).
//
// FlashAttention-2 in structure, on mma.sync.m16n8k16 with fp32
// accumulators in registers.  A warp owns 16 query rows.  Tiles sit in
// 16-bit shared memory, each row padded by 16 bytes (a pitch of HDP + 8
// elements), so the 8 rows an ldmatrix phase reads fall on distinct banks.
// Per key block of BK keys a warp:
//   - computes S = Q K^T: Q fragments by ldmatrix, re-read from shared
//     memory at every k16 step (holding them would cost HDP/4 registers);
//     K fragments by ldmatrix (K rows are the "col" B operand as stored);
//   - masks S where the caller says the block needs it (others skip it);
//   - runs the online softmax on the fragments: row max and row sum over
//     the quad of lanes that share a row (__shfl_xor_sync 1, 2; the sum is
//     kept per lane and reduced once at the end), ex2.approx with log2 e
//     folded into the scale, masked probabilities exactly 0, and a row with
//     nothing visible yet keeps acc = 0 and l = 0;
//   - repacks the S accumulators into the A fragments of O += P V (two n8
//     tiles make one k16 operand), so P never touches shared memory, and
//     reads V fragments by ldmatrix.trans; in bf16, P goes in as a high
//     and a low part (two products from the same V fragments), so that P
//     keeps about the precision of the plain version's fp32 P.
// Tiles are loaded by 16-byte cp.async, branch-free where a tensor's rows
// are 16-byte aligned (one cp.async a chunk; absent rows and the columns
// [hd, HDP) are zero fills, cp.async with source size 0).  Otherwise (an
// odd row stride of a transposed view, a misaligned base, hd not a
// multiple of 8) chunks that straddle hd or start misaligned are copied
// element by element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace flash_mma {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x on the special-function unit, subnormal results flushed to 0 (for
// probabilities in (0, 1], well below any bf16/fp16 rounding)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The 16-bit types: the mma, packing two floats into an operand register,
// and whether P goes into O += P V as a high and a low part (bf16 keeps 8
// mantissa bits: one rounding of P would move O by up to 2^-9 of |V|,
// and two products keep ~16 bits, as the plain version's fp32 P; fp16's
// 11 bits need one)
template <typename T> struct Mma;
template <> struct Mma<__half> {
  static constexpr bool kSplitP = false;
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
};
template <> struct Mma<__nv_bfloat16> {
  static constexpr bool kSplitP = true;
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  // what pack() keeps of v
  static __device__ __forceinline__ float rounded(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// elements of one shared-memory tile row
template <int HDP> __host__ __device__ constexpr int pitch() { return HDP + 8; }

// The rare chunk: n_ok (1..8) real elements, or a misaligned source.  Out
// of line, so that the unrolled tile loops stay small.
__device__ __noinline__ void copy_chunk_slow(uint16_t* dst, const uint16_t* src, int n_ok) {
  for (int e = 0; e < 8; ++e) dst[e] = e < n_ok ? src[e] : uint16_t(0);
}

// Whether every 16-byte chunk of a tensor's rows is one aligned cp.async:
// its base and row stride are 16-byte aligned and hd fills whole chunks.
template <typename T>
__device__ __forceinline__ bool rows_aligned(const T* base, long long row_stride, int hd) {
  return ((reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(row_stride * 2)) & 15) ==
             0 &&
         hd % 8 == 0;
}

// Copy a ROWS x HDP tile into shared memory with THREADS threads: tile
// row r is global row row0 + r of `base` (row_stride elements apart) where
// row_ok(r), else zeros; columns [hd, HDP) load as zeros too.  `aligned`
// (see rows_aligned, uniform over the block) takes the branch-free path:
// thread t copies 16-byte chunk t % CPR of rows t / CPR, t / CPR + RPP,
// ... (RPP rows a pass; threads past RPP * CPR idle), one cp.async a chunk
// of 16 bytes or, for a zero chunk, of 0 bytes from `fill` (any
// 16-byte-aligned global address), its source and destination stepped by
// a row pass, so few registers stay live beside O.  Otherwise chunks that
// straddle hd or start misaligned are copied element by element.
template <typename T, int ROWS, int HDP, int THREADS, typename RowOk>
__device__ __forceinline__ void load_tile(T* tile, int tid, int hd, bool aligned,
                                          const void* fill, const T* base, int row0,
                                          long long row_stride, RowOk row_ok) {
  constexpr int CPR = HDP / 8;        // 16-byte chunks a row
  constexpr int RPP = THREADS / CPR;  // rows a pass
  constexpr int PASSES = (ROWS + RPP - 1) / RPP;
  static_assert(RPP >= 1, "a row's chunks fit the threads");
  if (aligned) {
    const int c = tid % CPR, r0 = tid / CPR;
    if (r0 >= RPP) return;
    const bool col_ok = c * 8 < hd;
    const T* src = base + (row0 + r0) * row_stride + c * 8;
    uint32_t dst = smem_u32(tile + r0 * pitch<HDP>() + c * 8);
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int r = r0 + i * RPP;
      if (ROWS % RPP == 0 || r < ROWS) {
        const bool ok = col_ok && row_ok(r);
        cp_async16(dst, ok ? static_cast<const void*>(src) : fill, ok ? 16 : 0);
      }
      src += RPP * row_stride;
      dst += 2 * RPP * pitch<HDP>();
    }
    return;
  }
  static_assert((ROWS * CPR) % THREADS == 0, "chunks must divide over the threads");
#pragma unroll 1
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CPR, c = idx % CPR;
    T* dst = tile + r * pitch<HDP>() + c * 8;
    const int n_ok = row_ok(r) ? min(8, hd - c * 8) : 0;
    const T* src = base + (row0 + r) * row_stride + c * 8;
    if (n_ok >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(smem_u32(dst), src, 16);
    } else if (n_ok <= 0) {
      cp_async16(smem_u32(dst), fill, 0);
    } else {
      copy_chunk_slow(reinterpret_cast<uint16_t*>(dst), reinterpret_cast<const uint16_t*>(src),
                      n_ok);
    }
  }
}

// One warp's 16 query rows: the O accumulator and the softmax state.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, output
// columns 8 n + 2 t and 8 n + 2 t + 1 of every n8 tile n.
template <typename T, int HDP, int BK>
struct WarpFlash {
  static constexpr int NT = HDP / 8;  // n8 tiles of O
  static constexpr int ST = BK / 8;   // n8 tiles of S
  static constexpr int P = pitch<HDP>();
  static_assert(HDP % 16 == 0 && BK % 16 == 0, "tiles are whole k16 steps");

  float o[NT][4];
  float m[2];  // running row max, in scaled log2 units
  float l[2];  // this lane's part of the running row sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // One key block.  q: this warp's 16 rows; k, v: the block's BK rows (all
  // shared-memory addresses).  scale_log2 = log2(e) / sqrt(hd).  With
  // `masked` (warp-uniform), visible(half, key) says whether key `key`
  // (0..BK-1) is visible to this lane's row g + 8 * half; a caller that
  // passes a constant gets a copy of the step without the other case.
  template <typename Visible>
  __device__ __forceinline__ void step(bool masked, uint32_t q, uint32_t k, uint32_t v,
                                       float scale_log2, int lane, Visible visible) {
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // S = Q K^T
    const uint32_t qa = q + 2 * ((lane % 16) * P + (lane / 16) * 8);
    const uint32_t ka = k + 2 * (((lane % 8) + (lane / 16) * 8) * P + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + 2 * kk * 16);
#pragma unroll
      for (int j = 0; j < ST / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, ka + 2 * (j * 16 * P + kk * 16));
        Mma<T>::run(s[2 * j], a, b[0], b[1]);
        Mma<T>::run(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked && !visible(e / 2, 8 * j + 2 * (lane % 4) + (e % 2))) x = NEG_INF;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with nothing visible before has acc = 0 and l = 0
      alpha[r] = m[r] > NEG_INF / 2 ? fast_exp2(m[r] - m_new) : 0.f;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        // masked: exactly 0 (and a row with nothing visible stays at 0)
        const float p = !masked || x > NEG_INF / 2 ? fast_exp2(x - m[e / 2]) : 0.f;
        s[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
    // once the row maxima settle most blocks leave them be: alpha is then
    // exactly 1 on every row of the warp and O needs no rescale
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
    }

    // O += P V over the (k16 step, n16 column pair) items in order, with
    // the V fragments of the next VD items in flight; pf holds P as the
    // A operand (two n8 tiles of S make one k16 step), pl what bf16
    // rounding left of it
    constexpr bool SPLIT = Mma<T>::kSplitP;
    uint32_t pf[BK / 16][4], pl[SPLIT ? BK / 16 : 1][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[2 * kk + r / 2][2 * (r % 2)], y = s[2 * kk + r / 2][2 * (r % 2) + 1];
        pf[kk][r] = Mma<T>::pack(x, y);
        if constexpr (SPLIT)
          pl[kk][r] = Mma<T>::pack(x - Mma<T>::rounded(x), y - Mma<T>::rounded(y));
      }
    }
    constexpr int NP = NT / 2, ITEMS = (BK / 16) * NP, VD = 2;
    const uint32_t va = v + 2 * ((lane % 16) * P + (lane / 16) * 8);
    uint32_t vf[VD][4];
#pragma unroll
    for (int i = 0; i < VD && i < ITEMS; ++i)
      ldsm_x4_t(vf[i], va + 2 * ((i / NP) * 16 * P + (i % NP) * 16));
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int kk = i / NP, n = i % NP;
      Mma<T>::run(o[2 * n], pf[kk], vf[i % VD][0], vf[i % VD][1]);
      Mma<T>::run(o[2 * n + 1], pf[kk], vf[i % VD][2], vf[i % VD][3]);
      if constexpr (SPLIT) {
        Mma<T>::run(o[2 * n], pl[kk], vf[i % VD][0], vf[i % VD][1]);
        Mma<T>::run(o[2 * n + 1], pl[kk], vf[i % VD][2], vf[i % VD][3]);
      }
      if (i + VD < ITEMS)
        ldsm_x4_t(vf[i % VD], va + 2 * (((i + VD) / NP) * 16 * P + ((i + VD) % NP) * 16));
    }
  }

  // Write this lane's rows: row_dst(half) is the output row of g + 8 *
  // half (nullptr: not written); columns past hd are not written.  A row
  // with no visible key writes exact zeros.
  template <typename RowDst>
  __device__ __forceinline__ void store(int lane, int hd, RowDst row_dst) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T* dst = row_dst(r);
      if (dst == nullptr) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        const float v0 = l[r] > 0.f ? o[n][2 * r] * inv : 0.f;
        const float v1 = l[r] > 0.f ? o[n][2 * r + 1] * inv : 0.f;
        if (col + 1 < hd && (reinterpret_cast<uintptr_t>(dst + col) & 3) == 0) {
          const uint32_t w = Mma<T>::pack(v0, v1);
          *reinterpret_cast<uint32_t*>(dst + col) = w;
        } else {
          if (col < hd) dst[col] = Mma<T>::from_float(v0);
          if (col + 1 < hd) dst[col + 1] = Mma<T>::from_float(v1);
        }
      }
    }
  }
};

}  // namespace flash_mma
