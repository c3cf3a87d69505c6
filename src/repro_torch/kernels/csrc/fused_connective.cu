// Fused connective block for Hopper (sm_90a): dropout -> residual add ->
// LayerNorm -> scale and bias, over the row shards of one connective site
// in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_connective.py:
// fused_connective (body _kernel).  For every row of every shard: x
// (times keep / (1 - rate) when dropout is on) plus the residual, then
// LayerNorm in fp32 (eps given), times scale plus bias, written in x's
// dtype.  Each shard has its own tensors, row count and row strides, and
// its own scale and bias; all share d and the dtype.
//
// What bounds it on the H100: bytes, and far more the launch.  One
// GPT2-L connective site is 4 shards of 57 x 1280 fp16 rows, ~1.8 MB
// moved against a 0.0005 ms bound, where one launch costs a few
// microseconds.  So the design launches once per site, not once per
// shard, and keeps each row's trip through the SM short:
// - The parameter struct (by value) holds up to MAX_SHARDS shard
//   descriptors and the prefix of their row counts; the grid covers the
//   shards' rows one after another, WARPS rows a block.
// - Path "warp": one warp per row.  Each lane loads its share of x, the
//   residual (and the keep mask) with 16-byte loads, keeps the row's fp32
//   sums in registers (up to MAX_ELEMS a lane: rows up to 2560 wide, the
//   widest model of configs/paper_models.py), takes the mean and then the
//   variance of the row (two passes over the registers, as the plain
//   version) with warp shuffles, and writes the row with 16-byte stores.
//   No shared memory and no __syncthreads.  Rows up to 1280 wide (an
//   instance of 40 values a lane) load the lane's scale and bias vectors
//   with the row: loaded after the reductions they cost ~1 us of a ~5 us
//   launch (H100, a GPT2-L site, launch/connective_breakdown.py); wider
//   rows (80 values a lane) have no registers left for that.  It needs d
//   a multiple of the 16-byte vector, d <= 32 * MAX_ELEMS, and
//   16-byte-aligned pointers and row strides.
// - Path "loop" (any other row): one warp per row, element by element,
//   three passes over the row in device memory (sum, squared deviations,
//   output).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SHARDS = 8;
constexpr int WARPS = 4;         // rows a block
// fp32 values a lane holds on path "warp": rows up to 32 x 40 = 1280 wide
// (GPT2-L) and up to 32 x 80 = 2560 wide
constexpr int SMALL_ELEMS = 40;
constexpr int MAX_ELEMS = 80;

struct Shard {
  const void* x;
  const void* res;
  const void* keep;
  void* out;
  const void* scale;
  const void* bias;
  long long sx, sr, sk, so;  // row strides, elements
};

struct Group {
  Shard sh[MAX_SHARDS];
  int row0[MAX_SHARDS + 1];  // shard j holds the grid's rows [row0[j], row0[j + 1])
  int n, d;
  float keep_scale, eps;
};

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the shard that holds grid row `row` (shards with no rows hold none)
__device__ __forceinline__ int shard_of(const Group& g, int row) {
  int j = 0;
#pragma unroll
  for (int k = 1; k < MAX_SHARDS; ++k)
    if (k < g.n && row >= g.row0[k]) j = k;
  return j;
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[V]) {
  static_assert(V * sizeof(T) == 16, "16-byte vectors");
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = to_float(t[e]);
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  unpack<T, V>(load16(p), f);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  uint4 u;
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = from_float<T>(f[e]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, bool KEEP, int ELEMS>
__global__ void __launch_bounds__(WARPS * 32) warp_kernel(const __grid_constant__ Group g,
                                                          int total) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int NV = ELEMS / V;      // vectors a lane holds at most
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= total) return;
  const int j = shard_of(g, row);
  const Shard& sh = g.sh[j];
  const long long r = row - g.row0[j];
  const int d = g.d;
  const T* x = static_cast<const T*>(sh.x) + r * sh.sx;
  const T* res = static_cast<const T*>(sh.res) + r * sh.sr;
  const T* keep = static_cast<const T*>(sh.keep) + r * sh.sk;
  const T* scale = static_cast<const T*>(sh.scale);
  const T* bias = static_cast<const T*>(sh.bias);
  // rows up to SMALL_ELEMS a lane load the lane's scale and bias vectors
  // with the row (8 registers a vector), so no load is waited for after
  // the reductions; wider rows would run out of registers and load them
  // last
  constexpr bool EARLY = ELEMS == SMALL_ELEMS;
  uint4 sraw[EARLY ? NV : 1], braw[EARLY ? NV : 1];
  float y[NV][V];
  float part[V];  // V short chains of sums, not one long one
#pragma unroll
  for (int e = 0; e < V; ++e) part[e] = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = (v * 32 + lane) * V;
    if (c < d) {
      float xv[V], rv[V];
      load_vec<T, V>(x + c, xv);
      load_vec<T, V>(res + c, rv);
      if constexpr (EARLY) {
        sraw[v] = load16(scale + c);
        braw[v] = load16(bias + c);
      }
      if constexpr (KEEP) {
        float kv[V];
        load_vec<T, V>(keep + c, kv);
#pragma unroll
        for (int e = 0; e < V; ++e) xv[e] = xv[e] * kv[e] * g.keep_scale;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        y[v][e] = xv[e] + rv[e];
        part[e] += y[v][e];
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) sum += part[e];
  const float mean = warp_sum(sum) / d;
#pragma unroll
  for (int e = 0; e < V; ++e) part[e] = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if ((v * 32 + lane) * V < d) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        y[v][e] -= mean;
        part[e] += y[v][e] * y[v][e];
      }
    }
  }
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) sq += part[e];
  const float rstd = rsqrtf(warp_sum(sq) / d + g.eps);
  T* out = static_cast<T*>(sh.out) + r * sh.so;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = (v * 32 + lane) * V;
    if (c < d) {
      float sv[V], bv[V], o[V];
      if constexpr (EARLY) {
        unpack<T, V>(sraw[v], sv);
        unpack<T, V>(braw[v], bv);
      } else {
        load_vec<T, V>(scale + c, sv);
        load_vec<T, V>(bias + c, bv);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = y[v][e] * rstd * sv[e] + bv[e];
      store_vec<T, V>(out + c, o);
    }
  }
}

template <typename T, bool KEEP>
__global__ void __launch_bounds__(WARPS * 32) loop_kernel(const __grid_constant__ Group g,
                                                          int total) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= total) return;
  const int j = shard_of(g, row);
  const Shard& sh = g.sh[j];
  const long long r = row - g.row0[j];
  const int d = g.d;
  const T* x = static_cast<const T*>(sh.x) + r * sh.sx;
  const T* res = static_cast<const T*>(sh.res) + r * sh.sr;
  const T* keep = static_cast<const T*>(sh.keep) + r * sh.sk;
  auto y_at = [&](int c) {
    float xv = to_float(x[c]);
    if constexpr (KEEP) xv = xv * to_float(keep[c]) * g.keep_scale;
    return xv + to_float(res[c]);
  };
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += y_at(c);
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = y_at(c) - mean;
    sq += t * t;
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + g.eps);
  const T* scale = static_cast<const T*>(sh.scale);
  const T* bias = static_cast<const T*>(sh.bias);
  T* out = static_cast<T*>(sh.out) + r * sh.so;
  for (int c = lane; c < d; c += 32)
    out[c] = from_float<T>((y_at(c) - mean) * rstd * to_float(scale[c]) + to_float(bias[c]));
}

template <typename T, bool KEEP>
void launch_rows(int path, int d, const Group& g, int total, int blocks, cudaStream_t s) {
  if (path == 1)
    loop_kernel<T, KEEP><<<blocks, WARPS * 32, 0, s>>>(g, total);
  else if (d <= 32 * SMALL_ELEMS)
    warp_kernel<T, KEEP, SMALL_ELEMS><<<blocks, WARPS * 32, 0, s>>>(g, total);
  else
    warp_kernel<T, KEEP, MAX_ELEMS><<<blocks, WARPS * 32, 0, s>>>(g, total);
}

template <typename T>
int launch(int path, bool keep, const Group& g, int total, int blocks, cudaStream_t s) {
  if (keep)
    launch_rows<T, true>(path, g.d, g, total, blocks, s);
  else
    launch_rows<T, false>(path, g.d, g, total, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of every tensor).  path:
// 0 = warp (rows in registers), 1 = loop.  shards: n x 10 int64, each
// shard's x, res, keep, out, scale, bias pointers then the row strides (in
// elements) of x, res, keep and out; keep is read only when has_keep.
// row0: n + 1 row offsets, from 0 to total, of the shards' rows in the
// grid; blocks must be ceil(total / 4), one warp a row.  Returns
// cudaGetLastError() after launch, or cudaErrorInvalidValue (before any
// launch) for a group or a path this file does not take.
extern "C" int fused_connective(int dtype, int path, const long long* shards, const int* row0,
                                int n, int d, int has_keep, float keep_scale, float eps,
                                int total, int blocks, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || n > MAX_SHARDS || d < 1 || total < 1 || dtype < 0 || dtype > 2 ||
      (path != 0 && path != 1) || row0[0] != 0 || row0[n] != total ||
      blocks != (total + WARPS - 1) / WARPS)
    return bad;
  const int esize = dtype == 0 ? 4 : 2;
  if (path == 0 && (d % (16 / esize) || d > 32 * MAX_ELEMS)) return bad;
  Group g;
  g.n = n;
  g.d = d;
  g.keep_scale = keep_scale;
  g.eps = eps;
  for (int j = 0; j <= MAX_SHARDS; ++j) g.row0[j] = j <= n ? row0[j] : total;
  for (int j = 0; j < MAX_SHARDS; ++j) {
    Shard& sh = g.sh[j];
    if (j >= n) {
      sh = g.sh[0];
      continue;
    }
    if (row0[j + 1] < row0[j]) return bad;
    const long long* p = shards + 10 * j;
    sh.x = reinterpret_cast<const void*>(p[0]);
    sh.res = reinterpret_cast<const void*>(p[1]);
    sh.keep = reinterpret_cast<const void*>(p[2]);
    sh.out = reinterpret_cast<void*>(p[3]);
    sh.scale = reinterpret_cast<const void*>(p[4]);
    sh.bias = reinterpret_cast<const void*>(p[5]);
    sh.sx = p[6];
    sh.sr = p[7];
    sh.sk = p[8];
    sh.so = p[9];
    if (path == 0) {
      const bool ok = aligned16(sh.x) && aligned16(sh.res) && aligned16(sh.out) &&
                      aligned16(sh.scale) && aligned16(sh.bias) &&
                      (sh.sx * esize) % 16 == 0 && (sh.sr * esize) % 16 == 0 &&
                      (sh.so * esize) % 16 == 0 &&
                      (!has_keep || (aligned16(sh.keep) && (sh.sk * esize) % 16 == 0));
      if (!ok) return bad;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool keep = has_keep != 0;
  if (dtype == 0) return launch<float>(path, keep, g, total, blocks, s);
  if (dtype == 1) return launch<__nv_bfloat16>(path, keep, g, total, blocks, s);
  return launch<__half>(path, keep, g, total, blocks, s);
}
