// Masked shard-local row gather of a vocabulary table: the ISP embedding
// lookup, where indexes travel to the table shard and only rows come back.
//
// Replaces: src/repro/kernels/isp_gather.py::isp_gather (the Pallas
// `_gather_kernel`, grid (index blocks, D blocks), a (V_loc, 512) panel of
// the table pinned in VMEM and a loop over 256 ids per block).
//
// For n global ids it writes out[i] = table[id_i - off] when
// off <= id_i < off + V_loc, and zeros otherwise (ids of other shards and
// the -1 pads); with weights the row is multiplied by w_i in fp32 and
// rounded once to the table's dtype, as the Pallas kernel does.
//
// What bounds it on an H100: bytes at a prefill (8192 rows of 7,680 bytes
// read and written), the latency of one round trip to device memory at a
// decode step (8 rows, 61 KB).  The function reads each in-range row once
// and writes every output row: n_in * D * b + n * D * b + 4n bytes (+ 4n
// for weights), with no arithmetic worth counting.
//
// Design:
//   * no panel: a (V_loc, 512) slice of the table does not fit in shared
//     memory and is not needed — a gather reads each wanted row once from
//     device memory;
//   * a row is cut into units — 16-byte vectors (8 bf16 or 4 fp32) where
//     the table, the output and D allow it, single elements otherwise (the
//     scalar path, e.g. D = 3841) — and a work item is one (row, tile of
//     THREADS * U units); thread t of a tile takes units t, t + THREADS,
//     ..., so neighbouring threads touch neighbouring addresses;
//   * a thread issues all U loads of its item before any store and holds
//     them in registers, so a call's loads go out together in one round
//     trip: at a decode step U = 1 spreads 8 rows over 32 blocks on as many
//     SMs (the first design ran them on one block, four round trips one
//     after another); at a prefill U = 4 keeps 64 bytes a thread in flight;
//   * blocks walk the items grid-stride, at most GATHER_BLOCKS_PER_SM
//     blocks on each SM (the plan is `isp_gather.gather_plan`: shapes and
//     the SM count only);
//   * an out-of-range id stores zeros without loading anything;
//   * row offsets are 64-bit: gemma3-12b's 262,144 x 3,840 bf16 table is
//     2.01 GB, past 2^31 bytes.
// It launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // threads per block (GATHER_THREADS)
constexpr int MIN_BLOCKS = 8;  // resident blocks an SM (GATHER_BLOCKS_PER_SM)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one unit: a 16-byte vector of T, or one T (the scalar path)
template <typename T, bool VEC>
struct Unit {
  using type = T;
  static __device__ __forceinline__ T load(const T* p) { return *p; }
  static __device__ __forceinline__ T zero() { return from_f<T>(0.f); }
  static __device__ __forceinline__ T scale(T x, float w) {
    return from_f<T>(to_f(x) * w);
  }
};
template <typename T>
struct Unit<T, true> {
  using type = uint4;
  static __device__ __forceinline__ uint4 load(const uint4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ uint4 zero() {
    return make_uint4(0, 0, 0, 0);
  }
  // scale the elements packed in one vector, rounding each once
  static __device__ __forceinline__ uint4 scale(uint4 v, float w) {
    if constexpr (sizeof(T) == 4) {
      float4 f = *reinterpret_cast<float4*>(&v);
      f.x *= w;
      f.y *= w;
      f.z *= w;
      f.w *= w;
      return *reinterpret_cast<uint4*>(&f);
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * w, f.y * w);
      }
      return v;
    }
  }
};

template <typename T, bool VEC, int U, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) isp_gather_kernel(
    const T* __restrict__ table,      // (V_loc, D)
    const int32_t* __restrict__ ids,  // (n,) global ids
    const float* __restrict__ w,      // (n,) or null
    T* __restrict__ out,              // (n, D)
    long long n, long long v_loc, int d, long long off, int tiles) {
  using Un = Unit<T, VEC>;
  using V = typename Un::type;
  constexpr int PER = sizeof(V) / sizeof(T);  // elements a unit
  const int units = d / PER;
  const long long items = n * tiles;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long i = it / tiles;
    const int base = (int)(it % tiles) * (THREADS * U) + threadIdx.x;
    const long long row = (long long)__ldg(ids + i) - off;
    V* dst = reinterpret_cast<V*>(out + i * (long long)d);
    if (row < 0 || row >= v_loc) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int j = base + k * THREADS;
        if (j < units) dst[j] = Un::zero();
      }
      continue;
    }
    const V* src = reinterpret_cast<const V*>(table + row * (long long)d);
    const float scale = WEIGHTED ? __ldg(w + i) : 1.f;
    V v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int j = base + k * THREADS;
      if (j < units) v[k] = Un::load(src + j);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int j = base + k * THREADS;
      if (j < units) dst[j] = WEIGHTED ? Un::scale(v[k], scale) : v[k];
    }
  }
}

template <typename T, bool VEC, int U>
void launch_u(const void* table, const void* ids, const void* w, void* out,
              long long n, long long v_loc, int d, long long off, int tiles,
              int grid, cudaStream_t s) {
  if (w != nullptr)
    isp_gather_kernel<T, VEC, U, true><<<grid, THREADS, 0, s>>>(
        (const T*)table, (const int32_t*)ids, (const float*)w, (T*)out, n,
        v_loc, d, off, tiles);
  else
    isp_gather_kernel<T, VEC, U, false><<<grid, THREADS, 0, s>>>(
        (const T*)table, (const int32_t*)ids, nullptr, (T*)out, n, v_loc, d,
        off, tiles);
}

template <typename T>
cudaError_t launch(const void* table, const void* ids, const void* w,
                   void* out, long long n, long long v_loc, int d,
                   long long off, int vec, int u, int tiles, int grid,
                   cudaStream_t s) {
  const int per = vec ? 16 / (int)sizeof(T) : 1;
  if (vec && (d % per || (uintptr_t)table % 16 || (uintptr_t)out % 16))
    return cudaErrorInvalidValue;
  // the tiles must reach the end of a row
  if ((long long)tiles * THREADS * u < d / per) return cudaErrorInvalidValue;
#define GATHER_CASE(V, UU)                                                 \
  if (vec == V && u == UU) {                                               \
    launch_u<T, V, UU>(table, ids, w, out, n, v_loc, d, off, tiles, grid, \
                       s);                                                 \
    return cudaGetLastError();                                             \
  }
  GATHER_CASE(1, 1) GATHER_CASE(1, 2) GATHER_CASE(1, 4)
  GATHER_CASE(0, 1) GATHER_CASE(0, 2) GATHER_CASE(0, 4)
#undef GATHER_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  weights may be null.  vec: 16-byte
// units (1) or elements (0); u: units a thread per item (1, 2 or 4);
// tiles: items a row; grid: blocks.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int repro_isp_gather(const void* table, const void* ids,
                                const void* weights, void* out, long long n,
                                long long v_loc, int d, long long off,
                                int vec, int u, int tiles, int grid,
                                int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0 || tiles <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(table, ids, weights, out, n, v_loc, d, off,
                              vec, u, tiles, grid, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(table, ids, weights, out, n, v_loc, d,
                                      off, vec, u, tiles, grid, s);
  return (int)cudaErrorInvalidValue;
}
