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
// What bounds it on an H100: bytes.  The function reads each in-range row
// once and writes every output row: n_in * D * b + n * D * b + 4n bytes
// (+ 4n for weights), with no arithmetic worth counting.
//
// Design:
//   * no panel: a (V_loc, 512) slice of the table does not fit in shared
//     memory and is not needed — a gather reads each wanted row once from
//     device memory;
//   * one warp per index; the block loads its ids and the shard offset
//     itself (plain kernel arguments, no scalar prefetch);
//   * in-range rows are copied with 16-byte vector loads and stores (8 bf16
//     or 4 fp32 per lane per step) when the source and destination rows are
//     16-byte aligned, with a scalar tail for the rest of the row; rows that
//     are not aligned (a D the vector width does not divide) go scalar;
//   * an out-of-range id stores zeros without loading anything;
//   * row offsets are 64-bit: gemma3-12b's 262,144 x 3,840 bf16 table is
//     2.01 GB, past 2^31 bytes.
// It launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;  // warps (= ids) per block

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

// scale the elements packed in one 16-byte vector, rounding each once
__device__ __forceinline__ uint4 scale_vec(uint4 v, float w, float*) {
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x *= w;
  f.y *= w;
  f.z *= w;
  f.w *= w;
  return *reinterpret_cast<uint4*>(&f);
}
__device__ __forceinline__ uint4 scale_vec(uint4 v, float w, __nv_bfloat16*) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    h[j] = __floats2bfloat162_rn(f.x * w, f.y * w);
  }
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool WEIGHTED>
__global__ void __launch_bounds__(NW * 32) isp_gather_kernel(
    const T* __restrict__ table,      // (V_loc, D)
    const int32_t* __restrict__ ids,  // (n,) global ids
    const float* __restrict__ w,      // (n,) or null
    T* __restrict__ out,              // (n, D)
    long long n, long long v_loc, int d, long long off) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (i >= n) return;
  const long long row = (long long)ids[i] - off;
  T* dst = out + i * (long long)d;
  if (row < 0 || row >= v_loc) {
    const int nv = aligned16(dst) ? d / VEC : 0;
    uint4* dv = reinterpret_cast<uint4*>(dst);
    for (int j = lane; j < nv; j += 32) dv[j] = make_uint4(0, 0, 0, 0);
    for (int e = nv * VEC + lane; e < d; e += 32) dst[e] = from_f<T>(0.f);
    return;
  }
  const T* src = table + row * (long long)d;
  const float scale = WEIGHTED ? w[i] : 1.f;
  const int nv = (aligned16(src) && aligned16(dst)) ? d / VEC : 0;
  const uint4* sv = reinterpret_cast<const uint4*>(src);
  uint4* dv = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
  for (int j = lane; j < nv; j += 32) {
    uint4 v = __ldg(sv + j);
    if (WEIGHTED) v = scale_vec(v, scale, (T*)nullptr);
    dv[j] = v;
  }
  for (int e = nv * VEC + lane; e < d; e += 32) {
    const T x = src[e];
    dst[e] = WEIGHTED ? from_f<T>(to_f(x) * scale) : x;
  }
}

template <typename T>
cudaError_t launch(const void* table, const void* ids, const void* w,
                   void* out, long long n, long long v_loc, int d,
                   long long off, cudaStream_t s) {
  const dim3 grid((unsigned)((n + NW - 1) / NW));
  const dim3 block(NW * 32);
  if (w != nullptr)
    isp_gather_kernel<T, true><<<grid, block, 0, s>>>(
        (const T*)table, (const int32_t*)ids, (const float*)w, (T*)out, n,
        v_loc, d, off);
  else
    isp_gather_kernel<T, false><<<grid, block, 0, s>>>(
        (const T*)table, (const int32_t*)ids, nullptr, (T*)out, n, v_loc, d,
        off);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  weights may be null.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int repro_isp_gather(const void* table, const void* ids,
                                const void* weights, void* out, long long n,
                                long long v_loc, int d, long long off,
                                int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0 || (n + NW - 1) / NW > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(table, ids, weights, out, n, v_loc, d, off, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(table, ids, weights, out, n, v_loc, d,
                                      off, s);
  return (int)cudaErrorInvalidValue;
}
