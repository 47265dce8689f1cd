// Forward blocked attention with an online softmax (causal, optional sliding
// window, q_offset, GQA), output in the input dtype.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas `_kernel`, grid (B, Hkv, G, nq, nk) with VMEM scratch carried
// across the kv axis).
//
// What bounds it on an H100: operations.  At the prefill shapes (S = 704,
// dh = 128) a causal call does ~S/2 * 4 * dh flops per query row against
// 4 * dh bytes of q/out per row, thousands of flops per byte.  This first
// version runs on the fp32 CUDA cores (67 TFLOP/s peak), not the tensor
// cores (989 TFLOP/s bf16), so it sits far from the operations bound; a
// wgmma/TMA version is later work.
//
// Design:
//   * one thread block per (64-row q tile, q head, batch row); four threads
//     per query row, each owning a quarter of the head dims (interleaved in
//     float4 groups so the four read neighbouring shared-memory words);
//     the row's score is a 4-lane shuffle reduction;
//   * K/V tiles of 32 keys are staged in shared memory as fp32 and shared
//     by the block's 64 rows; the kv loop visits only tiles that the causal
//     and window masks can reach, so the work follows the triangle;
//   * GQA maps q head h to kv head h / G (the (Hkv, G) reshape of the TPU
//     wrapper), so no KV head is repeated in memory;
//   * masking uses -1e30 and masked keys contribute p = 0; the TPU kernel
//     leaves p unmasked, which agrees whenever a row sees at least one key,
//     as every causal prefill row sees key 0.  The l == 0 -> 1 guard stays.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int TPR = 4;   // threads per query row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(BQ * TPR)
flash_fwd_kernel(const T* __restrict__ q,   // (B, Sq, H, DH)
                 const T* __restrict__ k,   // (B, Skv, Hkv, DH)
                 const T* __restrict__ v,
                 T* __restrict__ out,       // (B, Sq, H, DH)
                 int Sq, int Skv, int H, int Hkv, int causal, int window,
                 int q_offset, float scale) {
  constexpr int NG = DH / 16;      // float4 groups per thread
  __shared__ __align__(16) float ks[BK * DH];
  __shared__ __align__(16) float vs[BK * DH];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qi = qt * BQ + row;              // query row inside the call
  const int qpos = q_offset + qi;
  const bool live = qi < Sq;

  // thread's dims: 16 * g + 4 * part + {0..3}, g in [0, NG)
  float qr[NG * 4], acc[NG * 4];
  const size_t qbase = (((size_t)b * Sq + (live ? qi : 0)) * H + h) * DH;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[g * 4 + e] = live ? to_f(q[qbase + 16 * g + 4 * part + e]) : 0.f;
      acc[g * 4 + e] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  // keys any row of this tile may see
  const int q_lo = q_offset + qt * BQ;
  const int q_hi = q_offset + min(qt * BQ + BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal && q_hi + 1 < kv_end) kv_end = q_hi + 1;
  int kv_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kv_begin = q_lo - window + 1;
  kv_begin = (kv_begin / BK) * BK;

  const size_t kv_row = (size_t)Hkv * DH;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * DH; e += blockDim.x) {
      const int j = e / DH, d = e - j * DH;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Skv) {
        const size_t off = ((size_t)b * Skv + kp) * kv_row + (size_t)hk * DH + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();

    float s[BK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DH);
      float dot = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kk = kr[4 * g + part];
        dot += qr[g * 4 + 0] * kk.x + qr[g * 4 + 1] * kk.y +
               qr[g * 4 + 2] * kk.z + qr[g * 4 + 3] * kk.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      bool ok = kp < Skv;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[j] = ok ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NG * 4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j] == kNegInf ? 0.f : expf(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * DH);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = vr[4 * g + part];
        acc[g * 4 + 0] += p * vv.x;
        acc[g * 4 + 1] += p * vv.y;
        acc[g * 4 + 2] += p * vv.z;
        acc[g * 4 + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  const size_t obase = (((size_t)b * Sq + qi) * H + h) * DH;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      from_f(out + obase + 16 * g + 4 * part + e, acc[g * 4 + e] * inv);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int Hkv, int dh, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const dim3 block(BQ * TPR);
#define REPRO_FA_LAUNCH(DH)                                                   \
  flash_fwd_kernel<T, DH><<<grid, block, 0, stream>>>(                        \
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, Hkv,        \
      causal, window, q_offset, scale)
  switch (dh) {
    case 64: REPRO_FA_LAUNCH(64); break;
    case 128: REPRO_FA_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int H, int Hkv, int dh,
                                     int causal, int window, int q_offset,
                                     float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal,
                              window, q_offset, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Hkv, dh,
                                      causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
