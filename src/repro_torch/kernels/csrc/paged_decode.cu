// Ragged single-query GQA decode attention over a paged KV pool, returning
// combinable fp32 (acc, l, m) partials.
//
// Replaces: src/repro/kernels/paged_decode.py::paged_decode_partial (the
// Pallas `_kernel`, grid (B, Hkv, max_pages) with the page table in scalar
// prefetch).
//
// What bounds it on an H100: bytes.  Each decode step reads every live KV
// row of every slot once (2 * ps * dh * itemsize per page and kv head) and
// does 4 * G * dh flops per key row, about 8 flops per byte in bf16, far
// below the ~295 flops/byte where the tensor cores would become the limit.
//
// Design:
//   * one thread block per (slot, kv head); one warp per query head of the
//     GQA group (G warps), each lane owning DPL = ceil(dh/32) contiguous
//     output dims (lanes past dh, as at dh 240 with DPL 8, hold zeros and
//     read nothing), so the K/V page is fetched once per kv head and shared
//     by its G heads;
//   * the pool is read in place through its (P+1, ps, Hkv, dh) layout (the
//     Pallas wrapper transposed the whole pool on every call, a full copy
//     per layer per step on this card);
//   * the block walks only the logical pages that can hold a valid key
//     (positions <= cur[b], inside the window) and skips unallocated pages
//     (table entry -1) outright instead of clamping and masking them; the
//     scratch page (index P) is never read;
//   * a page is staged into shared memory as fp32, scores are warp-reduced
//     dot products, and the online softmax keeps (m, l, acc) in registers;
//   * a slot with no valid key comes out as m = -1e30, l = 0, acc = 0 (the
//     reference's convention; combine_partials guards l == 0).
// At 8 slots and 4 kv heads this launches only 32 blocks on 132 SMs;
// splitting the page axis (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int DPL>  // DPL: output dims per lane, dh <= 32 * DPL
__global__ void paged_decode_kernel(
    const T* __restrict__ q,        // (B, H, dh)
    const T* __restrict__ kpool,    // (P+1, ps, Hkv, dh)
    const T* __restrict__ vpool,
    const int32_t* __restrict__ pages,  // (B, maxp)
    const int32_t* __restrict__ cur,    // (B,)
    float* __restrict__ acc_out,    // (B, H, dh)
    float* __restrict__ l_out,      // (B, H)
    float* __restrict__ m_out,      // (B, H)
    int H, int Hkv, int dh, int ps, int maxp, int window, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;               // (ps, dh)
  float* vs = smem + ps * dh;     // (ps, dh)

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = hk * G + warp;    // query head of this warp
  const int d0 = lane * DPL;

  float qr[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    qr[i] = d0 + i < dh ? to_f(q[((size_t)b * H + h) * dh + d0 + i]) : 0.f;

  float m = kNegInf, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  const int c = cur[b];
  // logical pages that can hold a valid key: pos <= c and, with a window,
  // pos > c - window
  int lp_lo = 0;
  if (window > 0) {
    const int lo = c - window + 1;
    lp_lo = lo > 0 ? lo / ps : 0;
  }
  int lp_hi = c >= 0 ? c / ps : -1;
  if (lp_hi > maxp - 1) lp_hi = maxp - 1;

  const size_t row_stride = (size_t)Hkv * dh;
  const int n_el = ps * dh;
  for (int lp = lp_lo; lp <= lp_hi; ++lp) {
    const int page = pages[(size_t)b * maxp + lp];
    if (page < 0) continue;       // unallocated: every key invalid
    const size_t base = (size_t)page * ps * row_stride + (size_t)hk * dh;
    __syncthreads();              // previous page fully consumed
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      const int r = e / dh, d = e - r * dh;
      ks[e] = to_f(kpool[base + r * row_stride + d]);
      vs[e] = to_f(vpool[base + r * row_stride + d]);
    }
    __syncthreads();

    // scores of this page's keys for this warp's head (all lanes hold them)
    float pmax = kNegInf;
    for (int j = 0; j < ps; ++j) {
      const int pos = lp * ps + j;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (d0 + i < dh) part += qr[i] * ks[j * dh + d0 + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const bool ok = pos <= c && (window <= 0 || pos > c - window);
      if (ok) pmax = fmaxf(pmax, part * scale);
    }
    const float m_new = fmaxf(m, pmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    for (int j = 0; j < ps; ++j) {
      const int pos = lp * ps + j;
      const bool ok = pos <= c && (window <= 0 || pos > c - window);
      if (!ok) continue;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (d0 + i < dh) part += qr[i] * ks[j * dh + d0 + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float p = expf(part * scale - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (d0 + i < dh) acc[i] += p * vs[j * dh + d0 + i];
    }
    m = m_new;
  }

  const size_t o = ((size_t)b * H + h) * dh + d0;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (d0 + i < dh) acc_out[o + i] = acc[i];
  if (lane == 0) {
    l_out[(size_t)b * H + h] = l;
    m_out[(size_t)b * H + h] = m;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pages, const void* cur, void* acc, void* l,
                   void* m, int B, int H, int Hkv, int dh, int ps, int maxp,
                   int window, float scale, cudaStream_t stream) {
  const dim3 grid(B, Hkv);
  const dim3 block(32 * (H / Hkv));
  const size_t smem = 2 * (size_t)ps * dh * sizeof(float);
#define REPRO_PD_LAUNCH(DPL)                                                  \
  paged_decode_kernel<T, DPL><<<grid, block, smem, stream>>>(                 \
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pages,         \
      (const int32_t*)cur, (float*)acc, (float*)l, (float*)m, H, Hkv, dh, ps, \
      maxp, window, scale)
  switch (dh) {
    case 32: REPRO_PD_LAUNCH(1); break;
    case 64: REPRO_PD_LAUNCH(2); break;
    case 128: REPRO_PD_LAUNCH(4); break;
    case 240: REPRO_PD_LAUNCH(8); break;
    case 256: REPRO_PD_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_paged_decode(const void* q, const void* kpool,
                                  const void* vpool, const void* pages,
                                  const void* cur, void* acc, void* l,
                                  void* m, int B, int H, int Hkv, int dh,
                                  int ps, int maxp, int window, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, kpool, vpool, pages, cur, acc, l, m, B, H,
                              Hkv, dh, ps, maxp, window, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, kpool, vpool, pages, cur, acc, l, m,
                                      B, H, Hkv, dh, ps, maxp, window, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}
