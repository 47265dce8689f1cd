// Ragged single-query GQA decode attention over a paged KV pool, returning
// combinable fp32 (acc, l, m) partials: split-K flash-decoding.
//
// Replaces: src/repro/kernels/paged_decode.py::paged_decode_partial (the
// Pallas `_kernel`, grid (B, Hkv, max_pages) with the page table in scalar
// prefetch).
//
// What bounds it on an H100: bytes.  Each decode step reads every live KV
// row of every slot once (2 * ps * dh * itemsize per page and kv head) and
// does 4 * G * dh flops per key row, about 8 flops per byte in bf16, far
// below the ~295 flops/byte where the tensor cores would become the limit.
// At 8 slots the bytes are a few MB, so the kernel is a latency problem:
// enough blocks must be in flight, each with its next page already loading.
//
// Design (two passes, one C entry, both on the caller's stream):
//   * pass 1, grid (B, Hkv * head chunks, n_split): the key axis is split
//     into n_split spans of `span` logical pages (the wrapper picks span
//     from the shapes alone, so no device value is read on the host).  A
//     block serves up to 8 query heads of one kv head (2 when the group
//     has at most 2) over its span; a span past the slot's last valid key
//     (or before its window) writes the empty partial at once;
//   * a page is staged in the input dtype (bf16 stays bf16) by 16-byte
//     cp.async copies, double buffered, so the next page lands while the
//     current one is used; unallocated pages (-1) are never loaded and the
//     scratch page P is never read;
//   * the block's warps are spread over the keys, not the heads: a key
//     group of LPK lanes owns one key at a time, each lane 8 of its dims,
//     so a key's score is computed once for all the block's heads (a dot
//     over the lane's 8 dims, then a shuffle reduction inside the group);
//     each (warp, key group) keeps its own online softmax (m, l, acc) in
//     fp32 registers, batched per page (one rescale per page);
//   * at the end of the span the (warp, key group) partials are merged in
//     shared memory and the split's (acc, l, m) is written to the fp32
//     scratch (B, H, n_split, dh);
//   * pass 2, grid (B * H): m = max m_i, l = sum l_i e^(m_i - m),
//     acc = sum acc_i e^(m_i - m) (ref.merge_partials, no division).
// A slot with no valid key comes out as m = -1e30, l = 0, acc = 0: masked
// scores are -1e30 and get p = 0, and every merge weight of an all-empty
// set is e^0 = 1 times zeros, so no NaN enters the merge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NW = 4;             // warps per block of pass 1
constexpr int NT = NW * 32;

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// LPK: lanes per key (dh / 8 rounded up to a power of two); GC: query heads
// per block (2 or 8; a block with fewer heads leaves the rest idle).
template <typename T, int LPK, int GC>
__global__ void __launch_bounds__(NT) paged_split_kernel(
    const T* __restrict__ q,        // (B, H, dh)
    const T* __restrict__ kpool,    // (P+1, ps, Hkv, dh)
    const T* __restrict__ vpool,
    const int32_t* __restrict__ pages,  // (B, maxp)
    const int32_t* __restrict__ cur,    // (B,)
    float* __restrict__ pacc,       // (B, H, n_split, dh)
    float* __restrict__ pl,         // (B, H, n_split)
    float* __restrict__ pm,
    int H, int Hkv, int dh, int ps, int maxp, int window, int span,
    int n_split, float scale) {
  constexpr int KPI = 32 / LPK;             // keys a warp holds at once
  constexpr int ROUND = NW * KPI;           // keys the block holds at once
  constexpr int MAXK = GC >= 8 ? 2 : 4;     // rounds of keys per batch
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x;
  const int G = H / Hkv;
  const int nhg = (G + GC - 1) / GC;
  const int hk = blockIdx.y / nhg;
  const int h0 = hk * G + (blockIdx.y % nhg) * GC;  // first head of block
  const int ng = min(GC, hk * G + G - h0);          // heads of this block
  const int split = blockIdx.z;
  const size_t out_row = (size_t)b * H + h0;        // (b, h0) row

  // logical pages of this split that can hold a valid key: pos <= c and,
  // with a window, pos > c - window
  const int c = cur[b];
  int lp_lo = split * span;
  int lp_hi = min(split * span + span, maxp) - 1;
  if (window > 0) {
    const int lo = c - window + 1;
    if (lo > 0) lp_lo = max(lp_lo, lo / ps);
  }
  lp_hi = min(lp_hi, c >= 0 ? c / ps : -1);
  if (lp_lo > lp_hi) {            // nothing to see: the empty partial
    for (int i = threadIdx.x; i < ng * dh; i += NT) {
      const int g = i / dh;
      pacc[((out_row + g) * n_split + split) * dh + i - g * dh] = 0.f;
    }
    if (threadIdx.x < ng) {
      pl[(out_row + threadIdx.x) * n_split + split] = 0.f;
      pm[(out_row + threadIdx.x) * n_split + split] = kNegInf;
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPK;     // key group inside the warp
  const int d0 = (lane % LPK) * 8;
  const bool has_d = d0 < dh;     // lanes past dh (dh 240: 30, 31) idle

  float qr[GC][8], acc[GC][8], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng && has_d) {
      load8(q + (out_row + g) * dh + d0, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  T* stage = reinterpret_cast<T*>(smem);    // [2 stages][K, V][ps * dh]
  const size_t row_stride = (size_t)Hkv * dh;
  const int cpr = dh / EPC;                 // 16-byte copies per row
  const int n_cp = ps * cpr;
  const int32_t* table = pages + (size_t)b * maxp;
  auto load_page = [&](int lp, int st) {
    const int page = table[lp];
    if (page < 0) return;         // unallocated: every key invalid
    const size_t base = (size_t)page * ps * row_stride + (size_t)hk * dh;
    T* ks = stage + (size_t)st * 2 * ps * dh;
    T* vs = ks + ps * dh;
    for (int i = threadIdx.x; i < n_cp; i += NT) {
      const int r = i / cpr, e = (i - r * cpr) * EPC;
      cp_async16(ks + r * dh + e, kpool + base + r * row_stride + e);
      cp_async16(vs + r * dh + e, vpool + base + r * row_stride + e);
    }
  };

  load_page(lp_lo, 0);
  cp_async_commit();
  for (int lp = lp_lo, it = 0; lp <= lp_hi; ++lp, ++it) {
    if (lp < lp_hi) load_page(lp + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (table[lp] >= 0) {
      const T* ks = stage + (size_t)(it & 1) * 2 * ps * dh;
      const T* vs = ks + ps * dh;
      for (int j0 = 0; j0 < ps; j0 += ROUND * MAXK) {
        // scores of up to MAXK keys of this key group, for all heads
        float s[GC][MAXK], bmax[GC];
#pragma unroll
        for (int g = 0; g < GC; ++g) bmax[g] = kNegInf;
#pragma unroll
        for (int t = 0; t < MAXK; ++t) {
#pragma unroll
          for (int g = 0; g < GC; ++g) s[g][t] = kNegInf;
          if (j0 + t * ROUND >= ps) continue;       // block-uniform
          const int j = j0 + t * ROUND + warp * KPI + grp;
          const int pos = lp * ps + j;
          const bool ok = j < ps && pos <= c && (window <= 0 ||
                                                 pos > c - window);
          float kf[8];
          if (j < ps && has_d) {
            load8(ks + j * dh + d0, kf);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) part += qr[g][e] * kf[e];
#pragma unroll
            for (int off = LPK / 2; off > 0; off >>= 1)
              part += __shfl_xor_sync(0xffffffffu, part, off);
            if (ok) {
              s[g][t] = part * scale;
              bmax[g] = fmaxf(bmax[g], s[g][t]);
            }
          }
        }
        // one rescale per batch, then p and p.V
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float m_new = fmaxf(m[g], bmax[g]);
          const float alpha = __expf(m[g] - m_new);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
          m[g] = m_new;
        }
#pragma unroll
        for (int t = 0; t < MAXK; ++t) {
          if (j0 + t * ROUND >= ps) continue;
          const int j = j0 + t * ROUND + warp * KPI + grp;
          if (j >= ps || !has_d) continue;
          float vf[8];
          load8(vs + j * dh + d0, vf);
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float p = s[g][t] == kNegInf ? 0.f
                                               : __expf(s[g][t] - m[g]);
            l[g] += p;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] += p * vf[e];
          }
        }
      }
    }
    __syncthreads();              // stage fully consumed before reuse
  }

  // merge the NW * KPI (warp, key group) partials of this split; the
  // stage buffers are free now (the loop ended on a barrier)
  constexpr int NSLOT = NW * KPI;
  float* red_acc = reinterpret_cast<float*>(smem);  // [NSLOT][GC][dh]
  float* red_m = red_acc + NSLOT * GC * dh;         // [NSLOT][GC]
  float* red_l = red_m + NSLOT * GC;
  const int slot = warp * KPI + grp;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (has_d) {
      float* dst = red_acc + (slot * GC + g) * dh + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = acc[g][e];
    }
    if (d0 == 0) {
      red_m[slot * GC + g] = m[g];
      red_l[slot * GC + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * dh; i += NT) {
    const int g = i / dh, d = i - g * dh;
    float mx = kNegInf;
    for (int s = 0; s < NSLOT; ++s) mx = fmaxf(mx, red_m[s * GC + g]);
    float a = 0.f;
    for (int s = 0; s < NSLOT; ++s)
      a += red_acc[(s * GC + g) * dh + d] * __expf(red_m[s * GC + g] - mx);
    pacc[((out_row + g) * n_split + split) * dh + d] = a;
    if (d == 0) {
      float ls = 0.f;
      for (int s = 0; s < NSLOT; ++s)
        ls += red_l[s * GC + g] * __expf(red_m[s * GC + g] - mx);
      pl[(out_row + g) * n_split + split] = ls;
      pm[(out_row + g) * n_split + split] = mx;
    }
  }
}

// pass 2: one block per (b, h) merges its n_split partials
__global__ void __launch_bounds__(128) merge_splits_kernel(
    const float* __restrict__ pacc, const float* __restrict__ pl,
    const float* __restrict__ pm, float* __restrict__ acc,
    float* __restrict__ l, float* __restrict__ m, int n_split, int dh) {
  extern __shared__ float w[];    // [n_split] merge weights
  const size_t bh = blockIdx.x;
  const float* ms = pm + bh * n_split;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ms[s]);
  for (int s = threadIdx.x; s < n_split; s += blockDim.x)
    w[s] = __expf(ms[s] - mx);
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += pacc[(bh * n_split + s) * dh + d] * w[s];
    acc[bh * dh + d] = a;
  }
  if (threadIdx.x == 0) {
    float ls = 0.f;
    for (int s = 0; s < n_split; ++s) ls += pl[bh * n_split + s] * w[s];
    l[bh] = ls;
    m[bh] = mx;
  }
}

template <typename T, int LPK, int GC>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const void* pages, const void* cur, float* pacc,
                         float* pl, float* pm, int B, int H, int Hkv, int dh,
                         int ps, int maxp, int window, int span, int n_split,
                         float scale, cudaStream_t stream) {
  constexpr int NSLOT = NW * (32 / LPK);
  const size_t stage = 4 * (size_t)ps * dh * sizeof(T);
  const size_t red = (size_t)NSLOT * GC * (dh + 2) * sizeof(float);
  const size_t smem = stage > red ? stage : red;
  auto kern = paged_split_kernel<T, LPK, GC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int G = H / Hkv;
  const dim3 grid(B, Hkv * ((G + GC - 1) / GC), n_split);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pages,
      (const int32_t*)cur, pacc, pl, pm, H, Hkv, dh, ps, maxp, window, span,
      n_split, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pages, const void* cur, float* pacc, float* pl,
                   float* pm, int B, int H, int Hkv, int dh, int ps, int maxp,
                   int window, int span, int n_split, float scale,
                   cudaStream_t stream) {
  const bool wide = H / Hkv > 2;  // 8 query heads a block, else 2
#define REPRO_PD_ARGS                                                        \
  q, kp, vp, pages, cur, pacc, pl, pm, B, H, Hkv, dh, ps, maxp, window,      \
      span, n_split, scale, stream
#define REPRO_PD_LPK(LPK)                                                    \
  return wide ? launch_split<T, LPK, 8>(REPRO_PD_ARGS)                       \
              : launch_split<T, LPK, 2>(REPRO_PD_ARGS)
  switch (dh) {
    case 32: REPRO_PD_LPK(4);
    case 64: REPRO_PD_LPK(8);
    case 128: REPRO_PD_LPK(16);
    case 240: REPRO_PD_LPK(32);
    case 256: REPRO_PD_LPK(32);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PD_LPK
#undef REPRO_PD_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  The key
// axis is cut into n_split spans of `span` logical pages; the split
// partials go to the fp32 scratch pacc (B, H, n_split, dh), pl and pm
// (B, H, n_split) and a second pass merges them into acc, l, m.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int repro_paged_decode(const void* q, const void* kpool,
                                  const void* vpool, const void* pages,
                                  const void* cur, void* acc, void* l,
                                  void* m, void* pacc, void* pl, void* pm,
                                  int B, int H, int Hkv, int dh, int ps,
                                  int maxp, int window, int span, int n_split,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || span < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  float *pa = (float*)pacc, *ls = (float*)pl, *ms = (float*)pm;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, kpool, vpool, pages, cur, pa, ls, ms, B, H, Hkv, dh,
                      ps, maxp, window, span, n_split, scale, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, kpool, vpool, pages, cur, pa, ls, ms, B, H,
                              Hkv, dh, ps, maxp, window, span, n_split, scale,
                              s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  merge_splits_kernel<<<B * H, 128, n_split * sizeof(float), s>>>(
      (const float*)pacc, (const float*)pl, (const float*)pm, (float*)acc,
      (float*)l, (float*)m, n_split, dh);
  return (int)cudaGetLastError();
}
