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
//   * a page is staged in the input dtype (bf16 and fp16 stay 16-bit) by
//     16-byte cp.async copies, double buffered, so the next page lands
//     while the current one is used; unallocated pages (-1) are never
//     loaded and the scratch page P is never read;
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
//
// Head dims: 16, 32, 64, 128, 240 and 256 stage a page's rows at dh
// elements (instantiations of their own).  Every other dh from 1 to 256
// (PAD = true) takes isp_decode.cu's lane ladder: LPK = dh / 8 rounded up
// to a power of two, at least 4, rows staged at DP = 8 * LPK elements
// whose dims dh..DP are zeroed once and never loaded, lanes past dh idle
// (has_d); rows are copied by 16-byte cp.async where dh is a multiple of
// the copy (then every row of the pool is aligned) and by element loads
// otherwise.  Any group H / Hkv runs: a block takes GC query heads of one
// kv head and the grid's y axis as many head chunks as the group needs.
//
// The loaders, the per-batch online softmax, the merge of the (warp, key
// group) partials and pass 2 are split_decode.cuh's, shared with
// isp_decode.cu; this file keeps what is paged: the page walk and its
// position mask.
#include "split_decode.cuh"

namespace {

using namespace split_decode;

// LPK: lanes per key (dh / 8 rounded up to a power of two: 2 at dh 16, so a
// warp holds 16 keys at once, a page of 16 keys per warp round); GC: query
// heads per block (2 or 8; a block with fewer heads leaves the rest idle);
// PAD: rows staged at 8 * LPK elements, dh any of 1..8 * LPK.
template <typename T, int LPK, int GC, bool PAD = false>
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
    write_empty(pacc, pl, pm, out_row, ng, dh, split, n_split);
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
    if constexpr (PAD) {          // q rows need not be 16-byte aligned
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = d0 + e;
        qr[g][e] = g < ng && d < dh ? to_f(q[(out_row + g) * dh + d]) : 0.f;
      }
    } else if (g < ng && has_d) {
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

  // staged row width: dh, or the lane class's 8 * LPK with zero pad dims
  const int rs = PAD ? 8 * LPK : dh;
  T* stage = reinterpret_cast<T*>(smem);    // [2 stages][K, V][ps * rs]
  if constexpr (PAD) {            // dims dh..rs stay zero (never loaded)
    for (int i = threadIdx.x; i < 4 * ps * (rs - dh); i += NT) {
      const int r = i / (rs - dh);
      set_zero(stage[r * rs + dh + i - r * (rs - dh)]);
    }
  }
  const size_t row_stride = (size_t)Hkv * dh;
  const bool vec = !PAD || dh % EPC == 0;   // every pool row 16-byte aligned
  const int cpr = dh / EPC;                 // 16-byte copies per row
  const int n_cp = ps * cpr;
  const int32_t* table = pages + (size_t)b * maxp;
  auto load_page = [&](int lp, int st) {
    const int page = table[lp];
    if (page < 0) return;         // unallocated: every key invalid
    const size_t base = (size_t)page * ps * row_stride + (size_t)hk * dh;
    T* ks = stage + (size_t)st * 2 * ps * rs;
    T* vs = ks + ps * rs;
    if (vec) {
      for (int i = threadIdx.x; i < n_cp; i += NT) {
        const int r = i / cpr, e = (i - r * cpr) * EPC;
        cp_async16(ks + r * rs + e, kpool + base + r * row_stride + e);
        cp_async16(vs + r * rs + e, vpool + base + r * row_stride + e);
      }
    } else {
      for (int i = threadIdx.x; i < ps * dh; i += NT) {
        const int r = i / dh, e = i - r * dh;
        ks[r * rs + e] = kpool[base + r * row_stride + e];
        vs[r * rs + e] = vpool[base + r * row_stride + e];
      }
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
      const T* ks = stage + (size_t)(it & 1) * 2 * ps * rs;
      const T* vs = ks + ps * rs;
      attend_stage<T, LPK, GC>(
          ks, vs, rs, ps, warp, grp, d0, has_d, qr, acc, m, l, scale,
          [&](int j) {
            const int pos = lp * ps + j;
            return pos <= c && (window <= 0 || pos > c - window);
          });
    }
    __syncthreads();              // stage fully consumed before reuse
  }

  // merge the (warp, key group) partials of this split; the stage
  // buffers are free now (the loop ended on a barrier)
  merge_slots<LPK, GC>(smem, rs, acc, m, l, warp, grp, d0, has_d, ng, dh,
                       out_row, split, n_split, pacc, pl, pm);
}

template <typename T, int LPK, int GC, bool PAD = false>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const void* pages, const void* cur, float* pacc,
                         float* pl, float* pm, int B, int H, int Hkv, int dh,
                         int ps, int maxp, int window, int span, int n_split,
                         float scale, cudaStream_t stream) {
  const int rs = PAD ? 8 * LPK : dh;        // staged row width
  const size_t stage = 4 * (size_t)ps * rs * sizeof(T);
  const size_t red = merge_smem<LPK, GC>(rs);
  const size_t smem = stage > red ? stage : red;
  auto kern = paged_split_kernel<T, LPK, GC, PAD>;
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

#define REPRO_PD_ARGS                                                        \
  q, kp, vp, pages, cur, pacc, pl, pm, B, H, Hkv, dh, ps, maxp, window,      \
      span, n_split, scale, stream

// A head dim with no instantiation of its own (1..256): the lane class
// that holds it, rows padded to 8 * LPK.
template <typename T>
cudaError_t launch_pad(const void* q, const void* kp, const void* vp,
                       const void* pages, const void* cur, float* pacc,
                       float* pl, float* pm, int B, int H, int Hkv, int dh,
                       int ps, int maxp, int window, int span, int n_split,
                       float scale, cudaStream_t stream) {
  const bool wide = H / Hkv > 2;  // 8 query heads a block, else 2
#define REPRO_PD_PAD(LPK)                                                    \
  return wide ? launch_split<T, LPK, 8, true>(REPRO_PD_ARGS)                 \
              : launch_split<T, LPK, 2, true>(REPRO_PD_ARGS)
  if (dh < 1) return cudaErrorInvalidValue;
  if (dh <= 32) REPRO_PD_PAD(4);
  if (dh <= 64) REPRO_PD_PAD(8);
  if (dh <= 128) REPRO_PD_PAD(16);
  if (dh <= 256) REPRO_PD_PAD(32);
#undef REPRO_PD_PAD
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pages, const void* cur, float* pacc, float* pl,
                   float* pm, int B, int H, int Hkv, int dh, int ps, int maxp,
                   int window, int span, int n_split, float scale,
                   cudaStream_t stream) {
  const bool wide = H / Hkv > 2;  // 8 query heads a block, else 2
#define REPRO_PD_LPK(LPK)                                                    \
  return wide ? launch_split<T, LPK, 8>(REPRO_PD_ARGS)                       \
              : launch_split<T, LPK, 2>(REPRO_PD_ARGS)
  switch (dh) {
    case 16: REPRO_PD_LPK(2);     // the reduced (smoke) configs
    case 32: REPRO_PD_LPK(4);
    case 64: REPRO_PD_LPK(8);
    case 128: REPRO_PD_LPK(16);
    case 240: REPRO_PD_LPK(32);
    case 256: REPRO_PD_LPK(32);
    default: return launch_pad<T>(REPRO_PD_ARGS);
  }
#undef REPRO_PD_LPK
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  window <= 0 means no
// window.  The key
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
  else if (dtype == 2)
    e = launch<__half>(q, kpool, vpool, pages, cur, pa, ls, ms, B, H, Hkv, dh,
                       ps, maxp, window, span, n_split, scale, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)merge_splits(pacc, pl, pm, acc, l, m, B * H, n_split, dh, s);
}
#undef REPRO_PD_ARGS
