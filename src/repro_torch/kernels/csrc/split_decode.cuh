// Device code shared by the two split-K flash-decoding kernels,
// paged_decode.cu (keys in pages of a pool) and isp_decode.cu (keys in rows
// of a dense strip masked by positions).  Each source includes this header
// and is compiled on its own (kernels/build.py keys every library by the
// headers' bytes too).
//
// Both run pass 1 with grid (B, Hkv * head chunks, n_split) and NT threads:
// the block stages its span's keys in their own dtype (16-byte cp.async,
// double buffered) and spreads its warps over the keys: a key group of LPK
// lanes owns one key at a time, each lane 8 of its dims, so a key's score
// is computed once for all the block's GC query heads.  Each (warp, key
// group) keeps its own online softmax (m, l, acc) in fp32 registers,
// rescaled once per batch of keys (attend_stage); at the end of the span
// the partials are merged in shared memory into the split's (acc, l, m)
// (merge_slots).  Pass 2 (merge_splits_kernel) merges the splits with
// ref.merge_partials' algebra: m = max m_i, l = sum l_i e^(m_i - m),
// acc = sum acc_i e^(m_i - m), no division.
//
// Masked scores are -1e30 and get p = 0, and a split with no valid key
// writes m = -1e30, l = 0, acc = 0 (write_empty), so every merge weight of
// an all-empty set is e^0 = 1 times zeros and no NaN enters the merge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_decode {

constexpr float kNegInf = -1e30f;
constexpr int NW = 4;             // warps per block of pass 1
constexpr int NT = NW * 32;
constexpr unsigned FULL = 0xffffffffu;

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

// The empty partial of the block's ng heads (rows out_row..) in `split`.
__device__ __forceinline__ void write_empty(float* pacc, float* pl, float* pm,
                                            size_t out_row, int ng, int dh,
                                            int split, int n_split) {
  for (int i = threadIdx.x; i < ng * dh; i += NT) {
    const int g = i / dh;
    pacc[((out_row + g) * n_split + split) * dh + i - g * dh] = 0.f;
  }
  if (threadIdx.x < ng) {
    pl[(out_row + threadIdx.x) * n_split + split] = 0.f;
    pm[(out_row + threadIdx.x) * n_split + split] = kNegInf;
  }
}

// The online softmax over the cnt keys staged at ks / vs (rows of rs
// elements): batches of MAXK rounds of the block's keys, each batch scored
// for all GC heads, one rescale a batch, then p and p.V.  valid(j) says
// whether staged key j may be seen (position and window); keys at j >= cnt
// never are.  grp is the key group inside the warp, d0 the lane's first dim.
template <typename T, int LPK, int GC, class Valid>
__device__ __forceinline__ void attend_stage(
    const T* ks, const T* vs, int rs, int cnt, int warp, int grp, int d0,
    bool has_d, const float (&qr)[GC][8], float (&acc)[GC][8],
    float (&m)[GC], float (&l)[GC], float scale, Valid valid) {
  constexpr int KPI = 32 / LPK;             // keys a warp holds at once
  constexpr int ROUND = NW * KPI;           // keys the block holds at once
  constexpr int MAXK = GC >= 8 ? 2 : 4;     // rounds of keys per batch
  for (int j0 = 0; j0 < cnt; j0 += ROUND * MAXK) {
    // scores of up to MAXK keys of this key group, for all heads
    float s[GC][MAXK], bmax[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) bmax[g] = kNegInf;
#pragma unroll
    for (int t = 0; t < MAXK; ++t) {
#pragma unroll
      for (int g = 0; g < GC; ++g) s[g][t] = kNegInf;
      if (j0 + t * ROUND >= cnt) continue;           // block-uniform
      const int j = j0 + t * ROUND + warp * KPI + grp;
      const bool ok = j < cnt && valid(j);
      float kf[8];
      if (j < cnt && has_d) {
        load8(ks + j * rs + d0, kf);
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
          part += __shfl_xor_sync(FULL, part, off);
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
      if (j0 + t * ROUND >= cnt) continue;
      const int j = j0 + t * ROUND + warp * KPI + grp;
      if (j >= cnt || !has_d) continue;
      float vf[8];
      load8(vs + j * rs + d0, vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = s[g][t] == kNegInf ? 0.f : __expf(s[g][t] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += p * vf[e];
      }
    }
  }
}

// Shared memory merge_slots needs, rows of rs floats (rs >= dh).
template <int LPK, int GC>
constexpr size_t merge_smem(int rs) {
  return (size_t)NW * (32 / LPK) * GC * (rs + 2) * sizeof(float);
}

// Merge the block's NW * KPI (warp, key group) partials of this split in
// shared memory (merge_smem<LPK, GC>(rs) bytes at smem, free to overwrite:
// the caller's last barrier has passed) and write the split's (acc, l, m).
template <int LPK, int GC>
__device__ __forceinline__ void merge_slots(
    unsigned char* smem, int rs, const float (&acc)[GC][8],
    const float (&m)[GC], const float (&l)[GC], int warp, int grp, int d0,
    bool has_d, int ng, int dh, size_t out_row, int split, int n_split,
    float* pacc, float* pl, float* pm) {
  constexpr int NSLOT = NW * (32 / LPK);
  float* red_acc = reinterpret_cast<float*>(smem);  // [NSLOT][GC][rs]
  float* red_m = red_acc + NSLOT * GC * rs;         // [NSLOT][GC]
  float* red_l = red_m + NSLOT * GC;
  const int slot = warp * (32 / LPK) + grp;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (has_d) {
      float* dst = red_acc + (slot * GC + g) * rs + d0;
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
      a += red_acc[(s * GC + g) * rs + d] * __expf(red_m[s * GC + g] - mx);
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

// Pass 2: one block per (b, h) merges its n_split partials.
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

// Launch pass 2 on `stream` for B * H (slot, head) rows.
inline cudaError_t merge_splits(const void* pacc, const void* pl,
                                const void* pm, void* acc, void* l, void* m,
                                int BH, int n_split, int dh,
                                cudaStream_t stream) {
  merge_splits_kernel<<<BH, 128, n_split * sizeof(float), stream>>>(
      (const float*)pacc, (const float*)pl, (const float*)pm, (float*)acc,
      (float*)l, (float*)m, n_split, dh);
  return cudaGetLastError();
}

}  // namespace split_decode
