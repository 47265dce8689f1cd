// Single-query GQA decode attention over a dense KV strip masked by explicit
// key positions, returning combinable fp32 (acc, l, m) partials.
//
// Replaces: src/repro/kernels/isp_decode.py::decode_partial (the Pallas
// `_kernel`, grid (B, Hkv, S / kv_block) with the online-softmax state in
// VMEM scratch carried across the kv axis).
//
// Both position layouts of the reference take this kernel:
//   * the Pallas layout: one shared track kpos (S,) and a scalar cur (the
//     uniform-position decode_fn), passed with batch stride 0;
//   * the serve engine's per-slot layout: kpos (B, S) and cur (B,) (ring
//     strips of sliding-window layers, the strip KV layout), which the
//     reference sends to its jnp path.
// A key row s is valid iff kpos[s] >= 0, kpos[s] <= cur and, with a window,
// kpos[s] > cur - window.  Ring buffers are not sorted by position, so every
// row of the strip is scanned and masked; nothing stops early at cur.
//
// What bounds it on an H100: bytes.  Every valid key row is read once (K and
// V, 2 * dh * itemsize per kv head) and costs 4 * G * dh flops, about
// 2 * G flops per byte in bf16, far below the ~295 flops/byte where the
// tensor cores would become the limit.
//
// Design:
//   * one thread block per (slot, kv head, group of GC query heads); NW warps
//     split the strip's rows between them (warp w takes row chunks
//     w, w + NW, ...), each lane owning DPL output dims, so a K/V row is read
//     from device memory once for all GC heads of its group;
//   * the strip is read in place through its strides (the Pallas wrapper
//     transposed it to (B, Hkv, S, dh), a full copy per layer per step);
//   * rows are masked before they are loaded: an invalid row is never read,
//     and a chunk with no valid row is skipped by the whole warp;
//   * each warp keeps an online softmax (m, l, acc) per head in registers;
//     the NW warp partials are merged in shared memory at the end, in warp
//     order (deterministic);
//   * a head with no valid key comes out as m = -1e30, l = 0, acc = 0, as the
//     TPU kernel gives by masking p after the exponent (combine_partials
//     guards l == 0).
// Loads are scalar; vectorised or TMA-staged loads and splitting the rows
// across more blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NW = 8;  // warps per block
constexpr int R = 4;   // rows a warp takes per iteration

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int GC, int DPL>  // GC q heads per block, DPL dims/lane
__global__ void __launch_bounds__(NW * 32) isp_decode_kernel(
    const T* __restrict__ q,            // (B, H, dh)
    const T* __restrict__ k,            // (B, S, Hkv, dh) by strides
    const T* __restrict__ v,
    const int32_t* __restrict__ kpos,   // (S,) or (B, S)
    const int32_t* __restrict__ cur,    // () or (B,)
    float* __restrict__ acc_out,        // (B, H, dh)
    float* __restrict__ l_out,          // (B, H)
    float* __restrict__ m_out,          // (B, H)
    int H, int Hkv, int dh, int S, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int kpos_sb, int cur_sb, int window, float scale) {
  __shared__ float wm[NW][GC], wl[NW][GC];
  __shared__ float accs[GC][32 * DPL];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = H / Hkv;
  const int h0 = hk * G + blockIdx.z * GC;  // first q head of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * DPL;

  float qr[GC][DPL], acc[GC][DPL], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = d0 + i;
      qr[g][i] = d < dh ? to_f(q[((size_t)b * H + h0 + g) * dh + d]) : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const int c = cur[(size_t)b * cur_sb];
  const int32_t* kp = kpos + (size_t)b * kpos_sb;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int s0 = warp * R; s0 < S; s0 += NW * R) {
    bool ok[R];
    bool any = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r;
      const int p = s < S ? kp[s] : -1;
      ok[r] = p >= 0 && p <= c && (window <= 0 || p > c - window);
      any = any || ok[r];
    }
    if (!any) continue;  // the same for every lane of the warp

    float kr[R][DPL], vr[R][DPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long ks = (long long)(s0 + r) * k_ss;
      const long long vs = (long long)(s0 + r) * v_ss;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = d0 + i;
        const bool in = ok[r] && d < dh;
        kr[r][i] = in ? to_f(kb[ks + d]) : 0.f;
        vr[r][i] = in ? to_f(vb[vs + d]) : 0.f;
      }
    }

#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float sc[R];
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qr[g][i] * kr[r][i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[r] = ok[r] ? part * scale : kNegInf;
        mx = fmaxf(mx, sc[r]);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!ok[r]) continue;
        const float p = expf(sc[r] - mx);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += p * vr[r][i];
      }
      m[g] = mx;
    }
  }

  // merge the NW warp partials
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
  }
  __syncthreads();
  float mg[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    mg[g] = kNegInf;
    for (int w = 0; w < NW; ++w) mg[g] = fmaxf(mg[g], wm[w][g]);
  }
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float a = expf(m[g] - mg[g]);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const float x = acc[g][i] * a;
          accs[g][d0 + i] = w == 0 ? x : accs[g][d0 + i] + x;
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < GC * dh; e += blockDim.x) {
    const int g = e / dh, d = e - g * dh;
    acc_out[((size_t)b * H + h0 + g) * dh + d] = accs[g][d];
  }
  if (threadIdx.x < GC) {  // thread g writes head g's (l, m) from smem
    const int g = threadIdx.x;
    float mx = kNegInf, lsum = 0.f;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w][g]);
    for (int w = 0; w < NW; ++w) lsum += wl[w][g] * expf(wm[w][g] - mx);
    l_out[(size_t)b * H + h0 + g] = lsum;
    m_out[(size_t)b * H + h0 + g] = mx;
  }
}

template <typename T, int DPL>
cudaError_t launch_dpl(const void* q, const void* k, const void* v,
                       const void* kpos, const void* cur, void* acc, void* l,
                       void* m, int B, int H, int Hkv, int dh, int S,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       int kpos_sb, int cur_sb, int window, float scale,
                       int gc, cudaStream_t stream) {
  const dim3 block(NW * 32);
  const dim3 grid(B, Hkv, (H / Hkv) / gc);
#define REPRO_ID_LAUNCH(GC)                                                   \
  isp_decode_kernel<T, GC, DPL><<<grid, block, 0, stream>>>(                  \
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)kpos,            \
      (const int32_t*)cur, (float*)acc, (float*)l, (float*)m, H, Hkv, dh, S,  \
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kpos_sb, cur_sb, window, scale)
  switch (gc) {
    case 1: REPRO_ID_LAUNCH(1); break;
    case 2: REPRO_ID_LAUNCH(2); break;
    case 4: REPRO_ID_LAUNCH(4); break;
    case 8:
      if constexpr (8 * DPL <= 32) {
        REPRO_ID_LAUNCH(8);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_ID_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kpos, const void* cur, void* acc, void* l,
                   void* m, int B, int H, int Hkv, int dh, int S,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   int kpos_sb, int cur_sb, int window, float scale, int gc,
                   cudaStream_t stream) {
  if (dh <= 64)
    return launch_dpl<T, 2>(q, k, v, kpos, cur, acc, l, m, B, H, Hkv, dh, S,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kpos_sb,
                            cur_sb, window, scale, gc, stream);
  if (dh <= 128)
    return launch_dpl<T, 4>(q, k, v, kpos, cur, acc, l, m, B, H, Hkv, dh, S,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kpos_sb,
                            cur_sb, window, scale, gc, stream);
  if (dh <= 256)
    return launch_dpl<T, 8>(q, k, v, kpos, cur, acc, l, m, B, H, Hkv, dh, S,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kpos_sb,
                            cur_sb, window, scale, gc, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  Strides
// are in elements; the head dim must be contiguous.  kpos_sb / cur_sb are 0
// for the shared (S,) track and scalar cur, S and 1 for the per-slot
// layout.  gc: q heads per block (1, 2, 4 or 8, dividing H / Hkv, with
// gc * ceil(dh / 32) <= 32 rounded to the kernel's lane widths).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_isp_decode(const void* q, const void* k, const void* v,
                                const void* kpos, const void* cur, void* acc,
                                void* l, void* m, int B, int H, int Hkv,
                                int dh, int S, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, int kpos_sb,
                                int cur_sb, int window, int gc, float scale,
                                int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, kpos, cur, acc, l, m, B, H, Hkv, dh, S,
                              k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kpos_sb,
                              cur_sb, window, scale, gc, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, kpos, cur, acc, l, m, B, H,
                                      Hkv, dh, S, k_sb, k_ss, k_sh, v_sb,
                                      v_ss, v_sh, kpos_sb, cur_sb, window,
                                      scale, gc, s);
  return (int)cudaErrorInvalidValue;
}
