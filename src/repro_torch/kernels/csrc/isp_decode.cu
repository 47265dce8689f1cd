// Single-query GQA decode attention over a dense KV strip masked by explicit
// key positions, returning combinable fp32 (acc, l, m) partials: split-K
// flash-decoding over the strip's rows.
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
// kpos[s] > cur - window.  Ring buffers are not sorted by position, so no
// span of rows can be skipped by position arithmetic: each block reads its
// span's positions and finds its valid rows itself.
//
// What bounds it on an H100: bytes.  Every valid key row is read once (K and
// V, 2 * dh * itemsize per kv head) and costs 4 * G * dh flops, about
// 2 * G flops per byte in bf16, far below the ~295 flops/byte where the
// tensor cores would become the limit; fp32 stays fp32 on the CUDA cores.
// At 8 slots the bytes are a few MB to tens of MB, so the kernel is a
// latency problem: enough blocks must be in flight, each with its next rows
// already loading.
//
// Design (two passes, one C entry, both on the caller's stream):
//   * pass 1, grid (B, Hkv * head chunks, n_split): the strip's S rows are
//     cut into n_split spans of `span` rows (the wrapper picks them from
//     the shapes alone, so no device value is read on the host).  A block
//     serves up to 8 query heads of one kv head (2 when the group has at
//     most 2) over its span;
//   * the block first reads its span's kpos rows and compacts the valid
//     row numbers, in row order, into a list in shared memory (a ballot
//     and a popcount a warp); a span with no valid row writes the empty
//     partial (m = -1e30, l = 0, acc = 0) and exits;
//   * the listed rows are staged CH at a time in their own dtype (bf16
//     and fp16 stay 16-bit), read in place through the strides, by
//     16-byte cp.async, double buffered, so the next rows land while the
//     current ones are used; rows that are not 16-byte aligned (odd dh,
//     odd strides) take a branch of the same kernel with element loads;
//   * the block's warps are spread over the keys, not the heads: a key
//     group of LPK lanes owns one key at a time, each lane 8 of its dims,
//     so a key's score is computed once for all the block's heads (a dot
//     over the lane's 8 dims, then a shuffle reduction inside the group);
//     each (warp, key group) keeps its own online softmax (m, l, acc) in
//     fp32 registers, rescaled once per batch of keys;
//   * at the end of the span the (warp, key group) partials are merged in
//     shared memory and the split's (acc, l, m) is written to the fp32
//     scratch (B, H, n_split, dh);
//   * pass 2, grid (B * H): m = max m_i, l = sum l_i e^(m_i - m),
//     acc = sum acc_i e^(m_i - m) (ref.merge_partials, no division).
// A head with no valid key comes out as m = -1e30, l = 0, acc = 0: every
// split is empty, and every merge weight of an all-empty set is e^0 = 1
// times zeros, so no NaN enters the merge.
//
// The loaders, the per-batch online softmax, the merge of the (warp, key
// group) partials and pass 2 are split_decode.cuh's, shared with
// paged_decode.cu; this file keeps what is a strip's: the list of a span's
// valid rows and their strided staging.
#include "split_decode.cuh"

namespace {

using namespace split_decode;

constexpr int SMEM_MAX = 232448;  // shared memory one block may use

// The pass-1 tile of a head dim class: LPK lanes per key (dh / 8 rounded up
// to a power of two, at least 4), DP staged dims a row (8 a lane, >= dh),
// CH rows a stage (at least one round of the block's key groups).
template <typename T, int LPK, int GC>
struct Tile {
  static constexpr int KPI = 32 / LPK;        // keys a warp holds at once
  static constexpr int ROUND = NW * KPI;      // keys the block holds at once
  static constexpr int CH = ROUND > 16 ? ROUND : 16;
  static constexpr int DP = 8 * LPK;
  static constexpr size_t STAGE = 4 * (size_t)CH * DP * sizeof(T);
  static size_t smem(int span) {
    const size_t stage = STAGE + (size_t)span * sizeof(int);
    const size_t red = merge_smem<LPK, GC>(DP);
    return stage > red ? stage : red;
  }
};

template <typename T, int LPK, int GC>
__global__ void __launch_bounds__(NT) isp_split_kernel(
    const T* __restrict__ q,            // (B, H, dh)
    const T* __restrict__ k,            // (B, S, Hkv, dh) by strides
    const T* __restrict__ v,
    const int32_t* __restrict__ kpos,   // (S,) or (B, S)
    const int32_t* __restrict__ cur,    // () or (B,)
    float* __restrict__ pacc,           // (B, H, n_split, dh)
    float* __restrict__ pl,             // (B, H, n_split)
    float* __restrict__ pm,
    int H, int Hkv, int dh, int S, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int kpos_sb, int cur_sb, int window, int span, int n_split, int vec,
    float scale) {
  using TL = Tile<T, LPK, GC>;
  constexpr int CH = TL::CH, DP = TL::DP;
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wcnt[NW];

  const int b = blockIdx.x;
  const int G = H / Hkv;
  const int nhg = (G + GC - 1) / GC;
  const int hk = blockIdx.y / nhg;
  const int h0 = hk * G + (blockIdx.y % nhg) * GC;  // first head of block
  const int ng = min(GC, hk * G + G - h0);          // heads of this block
  const int split = blockIdx.z;
  const size_t out_row = (size_t)b * H + h0;        // (b, h0) row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  T* stage = reinterpret_cast<T*>(smem);   // [2 stages][K, V][CH][DP]
  int* rows = reinterpret_cast<int*>(smem + TL::STAGE);  // [span]

  // the span's valid rows, in row order
  const int c = cur[(size_t)b * cur_sb];
  const int32_t* kp = kpos + (size_t)b * kpos_sb;
  const int r_lo = split * span;
  const int r_hi = min(r_lo + span, S);
  int nv = 0;
  for (int base = r_lo; base < r_hi; base += NT) {
    const int r = base + threadIdx.x;
    bool ok = false;
    if (r < r_hi) {
      const int p = kp[r];
      ok = p >= 0 && p <= c && (window <= 0 || p > c - window);
    }
    const unsigned bal = __ballot_sync(FULL, ok);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = nv, tot = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      off += w < warp ? wcnt[w] : 0;
      tot += wcnt[w];
    }
    if (ok) rows[off + __popc(bal & ((1u << lane) - 1u))] = r;
    nv += tot;
    __syncthreads();              // wcnt is rewritten by the next round
  }

  if (nv == 0) {                  // nothing to see: the empty partial
    write_empty(pacc, pl, pm, out_row, ng, dh, split, n_split);
    return;
  }

  // dims dh..DP of every staged row stay zero (no load writes them)
  if (dh < DP) {
    for (int i = threadIdx.x; i < 4 * CH * (DP - dh); i += NT) {
      const int r = i / (DP - dh);
      set_zero(stage[r * DP + dh + i - r * (DP - dh)]);
    }
  }

  const int grp = lane / LPK;     // key group inside the warp
  const int d0 = (lane % LPK) * 8;
  const bool has_d = d0 < dh;     // lanes past dh (dh 240: 30, 31) idle

  float qr[GC][8], acc[GC][8], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = d0 + e;
      qr[g][e] = g < ng && d < dh ? to_f(q[(out_row + g) * dh + d]) : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const T* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)hk * v_sh;
  const int n_chunks = (nv + CH - 1) / CH;
  auto load_chunk = [&](int ci, int st) {
    T* ks = stage + (size_t)st * 2 * CH * DP;
    T* vs = ks + CH * DP;
    const int j0 = ci * CH;
    const int cnt = min(CH, nv - j0);
    if (vec) {                    // dh, strides and bases 16-byte aligned
      const int cpr = dh / EPC;   // 16-byte copies per row
      for (int i = threadIdx.x; i < cnt * cpr; i += NT) {
        const int j = i / cpr, e = (i - j * cpr) * EPC;
        const long long s = rows[j0 + j];
        cp_async16(ks + j * DP + e, kb + s * k_ss + e);
        cp_async16(vs + j * DP + e, vb + s * v_ss + e);
      }
    } else {
      for (int i = threadIdx.x; i < cnt * dh; i += NT) {
        const int j = i / dh, e = i - j * dh;
        const long long s = rows[j0 + j];
        ks[j * DP + e] = kb[s * k_ss + e];
        vs[j * DP + e] = vb[s * v_ss + e];
      }
    }
  };

  load_chunk(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_chunks; ++it) {
    if (it + 1 < n_chunks) load_chunk(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const T* ks = stage + (size_t)(it & 1) * 2 * CH * DP;
    const T* vs = ks + CH * DP;
    // every listed row is valid
    attend_stage<T, LPK, GC>(ks, vs, DP, min(CH, nv - it * CH), warp, grp,
                             d0, has_d, qr, acc, m, l, scale,
                             [](int) { return true; });
    __syncthreads();              // stage fully consumed before reuse
  }

  // merge the (warp, key group) partials of this split; the stage
  // buffers are free now (the loop ended on a barrier)
  merge_slots<LPK, GC>(smem, DP, acc, m, l, warp, grp, d0, has_d, ng, dh,
                       out_row, split, n_split, pacc, pl, pm);
}

struct Args {
  const void *q, *k, *v, *kpos, *cur;
  float *pacc, *pl, *pm;
  int B, H, Hkv, dh, S;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int kpos_sb, cur_sb, window, span, n_split, vec;
  float scale;
};

template <typename T, int LPK, int GC>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  const size_t smem = Tile<T, LPK, GC>::smem(a.span);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = isp_split_kernel<T, LPK, GC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int G = a.H / a.Hkv;
  const dim3 grid(a.B, a.Hkv * ((G + GC - 1) / GC), a.n_split);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int32_t*)a.kpos,
      (const int32_t*)a.cur, a.pacc, a.pl, a.pm, a.H, a.Hkv, a.dh, a.S,
      a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.kpos_sb, a.cur_sb,
      a.window, a.span, a.n_split, a.vec, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool wide = a.H / a.Hkv > 2;  // 8 query heads a block, else 2
#define REPRO_ID_LPK(LPK)                                                    \
  return wide ? launch_split<T, LPK, 8>(a, stream)                           \
              : launch_split<T, LPK, 2>(a, stream)
  if (a.dh <= 32) REPRO_ID_LPK(4);
  if (a.dh <= 64) REPRO_ID_LPK(8);
  if (a.dh <= 128) REPRO_ID_LPK(16);
  if (a.dh <= 256) REPRO_ID_LPK(32);
#undef REPRO_ID_LPK
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  window <= 0 means no
// window.  Strides
// are in elements; the head dim must be contiguous.  kpos_sb / cur_sb are 0
// for the shared (S,) track and scalar cur, S and 1 for the per-slot
// layout.  The rows are cut into n_split spans of `span` rows; the split
// partials go to the fp32 scratch pacc (B, H, n_split, dh), pl and pm
// (B, H, n_split) and a second pass merges them into acc, l, m.  vec = 1
// when dh, every stride and both bases are multiples of 16 bytes (rows are
// then copied by 16-byte cp.async), 0 for element loads.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int repro_isp_decode(const void* q, const void* k, const void* v,
                                const void* kpos, const void* cur, void* acc,
                                void* l, void* m, void* pacc, void* pl,
                                void* pm, int B, int H, int Hkv, int dh,
                                int S, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, int kpos_sb,
                                int cur_sb, int window, int span, int n_split,
                                int vec, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || span < 1 || Hkv < 1 || H % Hkv || dh < 1 || dh > 256 ||
      (long long)span * n_split < S)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, kpos, cur, (float*)pacc, (float*)pl, (float*)pm,
               B, H, Hkv, dh, S, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               kpos_sb, cur_sb, window, span, n_split, vec, scale};
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(a, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(a, s);
  else if (dtype == 2)
    e = launch<__half>(a, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)merge_splits(pacc, pl, pm, acc, l, m, B * H, n_split, dh, s);
}
