// Cosine-similarity top-k over a corpus: the recommender's hot spot, where
// only (k scores, k ids) per query leave the corpus's device.
//
// Replaces: src/repro/kernels/topk_similarity.py::topk_similarity (the
// Pallas `_kernel`, grid (query blocks, corpus tiles) with the corpus axis
// sequential, a (qb, ct) MXU product per tile and a running top-k in VMEM
// scratch merged by k rounds of max-extract).
//
// The queries come in fp32 and each block normalises its own (q^ =
// q / max(|q|, 1e-9), as the Pallas wrapper does outside its kernel); the
// corpus is read once, as it is stored (fp32 or bf16), with no normalised
// copy.  For each query it finds the k best (score, id) pairs of
//   s = (q^ . c) / max(|c|, 1e-9)
// over the corpus rows, in the order: higher score first, and on equal
// scores the lower id first (jax.lax.top_k's order).  |c| comes from the
// staged tile itself.
//
// What bounds it on an H100: at the recommender's D = 128 the product is
// 2QND flops against reading the corpus once (ND * itemsize bytes), Q / 2
// flops a byte in fp32.  The product runs on the tensor cores at fp32
// accuracy (a one-pass TF32 product keeps ~1e-3 and would miss the
// scores' 1e-5 tolerance), so it costs three products:
//   * fp32 corpus, 3xTF32 on mma.sync m16n8k8: a = a_hi + a_lo and
//     b = b_hi + b_lo split in registers (cvt.rna.tf32), and
//     a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (3 * 2QND flops at 495 TF/s);
//   * bf16 corpus, exact in bf16: q^ is split into three bf16 parts
//     (h + m + l holds its 24 bits) and c.q^ ~ c.l + c.m + c.h on mma.sync
//     m16n8k16 with fp32 accumulation (3 * 2QND flops at 989 TF/s).
// At Q = 50 the corpus bytes bound it, at Q = 256 the operations (3xTF32).
// Measured on the card (PERF.md), neither does: the running selection
// takes most of pass 1 at Q = 50, and mma.sync's rate (not wgmma's peak)
// the product at Q = 256.
//
// Design:
//   * pass 1, grid (query blocks of QB = 64, corpus splits): a block
//     normalises its 64 queries (a warp a row) and stages them in shared
//     memory once (the bf16 route as their three parts), then streams
//     its split of the corpus through shared memory in tiles of CT = 64
//     rows, KC = 128 columns a stage, by 16-byte
//     cp.async, double buffered (rows whose bytes are not 16-byte aligned,
//     such as D = 37, take element loads in the same kernel); columns past
//     D are zero;
//   * the product: warp w computes rows 32 (w & 1) .. + 32 against queries
//     16 (w >> 1) .. + 16 (two m16 tiles by two n8 tiles); query tiles past
//     the block's last query are skipped.  The row stride is 4 (mod 8)
//     words, so the fragment loads do not conflict.  The squared row norm
//     is summed from the same A fragments (each row's columns in the same
//     lanes and order, then a butterfly over the quad), so a row's score
//     does not depend on where the row falls in a tile or a split: equal
//     rows give bit-equal scores;
//   * the scores are restaged through shared memory (the consumed corpus
//     stage) as (query, row), then warp w keeps, per query of 8w..8w+7,
//     its running top-k spread over its lanes (lane j holds entry j,
//     k <= 32), with the k-th entry, warp-uniform, as the threshold.  A
//     ballot finds the lanes whose score beats it (rarely more than a few
//     once the list has filled), and each is inserted in one step: a
//     ballot for its rank, a shuffle down;
//   * rows at or past the split's end (and N) are never candidates;
//   * pass 2, one block per query: the splits' partial lists are staged in
//     shared memory, then k rounds of a block arg-best, each round taking
//     the best entry below the previous winner in the (score, id) order.
//     Splitting the corpus gives Q = 50 (one query block) enough blocks to
//     fill 132 SMs; two blocks fit on an SM.
// Both passes launch on the caller's stream; the wrapper allocates the
// partial lists.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARP = 8;           // warps per block
constexpr int NTH = NWARP * 32;
constexpr int TQ = 8;              // queries a warp selects for
constexpr int QB = NWARP * TQ;     // queries per block
constexpr int CT = 64;             // corpus rows per tile
constexpr int KC = 128;            // corpus columns per stage
constexpr int SLD = CT + 4;        // row stride of the staged scores
constexpr int NOID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;
constexpr int TOO_WIDE = -1;       // status: D does not fit Smem<T> (below)

// The product's route, by the corpus dtype.
template <typename T>
struct Route;
template <>
struct Route<float> {              // 3xTF32 on mma.sync m16n8k8
  static constexpr int KSTEP = 8, PAD = 4, QPARTS = 1;
  using QT = float;                // staged queries: q^ itself
};
template <>
struct Route<__nv_bfloat16> {      // bf16x3 on mma.sync m16n8k16
  static constexpr int KSTEP = 16, PAD = 8, QPARTS = 3;
  using QT = __nv_bfloat16;        // staged queries: q^'s three parts
};

// Shared memory: two stages (a corpus tile, or the tile's scores once the
// tile is used up), then the queries.
template <typename T>
struct Smem {
  using R = Route<T>;
  static constexpr int LDC = KC + R::PAD;        // staged corpus row
  static constexpr size_t TILE = (size_t)CT * LDC * sizeof(T);
  static constexpr size_t SCORES = (size_t)QB * SLD * sizeof(float);
  static constexpr size_t STAGE = TILE > SCORES ? TILE : SCORES;
  __host__ __device__ static int dp(int d) {     // D padded to the k-step
    return (d + R::KSTEP - 1) / R::KSTEP * R::KSTEP;
  }
  __host__ __device__ static int ldq(int d) { return dp(d) + R::PAD; }
  static size_t bytes(int d) {
    return 2 * STAGE +
           (size_t)R::QPARTS * QB * ldq(d) * sizeof(typename R::QT);
  }
};

// (s, i) ranks above (t, j): higher score, or the lower id on equal scores
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(FULL, s, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// Offer the candidates (v, id) of the lanes whose `mine` is set to the
// warp's sorted list (lane j holds entry j of k; ts/ti = entry k-1).
__device__ __forceinline__ void offer(float v, int id, bool mine, float& ls,
                                      int& li, float& ts, int& ti, int k,
                                      int lane) {
  unsigned m = __ballot_sync(FULL, mine && better(v, id, ts, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float s = __shfl_sync(FULL, v, src);
    const int i = __shfl_sync(FULL, id, src);
    if (!better(s, i, ts, ti)) continue;  // the threshold rose meanwhile
    // rank = number of entries above the candidate (a prefix of the lanes)
    const int p = __popc(__ballot_sync(FULL, lane < k &&
                                                 better(ls, li, s, i)));
    const float us = __shfl_up_sync(FULL, ls, 1);
    const int ui = __shfl_up_sync(FULL, li, 1);
    if (lane > p) {
      ls = us;
      li = ui;
    } else if (lane == p) {
      ls = s;
      li = i;
    }
    ts = __shfl_sync(FULL, ls, k - 1);
    ti = __shfl_sync(FULL, li, k - 1);
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
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.f);
}

// x = hi + lo with both parts in tf32 (hi keeps 11 significant bits, lo the
// next 11)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float sq2(uint32_t u, float acc) {
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u));
  return fmaf(x.y, x.y, fmaf(x.x, x.x, acc));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(NTH, 2) topk_partial_kernel(
    const float* __restrict__ q,  // (nq, d) queries, as given
    const T* __restrict__ c,      // (n, ldc) corpus rows, as stored
    float* __restrict__ ps,       // (splits, nq, k) partial scores
    int* __restrict__ pi,         // (splits, nq, k) partial ids
    int nq, int n, int d, int ldc, int k, int rows_per_split, int vec) {
  using SM = Smem<T>;
  using R = typename SM::R;
  using QT = typename R::QT;
  constexpr int LDC = SM::LDC;
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = SM::dp(d), ldq = SM::ldq(d);
  const int nkc = (dp + KC - 1) / KC;     // stages a tile takes
  QT* qs = reinterpret_cast<QT*>(smem + 2 * SM::STAGE);  // [parts][QB][ldq]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = blockIdx.x * QB;
  const int nqb = min(QB, nq - q0);       // queries of this block
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + CT - 1) / CT : 0;

  // the block's queries, normalised here (x / max(|x|, 1e-9), |x|^2
  // summed in fp32 over the lanes), zero past nqb and d: warp w stages rows
  // w, w + NWARP, ...
  for (int r = warp; r < QB; r += NWARP) {
    const float* qr = q + (size_t)(q0 + r) * d;
    float ss = 0.f;
    for (int col = lane; r < nqb && col < d; col += 32)
      ss = fmaf(qr[col], qr[col], ss);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_down_sync(FULL, ss, off);
    const float nrm = fmaxf(sqrtf(__shfl_sync(FULL, ss, 0)), 1e-9f);
    for (int col = lane; col < dp; col += 32) {
      const float x = r < nqb && col < d ? qr[col] / nrm : 0.f;
      if constexpr (R::QPARTS == 1) {
        qs[r * ldq + col] = x;
      } else {                    // h + m + l = x to fp32's 24 bits
        const __nv_bfloat16 h = __float2bfloat16_rn(x);
        const float r1 = x - __bfloat162float(h);
        const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
        qs[r * ldq + col] = h;
        qs[(QB + r) * ldq + col] = mid;
        qs[(2 * QB + r) * ldq + col] =
            __float2bfloat16_rn(r1 - __bfloat162float(mid));
      }
    }
  }

  // unit u = (tile u / nkc, column chunk u % nkc) into stage st
  auto load_unit = [&](int u, int st) {
    T* dst = reinterpret_cast<T*>(smem + st * SM::STAGE);
    const int tile = r_begin + (u / nkc) * CT;
    const int kc0 = (u % nkc) * KC;
    const int cols = min(KC, dp - kc0);   // staged columns
    const int have = min(cols, d - kc0);  // of which hold data
    const int rows = min(CT, r_end - tile);
    if (vec) {                    // d, ldc and the base 16-byte aligned
      const int cpr = have / EPC;
      for (int i = tid; i < rows * cpr; i += NTH) {
        const int r = i / cpr, e = (i - r * cpr) * EPC;
        cp_async16(dst + r * LDC + e,
                   c + (size_t)(tile + r) * ldc + kc0 + e);
      }
    } else {
      for (int i = tid; i < rows * have; i += NTH) {
        const int r = i / have, e = i - r * have;
        dst[r * LDC + e] = c[(size_t)(tile + r) * ldc + kc0 + e];
      }
    }
    const int pad = cols - have;  // columns past d (the stage may hold
    for (int i = tid; i < CT * pad; i += NTH) {  // scores from before)
      const int r = i / pad;
      set_zero(dst[r * LDC + have + i - r * pad]);
    }
  };

  // the product's share of warp w: rows 32 rg.., queries 16 qg..
  const int rg = warp & 1, qg = warp >> 1;
  const int nlive = min(2, max(0, (nqb - qg * 16 + 7) / 8));  // live n8s
  float acc[2][2][4], n2[2][2];

  float ls[TQ], ts[TQ];
  int li[TQ], ti[TQ];
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    ls[u] = ts[u] = -INFINITY;
    li[u] = ti[u] = NOID;
  }

  const int n_units = n_tiles * nkc;
  if (n_units > 0) load_unit(0, 0);
  cp_async_commit();
  for (int u = 0; u < n_units; ++u) {
    const int st = u & 1, kc = u % nkc;
    cp_async_wait0();
    __syncthreads();  // unit u landed; the other stage is used up
    if (u + 1 < n_units) load_unit(u + 1, st ^ 1);
    cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        n2[i][0] = n2[i][1] = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
    if (nlive > 0) {  // the product of this column chunk (warp-uniform)
      const T* cs = reinterpret_cast<const T*>(smem + st * SM::STAGE);
      const int kc0 = kc * KC, cols = min(KC, dp - kc0);
      for (int k0 = 0; k0 < cols; k0 += R::KSTEP) {
        if constexpr (R::QPARTS == 1) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* ar = cs + (rg * 32 + i * 16 + g) * LDC + k0 + t;
            const float a[4] = {ar[0], ar[8 * LDC], ar[4], ar[8 * LDC + 4]};
            n2[i][0] = fmaf(a[2], a[2], fmaf(a[0], a[0], n2[i][0]));
            n2[i][1] = fmaf(a[3], a[3], fmaf(a[1], a[1], n2[i][1]));
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[i][e], al[i][e]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= nlive) break;
            const float* br = qs + (qg * 16 + j * 8 + g) * ldq + kc0 + k0 + t;
            uint32_t bh[2], bl[2];
            split_tf32(br[0], bh[0], bl[0]);
            split_tf32(br[4], bh[1], bl[1]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_tf32(acc[i][j], al[i], bh[0], bh[1]);
              mma_tf32(acc[i][j], ah[i], bl[0], bl[1]);
              mma_tf32(acc[i][j], ah[i], bh[0], bh[1]);
            }
          }
        } else {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const T* ar = cs + (rg * 32 + i * 16 + g) * LDC + k0 + 2 * t;
            a[i][0] = ld32(ar);
            a[i][1] = ld32(ar + 8 * LDC);
            a[i][2] = ld32(ar + 8);
            a[i][3] = ld32(ar + 8 * LDC + 8);
            n2[i][0] = sq2(a[i][2], sq2(a[i][0], n2[i][0]));
            n2[i][1] = sq2(a[i][3], sq2(a[i][1], n2[i][1]));
          }
          const int part = QB * ldq;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= nlive) break;
            const QT* br = qs + (qg * 16 + j * 8 + g) * ldq + kc0 + k0 + 2 * t;
            uint32_t b[3][2];
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              b[p][0] = ld32(br + p * part);
              b[p][1] = ld32(br + p * part + 8);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][j], a[i], b[2][0], b[2][1]);
              mma_bf16(acc[i][j], a[i], b[1][0], b[1][1]);
              mma_bf16(acc[i][j], a[i], b[0][0], b[0][1]);
            }
          }
        }
      }
    }
    if (kc + 1 < nkc) continue;

    // the tile's scores: dot / max(|c|, 1e-9), |c|^2 summed over the quad
    float nrm[2][2];
    if (nlive > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = n2[i][h];
          x += __shfl_xor_sync(FULL, x, 1);
          x += __shfl_xor_sync(FULL, x, 2);
          nrm[i][h] = fmaxf(sqrtf(x), 1e-9f);
        }
    }
    __syncthreads();  // every warp is done with the stage's rows
    float* sc = reinterpret_cast<float*>(smem + st * SM::STAGE);  // [QB][SLD]
    if (nlive > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= nlive) break;
          const int r = rg * 32 + i * 16 + g;
          const int qc = qg * 16 + j * 8 + 2 * t;
          sc[qc * SLD + r] = acc[i][j][0] / nrm[i][0];
          sc[(qc + 1) * SLD + r] = acc[i][j][1] / nrm[i][0];
          sc[qc * SLD + r + 8] = acc[i][j][2] / nrm[i][1];
          sc[(qc + 1) * SLD + r + 8] = acc[i][j][3] / nrm[i][1];
        }
    }
    __syncthreads();
    const int tile = r_begin + (u / nkc) * CT;
#pragma unroll
    for (int tq = 0; tq < TQ; ++tq) {
      const int qi = warp * TQ + tq;
      if (qi < nqb) {             // warp-uniform
#pragma unroll
        for (int h = 0; h < CT / 32; ++h) {
          const int r = h * 32 + lane;
          offer(sc[qi * SLD + r], tile + r, tile + r < r_end, ls[tq],
                li[tq], ts[tq], ti[tq], k, lane);
        }
      }
    }
  }

#pragma unroll
  for (int tq = 0; tq < TQ; ++tq) {
    const int qi = q0 + warp * TQ + tq;
    if (warp * TQ + tq < nqb && lane < k) {
      const size_t o = ((size_t)split * nq + qi) * k + lane;
      ps[o] = ls[tq];
      pi[o] = li[tq];
    }
  }
}

__global__ void __launch_bounds__(NTH) topk_merge_kernel(
    const float* __restrict__ ps, const int* __restrict__ pi,
    float* __restrict__ out_s, int* __restrict__ out_i, int nq, int k,
    int splits) {
  extern __shared__ float4 smem4[];
  __shared__ float win_s[NWARP];
  __shared__ int win_i[NWARP];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int m = splits * k;
  float* cs = reinterpret_cast<float*>(smem4);  // (m,) this query's entries
  int* ci = reinterpret_cast<int*>(cs + m);
  for (int e = tid; e < m; e += NTH) {
    const size_t o = ((size_t)(e / k) * nq + qi) * k + e % k;
    cs[e] = ps[o];
    ci[e] = pi[o];
  }
  __syncthreads();
  float prev_s = INFINITY;  // ranks above every entry
  int prev_i = -1;
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int bi = NOID;
    for (int e = tid; e < m; e += NTH) {
      const float s = cs[e];
      const int i = ci[e];
      if (better(prev_s, prev_i, s, i) && better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
    warp_best(bs, bi);
    if (lane == 0) {
      win_s[warp] = bs;
      win_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < NWARP ? win_s[lane] : -INFINITY;
      bi = lane < NWARP ? win_i[lane] : NOID;
      warp_best(bs, bi);
      if (lane == 0) {
        out_s[(size_t)qi * k + j] = bs;
        out_i[(size_t)qi * k + j] = bi;
        win_s[0] = bs;
        win_i[0] = bi;
      }
    }
    __syncthreads();
    prev_s = win_s[0];
    prev_i = win_i[0];
  }
}

template <typename T>
cudaError_t launch_partial(const void* q, const void* c, void* ps, void* pi,
                           int nq, int n, int d, int ldc, int k, int splits,
                           int rows_per_split, int vec, cudaStream_t s) {
  const size_t smem = Smem<T>::bytes(d);   // <= SMEM_MAX: the entry checked
  auto kern = topk_partial_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((nq + QB - 1) / QB, splits);
  kern<<<grid, NTH, smem, s>>>((const float*)q, (const T*)c, (float*)ps,
                               (int*)pi, nq, n, d, ldc, k, rows_per_split,
                               vec);
  return cudaGetLastError();
}

}  // namespace

// q (nq, d) fp32 queries (not normalised), contiguous; c (n, d) rows ldc
// elements apart, fp32 (dtype 0) or bf16 (dtype 1); vec = 1 when d, ldc
// and c's base allow 16-byte copies.  ps/pi (splits, nq, k) scratch;
// out_s/out_i (nq, k).  Split j covers corpus rows [j * rows_per_split,
// (j + 1) * rows_per_split).  Returns TOO_WIDE (-1) when d does not fit
// the shared-memory tiles (d <= 640 for an fp32 corpus, 496 for bf16),
// else the cudaError_t of the launches (0 = success).
extern "C" int repro_topk_similarity(const void* q, const void* c, void* ps,
                                     void* pi, void* out_s, void* out_i,
                                     int nq, int n, int d, int ldc, int k,
                                     int splits, int rows_per_split, int vec,
                                     int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t merge_smem = (size_t)splits * k * 8;
  if (nq <= 0 || n <= 0 || d <= 0 || ldc < d || k <= 0 || k > n ||
      k > 32 || splits <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < n || merge_smem > 48 * 1024 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((dtype ? Smem<__nv_bfloat16>::bytes(d) : Smem<float>::bytes(d)) >
      SMEM_MAX)
    return TOO_WIDE;
  const cudaError_t e =
      dtype ? launch_partial<__nv_bfloat16>(q, c, ps, pi, nq, n, d, ldc, k,
                                            splits, rows_per_split, vec, s)
            : launch_partial<float>(q, c, ps, pi, nq, n, d, ldc, k, splits,
                                    rows_per_split, vec, s);
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<nq, NTH, merge_smem, s>>>(
      (const float*)ps, (const int*)pi, (float*)out_s, (int*)out_i, nq, k,
      splits);
  return (int)cudaGetLastError();
}
