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
// corpus is read once, as it is stored (fp32, bf16 or fp16), with no
// normalised copy.  For each query it finds the k best (score, id) pairs of
//   s = (q^ . c) / max(|c|, 1e-9)
// over the corpus rows, in the order: higher score first, and on equal
// scores the lower id first (jax.lax.top_k's order).  |c| comes from the
// staged tile itself.
//
// What bounds it on an H100: at the recommender's D = 128 the product is
// 2QND flops against reading the corpus once (ND * itemsize bytes), Q / 2
// flops a byte in fp32.  The product runs on the tensor cores at fp32
// accuracy (a one-pass TF32 product keeps ~1e-3 and would miss the
// scores' 1e-5 tolerance), so it costs three products (two for fp16):
//   * fp32 corpus, 3xTF32 on mma.sync m16n8k8: a = a_hi + a_lo and
//     b = b_hi + b_lo split in registers (cvt.rna.tf32), and
//     a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (3 * 2QND flops at 495 TF/s);
//   * bf16 corpus, exact in bf16: q^ is split into three bf16 parts
//     (h + m + l holds its 24 bits) and c.q^ ~ c.l + c.m + c.h on mma.sync
//     m16n8k16 with fp32 accumulation (3 * 2QND flops at 989 TF/s);
//   * fp16 corpus, 2xTF32 on mma.sync m16n8k8: an fp16 value (11
//     significant bits, a narrower exponent) is a TF32 value exactly, so
//     the staged corpus enters the product whole and only q^ is split,
//     c.q^ ~ c.b_lo + c.b_hi (2 * 2QND flops at 495 TF/s).  Splitting q^
//     into fp16 parts instead would lose bits: a normalised query's third
//     part lies near 2^-22, below fp16's smallest normal.
// At Q = 50 the corpus bytes bound it, at Q = 256 the operations (3xTF32).
// Measured on the card (PERF.md), neither does: the running selection
// takes most of pass 1 at Q = 50, and mma.sync's rate (not wgmma's peak)
// the product at Q = 256.
//
// Design:
//   * pass 1, grid (query blocks of QB = 64, corpus splits): a block
//     normalises its 64 queries (a warp a row) and stages them in shared
//     memory once (the bf16 route as their three parts); where D is wider
//     than one column chunk (QCH), topk_norm_kernel first normalises them
//     into a scratch the same way, and each unit stages the queries'
//     matching column chunk beside the corpus's, so shared memory does
//     not grow with D; then it streams
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
//   * k > 32 (BIG): a warp's lists would not fit its lanes, and 64
//     queries' lists of k = 1024 would not fit shared memory, so each
//     query's list lives in its split's slice of the partial lists in
//     global memory (the L2 holds them), sorted, with its k-th entry in
//     registers as the threshold: per tile the warp gathers the query's
//     candidates that beat it (at most 64), ranks them, and merges them
//     into the list in place from its end (merge_list);
//   * rows at or past the split's end (and N) are never candidates;
//   * pass 2, one block per query: the splits' partial lists are staged in
//     shared memory, then k rounds of a block arg-best, each round taking
//     the best entry below the previous winner in the (score, id) order;
//     for k > 32 the lists are sorted, and one warp merges up to 128 of
//     them (4 heads a lane), a round a warp arg-best and one list's head
//     moved on, from up to 227 KB of staged entries.
//     Splitting the corpus gives Q = 50 (one query block) enough blocks to
//     fill 132 SMs; two blocks fit on an SM.
// Both passes launch on the caller's stream; the wrapper allocates the
// partial lists.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// The product's route, by the corpus dtype.  PAD / QPAD: elements past a
// staged corpus / query row (row strides of 4 (mod 8) words, so the
// fragment loads do not conflict); EXACT: a corpus value is a TF32 value
// as it is, so it enters the TF32 product whole and only q^ is split.
template <typename T>
struct Route;
template <>
struct Route<float> {              // 3xTF32 on mma.sync m16n8k8
  static constexpr int KSTEP = 8, PAD = 4, QPAD = 4, QPARTS = 1;
  static constexpr bool EXACT = false;
  using QT = float;                // staged queries: q^ itself
};
template <>
struct Route<__nv_bfloat16> {      // bf16x3 on mma.sync m16n8k16
  static constexpr int KSTEP = 16, PAD = 8, QPAD = 8, QPARTS = 3;
  static constexpr bool EXACT = false;
  using QT = __nv_bfloat16;        // staged queries: q^'s three parts
};
template <>
struct Route<__half> {             // 2xTF32 on mma.sync m16n8k8
  static constexpr int KSTEP = 8, PAD = 8, QPAD = 4, QPARTS = 1;
  static constexpr bool EXACT = true;   // fp16 values are TF32 values
  using QT = float;                // staged queries: q^ itself
};

// Shared memory: two stages (a corpus tile, or the tile's scores once the
// tile is used up; with QCH the tile's query chunk after it), then the
// queries staged whole (QCH false), then with BIG each warp's two
// candidate buffers.
template <typename T, bool QCH = false, bool BIG = false>
struct Smem {
  using R = Route<T>;
  using QT = typename R::QT;
  static constexpr int LDC = KC + R::PAD;        // staged corpus row
  static constexpr int LDQC = KC + R::QPAD;      // staged query chunk row
  static constexpr size_t TILE = (size_t)CT * LDC * sizeof(T);
  static constexpr size_t SCORES = (size_t)QB * SLD * sizeof(float);
  static constexpr size_t BODY = TILE > SCORES ? TILE : SCORES;
  // QCH: the unit's query chunk [parts][QB][LDQC], after the tile
  static constexpr size_t QCHUNK =
      QCH ? (size_t)R::QPARTS * QB * LDQC * sizeof(QT) : 0;
  static constexpr size_t STAGE = BODY + QCHUNK;
  // BIG: a warp's candidates of one query and tile, as offered and sorted
  static constexpr size_t CAND = BIG ? (size_t)NWARP * 4 * CT * 4 : 0;
  __host__ __device__ static int dp(int d) {     // D padded to the k-step
    return (d + R::KSTEP - 1) / R::KSTEP * R::KSTEP;
  }
  __host__ __device__ static int ldq(int d) { return dp(d) + R::QPAD; }
  __host__ __device__ static size_t whole(int d) {   // queries staged whole
    return QCH ? 0 : (size_t)R::QPARTS * QB * ldq(d) * sizeof(QT);
  }
  static size_t bytes(int d) { return 2 * STAGE + whole(d) + CAND; }
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

// Entries of the sorted (cs, ci)[0, n) that rank above (s, i).
__device__ __forceinline__ int rank_in(const float* cs, const int* ci, int n,
                                       float s, int i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(cs[mid], ci[mid], s, i))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// k > 32: merge the candidates of one query and tile (each lane offers rows
// lane and lane + 32, (s0, i0) and (s1, i1) where c0 / c1) into the query's
// sorted list (Ls, Li) of k entries in global memory: cnt real entries,
// then (-inf, NOID).  The warp sorts the candidates in its buffers (us/ui
// as offered, cs/ci by rank), then walks the list from its end in chunks
// of 32: list entry i moves down by the number of candidates above it,
// delta_i, and the candidates j in [delta_(i-1), delta_i) land just above
// it, at i + j.  Every entry only moves down, and a chunk is read whole
// before it is written, so the walk works in place; it stops at the first
// chunk above which no candidate lands.  (ts, ti) becomes the k-th entry
// once the list is full.
__device__ __forceinline__ void merge_list(
    float s0, int i0, bool c0, float s1, int i1, bool c1, float* Ls,
    int* Li, int k, int& cnt, float& ts, int& ti, float* us, int* ui,
    float* cs, int* ci, int lane) {
  const unsigned b0 = __ballot_sync(FULL, c0), b1 = __ballot_sync(FULL, c1);
  const int n0 = __popc(b0), nc = n0 + __popc(b1);
  if (nc == 0) return;                        // warp-uniform
  const unsigned lt = (1u << lane) - 1u;
  if (c0) {
    const int e = __popc(b0 & lt);
    us[e] = s0;
    ui[e] = i0;
  }
  if (c1) {
    const int e = n0 + __popc(b1 & lt);
    us[e] = s1;
    ui[e] = i1;
  }
  __syncwarp();
  for (int e = lane; e < nc; e += 32) {       // rank among the candidates
    const float s = us[e];
    const int i = ui[e];
    int r = 0;
    for (int f = 0; f < nc; ++f) r += better(us[f], ui[f], s, i);
    cs[r] = s;
    ci[r] = i;
  }
  __syncwarp();
  // entries [0, n): the real ones and, while the list is not full, the
  // first pad, below every candidate, which takes those past the last one
  const int n = min(k, cnt + 1);
  for (int a = (n - 1) & ~31;; a -= 32) {
    const int i = a + lane;
    float s = -INFINITY;
    int id = NOID, dl = nc;
    if (i < n) {
      s = Ls[i];
      id = Li[i];
      dl = rank_in(cs, ci, nc, s, id);
    }
    int dp = __shfl_up_sync(FULL, dl, 1);     // delta of entry i - 1
    if (lane == 0) dp = a > 0 ? rank_in(cs, ci, nc, Ls[a - 1], Li[a - 1]) : 0;
    __syncwarp();                 // the chunk (and a - 1) read before writes
    if (i < n) {
      if (i + dl < k) {
        Ls[i + dl] = s;
        Li[i + dl] = id;
      }
      for (int j = dp; j < dl && i + j < k; ++j) {
        Ls[i + j] = cs[j];
        Li[i + j] = ci[j];
      }
    }
    if (__shfl_sync(FULL, dp, 0) == 0) break; // nothing lands above a
  }
  cnt = min(k, cnt + nc);
  __syncwarp();
  if (cnt == k) {
    ts = Ls[k - 1];
    ti = Li[k - 1];
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
__device__ __forceinline__ void set_zero(__half& x) { x = __float2half(0.f); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

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

// The queries normalised as pass 1 normalises them (a warp a row, the same
// sums), into qn [parts][nq][dp], zero past d: what a QCH block stages a
// column chunk of beside each corpus chunk.
template <typename T>
__global__ void __launch_bounds__(NTH) topk_norm_kernel(
    const float* __restrict__ q, typename Route<T>::QT* __restrict__ qn,
    int nq, int d) {
  using R = Route<T>;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * NWARP + (threadIdx.x >> 5);
  if (r >= nq) return;                        // warp-uniform
  const int dp = Smem<T>::dp(d);
  const float* qr = q + (size_t)r * d;
  float ss = 0.f;
  for (int col = lane; col < d; col += 32) ss = fmaf(qr[col], qr[col], ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_down_sync(FULL, ss, off);
  const float nrm = fmaxf(sqrtf(__shfl_sync(FULL, ss, 0)), 1e-9f);
  for (int col = lane; col < dp; col += 32) {
    const float x = col < d ? qr[col] / nrm : 0.f;
    if constexpr (R::QPARTS == 1) {
      qn[(size_t)r * dp + col] = x;
    } else {                      // h + m + l = x to fp32's 24 bits
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      const float r1 = x - __bfloat162float(h);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      qn[(size_t)r * dp + col] = h;
      qn[((size_t)nq + r) * dp + col] = mid;
      qn[((size_t)2 * nq + r) * dp + col] =
          __float2bfloat16_rn(r1 - __bfloat162float(mid));
    }
  }
}

// QCH: the queries come normalised in qn (topk_norm_kernel) and a column
// chunk of them is staged with each corpus chunk, so shared memory does not
// grow with D.  BIG (k > 32): each query's list lives in its split's slice
// of ps / pi, sorted, merged tile by tile (merge_list).
template <typename T, bool QCH = false, bool BIG = false>
__global__ void __launch_bounds__(NTH, 2) topk_partial_kernel(
    const float* __restrict__ q,  // (nq, d) queries, as given
    const T* __restrict__ c,      // (n, ldc) corpus rows, as stored
    float* __restrict__ ps,       // (splits, nq, k) partial scores
    int* __restrict__ pi,         // (splits, nq, k) partial ids
    int nq, int n, int d, int ldc, int k, int rows_per_split, int vec,
    const typename Route<T>::QT* __restrict__ qn) {  // QCH: [parts][nq][dp]
  using SM = Smem<T, QCH, BIG>;
  using R = typename SM::R;
  using QT = typename R::QT;
  constexpr int LDC = SM::LDC, LDQC = SM::LDQC;
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = SM::dp(d);
  // the staged queries' row pitch: whole rows, or a chunk's LDQC
  const int ldq = QCH ? LDQC : SM::ldq(d);
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
  // w, w + NWARP, ...  (QCH: rows past nqb of both stages' chunks zeroed
  // once, the others come with each unit)
  if constexpr (QCH) {
    for (int st = 0; st < 2; ++st) {
      QT* qc = reinterpret_cast<QT*>(smem + st * SM::STAGE + SM::BODY);
      for (int i = tid; i < R::QPARTS * (QB - nqb) * LDQC; i += NTH) {
        const int p = i / ((QB - nqb) * LDQC);
        const int rem = i - p * (QB - nqb) * LDQC;
        set_zero(qc[(p * QB + nqb) * LDQC + rem]);
      }
    }
  }
  for (int r = warp; !QCH && r < QB; r += NWARP) {
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
    if constexpr (QCH) {          // the chunk's queries, rows < nqb
      QT* qc = reinterpret_cast<QT*>(smem + st * SM::STAGE + SM::BODY);
      constexpr int QEPC = 16 / sizeof(QT);
      const int cpr = cols / QEPC;            // cols is a k-step multiple
      for (int i = tid; i < R::QPARTS * nqb * cpr; i += NTH) {
        const int pr = i / cpr, e = (i - pr * cpr) * QEPC;
        const int p = pr / nqb, r = pr - p * nqb;
        cp_async16(qc + (p * QB + r) * LDQC + e,
                   qn + ((size_t)p * nq + q0 + r) * dp + kc0 + e);
      }
    }
  };

  // the product's share of warp w: rows 32 rg.., queries 16 qg..
  const int rg = warp & 1, qg = warp >> 1;
  const int nlive = min(2, max(0, (nqb - qg * 16 + 7) / 8));  // live n8s
  float acc[2][2][4], n2[2][2];

  float ls[TQ], ts[TQ];
  int li[TQ], ti[TQ], cnt[TQ];
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    ls[u] = ts[u] = -INFINITY;
    li[u] = ti[u] = NOID;
    cnt[u] = 0;
  }
  // BIG: the warp's candidate buffers, and its queries' lists set to pads
  float* cand = reinterpret_cast<float*>(smem + 2 * SM::STAGE +
                                         SM::whole(d)) + warp * 4 * CT;
  if constexpr (BIG) {
    for (int tq = 0; tq < TQ; ++tq) {
      const int qi = warp * TQ + tq;
      if (qi >= nqb) break;                   // warp-uniform
      const size_t o = ((size_t)split * nq + q0 + qi) * k;
      for (int e = lane; e < k; e += 32) {
        ps[o + e] = -INFINITY;
        pi[o + e] = NOID;
      }
    }
    __syncwarp();
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
      [[maybe_unused]] const QT* qc =
          reinterpret_cast<const QT*>(smem + st * SM::STAGE + SM::BODY);
      const int kc0 = kc * KC, cols = min(KC, dp - kc0);
      for (int k0 = 0; k0 < cols; k0 += R::KSTEP) {
        if constexpr (R::QPARTS == 1) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const T* ar = cs + (rg * 32 + i * 16 + g) * LDC + k0 + t;
            const float a[4] = {to_f(ar[0]), to_f(ar[8 * LDC]), to_f(ar[4]),
                                to_f(ar[8 * LDC + 4])};
            n2[i][0] = fmaf(a[2], a[2], fmaf(a[0], a[0], n2[i][0]));
            n2[i][1] = fmaf(a[3], a[3], fmaf(a[1], a[1], n2[i][1]));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (R::EXACT)
                ah[i][e] = __float_as_uint(a[e]);
              else
                split_tf32(a[e], ah[i][e], al[i][e]);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= nlive) break;
            const float* br = (QCH ? qc : qs) + (qg * 16 + j * 8 + g) * ldq +
                              (QCH ? 0 : kc0) + k0 + t;
            uint32_t bh[2], bl[2];
            split_tf32(br[0], bh[0], bl[0]);
            split_tf32(br[4], bh[1], bl[1]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if constexpr (!R::EXACT)
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
            const QT* br = (QCH ? qc : qs) + (qg * 16 + j * 8 + g) * ldq +
                           (QCH ? 0 : kc0) + k0 + 2 * t;
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
        if constexpr (BIG) {
          static_assert(CT == 64, "a lane offers rows lane and lane + 32");
          const float s0 = sc[qi * SLD + lane], s1 = sc[qi * SLD + lane + 32];
          const int i0 = tile + lane, i1 = tile + lane + 32;
          const size_t o = ((size_t)split * nq + q0 + qi) * k;
          merge_list(s0, i0, i0 < r_end && better(s0, i0, ts[tq], ti[tq]),
                     s1, i1, i1 < r_end && better(s1, i1, ts[tq], ti[tq]),
                     ps + o, pi + o, k, cnt[tq], ts[tq], ti[tq], cand,
                     reinterpret_cast<int*>(cand) + CT, cand + 2 * CT,
                     reinterpret_cast<int*>(cand) + 3 * CT, lane);
        } else {
#pragma unroll
          for (int h = 0; h < CT / 32; ++h) {
            const int r = h * 32 + lane;
            offer(sc[qi * SLD + r], tile + r, tile + r < r_end, ls[tq],
                  li[tq], ts[tq], ti[tq], k, lane);
          }
        }
      }
    }
  }

  if constexpr (!BIG) {
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

// k > 32, pass 2: one block per query stages the splits' sorted lists, then
// one warp merges them: lane l holds the heads of lists l, l + 32, ...
// (HPL a lane), and each of k rounds takes the best head over the warp and
// moves the winning list's head on.
constexpr int HPL = 4;
constexpr int SPLITS_BIG = 32 * HPL;  // lists the merge warp holds

__global__ void __launch_bounds__(NTH) topk_merge_sorted_kernel(
    const float* __restrict__ ps, const int* __restrict__ pi,
    float* __restrict__ out_s, int* __restrict__ out_i, int nq, int k,
    int splits) {
  extern __shared__ float4 smem4[];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int m = splits * k;
  float* cs = reinterpret_cast<float*>(smem4);  // (splits, k) sorted lists
  int* ci = reinterpret_cast<int*>(cs + m);
  for (int e = tid; e < m; e += NTH) {
    const size_t o = ((size_t)(e / k) * nq + qi) * k + e % k;
    cs[e] = ps[o];
    ci[e] = pi[o];
  }
  __syncthreads();
  if (tid >= 32) return;
  int hp[HPL];
  float hs[HPL];
  int hi[HPL];
#pragma unroll
  for (int h = 0; h < HPL; ++h) {
    const int l = lane + 32 * h;
    hp[h] = 0;
    hs[h] = l < splits ? cs[l * k] : -INFINITY;
    hi[h] = l < splits ? ci[l * k] : NOID;
  }
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int bi = NOID;
#pragma unroll
    for (int h = 0; h < HPL; ++h)
      if (better(hs[h], hi[h], bs, bi)) {
        bs = hs[h];
        bi = hi[h];
      }
    warp_best(bs, bi);
    if (lane == 0) {
      out_s[(size_t)qi * k + j] = bs;
      out_i[(size_t)qi * k + j] = bi;
    }
    // ids are unique and the lists hold at least k real entries, so one
    // head wins
#pragma unroll
    for (int h = 0; h < HPL; ++h)
      if (hi[h] == bi && hs[h] == bs) {
        const int l = lane + 32 * h, p = ++hp[h];
        hs[h] = p < k ? cs[l * k + p] : -INFINITY;
        hi[h] = p < k ? ci[l * k + p] : NOID;
      }
  }
}

template <typename T, bool QCH, bool BIG>
cudaError_t launch_partial(const void* q, const void* c, void* ps, void* pi,
                           int nq, int n, int d, int ldc, int k, int splits,
                           int rows_per_split, int vec, const void* qn,
                           cudaStream_t s) {
  using QT = typename Route<T>::QT;
  const size_t smem = Smem<T, QCH, BIG>::bytes(d);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if constexpr (QCH) {
    topk_norm_kernel<T><<<(nq + NWARP - 1) / NWARP, NTH, 0, s>>>(
        (const float*)q, (QT*)qn, nq, d);
  }
  auto kern = topk_partial_kernel<T, QCH, BIG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((nq + QB - 1) / QB, splits);
  kern<<<grid, NTH, smem, s>>>((const float*)q, (const T*)c, (float*)ps,
                               (int*)pi, nq, n, d, ldc, k, rows_per_split,
                               vec, (const QT*)qn);
  return cudaGetLastError();
}

// The other shapes: D past one column chunk (QCH) or k past 32 (BIG), pass
// 1 (with the queries' normalisation).
template <typename T>
cudaError_t launch_wide(const void* q, const void* c, void* ps, void* pi,
                        int nq, int n, int d, int ldc, int k, int splits,
                        int rows_per_split, int vec, const void* qn,
                        cudaStream_t s) {
#define REPRO_TK_GO(QCH, BIG)                                              \
  return launch_partial<T, QCH, BIG>(q, c, ps, pi, nq, n, d, ldc, k,       \
                                     splits, rows_per_split, vec, qn, s)
  if (d <= KC) REPRO_TK_GO(false, true);
  if (k <= 32) REPRO_TK_GO(true, false);
  REPRO_TK_GO(true, true);
#undef REPRO_TK_GO
}

// k > 32, pass 2: the sorted merge.
cudaError_t launch_merge_sorted(const void* ps, const void* pi, void* out_s,
                                void* out_i, int nq, int k, int splits,
                                cudaStream_t s) {
  const size_t merge_smem = (size_t)splits * k * 8;
  if (merge_smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        topk_merge_sorted_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)merge_smem);
    if (a != cudaSuccess) return a;
  }
  topk_merge_sorted_kernel<<<nq, NTH, merge_smem, s>>>(
      (const float*)ps, (const int*)pi, (float*)out_s, (int*)out_i, nq, k,
      splits);
  return cudaGetLastError();
}

}  // namespace

// q (nq, d) fp32 queries (not normalised), contiguous; c (n, d) rows ldc
// elements apart, fp32 (dtype 0), bf16 (dtype 1) or fp16 (dtype 2); vec = 1
// when d, ldc and c's base allow 16-byte copies.  ps/pi (splits, nq, k)
// scratch; out_s/out_i (nq, k); qn, for d > KC, the normalised queries'
// scratch [parts][nq][dp] (1 part fp32 for an fp32 or fp16 corpus, 3 bf16
// for a bf16 one; dp = d padded to 8 / 16), else unused.  Split j covers
// corpus rows [j * rows_per_split, (j + 1) * rows_per_split).  k <= 1024;
// for k <= 32, splits * k <= 6144 (the merge pass's 48 KB), above,
// splits <= 128 and splits * k * 8 bytes within a block's shared memory.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int repro_topk_similarity(const void* q, const void* c, void* ps,
                                     void* pi, void* out_s, void* out_i,
                                     const void* qn, int nq, int n, int d,
                                     int ldc, int k, int splits,
                                     int rows_per_split, int vec, int dtype,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t merge_smem = (size_t)splits * k * 8;
  const bool big = k > 32;
  if (nq <= 0 || n <= 0 || d <= 0 || ldc < d || k <= 0 || k > n ||
      k > 1024 || splits <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < n ||
      merge_smem > (big ? SMEM_MAX : 48 * 1024) ||
      (big && splits > SPLITS_BIG) || (d > KC && qn == nullptr) ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
#define REPRO_TK_ARGS \
  q, c, ps, pi, nq, n, d, ldc, k, splits, rows_per_split, vec, qn, s
  cudaError_t e;
  if (d <= KC && !big)            // the configs' shapes
    e = dtype == 0   ? launch_partial<float, false, false>(REPRO_TK_ARGS)
        : dtype == 1 ? launch_partial<__nv_bfloat16, false, false>(
                           REPRO_TK_ARGS)
                     : launch_partial<__half, false, false>(REPRO_TK_ARGS);
  else
    e = dtype == 0   ? launch_wide<float>(REPRO_TK_ARGS)
        : dtype == 1 ? launch_wide<__nv_bfloat16>(REPRO_TK_ARGS)
                     : launch_wide<__half>(REPRO_TK_ARGS);
#undef REPRO_TK_ARGS
  if (e != cudaSuccess) return (int)e;
  if (big)
    return (int)launch_merge_sorted(ps, pi, out_s, out_i, nq, k, splits, s);
  topk_merge_kernel<<<nq, NTH, merge_smem, s>>>(
      (const float*)ps, (const int*)pi, (float*)out_s, (int*)out_i, nq, k,
      splits);
  return (int)cudaGetLastError();
}
