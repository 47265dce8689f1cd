// Cosine-similarity top-k over a corpus: the recommender's hot spot, where
// only (k scores, k ids) per query leave the corpus's device.
//
// Replaces: src/repro/kernels/topk_similarity.py::topk_similarity (the
// Pallas `_kernel`, grid (query blocks, corpus tiles) with the corpus axis
// sequential, a (qb, ct) MXU product per tile and a running top-k in VMEM
// scratch merged by k rounds of max-extract).
//
// Inputs are L2-normalised fp32 (the wrapper normalises, as the Pallas
// wrapper does outside its kernel) and padded with zero columns to a width
// Dp that 4 divides.  For each query it finds the k best (score, id) pairs
// of s = q . c over the corpus rows, in the order: higher score first, and
// on equal scores the lower id first (jax.lax.top_k's order).
//
// What bounds it on an H100: operations.  Q * N * Dp fp32 multiply-adds on
// the CUDA cores (2QND flops at 67 TFLOP/s) against reading the corpus
// once (4ND bytes at 3.35 TB/s): at the recommender's D = 128 the product
// is Q/2 flops a byte, above the fp32 ridge (20 flops a byte) for any
// Q > 40.
//
// Design (fp32 CUDA cores; tensor cores and TMA are later work):
//   * pass 1, grid (query blocks of QB = 64, corpus splits): a block stages
//     its 64 queries in shared memory once, then streams its split of the
//     corpus through shared memory in tiles of CT = 64 rows.  Warp w owns
//     queries 8w..8w+7 and lane l rows l and l + 32 of each tile: per step
//     of 4 columns a lane reads 2 row vectors and 8 query vectors (warp
//     broadcasts) from shared memory and does 64 FMAs, which keeps the
//     FMA units and shared memory equally busy.  The row stride is padded
//     to an odd number of 16-byte groups so the row reads do not conflict;
//   * each warp keeps, per query, its running top-k spread over its lanes
//     (lane j holds entry j, k <= 32), with the k-th entry, warp-uniform,
//     as the threshold.  After a tile a ballot finds the lanes whose score
//     beats it (rarely more than a few once the list has filled), and each
//     is inserted in one step: a ballot for its rank, a shuffle down;
//   * rows at or past the split's end (and N) are never candidates;
//   * pass 2, one block per query: the splits' partial lists are staged in
//     shared memory, then k rounds of a block arg-best, each round taking
//     the best entry below the previous winner in the (score, id) order.
//     Splitting the corpus gives Q = 50 (one query block) enough blocks to
//     fill 132 SMs.
// Both passes launch on the caller's stream; the wrapper allocates the
// partial lists.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARP = 8;           // warps per block
constexpr int TQ = 8;              // queries per warp
constexpr int QB = NWARP * TQ;     // queries per block
constexpr int CT = 64;             // corpus rows per shared-memory tile
constexpr int NOID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// (s, i) ranks above (t, j): higher score, or the lower id on equal scores
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// row stride in floats: an odd number of 16-byte groups past Dp
__host__ __device__ __forceinline__ int row_stride(int dp) {
  const int g = dp / 4;
  return 4 * (g + 1 + (g & 1));
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

__global__ void __launch_bounds__(NWARP * 32) topk_partial_kernel(
    const float* __restrict__ q,  // (Q, Dp) normalised
    const float* __restrict__ c,  // (N, Dp) normalised
    float* __restrict__ ps,       // (splits, Q, k) partial scores
    int* __restrict__ pi,         // (splits, Q, k) partial ids
    int nq, int n, int dp, int k, int rows_per_split) {
  extern __shared__ float4 smem4[];
  const int ld4 = row_stride(dp) / 4;
  const int d4 = dp / 4;
  float4* sq = smem4;             // (QB, ld4)
  float4* sc = smem4 + QB * ld4;  // (CT, ld4)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);

  for (int e = tid; e < QB * d4; e += NWARP * 32) {
    const int r = e / d4, col = e % d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < nq)
      v = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * dp) +
                col);
    sq[r * ld4 + col] = v;
  }

  float ls[TQ], ts[TQ];
  int li[TQ], ti[TQ];
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    ls[t] = ts[t] = -INFINITY;
    li[t] = ti[t] = NOID;
  }
  const float4* qw = sq + warp * TQ * ld4;
  const float4* c0 = sc + lane * ld4;
  const float4* c1 = sc + (lane + 32) * ld4;

  for (int tile = r_begin; tile < r_end; tile += CT) {
    __syncthreads();  // the queries are staged / the last tile is used up
    for (int e = tid; e < CT * d4; e += NWARP * 32) {
      const int r = e / d4, col = e % d4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tile + r < r_end)
        v = __ldg(reinterpret_cast<const float4*>(c + (size_t)(tile + r) *
                                                          dp) + col);
      sc[r * ld4 + col] = v;
    }
    __syncthreads();
    float a0[TQ], a1[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) a0[t] = a1[t] = 0.f;
#pragma unroll 2
    for (int j = 0; j < d4; ++j) {
      const float4 x0 = c0[j], x1 = c1[j];
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const float4 y = qw[t * ld4 + j];
        a0[t] = fmaf(y.x, x0.x, a0[t]);
        a0[t] = fmaf(y.y, x0.y, a0[t]);
        a0[t] = fmaf(y.z, x0.z, a0[t]);
        a0[t] = fmaf(y.w, x0.w, a0[t]);
        a1[t] = fmaf(y.x, x1.x, a1[t]);
        a1[t] = fmaf(y.y, x1.y, a1[t]);
        a1[t] = fmaf(y.z, x1.z, a1[t]);
        a1[t] = fmaf(y.w, x1.w, a1[t]);
      }
    }
    const int r0 = tile + lane, r1 = tile + lane + 32;
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      offer(a0[t], r0, r0 < r_end, ls[t], li[t], ts[t], ti[t], k, lane);
      offer(a1[t], r1, r1 < r_end, ls[t], li[t], ts[t], ti[t], k, lane);
    }
  }

#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    const int qi = q0 + warp * TQ + t;
    if (qi < nq && lane < k) {
      const size_t o = ((size_t)split * nq + qi) * k + lane;
      ps[o] = ls[t];
      pi[o] = li[t];
    }
  }
}

__global__ void __launch_bounds__(NWARP * 32) topk_merge_kernel(
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
  for (int e = tid; e < m; e += NWARP * 32) {
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
    for (int e = tid; e < m; e += NWARP * 32) {
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

}  // namespace

// q (nq, dp) and c (n, dp) normalised fp32, dp % 4 == 0, 16-byte aligned;
// ps/pi (splits, nq, k) scratch; out_s/out_i (nq, k).  Split j covers
// corpus rows [j * rows_per_split, (j + 1) * rows_per_split).  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int repro_topk_similarity(const void* q, const void* c, void* ps,
                                     void* pi, void* out_s, void* out_i,
                                     int nq, int n, int dp, int k, int splits,
                                     int rows_per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)(QB + CT) * row_stride(dp) * sizeof(float);
  const size_t merge_smem = (size_t)splits * k * 8;
  if (nq <= 0 || n <= 0 || dp <= 0 || dp % 4 != 0 || k <= 0 || k > n ||
      k > 32 || splits <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < n || smem > 232448 ||
      merge_smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((nq + QB - 1) / QB, splits);
  topk_partial_kernel<<<grid, NWARP * 32, smem, s>>>(
      (const float*)q, (const float*)c, (float*)ps, (int*)pi, nq, n, dp, k,
      rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<nq, NWARP * 32, merge_smem, s>>>(
      (const float*)ps, (const int*)pi, (float*)out_s, (int*)out_i, nq, k,
      splits);
  return (int)cudaGetLastError();
}
