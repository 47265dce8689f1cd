// Fused gather + weighted segment sum of a vocabulary table: the RecSSD
// embedding bag, where indexes travel to the table shard and only pooled
// rows come back.
//
// Replaces: src/repro/kernels/isp_gather.py::isp_gather_pool (the Pallas
// `_gather_pool_kernel`, grid (index blocks, D blocks) with the index axis
// sequential, a (V_loc, 512) panel of the table pinned in VMEM and the
// (num_segments, 512) output block accumulated across the index blocks).
//
// For n global ids it adds w_i * table[id_i - off] (fp32) into
// out[seg_i] wherever off <= id_i < off + V_loc and
// 0 <= seg_i < num_segments; other ids (other shards, -1 pads) and other
// segments are dropped.  Every element of `out` (num_segments, D) fp32 is
// written by the kernel: segments no id reaches are 0.  Each row is scaled
// in fp32 before it is added, as the Pallas kernel does.
//
// What bounds it on an H100: bytes.  It reads the ids, the segment ids,
// the weights and each distinct in-range row once, and writes the pooled
// output once: 8n (+4n) + n_rows * D * b + num_segments * D * 4 bytes.  At
// the sentiment batch's 0.0045 ms bound, and one shard's 0.0004 ms, the
// fixed cost of a launch is most of any call.
//
// Design:
//   * one device operation a call: a cooperative launch (no larger than
//     the blocks that fit on the card at once) zero-fills `out` with
//     16-byte stores, stages its first range of ids while those drain,
//     syncs the grid, then accumulates; the fill lands in L2 where the
//     atomics find it, and the wrapper allocates `out` uninitialised;
//   * a block takes a contiguous range of `span` ids at a time (grid-
//     stride) and stages the range's valid ids — shard row, segment,
//     weight — in shared memory once, in order, dropping the others (each
//     thread loads a few consecutive ids at once, then one block scan of
//     the counts); its threads form groups of `group` lanes, each group
//     takes an equal contiguous share of the staged ids and each lane four
//     columns of a row (a slab of group * 4 columns at a time, for every
//     slab of the row, from the one staging);
//   * a lane sums each run of equal segment ids of its share in fp32
//     registers and adds the run once, by one 16-byte `atomicAdd` on a
//     float4 (sm_90): a sentiment review's 12 ids are one add a column
//     group, not twelve.  Unsorted segments stay right: each run still adds
//     once; a run cut by a share's edge adds once on each side;
//   * rows load as 16-byte (fp32) or 8-byte (bf16, fp16) vectors of four
//     columns, UNROLL rows in flight a lane; a D that four does not
//     divide, or a table not aligned to four elements, takes the scalar
//     path (one column a lane, scalar loads and atomics);
//   * row offsets are 64-bit.
// What holds it at the sentiment batch (480,000 ids, 40,000 reviews): the
// launch, the fill and the grid sync are about a third of a call; the walk
// over the staged ids, the rest, splits about evenly between the table
// loads and the per-id work of a lane (shared-memory reads, compares, fp32
// adds), the atomics a small part.  More columns a lane (fewer lanes a
// row) made the walk slower, not faster.
// The plan (span, group, vectors or scalars) is `isp_gather.pool_plan`,
// from shapes and the SM count only.  It launches on the caller's stream
// and allocates nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // threads per block (POOL_THREADS)
constexpr int NWARP = THREADS / 32;
constexpr int MIN_BLOCKS = 4;     // resident blocks an SM (64 registers)
constexpr int SPAN_MAX = 1024;    // ids a range (POOL_SPAN_MAX)
constexpr int UNROLL = 8;         // rows a lane has in flight
constexpr int FILL_PER_THREAD = 4;  // zero-fill stores a thread, at least
constexpr unsigned FULL = 0xffffffffu;

template <int C>
struct Cols {
  float v[C];
};

// the C columns of a lane, as fp32: one 16-byte (fp32) or 8-byte (bf16,
// fp16) load of four, or one element
template <int C>
__device__ __forceinline__ Cols<C> load_cols(const float* p) {
  Cols<C> x;
  if constexpr (C == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x.v[0] = f.x;
    x.v[1] = f.y;
    x.v[2] = f.z;
    x.v[3] = f.w;
  } else {
    x.v[0] = __ldg(p);
  }
  return x;
}
template <int C>
__device__ __forceinline__ Cols<C> load_cols(const __nv_bfloat16* p) {
  Cols<C> x;
  if constexpr (C == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x.v[0] = a.x;
    x.v[1] = a.y;
    x.v[2] = b.x;
    x.v[3] = b.y;
  } else {
    x.v[0] = __bfloat162float(*p);
  }
  return x;
}
template <int C>
__device__ __forceinline__ Cols<C> load_cols(const __half* p) {
  Cols<C> x;
  if constexpr (C == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    x.v[0] = a.x;
    x.v[1] = a.y;
    x.v[2] = b.x;
    x.v[3] = b.y;
  } else {
    x.v[0] = __half2float(*p);
  }
  return x;
}

// one 16-byte atomicAdd on a float4 (sm_90), or one scalar
template <int C>
__device__ __forceinline__ void add_cols(float* dst, const Cols<C>& a) {
  if constexpr (C == 4)
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  else
    atomicAdd(dst, a.v[0]);
}

// Stages range r's valid ids (in the shard, segment in [0, n_seg)) in
// order into s_row / s_seg / s_w and returns how many there are.  Thread t
// loads ids t * per .. t * per + per - 1 of the range, all at once, and one
// block-wide scan of the counts places them.  Called by the whole block.
template <bool WEIGHTED>
__device__ __forceinline__ int stage(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ segs,
    const float* __restrict__ w, long long n, int v_loc, long long off,
    int n_seg, int span, long long r, int* s_row, int* s_seg, float* s_w,
    int* s_cnt) {
  constexpr int KMAX = SPAN_MAX / THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = span > THREADS ? span / THREADS : 1;
  int row[KMAX], sg[KMAX];
  float wt[KMAX];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int p = tid * per + k;
    const long long i = r * span + p;
    row[k] = -1;
    if (k < per && p < span && i < n) {
      const long long rr = (long long)__ldg(ids + i) - off;
      sg[k] = __ldg(segs + i);
      wt[k] = WEIGHTED ? __ldg(w + i) : 1.f;
      if (rr >= 0 && rr < v_loc && sg[k] >= 0 && sg[k] < n_seg) {
        row[k] = (int)rr;
        ++cnt;
      }
    }
  }
  int incl = cnt;  // inclusive scan of the counts within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) s_cnt[warp] = incl;
  __syncthreads();
  int pos = incl - cnt, m = 0;
#pragma unroll
  for (int q = 0; q < NWARP; ++q) {
    const int c = s_cnt[q];
    pos += q < warp ? c : 0;
    m += c;
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (row[k] >= 0) {
      s_row[pos] = row[k];
      s_seg[pos] = sg[k];
      s_w[pos] = wt[k];
      ++pos;
    }
  }
  __syncthreads();
  return m;
}

template <typename T, bool WEIGHTED, int C>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) isp_gather_pool_kernel(
    const T* __restrict__ table,       // (V_loc, D)
    const int32_t* __restrict__ ids,   // (n,) global ids
    const int32_t* __restrict__ segs,  // (n,) segment ids
    const float* __restrict__ w,       // (n,) or null
    float* __restrict__ out,           // (num_segments, D)
    long long n, int v_loc, int d, long long off, int n_seg, int span,
    int group) {
  __shared__ int s_row[SPAN_MAX];
  __shared__ int s_seg[SPAN_MAX];
  __shared__ float s_w[SPAN_MAX];
  __shared__ int s_cnt[NWARP];
  const int tid = threadIdx.x;

  // 1. every element of out to 0; the block's first range is staged while
  // those stores drain, then the whole grid waits
  {
    const long long total = (long long)n_seg * d / C;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long e = (long long)blockIdx.x * THREADS + tid; e < total;
         e += stride) {
      if constexpr (C == 4)
        reinterpret_cast<float4*>(out)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        out[e] = 0.f;
    }
  }
  const long long ranges = (n + span - 1) / span;
  long long r = blockIdx.x;
  int m = r < ranges ? stage<WEIGHTED>(ids, segs, w, n, v_loc, off, n_seg,
                                       span, r, s_row, s_seg, s_w, s_cnt)
                     : 0;
  cooperative_groups::this_grid().sync();

  const int lanes = d / C;  // lanes a row needs
  const int groups = THREADS / group;
  const int slabs = (lanes + group - 1) / group;
  const int g = tid / group, gl = tid % group;
  for (; r < ranges; r += gridDim.x) {
    // 2. the range's valid ids (the first range's are staged already)
    if (r != blockIdx.x)
      m = stage<WEIGHTED>(ids, segs, w, n, v_loc, off, n_seg, span, r, s_row,
                          s_seg, s_w, s_cnt);
    // 3. each group sums the runs of its share, one atomic add a run
    const int share = (m + groups - 1) / groups;
    const int lo = min(m, g * share), hi = min(m, lo + share);
    if (g < groups) {
      for (int sl = 0; sl < slabs; ++sl) {
        const int lc = sl * group + gl;
        if (lc >= lanes || lo >= hi) break;
        const int col = lc * C;
        Cols<C> acc;
#pragma unroll
        for (int c = 0; c < C; ++c) acc.v[c] = 0.f;
        int cur = -1;
        for (int j0 = lo; j0 < hi; j0 += UNROLL) {
          Cols<C> x[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
            for (int c = 0; c < C; ++c) x[u].v[c] = 0.f;
            if (j0 + u < hi)
              x[u] = load_cols<C>(table + (long long)s_row[j0 + u] * d + col);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int j = j0 + u;
            if (j >= hi) break;
            const int sj = s_seg[j];
            if (sj != cur) {
              if (cur >= 0) add_cols<C>(out + (long long)cur * d + col, acc);
              cur = sj;
#pragma unroll
              for (int c = 0; c < C; ++c) acc.v[c] = 0.f;
            }
            const float wj = s_w[j];
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc.v[c] = __fadd_rn(
                  acc.v[c], WEIGHTED ? __fmul_rn(x[u].v[c], wj) : x[u].v[c]);
          }
        }
        add_cols<C>(out + (long long)cur * d + col, acc);
      }
    }
    __syncthreads();  // the next range overwrites the staging
  }
}

// Blocks of `kern` that fit on the current device at once: the most a
// cooperative launch may have.
template <typename Kernel>
cudaError_t coop_blocks(Kernel kern, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      0);
  if (e != cudaSuccess) return e;
  if (!coop || per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T, bool WEIGHTED, int C>
cudaError_t launch_c(const void* table_, const void* ids_, const void* segs_,
                     const void* w_, void* out_, long long n, int v_loc,
                     int d, long long off, int n_seg, int span, int group,
                     cudaStream_t s) {
  auto kern = isp_gather_pool_kernel<T, WEIGHTED, C>;
  static int max_blocks = 0;  // asked once per instantiation
  if (max_blocks == 0) {
    const cudaError_t e = coop_blocks(kern, &max_blocks);
    if (e != cudaSuccess) return e;
  }
  // a block a range, and at least enough blocks that the zero-fill takes
  // FILL_PER_THREAD 16-byte stores a thread; no more than fit at once
  const long long ranges = (n + span - 1) / span;
  const long long fill =
      ((long long)n_seg * d / 4 + FILL_PER_THREAD * THREADS - 1) /
      (FILL_PER_THREAD * THREADS);
  long long want = ranges > fill ? ranges : fill;
  want = want < 1 ? 1 : want;
  const int grid = (int)(want < max_blocks ? want : max_blocks);
  const T* table = (const T*)table_;
  const int32_t* ids = (const int32_t*)ids_;
  const int32_t* segs = (const int32_t*)segs_;
  const float* w = (const float*)w_;
  float* out = (float*)out_;
  void* args[] = {&table, &ids, &segs, &w, &out, &n, &v_loc,
                  &d, &off, &n_seg, &span, &group};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                     dim3(THREADS), args, 0, s);
}

template <typename T>
cudaError_t launch(const void* table, const void* ids, const void* segs,
                   const void* w, void* out, long long n, int v_loc, int d,
                   long long off, int n_seg, int span, int group, int cols,
                   cudaStream_t s) {
  // four columns load as one 16-byte (fp32) or 8-byte (bf16, fp16) vector;
  // the zero-fill and the adds are 16-byte
  if (cols == 4 && (d % 4 || (uintptr_t)table % (4 * sizeof(T)) ||
                    (uintptr_t)out % 16))
    return cudaErrorInvalidValue;
#define POOL_CASE(W, C)                                                     \
  if ((w != nullptr) == W && cols == C)                                     \
    return launch_c<T, W, C>(table, ids, segs, w, out, n, v_loc, d, off,    \
                             n_seg, span, group, s);
  POOL_CASE(true, 4) POOL_CASE(true, 1) POOL_CASE(false, 4)
  POOL_CASE(false, 1)
#undef POOL_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  weights may be null; n
// may be 0 (out is then only zero-filled).  span: ids a range (<= 1024);
// group: lanes a group (<= 256); cols: columns a lane (4 or 1).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int repro_isp_gather_pool(const void* table, const void* ids,
                                     const void* segs, const void* weights,
                                     void* out, long long n, long long v_loc,
                                     int d, long long off, int n_seg,
                                     int span, int group, int cols, int dtype,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 0 || d <= 0 || n_seg <= 0 || v_loc < 0 || v_loc > 0x7fffffffLL ||
      span < 1 || span > SPAN_MAX || (span > THREADS && span % THREADS) ||
      group < 1 || group > THREADS)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(table, ids, segs, weights, out, n, (int)v_loc,
                              d, off, n_seg, span, group, cols, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(table, ids, segs, weights, out, n,
                                      (int)v_loc, d, off, n_seg, span, group,
                                      cols, s);
  if (dtype == 2)
    return (int)launch<__half>(table, ids, segs, weights, out, n, (int)v_loc,
                               d, off, n_seg, span, group, cols, s);
  return (int)cudaErrorInvalidValue;
}
