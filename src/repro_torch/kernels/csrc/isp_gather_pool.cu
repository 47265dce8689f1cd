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
// segments are dropped.  The caller zero-fills `out` (num_segments, D)
// fp32.  Each row is scaled in fp32 and rounded once before it is added,
// as the Pallas kernel does.
//
// What bounds it on an H100: bytes.  It reads the ids, the segment ids,
// the weights and each distinct in-range row once, and writes the pooled
// output once: 8n (+4n) + n_rows * D * b + num_segments * D * 4 bytes.
//
// Design:
//   * no panel and no sequential grid: blocks run in parallel in no order,
//     so sums that span warps meet in fp32 atomicAdd on the output; their
//     order changes from run to run;
//   * a warp takes one (chunk of 32 consecutive ids, slab of 64 columns)
//     item at a time (grid-stride): lane j loads id, segment and weight j
//     of the chunk and drops it if either is out of range, and each lane
//     takes two columns of the slab (8-byte fp32 or 4-byte bf16 vector
//     loads when D is even, scalar otherwise), so a 64-wide row (the
//     sentiment table) keeps all 32 lanes busy.  All 32 rows of the slab
//     are loaded before any is added, so the loads are in flight together;
//   * a run of ids with the same segment (a review's 12 words, which the
//     sentiment batch lays out consecutively) is summed in registers and
//     added to the output with one atomic per column when the segment
//     changes, not one per id;
//   * row offsets are 64-bit.
// It launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;             // warps per block
constexpr int CH = 32;            // ids per warp chunk (one per lane)
constexpr int MAX_BLOCKS = 2048;  // grid-stride beyond this
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// columns c and c + 1 of a row (c + 1 only where `two`)
template <bool PAIR>
__device__ __forceinline__ void load2(const float* p, bool two, float& a,
                                      float& b) {
  if (PAIR) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    a = v.x;
    b = v.y;
  } else {
    a = __ldg(p);
    b = two ? __ldg(p + 1) : 0.f;
  }
}
template <bool PAIR>
__device__ __forceinline__ void load2(const __nv_bfloat16* p, bool two,
                                      float& a, float& b) {
  if (PAIR) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    a = v.x;
    b = v.y;
  } else {
    a = to_f(p[0]);
    b = two ? to_f(p[1]) : 0.f;
  }
}

__device__ __forceinline__ void flush(float* out, int seg, int d, int col,
                                      float a, float b) {
  float* dst = out + (long long)seg * d + col;
  if (col < d) atomicAdd(dst, a);
  if (col + 1 < d) atomicAdd(dst + 1, b);
}

template <typename T, bool WEIGHTED, bool PAIR>
__global__ void __launch_bounds__(NW * 32) isp_gather_pool_kernel(
    const T* __restrict__ table,       // (V_loc, D)
    const int32_t* __restrict__ ids,   // (n,) global ids
    const int32_t* __restrict__ segs,  // (n,) segment ids
    const float* __restrict__ w,       // (n,) or null
    float* __restrict__ out,           // (num_segments, D), zero-filled
    long long n, long long v_loc, int d, long long off, int n_seg) {
  const int lane = threadIdx.x & 31;
  const int slabs = (d + 63) / 64;
  const long long items = (n + CH - 1) / CH * slabs;
  for (long long it = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
       it < items; it += (long long)gridDim.x * NW) {
    const long long i = it / slabs * CH + lane;
    const int col = (int)(it % slabs) * 64 + 2 * lane;
    long long row = 0;
    int seg = -1;
    float scale = 0.f;
    if (i < n) {
      const long long r = (long long)__ldg(ids + i) - off;
      const int s = __ldg(segs + i);
      if (r >= 0 && r < v_loc && s >= 0 && s < n_seg) {
        row = r;
        seg = s;
        scale = WEIGHTED ? __ldg(w + i) : 1.f;
      }
    }
    const unsigned valid = __ballot_sync(FULL, seg >= 0);
    if (valid == 0) continue;
    float x0[CH], x1[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const long long rj = __shfl_sync(FULL, row, j);
      x0[j] = x1[j] = 0.f;
      if (((valid >> j) & 1u) && col < d)
        load2<PAIR>(table + rj * d + col, col + 1 < d, x0[j], x1[j]);
    }
    float a0 = 0.f, a1 = 0.f;
    int cur = -1;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int sj = __shfl_sync(FULL, seg, j);
      const float wj = __shfl_sync(FULL, scale, j);
      if (sj < 0) continue;
      if (sj != cur) {
        if (cur >= 0) flush(out, cur, d, col, a0, a1);
        cur = sj;
        a0 = a1 = 0.f;
      }
      a0 = __fadd_rn(a0, WEIGHTED ? __fmul_rn(x0[j], wj) : x0[j]);
      a1 = __fadd_rn(a1, WEIGHTED ? __fmul_rn(x1[j], wj) : x1[j]);
    }
    if (cur >= 0) flush(out, cur, d, col, a0, a1);
  }
}

template <typename T, bool WEIGHTED>
void launch_w(const void* table, const void* ids, const void* segs,
              const void* w, void* out, long long n, long long v_loc, int d,
              long long off, int n_seg, cudaStream_t s) {
  const long long items = (n + CH - 1) / CH * ((d + 63) / 64);
  const long long want = (items + NW - 1) / NW;
  const dim3 grid((unsigned)(want < MAX_BLOCKS ? want : MAX_BLOCKS));
  // two columns load as one vector when every row starts 2-element aligned
  const bool pair = d % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(table) % (2 * sizeof(T))) == 0;
  if (pair)
    isp_gather_pool_kernel<T, WEIGHTED, true><<<grid, NW * 32, 0, s>>>(
        (const T*)table, (const int32_t*)ids, (const int32_t*)segs,
        (const float*)w, (float*)out, n, v_loc, d, off, n_seg);
  else
    isp_gather_pool_kernel<T, WEIGHTED, false><<<grid, NW * 32, 0, s>>>(
        (const T*)table, (const int32_t*)ids, (const int32_t*)segs,
        (const float*)w, (float*)out, n, v_loc, d, off, n_seg);
}

template <typename T>
cudaError_t launch(const void* table, const void* ids, const void* segs,
                   const void* w, void* out, long long n, long long v_loc,
                   int d, long long off, int n_seg, cudaStream_t s) {
  if (w != nullptr)
    launch_w<T, true>(table, ids, segs, w, out, n, v_loc, d, off, n_seg, s);
  else
    launch_w<T, false>(table, ids, segs, w, out, n, v_loc, d, off, n_seg, s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  weights may be null.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int repro_isp_gather_pool(const void* table, const void* ids,
                                     const void* segs, const void* weights,
                                     void* out, long long n, long long v_loc,
                                     int d, long long off, int n_seg,
                                     int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0 || n_seg <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(table, ids, segs, weights, out, n, v_loc, d,
                              off, n_seg, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(table, ids, segs, weights, out, n,
                                      v_loc, d, off, n_seg, s);
  return (int)cudaErrorInvalidValue;
}
