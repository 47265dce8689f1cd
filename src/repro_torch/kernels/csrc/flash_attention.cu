// Forward blocked attention with an online softmax (causal, optional sliding
// window, q_offset, GQA), output in the input dtype.  The q/k head dim DQK
// and the v/out head dim DV are separate template parameters: (64, 64),
// (128, 128) and (240, 240) for the GQA families, (192, 128) for
// deepseek-v2's MLA prefill (128 nope + 64 rope dims against 128 value
// dims), as the op's contract allows (k/v (B, Skv, Hkv, dh[v])); (16, 16)
// and (24, 16) for the reduced (smoke) configs, whose head dim is 16 and
// whose reduced MLA attends at 16 nope + 8 rope dims against 16.  Every
// other uniform head dim from 1 to 256 (phi-2's 80, phi-3-mini's 96,
// gemma-2's 256, an odd 37) runs on a class instantiation (RT = true): the
// tiles are those of a class width C (32, 64, 96, 128, 160, 192 or 256, the
// least C >= dh), the real dh comes at run time for the row strides, the
// loads and the stores, and the columns dh..C of the staged Q, K and V are
// zero, so they add nothing to a dot product and nothing is stored past
// dh.  Rows whose dh is a multiple of 8 are copied by 16-byte cp.async as
// above; any other dh (rows not 16-byte aligned) takes element loads in
// the same kernel.  Unequal pairs other than the two above are refused, as
// the reference refuses them.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas `_kernel`, grid (B, Hkv, G, nq, nk) with VMEM scratch carried
// across the kv axis).
//
// What bounds it on an H100: operations.  At the prefill shapes (S = 704,
// dh = 128 for yi-9b; S up to 1536, dh = 240, window 1024 for gemma3-12b)
// a causal call does ~S/2 * 4 * dh flops per query row against
// 4 * dh bytes of q/out per row, thousands of flops per byte.
//
// Two kernels, picked by dtype (both hand-written; neither falls back to
// the other):
//
// bf16 and fp16: flash_fwd_tc<T>, FlashAttention-2 on the tensor cores,
// one template over the element type T (Tc<T>: the MMA's operand type and
// the roundings; fp16 runs at the bf16 peak).
//   * one block of 4 warps per (64-row q tile, q head, batch row); each
//     warp owns 16 q rows; heavy (late causal) q tiles are launched first;
//   * Q.K^T and P.V run on mma.sync.m16n8k16 with T inputs and fp32
//     accumulation, the operands fed by ldmatrix (V by ldmatrix.trans);
//   * K/V tiles of BK keys (64, or 32 above DQK 128) are staged in T by
//     16-byte cp.async, double buffered; rows are padded by 8 elements so
//     ldmatrix's eight 16-byte rows fall in distinct banks;
//   * Q stays in registers up to DQK 128; above (192, 240) its fragments
//     are read from shared memory at every k-step (the O accumulator alone
//     is 120 registers a thread at DV 240);
//   * the online softmax runs on the accumulator fragments (row max and
//     sum over the quad's shuffles); P is rounded to T in registers and
//     becomes the A operand of P.V with no trip through shared memory (in
//     fp16 P in [0, 1] keeps 10 mantissa bits against bf16's 7; a p below
//     2^-24 rounds to 0, an absolute error under 2^-25 a key);
//   * tiles wholly outside the causal / window band are never visited, and
//     element masks apply only on the tiles that a band edge or Skv crosses;
//   * a DQK that is not a multiple of the MMA's k of 16 (24) is padded to
//     the next one (DQK_P, 32) in shared memory: the Q and K copies of the
//     pad columns take cp.async's zero-fill form, and zero columns add
//     nothing to a dot product.  DV must be a multiple of 16 (O's n8 tiles
//     are read in pairs by ldmatrix.x4.trans).  The padded row pitches
//     (DQK_P + 8 and DV + 8 elements: 48 and 80 bytes at 16 and 32) keep
//     ldmatrix's rows 16-byte aligned and their eight rows in distinct
//     banks.
// fp32: flash_fwd_fma, the CUDA-core kernel (TF32 products would not stay
//   within the fp32 tolerance the port holds its kernels to):
//   * one block per (64-row q tile, q head, batch row); four threads per
//     query row, each owning a quarter of the head dims, in float4 groups
//     where the dim is a multiple of 16 and in float2 groups otherwise (a
//     DQK of 24: three float2 groups a thread), chosen for q/k and v/out
//     each;
//   * K/V tiles of 32 keys (16 above DQK 128) staged in shared memory and
//     shared by the block's 64 rows.
// Both: GQA maps q head h to kv head h / G, so no KV head is repeated in
// memory; masked keys contribute p = 0 (scores of -1e30); the l == 0 -> 1
// guard stays.
//
// lse: given a non-null pointer, each (b, q row, h) also writes the row's
// log-sum-exp of its scaled scores, m + log(l), in natural-log units and
// fp32 into lse (B, Sq, H): what the training path's backward recomputes
// the probabilities from, p = exp(s - lse).  The tensor-core kernel keeps
// m in log-2 units with the scale folded in, so the write converts once
// (m * ln 2 + log l).  A row that sees no key (only at a q_offset or
// window edge, never in causal training from position 0) has l = 0 and
// output 0; its lse is +inf, so that every p of the backward is 0 and the
// row's gradient is that of its output, 0.  (The plain version follows
// the reference, whose masked scores count in l there: its lse is -1e30
// and its output the mean of the visited values.)  With a null pointer
// nothing else changes.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows per block

// ------------------------------------------------------- bf16 and fp16 ---

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = fill ? 16 : 0;    // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The tensor-core kernel's two element types: per type its MMA
// (d (16x8 fp32) += a (16x16, row) * b (16x8, col), fp32 accumulation) and
// its round-to-nearest conversions of one value and of a pair.
template <typename T>
struct Tc;
template <>
struct Tc<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Tc<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ __half one(float x) {
    return __float2half_rn(x);
  }
};

// two fp32 values rounded to T and packed as one MMA operand register
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const typename Tc<T>::T2 h = Tc<T>::pair(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DQK, int DV>
struct TcShape {
  static_assert(DQK % 8 == 0 && DV % 16 == 0, "head dims the tiles take");
  static constexpr int DQK_P = (DQK + 15) / 16 * 16;  // DQK padded to k 16
  static constexpr int BK = DQK > 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int LD = DQK_P + 8;            // padded Q/K smem row
  static constexpr int LDV = DV + 8;              // padded V smem row
  static constexpr bool QREG = DQK <= 128;        // Q fragments in regs
  static constexpr int KSTEPS = DQK_P / 16;       // k-steps of Q.K^T
  static constexpr int NT_O = DV / 8;             // n-tiles of O
  static constexpr int NT_S = BK / 8;             // n-tiles of S
  // 16-byte copies a Q/K row, the zero-filled pad columns included
  static constexpr int CPR = DQK_P / 8;
  static constexpr int CPR_V = DV / 8;            // 16-byte copies a V row
  static constexpr int STAGE = BK * (LD + LDV);   // one K + V stage
  static constexpr size_t SMEM =
      (size_t)(BQ * LD + 2 * STAGE) * 2;   // 16-bit elements
};

template <typename T, int DQK, int DV, bool RT = false>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_tc(
    const T* __restrict__ q,   // (B, Sq, H, DQK)
    const T* __restrict__ k,   // (B, Skv, Hkv, DQK)
    const T* __restrict__ v,   // (B, Skv, Hkv, DV)
    T* __restrict__ out,       // (B, Sq, H, DV)
    float* __restrict__ lse,   // (B, Sq, H) or null
    int Sq, int Skv, int H, int Hkv, int causal, int window, int q_offset,
    float scale_log2, int dr) {
  // RT: DQK == DV is a class width and dr <= DQK the head dim of q, k, v
  // and out in memory; otherwise dr is not read
  using S = TcShape<DQK, DV>;
  using E = Tc<T>;
  static_assert(!RT || DQK == DV, "class instantiations are uniform");
  const int dq = RT ? dr : DQK, dvr = RT ? dr : DV;   // dims in memory
  constexpr int BK = S::BK, LD = S::LD, LDV = S::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* sq = smem;                   // [BQ][LD]
  T* skv = smem + BQ * LD;        // [2][K [BK][LD], V [BK][LDV]]

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;      // heavy tiles first
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * BQ;

  // keys any row of this tile may see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal && q_hi + 1 < kv_end) kv_end = q_hi + 1;
  int kv_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kv_begin = q_lo - window + 1;
  kv_begin = (kv_begin / BK) * BK;

  const size_t q_row = (size_t)H * dq, k_row = (size_t)Hkv * dq;
  const size_t v_row = (size_t)Hkv * dvr, o_row = (size_t)H * dvr;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * dq;
  const T* kb = k + (size_t)b * Skv * k_row + (size_t)hk * dq;
  const T* vb = v + (size_t)b * Skv * v_row + (size_t)hk * dvr;
  [[maybe_unused]] const T zero = E::one(0.f);
  const bool vec = !RT || dr % 8 == 0;  // rows 16-byte aligned

  // Q tile; rows past Sq and pad columns past DQK (dr) are zero-filled
  if (vec) {
    for (int i = tid; i < BQ * S::CPR; i += TC_THREADS) {
      const int r = i / S::CPR, c = (i - r * S::CPR) * 8;
      const bool in = q0 + r < Sq && (RT ? c < dr
                                         : (S::DQK_P == DQK || c < DQK));
      cp_async16(sq + r * LD + c,
                 qb + (in ? (size_t)(q0 + r) * q_row + c : 0), in);
    }
  } else if constexpr (RT) {
    for (int i = tid; i < BQ * DQK; i += TC_THREADS) {
      const int r = i / DQK, c = i - r * DQK;
      sq[r * LD + c] =
          q0 + r < Sq && c < dr ? qb[(size_t)(q0 + r) * q_row + c] : zero;
    }
  }
  auto load_kv = [&](int k0, int st) {
    T* ks = skv + st * S::STAGE;
    T* vs = ks + BK * LD;
    if constexpr (RT) {           // K and V rows of dr elements, one stride
      if (vec) {
        for (int i = tid; i < BK * S::CPR; i += TC_THREADS) {
          const int r = i / S::CPR, c = (i - r * S::CPR) * 8;
          const bool in = k0 + r < Skv && c < dr;
          const size_t off = in ? (size_t)(k0 + r) * k_row + c : 0;
          cp_async16(ks + r * LD + c, kb + off, in);
          cp_async16(vs + r * LDV + c, vb + off, in);
        }
      } else {
        for (int i = tid; i < BK * DQK; i += TC_THREADS) {
          const int r = i / DQK, c = i - r * DQK;
          const bool in = k0 + r < Skv && c < dr;
          const size_t off = (size_t)(k0 + r) * k_row + c;
          ks[r * LD + c] = in ? kb[off] : zero;
          vs[r * LDV + c] = in ? vb[off] : zero;
        }
      }
    } else if constexpr (DQK == DV && S::DQK_P == DQK) {
      // equal head dims keep the one loop of K and V rows they had before
      // the split, so their instantiations compile as they did
      for (int i = tid; i < BK * S::CPR; i += TC_THREADS) {
        const int r = i / S::CPR, c = (i - r * S::CPR) * 8;
        const bool in = k0 + r < Skv;
        const size_t off = in ? (size_t)(k0 + r) * k_row + c : 0;
        cp_async16(ks + r * LD + c, kb + off, in);
        cp_async16(vs + r * LD + c, vb + off, in);
      }
    } else {
      for (int i = tid; i < BK * S::CPR; i += TC_THREADS) {
        const int r = i / S::CPR, c = (i - r * S::CPR) * 8;
        const bool in = k0 + r < Skv && (S::DQK_P == DQK || c < DQK);
        cp_async16(ks + r * LD + c,
                   kb + (in ? (size_t)(k0 + r) * k_row + c : 0), in);
      }
      for (int i = tid; i < BK * S::CPR_V; i += TC_THREADS) {
        const int r = i / S::CPR_V, c = (i - r * S::CPR_V) * 8;
        const bool in = k0 + r < Skv;
        cp_async16(vs + r * LDV + c,
                   vb + (in ? (size_t)(k0 + r) * v_row + c : 0), in);
      }
    }
  };
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();

  const int g = lane >> 2, tg = lane & 3;   // mma fragment coordinates
  const int wrow = warp * 16;               // this warp's first q row
  uint32_t qf[S::QREG ? S::KSTEPS : 1][4];
  float o[S::NT_O][4];
#pragma unroll
  for (int n = 0; n < S::NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8
  // absolute positions of this thread's two rows
  const int qpos0 = q_lo + wrow + g, qpos1 = qpos0 + 8;

  int it = 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK, ++it) {
    if (k0 + BK < kv_end) load_kv(k0 + BK, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (S::QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < S::KSTEPS; ++kk)
          ldmatrix_x4(qf[kk], sq + (wrow + (lane & 15)) * LD + kk * 16 +
                                  (lane >> 4) * 8);
      }
    }
    const T* ks = skv + (it & 1) * S::STAGE;
    const T* vs = ks + BK * LD;

    // S = Q K^T (16 x BK per warp)
    float s[S::NT_S][4];
#pragma unroll
    for (int n = 0; n < S::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
      uint32_t a[4];
      if constexpr (S::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, sq + (wrow + (lane & 15)) * LD + kk * 16 +
                           (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < S::NT_S / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        E::mma(s[2 * np], a, bf[0], bf[1]);
        E::mma(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // scale into the log2 domain; element masks only where a band edge or
    // Skv crosses the tile
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q_lo) ||
                      (window > 0 && k0 <= q_hi - window);
#pragma unroll
    for (int n = 0; n < S::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kp = k0 + n * 8 + 2 * tg + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          const bool ok = kp < Skv && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }

    // online softmax on the fragments: row max over the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < S::NT_S; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < S::NT_O; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < S::NT_S; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = s[n][e] == kNegInf ? 0.f : exp2f(s[n][e] - m_new);
          l[r] += p;
          s[n][e] = p;
        }
    }

    // O += P V: P's fragments become the A operand in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < S::NT_O / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LDV +
                                  dp * 16 + (lane >> 4) * 8);
        E::mma(o[2 * dp], a, bf[0], bf[1]);
        E::mma(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();              // this stage consumed before reuse
  }
  cp_async_wait<0>();             // no copy outlives the block

  // row sums over the quad, normalise, store pairs of T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wrow + g + 8 * r;
    if (qi >= Sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    if (lse != nullptr && tg == 0)
      lse[((size_t)b * Sq + qi) * H + h] =
          l[r] == 0.f ? __int_as_float(0x7f800000)
                      : m[r] * 0.6931471805599453f + logf(l[r]);
    T* ob = out + ((size_t)b * Sq + qi) * o_row + (size_t)h * dvr;
#pragma unroll
    for (int n = 0; n < S::NT_O; ++n) {
      const int col = n * 8 + 2 * tg;
      if constexpr (RT) {         // columns past dr are not stored
        if (col >= dr) continue;
        if (dr % 2 == 0) {        // pairs stay 4-byte aligned
          *reinterpret_cast<typename E::T2*>(ob + col) =
              E::pair(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
        } else {
          ob[col] = E::one(o[n][2 * r] * inv);
          if (col + 1 < dr) ob[col + 1] = E::one(o[n][2 * r + 1] * inv);
        }
      } else {
        *reinterpret_cast<typename E::T2*>(ob + col) =
            E::pair(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
    }
  }
}

template <typename T, int DQK, int DV, bool RT = false>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Sq, int Skv, int H, int Hkv,
                      int causal, int window, int q_offset, float scale,
                      int dr, cudaStream_t stream) {
  const size_t smem = TcShape<DQK, DV>::SMEM;
  auto kern = flash_fwd_tc<T, DQK, DV, RT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, Sq, Skv, H, Hkv,
      causal, window, q_offset, scale * 1.4426950408889634f, dr);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 ---

constexpr int TPR = 4;   // threads per query row

// a thread's slice of a dot product and of p * v over V dims held at once
// (float4 or float2 reads from shared memory)
template <int V>
__device__ __forceinline__ float dot_part(const float* q, const float* k) {
  if constexpr (V == 4) {
    const float4 kk = *reinterpret_cast<const float4*>(k);
    return q[0] * kk.x + q[1] * kk.y + q[2] * kk.z + q[3] * kk.w;
  } else {
    const float2 kk = *reinterpret_cast<const float2*>(k);
    return q[0] * kk.x + q[1] * kk.y;
  }
}
template <int V>
__device__ __forceinline__ void axpy_part(float* acc, float p,
                                          const float* v) {
  if constexpr (V == 4) {
    const float4 vv = *reinterpret_cast<const float4*>(v);
    acc[0] += p * vv.x;
    acc[1] += p * vv.y;
    acc[2] += p * vv.z;
    acc[3] += p * vv.w;
  } else {
    const float2 vv = *reinterpret_cast<const float2*>(v);
    acc[0] += p * vv.x;
    acc[1] += p * vv.y;
  }
}

template <int DQK, int DV, bool RT = false>
__global__ void __launch_bounds__(BQ * TPR)
flash_fwd_fma(const float* __restrict__ q,   // (B, Sq, H, DQK)
              const float* __restrict__ k,   // (B, Skv, Hkv, DQK)
              const float* __restrict__ v,   // (B, Skv, Hkv, DV)
              float* __restrict__ out,       // (B, Sq, H, DV)
              float* __restrict__ lse,       // (B, Sq, H) or null
              int Sq, int Skv, int H, int Hkv, int causal, int window,
              int q_offset, float scale, int dr) {
  // RT: DQK == DV is a class width and dr <= DQK the head dim in memory;
  // dims dr..DQK of q, k and v read as 0 and are not stored
  static_assert(!RT || DQK == DV, "class instantiations are uniform");
  const int dq = RT ? dr : DQK, dvr = RT ? dr : DV;   // dims in memory
  // floats a thread reads at once: 4 where the dim is a multiple of 16,
  // else 2 (DQK 24)
  constexpr int VQ = DQK % (TPR * 4) == 0 ? 4 : 2;
  constexpr int VV = DV % (TPR * 4) == 0 ? 4 : 2;
  static_assert(DQK % (TPR * VQ) == 0 && DV % (TPR * VV) == 0,
                "head dims the thread groups take");
  constexpr int NG = DQK / (TPR * VQ);    // groups of q/k per thread
  constexpr int NGV = DV / (TPR * VV);    // groups of v/out per thread
  constexpr int BK = DQK > 128 ? 16 : 32;  // keys per shared-memory tile
  __shared__ __align__(16) float ks[BK * DQK];
  __shared__ __align__(16) float vs[BK * DV];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qi = qt * BQ + row;              // query row inside the call
  const int qpos = q_offset + qi;
  const bool live = qi < Sq;

  // thread's dims: TPR * V * g + V * part + {0..V-1}, g in [0, NG) for
  // q/k (V = VQ) and [0, NGV) for v/out (V = VV)
  float qr[NG * VQ], acc[NGV * VV];
  const size_t qbase = (((size_t)b * Sq + (live ? qi : 0)) * H + h) * dq;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < VQ; ++e) {
      const int d = TPR * VQ * g + VQ * part + e;
      qr[g * VQ + e] = live && (!RT || d < dr) ? q[qbase + d] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < NGV * VV; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  // keys any row of this tile may see
  const int q_lo = q_offset + qt * BQ;
  const int q_hi = q_offset + min(qt * BQ + BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal && q_hi + 1 < kv_end) kv_end = q_hi + 1;
  int kv_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kv_begin = q_lo - window + 1;
  kv_begin = (kv_begin / BK) * BK;

  const size_t k_row = (size_t)Hkv * dq, v_row = (size_t)Hkv * dvr;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();
    if constexpr (DQK == DV) {    // as before the split (see load_kv)
      for (int e = threadIdx.x; e < BK * DQK; e += blockDim.x) {
        const int j = e / DQK, d = e - j * DQK;
        const int kp = k0 + j;
        float kv = 0.f, vv = 0.f;
        if (kp < Skv && (!RT || d < dr)) {
          const size_t off =
              ((size_t)b * Skv + kp) * k_row + (size_t)hk * dq + d;
          kv = k[off];
          vv = v[off];
        }
        ks[e] = kv;
        vs[e] = vv;
      }
    } else {
      for (int e = threadIdx.x; e < BK * DQK; e += blockDim.x) {
        const int j = e / DQK, d = e - j * DQK;
        const int kp = k0 + j;
        ks[e] = kp < Skv
                    ? k[((size_t)b * Skv + kp) * k_row + (size_t)hk * DQK + d]
                    : 0.f;
      }
      for (int e = threadIdx.x; e < BK * DV; e += blockDim.x) {
        const int j = e / DV, d = e - j * DV;
        const int kp = k0 + j;
        vs[e] = kp < Skv
                    ? v[((size_t)b * Skv + kp) * v_row + (size_t)hk * DV + d]
                    : 0.f;
      }
    }
    __syncthreads();

    float s[BK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        dot += dot_part<VQ>(qr + g * VQ,
                            ks + j * DQK + (TPR * g + part) * VQ);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      bool ok = kp < Skv;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[j] = ok ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NGV * VV; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j] == kNegInf ? 0.f : expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int g = 0; g < NGV; ++g)
        axpy_part<VV>(acc + g * VV, p, vs + j * DV + (TPR * g + part) * VV);
    }
    m = m_new;
  }

  if (!live) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  if (lse != nullptr && part == 0)
    lse[((size_t)b * Sq + qi) * H + h] =
        l == 0.f ? __int_as_float(0x7f800000) : m + logf(l);
  const size_t obase = (((size_t)b * Sq + qi) * H + h) * dvr;
#pragma unroll
  for (int g = 0; g < NGV; ++g)
#pragma unroll
    for (int e = 0; e < VV; ++e) {
      const int d = TPR * VV * g + VV * part + e;
      if (!RT || d < dr) out[obase + d] = acc[g * VV + e] * inv;
    }
}

template <int DQK, int DV, bool RT = false>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Sq, int Skv, int H,
                       int Hkv, int causal, int window, int q_offset,
                       float scale, int dr,
                       cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_fma<DQK, DV, RT><<<grid, BQ * TPR, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
      Sq, Skv, H, Hkv, causal, window, q_offset, scale, dr);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_FA_ARGS                                                        \
  q, k, v, out, (float*)lse, B, Sq, Skv, H, Hkv, causal, window, q_offset,   \
      scale, dh, s
#define REPRO_FA_GO(DQK, DV, RT)                                             \
  return (int)(dtype == 0   ? launch_fma<DQK, DV, RT>(REPRO_FA_ARGS)         \
               : dtype == 1 ? launch_tc<__nv_bfloat16, DQK, DV, RT>(         \
                                  REPRO_FA_ARGS)                             \
                            : launch_tc<__half, DQK, DV, RT>(REPRO_FA_ARGS));

// A uniform head dim 1..256 on its class instantiation, the least class
// width that holds it.
static int launch_class(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Sq, int Skv, int H,
                        int Hkv, int dh, int causal, int window, int q_offset,
                        float scale, int dtype, cudaStream_t s) {
#define REPRO_FA_CLASS(C) \
  if (dh <= C) REPRO_FA_GO(C, C, true)
  REPRO_FA_CLASS(32)
  REPRO_FA_CLASS(64)
  REPRO_FA_CLASS(96)
  REPRO_FA_CLASS(128)
  REPRO_FA_CLASS(160)
  REPRO_FA_CLASS(192)
  REPRO_FA_CLASS(256)
#undef REPRO_FA_CLASS
  return (int)cudaErrorInvalidValue;
}

// dh: the q/k head dim; dv: the v/out head dim.  dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16, 2 = float16 (tensor cores).  window <= 0 means no
// window.  lse: null, or an fp32 (B, Sq, H) buffer for each row's
// log-sum-exp.
// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a (dh, dv) pair the kernel does not take: an
// unequal pair other than the two instantiated, or a head dim outside
// 1..256.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int Sq, int Skv, int H, int Hkv,
                                     int dh, int dv,
                                     int causal, int window, int q_offset,
                                     float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FA_LAUNCH(DQK, DV) \
  if (dh == DQK && dv == DV) REPRO_FA_GO(DQK, DV, false)
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  REPRO_FA_LAUNCH(16, 16)
  REPRO_FA_LAUNCH(24, 16)
  REPRO_FA_LAUNCH(64, 64)
  REPRO_FA_LAUNCH(128, 128)
  REPRO_FA_LAUNCH(240, 240)
  REPRO_FA_LAUNCH(192, 128)
#undef REPRO_FA_LAUNCH
  if (dh != dv || dh < 1 || dh > 256) return (int)cudaErrorInvalidValue;
  return launch_class(q, k, v, out, lse, B, Sq, Skv, H, Hkv, dh, causal,
                      window, q_offset, scale, dtype, s);
}
#undef REPRO_FA_GO
#undef REPRO_FA_ARGS
