// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// flash_fwd_kernel replaces the two Pallas forward kernels of
// bioreason_tpu/ops/flash_attention.py:
//   _fwd_kernel        (:60)  tiled online-softmax forward, out + fp32 LSE
//   _fwd_single_kernel (:239) whole-sequence forward with causal row groups
// Both compute the same function; on this card one tiled kernel covers both,
// and its causal tile skip is what the TPU kernel's row groups do.
//
// Function: q [B,Tq,Hq,D], k/v [B,Tk,Hkv,D] (any strides with a unit last
// stride, strides and base 16-byte aligned), optional key-padding mask
// [B,Tk] int32 (nonzero = valid) -> o [B,Tq,Hq,D] bf16 (its own strides) and
// lse [B,Hq,Tq] fp32. GQA reads kv head h / (Hq/Hkv); K/V are never
// repeated. Causal: key j is visible to query i iff j <= i + q_offset.
// A query row with no visible key gives o = 0 and lse = -1e30.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4*D flops per
// visible (query, key) pair against 2*D bytes per row of q, k, v and o. At
// the long-DNA decoder (causal T=4480, D=128) that is ~1,100 flops per byte
// and at the served prefill ~320: tensor-core bound; the encoder shapes
// (D=64, T <= 2048, bidirectional) sit near the ridge (~295).
//
// Design (FlashAttention-3's forward, written with the PTX of sm90.cuh):
//   * one CTA of three warpgroups per 128-row q tile: warpgroup 0 is the
//     producer (one warp issues TMA; setmaxnreg gives its registers to the
//     others, 24 / 240), warpgroups 1 and 2 each own 64 rows;
//   * Q arrives once by TMA; K and V tiles of 128 keys by TMA into a ring of
//     three stages (225 KB of shared memory at D = 128), 128-byte swizzled.
//     K and V have their own full barrier (TMA bytes; K's also the producer
//     warp's 32 arrivals) and empty barrier (K: each consumer warp after
//     its softmax; V: each consumer warpgroup after the P V that read it).
//     The producer issues K first, then builds the tile's key validity
//     (mask and ragged edge) as 128 bits with warp ballots while K flies;
//   * S = Q K^T by wgmma m64n128k16 with Q and K K-major in shared memory;
//     P rounded to bf16 is the register A operand of O += P V, with V as the
//     MN-major B operand (the transpose bit);
//   * the softmax, not the tensor cores, sets the pace: per score one FFMA,
//     one ex2.approx (MUFU) and the max / sum / pack work, against 512 flops
//     of products. So it is kept lean: the predicate is compiled out of
//     tiles whose pairs are all visible (P is selected to 0 on invalid
//     pairs, never multiplied by a mask), the output rows are rescaled only
//     when a row maximum moved, and exp2 skips exp2f's range handling;
//   * and it is overlapped with the products two ways: within a warpgroup,
//     S of tile j and P V of tile j-1 are issued together and the softmax of
//     tile j runs while P V does (tile 0's S is peeled off, so no wgmma sits
//     under a branch); across warpgroups, named barriers make the two take
//     turns to issue, so one's softmax overlaps the other's products;
//   * key tiles wholly above the causal diagonal are never loaded;
//   * heavy causal tiles go first: the grid is linear and walks the q tiles
//     from the last (most keys) to the first, so the light ones fill the
//     tail; a linear grid also lifts the 65,535 limit on B * Hq;
//   * TMA fills rows past T with zeros, so the ragged edge needs no load
//     masking; rows past Tq are not stored.
// Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled
// through the runtime's driver entry point) and passed as __grid_constant__
// parameters. `python3 -m bioreason_tpu_torch.tools.kernel_variants` times
// each of these choices against its alternative.
//
// local_fwd_kernel (fwd_body: mma.sync, no load pipeline) replaces the
// banded forward of
// bioreason_tpu/ops/local_attention.py:
//   _fwd_kernel        (:46)  key j visible to query i iff |i - j| <= window
//                             and mask[j]; self-attention, Tq == Tk
// The TPU kernel's grid is 2R+1 key blocks wide with the block index clamped
// to the band; here each 64-row q tile loops only over the 64-key tiles that
// meet [q0 - window, q0 + 63 + window], so the work is O(T * window). Its own
// __global__ name and C entry (local_fwd_bf16) keep it apart from flash_fwd
// in a profile. Bound: the band's visible pairs are ~2W+1 per query, so at
// the long-DNA encoder (D=64, W=256) it does ~64 flops per byte of q, k, v
// and o: bytes-bound, far below the card's ridge. It loads without a
// pipeline and multiplies with mma.sync m16n8k16 (P in registers as the A
// operand, V through ldmatrix.trans); its redesign on the machinery above
// is later work.

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128; // 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

using sm90::pack_bf16;

// The banded forward's body: key j is visible to query i iff
// |i - j| <= window (array indices) and mask[j].
template <int D>
__device__ __forceinline__ void
fwd_body(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v,
         const int* __restrict__ mask,
         __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
         int Tq, int Tk, int Hq, int Hkv,
         long long q_sb, long long q_st, long long q_sh,
         long long k_sb, long long k_st, long long k_sh,
         long long v_sb, long long v_st, long long v_sh,
         long long o_sb, long long o_st, long long o_sh,
         int window, float scale) {
  constexpr int RP = D + 8;     // padded smem row (elements)
  constexpr int CH = D / 8;     // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 ks[BK * RP];   // stages Q first
  __shared__ __align__(16) __nv_bfloat16 vs[BK * RP];
  __shared__ int kvalid[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  const int* mb = mask ? mask + (long long)b * Tk : nullptr;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // ---- Q tile -> smem (zero past Tq) -> this warp's A fragments ----------
  for (int i = tid; i < BQ * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero4;
    if (q0 + r < Tq)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * q_st + c);
    *reinterpret_cast<uint4*>(&ks[r * RP + c]) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;          // this thread's rows: r0 and r0 + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&ks[r0 * RP + c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&ks[(r0 + 8) * RP + c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&ks[r0 * RP + c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&ks[(r0 + 8) * RP + c + 8]);
  }
  __syncthreads();                       // ks is overwritten by K below

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};
  // absolute positions of this thread's two rows among the keys
  const int qpos0 = q0 + r0;
  const int qpos1 = qpos0 + 8;

  // the first and last key any row of this tile can see: only the key tiles
  // that meet the band are loaded
  const int last_row = min(q0 + BQ, Tq) - 1;
  const int k_begin = max(0, q0 - window) / BK * BK;
  const int k_end = min(Tk, last_row + window + 1);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // ---- K and V tiles -> smem (zero past Tk), key validity -> smem -----
    for (int i = tid; i < BK * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero4, vv = zero4;
      if (k0 + r < Tk) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_st + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_st + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * RP + c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r * RP + c]) = vv;
    }
    if (tid < BK) {
      const int kp = k0 + tid;
      kvalid[tid] = (kp < Tk) && (mb == nullptr || mb[kp] != 0);
    }
    __syncthreads();

    // ---- S = Q K^T: 16 rows x 64 keys per warp ---------------------------
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &ks[(n * 8 + g) * RP + 2 * t];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[n], qf[kk], b0, b1);
      }
    }

    // ---- mask, scale, online softmax (rows r0: e=0,1; r0+8: e=2,3) ------
    float mx0 = m_r[0], mx1 = m_r[1];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * t + (e & 1);
        const int qp = (e < 2) ? qpos0 : qpos1;
        const bool ok = kvalid[kc] && abs(k0 + kc - qp) <= window;
        const float x = ok ? s[n][e] * scale : NEG_INF;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the four threads of a quad share rows
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = __expf(m_r[0] - mx0);
    const float alpha1 = __expf(m_r[1] - mx1);
    m_r[0] = mx0;
    m_r[1] = mx1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * t + (e & 1);
        const int qp = (e < 2) ? qpos0 : qpos1;
        const bool ok = kvalid[kc] && abs(k0 + kc - qp) <= window;
        const float p = ok ? __expf(s[n][e] - ((e < 2) ? mx0 : mx1)) : 0.f;
        s[n][e] = p;
        if (e < 2) rs0 += p; else rs1 += p;
      }
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l_r[0] = l_r[0] * alpha0 + rs0;
    l_r[1] = l_r[1] * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0; acc[n][1] *= alpha0;
      acc[n][2] *= alpha1; acc[n][3] *= alpha1;
    }

    // ---- O += P V: P (bf16) straight from the S registers ----------------
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lanes 0-15: keys kk*16 + (lane & 15), columns n*8..; lanes 16-31 the
      // next 8 columns: matrices {0,1} feed d-tile n, {2,3} d-tile n+1
      const __nv_bfloat16* vrow =
          &vs[(kk * 16 + (lane & 15)) * RP + (lane >> 4) * 8];
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + n * 8);
        mma_16816(acc[n], a, bf[0], bf[1]);
        mma_16816(acc[n + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                     // before the next tile overwrites smem
  }

  // ---- finalize: o = acc / l, lse = m + log(l); empty rows -> 0, -1e30 ---
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + half * 8;
    if (qi >= Tq) continue;
    const float l = l_r[half];
    const float inv = (l == 0.f) ? 0.f : 1.f / l;
    __nv_bfloat16* orow = o + b * o_sb + (long long)qi * o_st + h * o_sh + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    }
    if (t == 0)
      lse[(long long)bh * Tq + qi] = (l == 0.f) ? NEG_INF : m_r[half] + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
local_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int T, int Hq, int Hkv,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 int window, float scale) {
  fwd_body<D>(q, k, v, mask, o, lse, T, T, Hq, Hkv, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
              v_sb, v_st, v_sh, o_sb, o_st, o_sh, window, scale);
}

}  // namespace


namespace fa3 {

using sm90::fence_regs;
using sm90::make_desc;
using sm90::mbar_arrive;
using sm90::mbar_wait;

constexpr int BM = 128;          // query rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;          // keys per tile
constexpr int STAGES = 3;        // K/V ring depth
constexpr int NTHREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.69314718055994531f;

// Shared memory, from a 1024-byte aligned base. A tile of R rows x D is
// D/64 boxes of R rows x 128 bytes, one after the other.
template <int D>
struct Smem {
  static constexpr int Q = 0;                               // BM x D
  static constexpr int K = Q + BM * D * 2;                  // STAGES x (BN x D)
  static constexpr int V = K + STAGES * BN * D * 2;         // STAGES x (BN x D)
  static constexpr int VALID = V + STAGES * BN * D * 2;     // STAGES x BN key-valid bits
  static constexpr int BAR = VALID + STAGES * BN / 8;       // q_full, K and V full / empty
  static constexpr int ALLOC = BAR + (1 + 4 * STAGES) * 8 + 1024;
};

// S = Q K^T for one warpgroup: 64 rows x BN keys over D, both K-major.
template <int D>
__device__ __forceinline__ void s_product(float (&sc)[BN / 2], const uint8_t* qs,
                                          const uint8_t* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, step = (kk % 4) * 32;      // 32 bytes per k16 in a box
    sm90::wgmma_ss<BN, 0, 0>(sc, make_desc(qs + box * BM * 128 + step, 16, 1024),
                             make_desc(ks + box * BN * 128 + step, 16, 1024), kk > 0);
  }
}

// O += P V: P (bf16) as register A fragments, V MN-major (the transpose bit).
template <int D>
__device__ __forceinline__ void pv_product(float (&acc)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                           const uint8_t* vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    sm90::wgmma_rs<D, 1>(acc, pa[kk], make_desc(vs + kk * 16 * 128, BN * 128, 1024), 1);
}

// Masks one S tile, moves the running row maxima (m, of the raw scores)
// and this thread's partial row sums (l), and leaves P in `sc`: p =
// exp2(s * scale_log2 - m * scale_log2), one FFMA and one MUFU an element.
// Returns the factors that rescale the output rows (alpha). NEED = false
// (every pair of the tile visible) compiles without the per-pair predicate;
// `kv` holds the tile's key validity, bit kc % 32 of word kc / 32.
// d[4j+e] is row r0 for e < 2, r0 + 8 otherwise; key column 8j + c2 + (e&1).
template <bool NEED>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], const uint4 kv, int causal,
                                             int k0, int qpos0, int qpos1, int c2,
                                             float scale_log2, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      if (NEED) {
        const int kc = 8 * j + c2 + (e & 1);
        const uint32_t word = (j < 4) ? kv.x : (j < 8) ? kv.y : (j < 12) ? kv.z : kv.w;
        const bool ok = ((word >> (kc & 31)) & 1u) &&
                        (!causal || k0 + kc <= ((e < 2) ? qpos0 : qpos1));
        x = ok ? x : NEG_INF;
        sc[4 * j + e] = x;
      }
      if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
    }
  }
  // the four threads of a quad share rows
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha[0] = sm90::exp2_approx((m[0] - mx0) * scale_log2);
  alpha[1] = sm90::exp2_approx((m[1] - mx1) * scale_log2);
  m[0] = mx0;
  m[1] = mx1;
  const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * j + e];
      // selected, not multiplied: a row with no valid key so far has max
      // -1e30 and exp2 would give 1 on its invalid pairs
      const float p = (NEED && x <= NEG_INF)
                          ? 0.f
                          : sm90::exp2_approx(fmaf(x, scale_log2, (e < 2) ? -ms0 : -ms1));
      sc[4 * j + e] = p;
      if (e < 2) rs0 += p; else rs1 += p;
    }
  }
  l[0] = l[0] * alpha[0] + rs0;
  l[1] = l[1] * alpha[1] + rs1;
}

// softmax_tile with the predicate only where the tile has an invalid pair:
// a masked or ragged key, or a key past some row's causal reach.
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], const uint4 kv, int causal,
                                               int k0, int wq0, int q_offset, int qpos0,
                                               int qpos1, int c2, float scale_log2,
                                               float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  const bool need = (kv.x & kv.y & kv.z & kv.w) != 0xffffffffu ||
                    (causal && k0 + BN - 1 > wq0 + q_offset);
  if (need) softmax_tile<true>(sc, kv, causal, k0, qpos0, qpos1, c2, scale_log2, m, l, alpha);
  else softmax_tile<false>(sc, kv, causal, k0, qpos0, qpos1, c2, scale_log2, m, l, alpha);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int B, int Tq, int Tk, int Hq, int Hkv,
                 long long o_sb, long long o_st, long long o_sh,
                 int causal, int q_offset, float scale_log2) {
  using S = Smem<D>;
  constexpr int KB = D / 64;                 // 64-column boxes per row
  constexpr int TILE = BN * D * 2;           // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  uint4* kvalid = reinterpret_cast<uint4*>(sm + S::VALID);

  // longest first: the last q tiles of a causal grid see the most keys
  const int n_qt = (Tq + BM - 1) / BM;
  const int per = B * Hq;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per);
  const int bh = (int)(blockIdx.x % per), b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BM;
  // the keys any row of the tile can see (causal tile skip)
  const int k_end = causal ? min(Tk, min(q0 + BM, Tq) + q_offset) : Tk;
  const int n_kt = k_end > 0 ? (k_end + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full_k[s], 32);       // the producer warp, with the key validity
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_k[s], 8);       // each consumer warp, after its softmax
      sm90::mbar_init(&empty_v[s], 2);       // each consumer warpgroup, after P V
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: warp 0 feeds the ring, the rest idle -------
    sm90::reg_dealloc<24>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(q_full, BM * D * 2);
#pragma unroll
        for (int i = 0; i < KB; ++i)
          sm90::tma_load_4d(sm + S::Q + i * BM * 128, &tm_q, q_full, 64 * i, h, q0, b);
      }
      const int* mb = mask ? mask + (long long)b * Tk : nullptr;
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % STAGES, ph = ((it / STAGES) & 1) ^ 1;
        const int k0 = it * BN;
        mbar_wait(&empty_k[s], ph);
        if (lane == 0) {                     // K first: its flight hides the mask read
          sm90::mbar_expect_tx(&full_k[s], TILE);
#pragma unroll
          for (int i = 0; i < KB; ++i)
            sm90::tma_load_4d(sm + S::K + s * TILE + i * BN * 128, &tm_k, &full_k[s], 64 * i, hk,
                              k0, b);
        }
        // key k0 + 32 w + lane is bit `lane` of word w
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 32 * e + lane;
          w[e] = __ballot_sync(0xffffffffu, kp < Tk && (mb == nullptr || mb[kp] != 0));
        }
        if (lane == 0) kvalid[s] = make_uint4(w[0], w[1], w[2], w[3]);
        mbar_arrive(&full_k[s]);
        if (lane == 0) {
          mbar_wait(&empty_v[s], ph);
          sm90::mbar_arrive_expect_tx(&full_v[s], TILE);
#pragma unroll
          for (int i = 0; i < KB; ++i)
            sm90::tma_load_4d(sm + S::V + s * TILE + i * BN * 128, &tm_v, &full_v[s], 64 * i, hk,
                              k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each --------------------------------
    // Tile it's S = Q K^T runs on the tensor cores while tile it-1's P V
    // does too and while tile it's softmax runs (FlashAttention-3's
    // intra-warpgroup overlap); K is released after the softmax, V after P V.
    sm90::reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
    const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
    const int wq0 = q0 + 64 * cw;            // this warpgroup's first row
    const int row0 = wq0 + r0;               // this thread's rows: row0, row0 + 8
    const int qpos0 = row0 + q_offset, qpos1 = qpos0 + 8;
    const uint8_t* qs = sm + S::Q + cw * 64 * 128;
    // the two warpgroups take turns to issue their products (named barriers
    // 1 + cw), so one's softmax runs while the other's products do; the
    // second warpgroup lets the first go first
    const int turn = 1 + cw, other = 2 - cw;
    if (cw == 1) sm90::named_barrier_arrive(1, 256);

    float acc[D / 2], sc[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];   // l: this thread's columns
    uint32_t pa[BN / 16][4];

    mbar_wait(q_full, 0);
    if (n_kt > 0) {
      // tile 0: S and its softmax
      mbar_wait(&full_k[0], 0);
      sm90::named_barrier(turn, 256);
      sm90::wgmma_fence();
      s_product<D>(sc, qs, sm + S::K);
      sm90::wgmma_commit();
      sm90::named_barrier_arrive(other, 256);
      sm90::wgmma_wait<0>();
      fence_regs(sc);
      online_softmax(sc, kvalid[0], causal, 0, wq0, q_offset, qpos0, qpos1, c2, scale_log2, m, l,
                     alpha);
      if (lane == 0) mbar_arrive(&empty_k[0]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) sm90::pack_a<BN>(pa[kk], sc, kk);
    }
    for (int it = 1; it < n_kt; ++it) {
      // S of tile it and P V of tile it - 1 on the tensor cores; the softmax
      // of tile it starts when S is done
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      const int k0 = it * BN;
      mbar_wait(&full_k[s], (it / STAGES) & 1);
      mbar_wait(&full_v[sp], ((it - 1) / STAGES) & 1);
      sm90::named_barrier(turn, 256);
      sm90::wgmma_fence();
      s_product<D>(sc, qs, sm + S::K + s * TILE);
      sm90::wgmma_commit();
      pv_product<D>(acc, pa, sm + S::V + sp * TILE);
      sm90::wgmma_commit();
      sm90::named_barrier_arrive(other, 256);
      sm90::wgmma_wait<1>();
      fence_regs(sc);
      online_softmax(sc, kvalid[s], causal, k0, wq0, q_offset, qpos0, qpos1, c2, scale_log2, m,
                     l, alpha);
      if (lane == 0) mbar_arrive(&empty_k[s]);
      sm90::wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (ct == 0) mbar_arrive(&empty_v[sp]);
      if (alpha[0] != 1.f || alpha[1] != 1.f) {     // a row maximum moved
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 0] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) sm90::pack_a<BN>(pa[kk], sc, kk);
    }
    if (n_kt > 0) {                          // the last tile's P V
      const int sl = (n_kt - 1) % STAGES;
      mbar_wait(&full_v[sl], ((n_kt - 1) / STAGES) & 1);
      sm90::named_barrier(turn, 256);
      sm90::wgmma_fence();
      pv_product<D>(acc, pa, sm + S::V + sl * TILE);
      sm90::wgmma_commit();
      sm90::named_barrier_arrive(other, 256);
      sm90::wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (ct == 0) mbar_arrive(&empty_v[sl]);
    }
    // ---- finalize: o = acc / l, lse = m + log(l); empty rows -> 0, -1e30 --
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
      const int qi = row0 + 8 * half;
      if (qi >= Tq) continue;
      const float inv = (l[half] == 0.f) ? 0.f : 1.f / l[half];
      __nv_bfloat16* orow = o + b * o_sb + (long long)qi * o_st + h * o_sh + c2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            sm90::pack_bf16(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
      if (lane % 4 == 0)
        lse[(long long)bh * Tq + qi] =
            (l[half] == 0.f) ? NEG_INF : (m[half] * scale_log2 + log2f(l[half])) * LN2;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask, __nv_bfloat16* o,
           float* lse, int B, int Tq, int Tk, int Hq, int Hkv,
           long long q_sb, long long q_st, long long q_sh,
           long long k_sb, long long k_st, long long k_sh,
           long long v_sb, long long v_st, long long v_sh,
           long long o_sb, long long o_st, long long o_sh,
           int causal, int q_offset, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::ALLOC);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv;
  int rc = sm90_host::make_map(&mq, q, B, Tq, Hq, D, q_sb, q_st, q_sh, BM);
  if (rc == 0) rc = sm90_host::make_map(&mk, k, B, Tk, Hkv, D, k_sb, k_st, k_sh, BN);
  if (rc == 0) rc = sm90_host::make_map(&mv, v, B, Tk, Hkv, D, v_sb, v_st, v_sh, BN);
  if (rc != 0) return rc;
  const long long grid = (long long)((Tq + BM - 1) / BM) * B * Hq;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<D><<<(unsigned)grid, NTHREADS, Smem<D>::ALLOC, stream>>>(
      mq, mk, mv, mask, o, lse, B, Tq, Tk, Hq, Hkv, o_sb, o_st, o_sh, causal, q_offset,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace fa3

// Plain C entry point (loaded with ctypes). Encodes the tensor maps and
// launches flash_fwd_kernel on `stream`; returns 0 or a cudaError (an
// argument or a layout the kernel does not take, or the launch's error).
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int Tq, int Tk, int Hq, int Hkv, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_offset, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 64)
    return fa3::launch<64>(q, k, v, mp, op, lp, B, Tq, Tk, Hq, Hkv, q_sb, q_st, q_sh, k_sb,
                           k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, q_offset,
                           scale, st);
  if (D == 128)
    return fa3::launch<128>(q, k, v, mp, op, lp, B, Tq, Tk, Hq, Hkv, q_sb, q_st, q_sh, k_sb,
                            k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, q_offset,
                            scale, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the banded forward (loaded with ctypes): q [B,T,Hq,D],
// k/v [B,T,Hkv,D], mask [B,T] or null, o [B,T,Hq,D], lse [B,Hq,T]; key j is
// visible to query i iff |i - j| <= window and mask[j]. Returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int local_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int T, int Hq, int Hkv, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int window, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BQ - 1) / BQ, B * Hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 64) {
    local_fwd_kernel<64><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, mp, op, lp, T, Hq, Hkv, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
        v_sb, v_st, v_sh, o_sb, o_st, o_sh, window, scale);
  } else if (D == 128) {
    local_fwd_kernel<128><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, mp, op, lp, T, Hq, Hkv, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
        v_sb, v_st, v_sh, o_sb, o_st, o_sh, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
