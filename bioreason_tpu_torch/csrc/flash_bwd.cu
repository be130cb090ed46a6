// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// flash_bwd (flash_bwd_kernel with its two small passes) replaces the three
// Pallas backward kernels of bioreason_tpu/ops/flash_attention.py:
//   _dq_kernel         (:118)  tiled dq, p from the LSE, delta computed outside
//   _dkv_kernel        (:160)  tiled dk/dv per q head, GQA-summed outside (:511-514)
//   _bwd_single_kernel (:271)  fused one-pass backward for Tq == Tk <= 768
// All three compute the gradient of one function; on this card one pass
// covers every case they cover: causal with q_offset or bidirectional, a
// [B, Tk] key mask, GQA (K/V never repeated), D in {64, 128}, any T (TMA
// zero-fills the ragged edge), the [B, T, H, D] layout read through strides.
//
// Function: given q [B,Tq,Hq,D], k/v [B,Tk,Hkv,D], the optional mask [B,Tk]
// int32, the forward's o [B,Tq,Hq,D] and lse [B,Hq,Tq] fp32, and do (dO)
// [B,Tq,Hq,D], write dq [B,Tq,Hq,D] and dk/dv [B,Tk,Hkv,D] (bf16). With
// P = exp(S - lse) on visible (query, key) pairs and 0 elsewhere (SELECTED,
// never multiplied by a mask: a fully masked row has lse = -1e30 and
// exp(s + 1e30) is inf), delta = rowsum(dO * O), dS = P * (dO V^T - delta),
// dq = dS K * scale, dk = dS^T Q * scale, dv = P^T dO. A query row with no
// visible key gets dq = 0 and adds nothing.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 10*D flops per
// visible (query, key) pair (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) against
// 2*D bytes per row of q, o, dO, dq and of k, v, dk, dv: ~320 flops per byte
// at bench.py's SFT shape (T=768), ~1,100 at the long-DNA decoder (T=4480),
// so the tensor cores bound it.
//
// Design (FlashAttention-3's backward, written with the PTX of sm90.cuh):
//   * flash_bwd_prep_kernel: delta = rowsum(dO * O), lse * log2(e) (both
//     into [B*Hq, Tq_pad] fp32, Tq_pad = Tq rounded up to 64, 0 past Tq), and
//     zeroes the fp32 dq scratch dq_accum [B, Hq, Tq_pad, D] (each 64-row
//     tile in the accumulator's fragment order, dq_frag_offset);
//   * flash_bwd_kernel: one CTA of three warpgroups per (128-key tile, KV
//     head, batch), heaviest first (a causal key tile's work falls with k0).
//     Warpgroup 0 is the producer: K and V by TMA once, then a ring of two
//     stages of (Q, dO) tiles of 64 rows by TMA and their lse / delta rows
//     by bulk copy, guarded by full / empty mbarriers, over the Hq/Hkv q
//     heads of the group and their q tiles from the first that sees the
//     key tile. Warpgroups 1 and 2 own 64 keys each and keep dk and dv in
//     registers for the whole group: the GQA sum happens there, with no
//     fp32 per-head temporaries. Per q tile, 5 products by wgmma:
//       S^T = K Q^T and dP^T = V dO^T (K, Q, V, dO K-major in shared memory);
//       dV += P^T dO and dK += dS^T Q (P^T, dS^T from the accumulators as
//       register A operands; dO and Q MN-major, the transpose bit);
//       dQ_part = dS K: dS^T goes to shared memory as the MN-major A
//       operand, K is the MN-major B operand. At D = 128 each warpgroup
//       computes 64 of the 128 columns over all 128 keys; at D = 64 each its
//       own 64 keys, and both parts are added. The part is staged in shared
//       memory (two buffers) in the accumulator's own fragment order, which
//       is also dq_accum's (so the stores have no bank conflicts), and added
//       into dq_accum by the TMA unit's bulk reduce-add
//       (cp.reduce.async.bulk .add.f32): no recomputation of S and dP for
//       dq. P and dS take one FFMA, one ex2.approx and a few ALU operations
//       a pair; the per-pair predicate is compiled out of the tiles where
//       every pair of a thread's keys is visible.
//   * flash_bwd_convert_kernel: dq = bf16(scale * dq_accum) in q's layout.
// dq is summed by atomic reduce-adds whose order varies from run to run, so
// it is not bitwise reproducible (dk and dv are); the error against the
// plain version stays within the same tolerance.
//
// local_bwd_dq / local_bwd_dkv (dq_body / dkv_body: mma.sync, no load
// pipeline) replace the banded backward of
// bioreason_tpu/ops/local_attention.py:
//   _dq_kernel  (:95)   banded dq, P from the LSE, delta computed outside
//   _dkv_kernel (:133)  banded dk/dv per q head, fp32, GQA-summed outside
//                       (:309-311)
// Key j is visible to query i iff |i - j| <= window and mask[j] (Tq == Tk).
// The dq block loops only over the key tiles that meet [q0 - window,
// q0 + 63 + window], the dk/dv block only over the q tiles that meet
// [k0 - window, k0 + 63 + window]: O(T * window) work, where the TPU grid
// walks 2R+1 clamped blocks. delta is folded into the dq prologue and the
// GQA group is summed in registers: no per-q-head fp32 temporaries. Own
// __global__ names and C entry (local_bwd_bf16). They load without a
// pipeline (rows padded to D+8 elements, so the 32-bit fragment loads are
// bank-conflict free) and multiply with mma.sync m16n8k16; their redesign
// on the machinery above is later work.

#include "sm90.cuh"

namespace {

constexpr int NTHREADS = 128;          // 4 warps x 16 rows
constexpr int DQ_BQ = 64, DQ_BK = 64;  // dq kernel: q rows per block, keys per tile
constexpr int KV_BK = 64, KV_BQ = 32;  // dkv kernel: keys per block, q rows per tile

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ROWS rows of D bf16 from global memory (row stride `st`, rows from `row0`)
// into shared memory rows of D+8 elements; rows at or past `limit` are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int row0, int limit, int tid) {
  constexpr int RP = D + 8, CH = D / 8;
  for (int i = tid; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * st + c);
    *reinterpret_cast<uint4*>(&dst[r * RP + c]) = val;
  }
}

// acc[n] = A[r0..r0+15, :] . B[n*8..n*8+7, :]^T over the D columns, with A
// and B both row-major tiles in shared memory; the rows of A are this
// warp's 16 (r0 = warp*16 + g), N rows of B.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float acc[N / 8][4], const __nv_bfloat16* sa,
                                        int r0, const __nv_bfloat16* sb, int g, int t) {
  constexpr int RP = D + 8;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    uint32_t a[4];
    a[0] = ld32(&sa[r0 * RP + c]);
    a[1] = ld32(&sa[(r0 + 8) * RP + c]);
    a[2] = ld32(&sa[r0 * RP + c + 8]);
    a[3] = ld32(&sa[(r0 + 8) * RP + c + 8]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const __nv_bfloat16* brow = &sb[(n * 8 + g) * RP + c];
      mma_16816(acc[n], a, ld32(brow), ld32(brow + 8));
    }
  }
}

// acc[D/8] += P . Y: P is 16 rows x K columns in the accumulator layout of
// mma_abt (rounded to bf16 as the A operand), Y is K rows x D in shared
// memory, read through ldmatrix.trans.
template <int D, int K>
__device__ __forceinline__ void mma_pv(float acc[D / 8][4], const float p[K / 8][4],
                                       const __nv_bfloat16* sy, int lane) {
  constexpr int RP = D + 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    // lanes 0-15: rows kk*16 + (lane & 15), columns n*8..; lanes 16-31 the
    // next 8 columns: matrices {0,1} feed d-tile n, {2,3} d-tile n+1
    const __nv_bfloat16* yrow = &sy[(kk * 16 + (lane & 15)) * RP + (lane >> 4) * 8];
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, yrow + n * 8);
      mma_16816(acc[n], a, bf[0], bf[1]);
      mma_16816(acc[n + 1], a, bf[2], bf[3]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * DQ_BQ + 2 * DQ_BK) * (D + 8) * 2 + DQ_BK * 4 + DQ_BQ * 4;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * KV_BK + 2 * KV_BQ) * (D + 8) * 2 + KV_BK * 4 + 2 * KV_BQ * 4;
}

// The banded dq and dk/dv bodies: key j is visible to query i iff
// |i - j| <= window (array indices) and mask[j].
#define DQ_PARAMS                                                              \
  const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,   \
      const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,      \
      const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,     \
      const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq, \
      float* __restrict__ delta, int Tq, int Tk, int Hq, int Hkv,             \
      long long q_sb, long long q_st, long long q_sh, long long k_sb,         \
      long long k_st, long long k_sh, long long v_sb, long long v_st,         \
      long long v_sh, long long o_sb, long long o_st, long long o_sh,         \
      long long do_sb, long long do_st, long long do_sh, long long dq_sb,     \
      long long dq_st, long long dq_sh
#define DQ_ARGS                                                                \
  q, k, v, mask, o, lse, dout, dq, delta, Tq, Tk, Hq, Hkv, q_sb, q_st, q_sh,   \
      k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, do_sb, do_st,      \
      do_sh, dq_sb, dq_st, dq_sh

template <int D>
__device__ __forceinline__ void dq_body(DQ_PARAMS, int window, float scale) {
  constexpr int RP = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + DQ_BQ * RP;
  __nv_bfloat16* ks = dos + DQ_BQ * RP;      // stages O first, for delta
  __nv_bfloat16* vs = ks + DQ_BK * RP;
  int* kvalid = reinterpret_cast<int*>(vs + DQ_BK * RP);
  float* delta_s = reinterpret_cast<float*>(kvalid + DQ_BK);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * DQ_BQ;

  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  const int* mb = mask ? mask + (long long)b * Tk : nullptr;

  // ---- prologue: Q, dO, O tiles; delta = rowsum(dO * O), 2 threads a row
  load_tile<D, DQ_BQ>(qs, q + b * q_sb + h * q_sh, q_st, q0, Tq, tid);
  load_tile<D, DQ_BQ>(dos, dout + b * do_sb + h * do_sh, do_st, q0, Tq, tid);
  load_tile<D, DQ_BQ>(ks, o + b * o_sb + h * o_sh, o_st, q0, Tq, tid);
  __syncthreads();
  {
    const int r = tid >> 1, c0 = (tid & 1) * (D / 2);
    float acc = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + D / 2; c += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dos[r * RP + c]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ks[r * RP + c]));
      acc += a.x * y.x + a.y * y.y;
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (q0 + r < Tq) delta[(long long)bh * Tq + q0 + r] = acc;
    }
  }
  __syncthreads();                       // ks is overwritten by K below

  const int r0 = warp * 16 + g;          // this thread's rows: r0 and r0 + 8
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  const float lse_r[2] = {qi[0] < Tq ? lse[(long long)bh * Tq + qi[0]] : 0.f,
                          qi[1] < Tq ? lse[(long long)bh * Tq + qi[1]] : 0.f};
  const float dl_r[2] = {delta_s[r0], delta_s[r0 + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // the first and last key any row of this tile can see: only the key tiles
  // that meet the band are loaded
  const int last_row = min(q0 + DQ_BQ, Tq) - 1;
  const int k_begin = max(0, q0 - window) / DQ_BK * DQ_BK;
  const int k_end = min(Tk, last_row + window + 1);

  for (int k0 = k_begin; k0 < k_end; k0 += DQ_BK) {
    load_tile<D, DQ_BK>(ks, kb, k_st, k0, Tk, tid);
    load_tile<D, DQ_BK>(vs, vb, v_st, k0, Tk, tid);
    if (tid < DQ_BK) {
      const int kp = k0 + tid;
      kvalid[tid] = (kp < Tk) && (mb == nullptr || mb[kp] != 0);
    }
    __syncthreads();

    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
    mma_abt<D, DQ_BK>(s, qs, r0, ks, g, t);        // S = Q K^T
    mma_abt<D, DQ_BK>(dp, dos, r0, vs, g, t);      // dP = dO V^T
    // dS = P * (dP - delta), P selected to 0 on invalid pairs (e<2: row r0)
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int kc = n * 8 + 2 * t + (e & 1);
        const bool ok = qi[half] < Tq && kvalid[kc] && abs(k0 + kc - qi[half]) <= window;
        const float p = ok ? __expf(s[n][e] * scale - lse_r[half]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl_r[half]);
      }
    }
    mma_pv<D, DQ_BK>(acc, s, ks, lane);           // dQ += dS K
    __syncthreads();                     // before the next tile overwrites smem
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (qi[half] >= Tq) continue;
    __nv_bfloat16* row = dq + b * dq_sb + (long long)qi[half] * dq_st + h * dq_sh + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

#define DKV_PARAMS                                                             \
  const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,   \
      const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,      \
      const float* __restrict__ lse, const float* __restrict__ delta,         \
      const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk, \
      __nv_bfloat16* __restrict__ dv, int Tq, int Tk, int Hq, int Hkv,        \
      long long q_sb, long long q_st, long long q_sh, long long k_sb,         \
      long long k_st, long long k_sh, long long v_sb, long long v_st,         \
      long long v_sh, long long do_sb, long long do_st, long long do_sh,      \
      long long dk_sb, long long dk_st, long long dk_sh, long long dv_sb,     \
      long long dv_st, long long dv_sh
#define DKV_ARGS                                                               \
  q, k, v, mask, lse, delta, dout, dk, dv, Tq, Tk, Hq, Hkv, q_sb, q_st, q_sh,  \
      k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh, dk_sb, dk_st,   \
      dk_sh, dv_sb, dv_st, dv_sh

template <int D>
__device__ __forceinline__ void dkv_body(DKV_PARAMS, int window, float scale) {
  constexpr int RP = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + KV_BK * RP;
  __nv_bfloat16* qs = vs + KV_BK * RP;
  __nv_bfloat16* dos = qs + KV_BQ * RP;
  int* kvalid = reinterpret_cast<int*>(dos + KV_BQ * RP);
  float* lse_s = reinterpret_cast<float*>(kvalid + KV_BK);
  float* delta_s = lse_s + KV_BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * KV_BK;
  const int* mb = mask ? mask + (long long)b * Tk : nullptr;

  load_tile<D, KV_BK>(ks, k + b * k_sb + hk * k_sh, k_st, k0, Tk, tid);
  load_tile<D, KV_BK>(vs, v + b * v_sb + hk * v_sh, v_st, k0, Tk, tid);
  if (tid < KV_BK) {
    const int kp = k0 + tid;
    kvalid[tid] = (kp < Tk) && (mb == nullptr || mb[kp] != 0);
  }

  const int r0 = warp * 16 + g;          // this thread's keys: r0 and r0 + 8
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // the q tiles that meet [k0 - window, k0 + 63 + window]
  const int q_lo = max(0, k0 - window) / KV_BQ * KV_BQ;
  const int q_hi = min(Tq, min(k0 + KV_BK, Tk) + window);

  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
    const long long row_base = ((long long)b * Hq + h) * Tq;
    for (int q0 = q_lo; q0 < q_hi; q0 += KV_BQ) {
      __syncthreads();                   // the previous tile's readers are done
      load_tile<D, KV_BQ>(qs, qb, q_st, q0, Tq, tid);
      load_tile<D, KV_BQ>(dos, dob, do_st, q0, Tq, tid);
      if (tid < KV_BQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < Tq ? lse[row_base + qi] : 0.f;
        delta_s[tid] = qi < Tq ? delta[row_base + qi] : 0.f;
      }
      __syncthreads();

      float s[KV_BQ / 8][4], dp[KV_BQ / 8][4];
      mma_abt<D, KV_BQ>(s, ks, r0, qs, g, t);      // S^T = K Q^T
      mma_abt<D, KV_BQ>(dp, vs, r0, dos, g, t);    // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < KV_BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = r0 + (e >> 1) * 8;
          const int qc = n * 8 + 2 * t + (e & 1);
          const int qi = q0 + qc;
          const bool ok = qi < Tq && kvalid[kl] && abs(k0 + kl - qi) <= window;
          const float p = ok ? __expf(s[n][e] * scale - lse_s[qc]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_s[qc]);
        }
      }
      mma_pv<D, KV_BQ>(dva, s, dos, lane);        // dV += P^T dO
      mma_pv<D, KV_BQ>(dka, dp, qs, lane);        // dK += dS^T Q
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = k0 + r0 + half * 8;
    if (kp >= Tk) continue;
    __nv_bfloat16* krow = dk + b * dk_sb + (long long)kp * dk_st + hk * dk_sh + 2 * t;
    __nv_bfloat16* vrow = dv + b * dv_sb + (long long)kp * dv_st + hk * dv_sh + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack_bf16(dka[n][2 * half] * scale, dka[n][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          pack_bf16(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
local_bwd_dq_kernel(DQ_PARAMS, int window, float scale) {
  dq_body<D>(DQ_ARGS, window, scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
local_bwd_dkv_kernel(DKV_PARAMS, int window, float scale) {
  dkv_body<D>(DKV_ARGS, window, scale);
}

// Launches the banded dq kernel, then the banded dk/dv kernel, on `stream`.
template <int D>
int launch_band(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const int* mask, const __nv_bfloat16* o, const float* lse,
                const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
                __nv_bfloat16* dv, float* delta, int B, int T, int Hq, int Hkv,
                const long long* st, int window, float scale, cudaStream_t stream) {
  // st: q, k, v, o, do, dq, dk, dv strides, (b, t, h) each
  const size_t smem_dq = dq_smem_bytes<D>(), smem_kv = dkv_smem_bytes<D>();
  constexpr auto kSmem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(local_bwd_dq_kernel<D>, kSmem, (int)smem_dq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(local_bwd_dkv_kernel<D>, kSmem, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_dq((T + DQ_BQ - 1) / DQ_BQ, B * Hq);
  local_bwd_dq_kernel<D><<<grid_dq, NTHREADS, smem_dq, stream>>>(
      q, k, v, mask, o, lse, dout, dq, delta, T, T, Hq, Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // delta comes from the dq kernel: the two launches are ordered on `stream`
  const dim3 grid_kv((T + KV_BK - 1) / KV_BK, B * Hkv);
  local_bwd_dkv_kernel<D><<<grid_kv, NTHREADS, smem_kv, stream>>>(
      q, k, v, mask, lse, delta, dout, dk, dv, T, T, Hq, Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[12], st[13], st[14], st[18], st[19], st[20], st[21], st[22], st[23],
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

namespace fa3b {

using sm90::fence_regs;
using sm90::make_desc;
using sm90::mbar_arrive;
using sm90::mbar_wait;

constexpr int BN = 128;          // keys per CTA: two consumer warpgroups of 64
constexpr int BM = 64;           // q rows per tile of the ring
constexpr int STAGES = 2;        // (Q, dO, lse, delta) ring depth
constexpr int NTHREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base. A tile of R rows x D is
// D/64 boxes of R rows x 128 bytes, one after the other.
template <int D>
struct Smem {
  static constexpr int NPART = D == 128 ? 1 : 2;          // dq parts per q tile
  static constexpr int K = 0;                             // BN x D
  static constexpr int V = K + BN * D * 2;                // BN x D
  static constexpr int Q = V + BN * D * 2;                // STAGES x (BM x D)
  static constexpr int DO = Q + STAGES * BM * D * 2;      // STAGES x (BM x D)
  static constexpr int DS = DO + STAGES * BM * D * 2;     // BN keys x BM q, bf16
  static constexpr int DQ = DS + BN * BM * 2;             // 2 x NPART x (BM x D) fp32
  static constexpr int LD = DQ + 2 * NPART * BM * D * 4;  // STAGES x (lse2[BM], delta[BM])
  static constexpr int BAR = LD + STAGES * 2 * BM * 4;    // kv_full, full[], empty[]
  static constexpr int ALLOC = BAR + (1 + 2 * STAGES) * 8 + 1024;
};

// P^T and dS^T = P^T * (dP^T - delta) in place of S^T and dP^T for one
// warpgroup's 64 keys x 64 queries: rows are this thread's keys kp0, kp1,
// columns queries q0 + 8 j + c2 (+1). P is selected to 0 on invalid pairs;
// NEED = false (every pair visible) compiles without the predicate.
template <bool NEED>
__device__ __forceinline__ void p_and_ds(float (&st)[BM / 2], float (&dpt)[BM / 2],
                                         const float* lsd, const float* dls, bool kval0,
                                         bool kval1, int kp0, int kp1, int q0, int c2, int Tq,
                                         int causal, int q_offset, float scale_log2) {
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + 8 * j + c2 + (e & 1);
      const bool ok = !NEED || (((e < 2) ? kval0 : kval1) && qi < Tq &&
                                (!causal || ((e < 2) ? kp0 : kp1) <= qi + q_offset));
      const float p = ok ? sm90::exp2_approx(fmaf(st[4 * j + e], scale_log2,
                                                  -lsd[8 * j + c2 + (e & 1)]))
                         : 0.f;
      st[4 * j + e] = p;
      dpt[4 * j + e] = p * (dpt[4 * j + e] - dls[8 * j + c2 + (e & 1)]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const int* __restrict__ mask, const float* __restrict__ lse2,
                 const float* __restrict__ delta, float* __restrict__ dq_accum,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 int B, int Tq, int Tk, int Hq, int Hkv, int Tq_pad,
                 long long dk_sb, long long dk_st, long long dk_sh,
                 long long dv_sb, long long dv_st, long long dv_sh,
                 int causal, int q_offset, float scale, float scale_log2) {
  using S = Smem<D>;
  constexpr int KB = D / 64;                 // 64-column boxes per row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  // heaviest first: a causal key tile is seen by every q tile after it
  const int per = B * Hkv;
  const int kt = (int)(blockIdx.x / per);
  const int b = (int)(blockIdx.x % per) / Hkv, hk = (int)(blockIdx.x % per) % Hkv;
  const int group = Hq / Hkv;
  const int k0 = kt * BN;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;    // the first query that sees k0
  const int qt0 = q_lo / BM;
  const int nq = max(0, (Tq + BM - 1) / BM - qt0);
  const int n_iter = group * nq;                           // (q head, q tile) pairs

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread feeds the ring, the rest idle ---
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * BN * D * 2);
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        sm90::tma_load_4d(sm + S::K + i * BN * 128, &tm_k, kv_full, 64 * i, hk, k0, b);
        sm90::tma_load_4d(sm + S::V + i * BN * 128, &tm_v, kv_full, 64 * i, hk, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int h = hk * group + it / nq, q0 = (qt0 + it % nq) * BM;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * BM * D * 2 + 2 * BM * 4);
        uint8_t* qs = sm + S::Q + s * BM * D * 2;
        uint8_t* dos = sm + S::DO + s * BM * D * 2;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          sm90::tma_load_4d(qs + i * BM * 128, &tm_q, &full[s], 64 * i, h, q0, b);
          sm90::tma_load_4d(dos + i * BM * 128, &tm_do, &full[s], 64 * i, h, q0, b);
        }
        const long long row = ((long long)b * Hq + h) * Tq_pad + q0;
        float* ld = reinterpret_cast<float*>(sm + S::LD) + s * 2 * BM;
        sm90::bulk_load(ld, lse2 + row, BM * 4, &full[s]);
        sm90::bulk_load(ld + BM, delta + row, BM * 4, &full[s]);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----------------------------------
    sm90::reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
    const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
    const int kl0 = 64 * cw + r0;            // this thread's keys in the tile: kl0, kl0 + 8
    const int kp0 = k0 + kl0, kp1 = kp0 + 8;
    const int* mb = mask ? mask + (long long)b * Tk : nullptr;
    const bool kval0 = kp0 < Tk && (mb == nullptr || mb[kp0] != 0);
    const bool kval1 = kp1 < Tk && (mb == nullptr || mb[kp1] != 0);
    // D = 128: one dq part, each warpgroup its 64 columns; D = 64: one part
    // per warpgroup (its 64 keys), each added by its own thread
    const bool issuer = ct == 0 && (S::NPART == 2 || cw == 0);
    const uint8_t* ksw = sm + S::K + cw * 64 * 128;     // this warpgroup's keys, box 0
    const uint8_t* vsw = sm + S::V + cw * 64 * 128;
    uint8_t* dss = sm + S::DS;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int h = hk * group + it / nq, q0 = (qt0 + it % nq) * BM;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* qs = sm + S::Q + s * BM * D * 2;
      const uint8_t* dos = sm + S::DO + s * BM * D * 2;
      const float* lsd = reinterpret_cast<const float*>(sm + S::LD) + s * 2 * BM;
      const float* dls = lsd + BM;

      // ---- S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 queries ---------------
      float st[BM / 2], dpt[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / 4, step = (kk % 4) * 32;
        sm90::wgmma_ss<BM, 0, 0>(st, make_desc(ksw + box * BN * 128 + step, 16, 1024),
                                 make_desc(qs + box * BM * 128 + step, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / 4, step = (kk % 4) * 32;
        sm90::wgmma_ss<BM, 0, 0>(dpt, make_desc(vsw + box * BN * 128 + step, 16, 1024),
                                 make_desc(dos + box * BM * 128 + step, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // ---- P^T and dS^T = P^T * (dP^T - delta) -----------------------------
      const bool need = !kval0 || !kval1 || q0 + BM > Tq || (causal && kp1 > q0 + q_offset);
      if (need) p_and_ds<true>(st, dpt, lsd, dls, kval0, kval1, kp0, kp1, q0, c2, Tq, causal,
                               q_offset, scale_log2);
      else p_and_ds<false>(st, dpt, lsd, dls, kval0, kval1, kp0, kp1, q0, c2, Tq, causal,
                           q_offset, scale_log2);
      uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        sm90::pack_a<BM>(pa[kk], st, kk);
        sm90::pack_a<BM>(dsa[kk], dpt, kk);
      }

      // ---- dV += P^T dO, dK += dS^T Q (dO, Q MN-major) ----------------------
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        sm90::wgmma_rs<D, 1>(dva, pa[kk], make_desc(dos + kk * 16 * 128, BM * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        sm90::wgmma_rs<D, 1>(dka, dsa[kk], make_desc(qs + kk * 16 * 128, BM * 128, 1024), 1);
      sm90::wgmma_commit();

      // meanwhile dS^T to shared memory, the MN-major A operand of dQ: key
      // row kl (128 bytes of 64 queries), 16-byte chunk (q / 8) ^ (kl % 8)
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int kl = kl0 + 8 * (f & 1), j = 2 * kk + (f >> 1);
          *reinterpret_cast<uint32_t*>(dss + kl * 128 + ((j ^ (kl & 7)) * 16) + c2 * 2) =
              dsa[kk][f];
        }
      }
      sm90::wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(dsa);
      if (ct == 0) mbar_arrive(&empty[s]);     // Q, dO, lse, delta of this stage are read

      // ---- dQ part = dS K, added into dq_accum by the TMA unit ----------------
      const int buf = it & 1;
      sm90::fence_proxy_async();
      if (issuer) sm90::bulk_wait_read<1>();    // this buffer's add of it - 2 has read it
      sm90::named_barrier(1, 256);              // all of dS is in shared memory
      float dqa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
      sm90::wgmma_fence();
      if constexpr (D == 128) {
        // this warpgroup's 64 columns (box cw of K) over all 128 keys
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          sm90::wgmma_ss<64, 1, 1>(dqa, make_desc(dss + kk * 16 * 128, BN * 128, 1024),
                                   make_desc(sm + S::K + cw * BN * 128 + kk * 16 * 128,
                                             BN * 128, 1024),
                                   kk > 0);
      } else {
        // all 64 columns over this warpgroup's 64 keys
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<64, 1, 1>(dqa, make_desc(dss + (64 * cw + kk * 16) * 128, BN * 128, 1024),
                                   make_desc(sm + S::K + (64 * cw + kk * 16) * 128, BN * 128, 1024),
                                   kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_regs(dqa);
      // staged in dq_accum's fragment order (see dq_frag_offset): each
      // thread's float4 j at j * 512 + 4 * ct of its 64 x 64 block, so a
      // warp stores 512 contiguous bytes, without bank conflicts
      const int part = S::NPART == 2 ? cw : 0;
      float* stg = reinterpret_cast<float*>(sm + S::DQ) + (buf * S::NPART + part) * BM * D +
                   (S::NPART == 2 ? 0 : 4096 * cw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(stg + j * 512 + 4 * ct) =
            make_float4(dqa[4 * j], dqa[4 * j + 1], dqa[4 * j + 2], dqa[4 * j + 3]);
      sm90::fence_proxy_async();
      sm90::named_barrier(2, 256);              // the part is staged; dS may be overwritten
      if (issuer) {
        sm90::bulk_reduce_add_f32(dq_accum + (((long long)b * Hq + h) * Tq_pad + q0) * D, stg,
                                  BM * D * 4);
        sm90::bulk_commit();
      }
    }
    if (issuer) sm90::bulk_wait_all();

    // ---- dk = scale * dS^T Q, dv = P^T dO, summed over the group --------------
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kp = kp0 + 8 * half;
      if (kp >= Tk) continue;
      __nv_bfloat16* krow = dk + b * dk_sb + (long long)kp * dk_st + hk * dk_sh + c2;
      __nv_bfloat16* vrow = dv + b * dv_sb + (long long)kp * dv_st + hk * dv_sh + c2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) = sm90::pack_bf16(
            dka[4 * j + 2 * half] * scale, dka[4 * j + 2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
            sm90::pack_bf16(dva[4 * j + 2 * half], dva[4 * j + 2 * half + 1]);
      }
    }
  }
}

// delta = rowsum(dO * O) and lse * log2(e) into [B*Hq, Tq_pad] (0 past Tq),
// and dq_accum's rows zeroed: one block of 128 threads per 64 rows of a
// (batch, head), two threads a row.
__global__ void __launch_bounds__(128)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, float* __restrict__ dq_accum,
                      int Hq, int Tq, int Tq_pad, int D,
                      long long o_sb, long long o_st, long long o_sh,
                      long long do_sb, long long do_st, long long do_sh) {
  const int tiles = Tq_pad / 64;
  const int bh = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * 64;
  const int b = bh / Hq, h = bh % Hq;
  const int r = threadIdx.x / 2, t = t0 + r, c0 = (threadIdx.x & 1) * (D / 2);
  float acc = 0.f;
  if (t < Tq) {
    const __nv_bfloat16* orow = o + b * o_sb + (long long)t * o_st + h * o_sh;
    const __nv_bfloat16* drow = dout + b * do_sb + (long long)t * do_st + h * do_sh;
    for (int c = c0; c < c0 + D / 2; c += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 af = __bfloat1622float2(a2[i]), yf = __bfloat1622float2(y2[i]);
        acc += af.x * yf.x + af.y * yf.y;
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((threadIdx.x & 1) == 0) {
    const long long row = (long long)bh * Tq_pad + t;
    delta[row] = t < Tq ? acc : 0.f;
    lse2[row] = t < Tq ? lse[(long long)bh * Tq + t] * LOG2E : 0.f;
  }
  float4* z = reinterpret_cast<float4*>(dq_accum + ((long long)bh * Tq_pad + t0) * D);
  for (int i = threadIdx.x; i < 64 * D / 4; i += 128) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Where dq_accum keeps element (row r, column c) of a 64-row q tile: the
// tile is D/64 blocks of 64 x 64 floats (columns 64 i .. 64 i + 63), each
// in the order of the wgmma m64n64 accumulator of the 128 threads that add
// it (d[4j + 2h + e] of thread t = 32 w + l is row 16 w + l / 4 + 8 h,
// column 8 j + 2 (l % 4) + e), float4 j of thread t at j * 512 + 4 t.
__device__ __forceinline__ int dq_frag_offset(int r, int c) {
  const int w = r / 16, rr = r % 16, t = 32 * w + 4 * (rr % 8) + (c % 8) / 2;
  return (c / 64) * 4096 + ((c % 64) / 8) * 512 + 4 * t + 2 * (rr / 8) + c % 2;
}

// dq = bf16(scale * dq_accum) in dq's own layout, 8 columns a thread.
__global__ void __launch_bounds__(256)
flash_bwd_convert_kernel(const float* __restrict__ dq_accum, __nv_bfloat16* __restrict__ dq,
                         int Hq, int Tq, int Tq_pad, int D,
                         long long dq_sb, long long dq_st, long long dq_sh, float scale,
                         long long n_chunks) {
  const int cpr = D / 8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_chunks;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cpr);
    const long long row = i / cpr;
    const int t = (int)(row % Tq);
    const long long bh = row / Tq;
    const float* tile = dq_accum + (bh * Tq_pad + t / 64 * 64) * D;
    uint32_t packed[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {      // columns 8 c + 2 k and + 1 sit side by side
      const float2 x =
          *reinterpret_cast<const float2*>(tile + dq_frag_offset(t % 64, 8 * c + 2 * k));
      packed[k] = sm90::pack_bf16(x.x * scale, x.y * scale);
    }
    const uint4 out = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    *reinterpret_cast<uint4*>(dq + (bh / Hq) * dq_sb + (long long)t * dq_st +
                              (bh % Hq) * dq_sh + 8 * c) = out;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask, const void* o,
           const float* lse, const void* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
           __nv_bfloat16* dv, float* lse2, float* delta, float* dq_accum, int B, int Tq,
           int Tk, int Hq, int Hkv, const long long* st, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  // st: q, k, v, o, do, dq, dk, dv strides, (b, t, h) each
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::ALLOC);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv, mdo;
  int rc = sm90_host::make_map(&mq, q, B, Tq, Hq, D, st[0], st[1], st[2], BM);
  if (rc == 0) rc = sm90_host::make_map(&mk, k, B, Tk, Hkv, D, st[3], st[4], st[5], BN);
  if (rc == 0) rc = sm90_host::make_map(&mv, v, B, Tk, Hkv, D, st[6], st[7], st[8], BN);
  if (rc == 0) rc = sm90_host::make_map(&mdo, dout, B, Tq, Hq, D, st[12], st[13], st[14], BM);
  if (rc != 0) return rc;
  const int Tq_pad = (Tq + 63) / 64 * 64;
  const long long prep_blocks = (long long)B * Hq * (Tq_pad / 64);
  const long long grid = (long long)((Tk + BN - 1) / BN) * B * Hkv;
  if (prep_blocks > 0x7fffffffLL || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  flash_bwd_prep_kernel<<<(unsigned)prep_blocks, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, lse2,
      delta, dq_accum, Hq, Tq, Tq_pad, D, st[9], st[10], st[11], st[12], st[13], st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  flash_bwd_kernel<D><<<(unsigned)grid, NTHREADS, Smem<D>::ALLOC, stream>>>(
      mq, mk, mv, mdo, mask, lse2, delta, dq_accum, dk, dv, B, Tq, Tk, Hq, Hkv, Tq_pad,
      st[18], st[19], st[20], st[21], st[22], st[23], causal, q_offset, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n_chunks = (long long)B * Hq * Tq * (D / 8);
  const long long want = (n_chunks + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  flash_bwd_convert_kernel<<<blocks, 256, 0, stream>>>(dq_accum, dq, Hq, Tq, Tq_pad, D, st[15],
                                                       st[16], st[17], scale, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace fa3b

// Plain C entry point (loaded with ctypes). Launches the prep pass, the
// backward kernel and the dq convert pass on `stream`; returns the first
// non-zero cudaError (0 = success). `strides` holds 24 values: (b, t, h)
// element strides of q, k, v, o, do, dq, dk, dv in that order; every tensor
// has a unit last stride. lse_log2 and delta are [B*Hq, Tq_pad] fp32 and
// dq_accum [B, Hq, Tq_pad, D] fp32 scratch (Tq_pad = Tq rounded up to 64),
// 16-byte aligned; the prep pass fills them.
extern "C" int flash_bwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv, void* lse_log2,
    void* delta, void* dq_accum, int B, int Tq, int Tk, int Hq, int Hkv, int D,
    const long long* strides, int causal, int q_offset, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const int*>(mask);
  const auto* lp = static_cast<const float*>(lse);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* l2 = static_cast<float*>(lse_log2);
  auto* dl = static_cast<float*>(delta);
  auto* acc = static_cast<float*>(dq_accum);
  if (D == 64)
    return fa3b::launch<64>(q, k, v, mp, o, lp, dout, dqp, dkp, dvp, l2, dl, acc, B, Tq, Tk,
                            Hq, Hkv, strides, causal, q_offset, scale, st);
  if (D == 128)
    return fa3b::launch<128>(q, k, v, mp, o, lp, dout, dqp, dkp, dvp, l2, dl, acc, B, Tq, Tk,
                             Hq, Hkv, strides, causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the banded backward (loaded with ctypes): q, k, v,
// mask, o, lse, do as for flash_bwd_bf16, then dq, dk, dv and delta
// [B, Hq, T] fp32 scratch (written by the dq kernel, read by the dk/dv
// kernel), Tq == Tk == T, the 24 strides as for flash_bwd_bf16, and
// `window`; key j is visible to query i iff |i - j| <= window and mask[j].
// Launches the dq kernel, then the dk/dv kernel, on `stream`; returns the
// first non-zero cudaError (0 = success).
extern "C" int local_bwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv, void* delta,
    int B, int T, int Hq, int Hkv, int D, const long long* strides, int window,
    float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const int*>(mask);
  const auto* op = static_cast<const __nv_bfloat16*>(o);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* dlp = static_cast<float*>(delta);
  if (D == 64)
    return launch_band<64>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dlp, B, T, Hq, Hkv,
                           strides, window, scale, st);
  if (D == 128)
    return launch_band<128>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dlp, B, T, Hq, Hkv,
                            strides, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
