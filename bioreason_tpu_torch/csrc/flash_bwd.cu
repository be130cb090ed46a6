// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the three Pallas backward kernels of bioreason_tpu/ops/flash_attention.py:
//   _dq_kernel         (:118)  tiled dq, p from the LSE, delta computed outside
//   _dkv_kernel        (:160)  tiled dk/dv per q head, GQA-summed outside (:511-514)
//   _bwd_single_kernel (:271)  fused one-pass backward for Tq == Tk <= 768
// All three compute the gradient of one function; on this card one pair of
// kernels covers every case they cover: causal with q_offset or bidirectional,
// a [B, Tk] key mask, GQA (K/V never repeated), D in {64, 128}, any T (the
// ragged edge is masked here), the [B, T, H, D] layout read through strides.
//
// Function: given q [B,Tq,Hq,D], k/v [B,Tk,Hkv,D], the optional mask [B,Tk]
// int32, the forward's o [B,Tq,Hq,D] and lse [B,Hq,Tq] fp32, and do (dO)
// [B,Tq,Hq,D], write dq [B,Tq,Hq,D], dk/dv [B,Tk,Hkv,D] (bf16) and
// delta = rowsum(dO * O) [B,Hq,Tq] (fp32 scratch). With P = exp(S - lse) on
// visible (query, key) pairs and 0 elsewhere (SELECTED, never multiplied by
// a mask: a fully masked row has lse = -1e30 and exp(s + 1e30) is inf),
// dS = P * (dO V^T - delta), dq = dS K * scale, dk = dS^T Q * scale,
// dv = P^T dO. A query row with no visible key gets dq = 0 and adds nothing.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 10*D flops per
// visible (query, key) pair (Q K^T, dO V^T, P^T dO, dS K, dS^T Q) against
// 2*D bytes per row of q, o, dO, dq and of k, v, dk, dv. At the SFT shape
// (B=4, T=768, Hq 16 / Hkv 8, D=128, causal) that is ~320 flops per byte,
// at the card's ridge (~295): both bounds are within 10% of each other, and
// a kernel built on mma.sync without a load pipeline sits well above both
// (PERF.md has the measured gap). The design keeps the byte traffic at the
// minimum the split allows (K/V tiles read once per dk/dv block, dk/dv
// written once, the GQA sum done in registers) and keeps every accumulator
// in registers without spills, so the tensor cores are the limit it works on.
//
// Design, simple and right first (no atomics: the result is deterministic):
//   * flash_bwd_dq<D>: one block of 4 warps per (64-row q tile, q head,
//     batch). Its prologue stages the Q, dO and O tiles in shared memory and
//     writes delta = rowsum(dO * O) (two threads per row); it then loops over
//     64-key K/V tiles up to the causal reach, recomputes S = Q K^T and
//     dP = dO V^T (mma.sync m16n8k16, A and B from padded shared memory),
//     forms P and dS in registers and accumulates dq += dS K with dS as the
//     A operand straight from the accumulator registers (FlashAttention-2's
//     register trick) and K through ldmatrix.trans. 128 fp32 registers of
//     accumulators a thread.
//   * flash_bwd_dkv<D>: one block of 4 warps per (64-key tile, KV head,
//     batch). K and V stay in shared memory; the block loops over the
//     Hq/Hkv query heads of its group and over their 32-row q tiles from the
//     first that sees the tile, recomputes S^T = K Q^T and dP^T = V dO^T,
//     and accumulates dv += P^T dO and dk += dS^T Q for the whole GQA group
//     in registers: what the TPU does with fp32 [B*Hq, Tk, D] temporaries
//     and a reshape-sum, or in VMEM scratch. The 32-row q tile keeps the
//     two 64-register accumulators (dk, dv at D=128) beside the S and dP
//     fragments under the 255-register limit without spilling.
//   * shared memory is dynamic (69.6 KB and 52.7 KB at D=128), rows padded
//     to D+8 elements so the fragment loads are bank-conflict free.
// Not yet: wgmma, TMA, a producer warp, double buffering (later work).
//
// local_bwd_dq / local_bwd_dkv, the same bodies with BAND = true, replace the
// banded backward of bioreason_tpu/ops/local_attention.py:
//   _dq_kernel  (:95)   banded dq, P from the LSE, delta computed outside
//   _dkv_kernel (:133)  banded dk/dv per q head, fp32, GQA-summed outside
//                       (:309-311)
// Key j is visible to query i iff |i - j| <= window and mask[j] (Tq == Tk).
// The dq block loops only over the key tiles that meet [q0 - window,
// q0 + 63 + window], the dk/dv block only over the q tiles that meet
// [k0 - window, k0 + 63 + window]: O(T * window) work, where the TPU grid
// walks 2R+1 clamped blocks. delta is folded into the dq prologue and the
// GQA group is summed in registers, as in flash_bwd: no per-q-head fp32
// temporaries. Own __global__ names and C entry (local_bwd_bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;          // 4 warps x 16 rows
constexpr int DQ_BQ = 64, DQ_BK = 64;  // dq kernel: q rows per block, keys per tile
constexpr int KV_BK = 64, KV_BQ = 32;  // dkv kernel: keys per block, q rows per tile
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// The dq and dk/dv bodies. BAND = false: the flash backward (causal with
// q_offset, or bidirectional; `window` unused). BAND = true: the banded
// backward (|i - j| <= window; causal and q_offset unused).
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

template <int D, bool BAND>
__device__ __forceinline__ void dq_body(DQ_PARAMS, int causal, int q_offset,
                                        int window, float scale) {
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

  // last key any row of this tile can see (causal tile skip); with BAND
  // also the first, so only the key tiles that meet the band are loaded
  int k_begin = 0, k_end = Tk;
  if (causal) {
    const int last_row = min(q0 + DQ_BQ, Tq) - 1;
    k_end = min(Tk, last_row + q_offset + 1);
  }
  if (BAND) {
    const int last_row = min(q0 + DQ_BQ, Tq) - 1;
    k_begin = max(0, q0 - window) / DQ_BK * DQ_BK;
    k_end = min(Tk, last_row + window + 1);
  }

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
        const bool ok = qi[half] < Tq && kvalid[kc] &&
                        (!causal || k0 + kc <= qi[half] + q_offset) &&
                        (!BAND || abs(k0 + kc - qi[half]) <= window);
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

template <int D, bool BAND>
__device__ __forceinline__ void dkv_body(DKV_PARAMS, int causal, int q_offset,
                                         int window, float scale) {
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

  // the first query that can see key k0 is k0 - q_offset (causal); with
  // BAND the q tiles that meet [k0 - window, k0 + 63 + window]
  int q_lo = causal ? max(0, k0 - q_offset) : 0, q_hi = Tq;
  if (BAND) {
    q_lo = max(0, k0 - window);
    q_hi = min(Tq, min(k0 + KV_BK, Tk) + window);
  }
  q_lo = (q_lo / KV_BQ) * KV_BQ;

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
          const bool ok = qi < Tq && kvalid[kl] && (!causal || k0 + kl <= qi + q_offset) &&
                          (!BAND || abs(k0 + kl - qi) <= window);
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
flash_bwd_dq_kernel(DQ_PARAMS, int causal, int q_offset, float scale) {
  dq_body<D, false>(DQ_ARGS, causal, q_offset, 0, scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(DKV_PARAMS, int causal, int q_offset, float scale) {
  dkv_body<D, false>(DKV_ARGS, causal, q_offset, 0, scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
local_bwd_dq_kernel(DQ_PARAMS, int window, float scale) {
  dq_body<D, true>(DQ_ARGS, 0, 0, window, scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
local_bwd_dkv_kernel(DKV_PARAMS, int window, float scale) {
  dkv_body<D, true>(DKV_ARGS, 0, 0, window, scale);
}

// Launches the dq kernel, then the dk/dv kernel, on `stream`: the flash pair
// (BAND = false, with causal and q_offset) or the banded pair (BAND = true,
// with window).
template <int D, bool BAND>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const int* mask, const __nv_bfloat16* o, const float* lse,
           const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
           __nv_bfloat16* dv, float* delta, int B, int Tq, int Tk, int Hq, int Hkv,
           const long long* st, int causal, int q_offset, int window, float scale,
           cudaStream_t stream) {
  // st: q, k, v, o, do, dq, dk, dv strides, (b, t, h) each
  const size_t smem_dq = dq_smem_bytes<D>(), smem_kv = dkv_smem_bytes<D>();
  constexpr auto kSmem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if constexpr (BAND) {
    err = cudaFuncSetAttribute(local_bwd_dq_kernel<D>, kSmem, (int)smem_dq);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(local_bwd_dkv_kernel<D>, kSmem, (int)smem_kv);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, kSmem, (int)smem_dq);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, kSmem, (int)smem_kv);
  }
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_dq((Tq + DQ_BQ - 1) / DQ_BQ, B * Hq);
  if constexpr (BAND)
    local_bwd_dq_kernel<D><<<grid_dq, NTHREADS, smem_dq, stream>>>(
        q, k, v, mask, o, lse, dout, dq, delta, Tq, Tk, Hq, Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
        window, scale);
  else
    flash_bwd_dq_kernel<D><<<grid_dq, NTHREADS, smem_dq, stream>>>(
        q, k, v, mask, o, lse, dout, dq, delta, Tq, Tk, Hq, Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
        causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || Tk <= 0) return (int)err;

  // delta comes from the dq kernel: the two launches are ordered on `stream`
  const dim3 grid_kv((Tk + KV_BK - 1) / KV_BK, B * Hkv);
  if constexpr (BAND)
    local_bwd_dkv_kernel<D><<<grid_kv, NTHREADS, smem_kv, stream>>>(
        q, k, v, mask, lse, delta, dout, dk, dv, Tq, Tk, Hq, Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[12], st[13], st[14], st[18], st[19], st[20], st[21], st[22], st[23],
        window, scale);
  else
    flash_bwd_dkv_kernel<D><<<grid_kv, NTHREADS, smem_kv, stream>>>(
        q, k, v, mask, lse, delta, dout, dk, dv, Tq, Tk, Hq, Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[12], st[13], st[14], st[18], st[19], st[20], st[21], st[22], st[23],
        causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches the dq kernel, then the
// dk/dv kernel, on `stream`; returns the first non-zero cudaError (0 =
// success). `strides` holds 24 values: (b, t, h) element strides of q, k,
// v, o, do, dq, dk, dv in that order; every tensor has a unit last stride.
extern "C" int flash_bwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv, void* delta,
    int B, int Tq, int Tk, int Hq, int Hkv, int D, const long long* strides,
    int causal, int q_offset, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
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
    return launch<64, false>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dlp, B, Tq, Tk,
                             Hq, Hkv, strides, causal, q_offset, 0, scale, st);
  if (D == 128)
    return launch<128, false>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dlp, B, Tq, Tk,
                              Hq, Hkv, strides, causal, q_offset, 0, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the banded backward (loaded with ctypes): the
// arguments of flash_bwd_bf16 with Tq == Tk == T and `window` in place of
// causal and q_offset; key j is visible to query i iff |i - j| <= window and
// mask[j]. Returns the first non-zero cudaError (0 = success).
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
    return launch<64, true>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dlp, B, T, T,
                            Hq, Hkv, strides, 0, 0, window, scale, st);
  if (D == 128)
    return launch<128, true>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dlp, B, T, T,
                             Hq, Hkv, strides, 0, 0, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
