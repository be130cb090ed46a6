// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the two Pallas forward kernels of bioreason_tpu/ops/flash_attention.py:
//   _fwd_kernel        (:60)  tiled online-softmax forward, out + fp32 LSE
//   _fwd_single_kernel (:239) whole-sequence forward with causal row groups
// Both compute the same function; on this card one tiled kernel covers both,
// and its causal tile skip is what the TPU kernel's row groups do.
//
// local_fwd_kernel, the same body with BAND = true, replaces the banded
// forward of bioreason_tpu/ops/local_attention.py:
//   _fwd_kernel        (:46)  key j visible to query i iff |i - j| <= window
//                             and mask[j]; self-attention, Tq == Tk
// The TPU kernel's grid is 2R+1 key blocks wide with the block index clamped
// to the band; here each 64-row q tile loops only over the 64-key tiles that
// meet [q0 - window, q0 + 63 + window], so the work is O(T * window). Its own
// __global__ name and C entry (local_fwd_bf16) keep it apart from flash_fwd
// in a profile. Bound: the band's visible pairs are ~2W+1 per query, so at
// the long-DNA encoder (D=64, W=256) it does ~64 flops per byte of q, k, v
// and o: bytes-bound, far below the card's ridge.
//
// Function: q [B,Tq,Hq,D], k/v [B,Tk,Hkv,D] (any strides with a unit last
// stride, rows 16-byte aligned), optional key-padding mask [B,Tk] int32
// (nonzero = valid) -> o [B,Tq,Hq,D] bf16 (its own strides) and
// lse [B,Hq,Tq] fp32. GQA reads kv head h / (Hq/Hkv); K/V are never
// repeated. Causal: key j is visible to query i iff j <= i + q_offset.
// A query row with no visible key gives o = 0 and lse = -1e30.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4*D flops per
// visible (query, key) pair against 2*D bytes per row of q, k, v and o. At
// the serving shapes that is ~170 flops/byte for the encoder (D=64, T=344,
// bidirectional) and ~320 for the prefill (D=128, T~900, causal, GQA 2),
// either side of the card's ridge (~295 flops/byte): the prefill is bounded
// by tensor-core throughput, the encoder about equally by both. This first
// kernel uses mma.sync without overlapping loads and math, so it sits well
// above either bound (PERF.md has the measured gap).
//
// Design, simple and right first:
//   * one block of 4 warps per (b*Hq, 64-row q tile); each warp owns 16 rows;
//   * a loop over 64-key K/V tiles staged in padded shared memory (rows of
//     D+8 elements: the fragment loads below are bank-conflict free);
//   * S = Q K^T and O += P V on the tensor cores with mma.sync m16n8k16
//     (bf16 x bf16 -> fp32); Q fragments stay in registers for the whole
//     loop, V fragments come from shared memory through ldmatrix.trans;
//   * online softmax in fp32 registers; the S accumulator layout is reused
//     as the A operand of P V (the FlashAttention-2 register trick), so P
//     never touches shared memory;
//   * key tiles wholly above the causal diagonal are never loaded;
//   * ragged edges are masked here: keys past Tk load as zeros and are
//     invalid, query rows past Tq are not stored.
// Not yet: wgmma, TMA, a producer warp, double buffering (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The body of both kernels. BAND = false: the flash forward (causal with
// q_offset, or bidirectional; `window` unused). BAND = true: the banded
// forward (|i - j| <= window on array indices; causal and q_offset unused).
template <int D, bool BAND>
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
         int causal, int q_offset, int window, float scale) {
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
  const int qpos0 = q0 + r0 + q_offset;
  const int qpos1 = qpos0 + 8;

  // last key any row of this tile can see (causal tile skip); with BAND
  // also the first, so only the key tiles that meet the band are loaded
  int k_begin = 0, k_end = Tk;
  if (causal) {
    const int last_row = min(q0 + BQ, Tq) - 1;
    k_end = min(Tk, last_row + q_offset + 1);
  }
  if (BAND) {
    const int last_row = min(q0 + BQ, Tq) - 1;
    k_begin = max(0, q0 - window) / BK * BK;
    k_end = min(Tk, last_row + window + 1);
  }

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
        const bool ok = kvalid[kc] && (!causal || k0 + kc <= qp) &&
                        (!BAND || abs(k0 + kc - qp) <= window);
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
        const bool ok = kvalid[kc] && (!causal || k0 + kc <= qp) &&
                        (!BAND || abs(k0 + kc - qp) <= window);
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
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, int Hq, int Hkv,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 int causal, int q_offset, float scale) {
  fwd_body<D, false>(q, k, v, mask, o, lse, Tq, Tk, Hq, Hkv, q_sb, q_st, q_sh,
                     k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                     causal, q_offset, 0, scale);
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
  fwd_body<D, true>(q, k, v, mask, o, lse, T, T, Hq, Hkv, q_sb, q_st, q_sh,
                    k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                    0, 0, window, scale);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int Tq, int Tk, int Hq, int Hkv, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_offset, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tq + BQ - 1) / BQ, B * Hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 64) {
    flash_fwd_kernel<64><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, mp, op, lp, Tq, Tk, Hq, Hkv, q_sb, q_st, q_sh, k_sb, k_st,
        k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, q_offset, scale);
  } else if (D == 128) {
    flash_fwd_kernel<128><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, mp, op, lp, Tq, Tk, Hq, Hkv, q_sb, q_st, q_sh, k_sb, k_st,
        k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, q_offset, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
