// Flash attention in fp32 for Hopper (sm_90a): fp32 in, fp32 products, fp32
// out. The bf16 kernels (flash_fwd.cu, flash_bwd.cu) feed the tensor cores
// bf16 operands; the Pallas kernels they replace keep their operands in the
// input dtype, so on fp32 inputs the TPU computes fp32 products. These two
// kernels are that fp32 route, for every Pallas kernel of
// bioreason_tpu/ops/flash_attention.py and ops/local_attention.py:
//
//   flash_f32_fwd (flash_f32_fwd_kernel<BAND>): out and the fp32 LSE
//     replaces, on fp32 operands, flash_attention.py _fwd_kernel (:60) and
//     _fwd_single_kernel (:239); with BAND = true local_attention.py
//     _fwd_kernel (:46)
//   flash_f32_bwd (flash_f32_delta_kernel, flash_f32_dq_kernel<BAND>,
//     flash_f32_dkv_kernel<BAND>): dq, dk, dv
//     replaces, on fp32 operands, flash_attention.py _dq_kernel (:118),
//     _dkv_kernel (:160) and _bwd_single_kernel (:271); with BAND = true
//     local_attention.py _dq_kernel (:95) and _dkv_kernel (:133)
//
// Function (the wrappers' contract, as the bf16 kernels'): q [B,Tq,Hq,D],
// k/v [B,Tk,Hkv,D] with a unit last stride, mask [B,Tk] int32 or null
// (nonzero = valid), D in {64, 128}. GQA reads kv head h / (Hq/Hkv); K/V are
// never repeated. Causal: key j visible to query i iff j <= i + q_offset.
// Band (Tq == Tk): iff |i - j| <= window. A query row with no visible key
// gives out = 0, lse = -1e30 and dq = 0.
//
// Bound on an H100 SXM: fp32 outside the tensor cores runs at 67 TFLOP/s
// (FMA), so 4*D flops per visible (query, key) pair forward and 10*D
// backward against 4 bytes per element of q, k, v, o: ~4,000 flops per byte
// at the served prefill, far above the ridge (~20): operations-bound. TF32
// would keep ~3 decimal digits, not fp32's, so every product is an FFMA.
//
// Design (simple and right first): one CTA of 256 threads per 64-row q tile
// (forward, dq) or 64-key tile (dk, dv). Tiles are staged in shared memory
// as fp32 rows padded by one word, so the 16 threads of a half-warp reading
// 16 rows at one column hit 16 banks. Each thread holds a 4 x 4 block of the
// score tile S = Q K^T (rows ty*4.., keys tx + 16*j) in registers, so one
// shared load feeds four FMAs; the online softmax reduces a row over the 16
// threads that share it with shuffles; P goes through shared memory into
// the O += P V product, where each thread owns 4 rows x D/16 columns. The
// backward recomputes P from the saved LSE: the dq kernel walks key tiles
// for its q tile, the dk/dv kernel walks q tiles, and every q head of its
// GQA group, for its key tile, so each output is written once by one CTA,
// with no atomics and in a fixed order. A delta pass (rowsum(dO * O)) runs
// first. Tiles wholly outside the causal reach or the band are skipped.

#include <cuda_runtime.h>
#include <math.h>

namespace f32fa {

constexpr int BM = 64;          // query rows per tile
constexpr int BN = 64;          // keys per tile
constexpr int NT = 256;         // threads: ty = tid / 16 (16 row groups), tx = tid % 16
constexpr float NEG_INF = -1e30f;

struct Strides {                // element strides (batch, time, head) of one tensor
  long long b, t, h;
};

// key j visible to query i (both in range, mask already applied); the band
// |i - j| <= W as one unsigned compare, (j - i + W) <= 2W
template <bool BAND>
__device__ __forceinline__ bool visible(int i, int j, int causal, int q_offset, int window) {
  if (BAND) return (unsigned)(j - i + window) <= 2u * (unsigned)window;
  return !causal || j <= i + q_offset;
}

// rows r0.. of one (batch, head) slice into dst [n][LD]; rows past `rows` are 0
template <int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long st, int r0,
                                          int rows, int n) {
  for (int idx = threadIdx.x; idx < n * D; idx += NT) {
    const int r = idx / D, c = idx % D, t = r0 + r;
    dst[r * LD + c] = t < rows ? src[(long long)t * st + c] : 0.f;
  }
}

// the key tile's validity: in range and unmasked
__device__ __forceinline__ void load_key_valid(int* kval, const int* mask, int b, int Tk, int k0) {
  if (threadIdx.x < BN) {
    const int j = k0 + threadIdx.x;
    kval[threadIdx.x] = j < Tk && (mask == nullptr || mask[(long long)b * Tk + j] != 0);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the keys [lo, hi) that some query of rows [q0, q1) may see
template <bool BAND>
__device__ __forceinline__ void key_range(int q0, int q1, int Tk, int causal, int q_offset,
                                          int window, int& lo, int& hi) {
  if (BAND) {
    lo = max(0, q0 - window);
    hi = min(Tk, q1 - 1 + window + 1);
  } else {
    lo = 0;
    hi = causal ? min(Tk, q1 - 1 + q_offset + 1) : Tk;
  }
}

// the queries [lo, hi) that may see some key of [k0, k1)
template <bool BAND>
__device__ __forceinline__ void query_range(int k0, int k1, int Tq, int causal, int q_offset,
                                            int window, int& lo, int& hi) {
  if (BAND) {
    lo = max(0, k0 - window);
    hi = min(Tq, k1 - 1 + window + 1);
  } else {
    lo = causal ? max(0, k0 - q_offset) : 0;
    hi = Tq;
  }
}

// s[i][j] += A[ty*4+i] . B[tx+16j]: the thread's 4 x 4 register block of a
// [64 x 64] product of row-major tiles [64][LD]
template <int D, int LD>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, float (&s)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty * 4 + i) * LD + d];
      bb[i] = Bm[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// `tile_dot` of (A, B) into s and of (A2, B2) into s2, one pass over D
template <int D, int LD>
__device__ __forceinline__ void tile_dot2(const float* A, const float* Bm, const float* A2,
                                          const float* B2, float (&s)[4][4],
                                          float (&s2)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4], a2[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty * 4 + i) * LD + d];
      bb[i] = Bm[(tx + 16 * i) * LD + d];
      a2[i] = A2[(ty * 4 + i) * LD + d];
      b2[i] = B2[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        s2[i][j] = fmaf(a2[i], b2[j], s2[i][j]);
      }
  }
}

template <bool BAND, int D>
__global__ void __launch_bounds__(NT)
flash_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int Hq,
                     int Hkv, Strides sq, Strides sk, Strides sv, Strides so, int causal,
                     int q_offset, int window, float scale) {
  constexpr int LDK = D + 1, LDS = BN + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BM][LDK]
  float* Ks = Qs + BM * LDK;              // [BN][LDK]
  float* Vs = Ks + BN * LDK;              // [BN][D]
  float* Ps = Vs + BN * D;                // [BM][LDS]
  int* kval = reinterpret_cast<int*>(Ps + BM * LDS);   // [BN]

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  load_rows<D, LDK>(Qs, qb, sq.t, q0, Tq, BM);

  int k_lo, k_hi;
  key_range<BAND>(q0, min(q0 + BM, Tq), Tk, causal, q_offset, window, k_lo, k_hi);
  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = k_lo / BN * BN; k0 < k_hi; k0 += BN) {
    __syncthreads();                      // the previous tile's readers are done
    load_rows<D, LDK>(Ks, kb, sk.t, k0, Tk, BN);
    load_rows<D, D>(Vs, vb, sv.t, k0, Tk, BN);
    load_key_valid(kval, mask, b, Tk, k0);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D, LDK>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jl = tx + 16 * j;
        const bool vis = qi < Tq && kval[jl] && visible<BAND>(qi, k0 + jl, causal, q_offset, window);
        s[i][j] = vis ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(m[i], half_warp_max(mx));
      float alpha = 1.f, rs = 0.f;
      if (mnew != -INFINITY) {
        alpha = expf(m[i] - mnew);        // 0 while no key was visible yet
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mnew);
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < Tq) {
      const bool any = l[i] > 0.f;
      const float inv = any ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) ob[qi * so.t + tx + 16 * c] = acc[i][c] * inv;
      if (tx == 0) lse[((long long)b * Hq + h) * Tq + qi] = any ? m[i] + logf(l[i]) : NEG_INF;
    }
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp per row
__global__ void __launch_bounds__(NT)
flash_f32_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int B, int Tq, int Hq, int D, Strides so,
                       Strides sd) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= (long long)B * Hq * Tq) return;
  const int i = row % Tq, h = (row / Tq) % Hq, b = row / ((long long)Tq * Hq);
  const float* op = o + b * so.b + i * so.t + h * so.h;
  const float* dp = dout + b * sd.b + i * sd.t + h * sd.h;
  float acc = 0.f;
  for (int c = threadIdx.x % 32; c < D; c += 32) acc = fmaf(op[c], dp[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) delta[row] = acc;
}

// P = exp(S * scale - lse) and dS = P * (dP - delta) on the visible pairs of
// one [64 q x 64 k] tile (0 elsewhere), in place of s and dp
template <bool BAND>
__device__ __forceinline__ void probs_and_ds(float (&s)[4][4], float (&dp)[4][4], int q0, int k0,
                                             int Tq, const int* kval, const float* lse_s,
                                             const float* delta_s, int causal, int q_offset,
                                             int window, float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jl = tx + 16 * j;
      const bool vis = qi < Tq && kval[jl] && visible<BAND>(qi, k0 + jl, causal, q_offset, window);
      const float p = vis ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// the lse and delta of q rows q0.. of head h (0 past Tq)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s, const float* lse,
                                               const float* delta, long long bh, int Tq, int q0) {
  if (threadIdx.x < BM) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < Tq ? lse[bh * Tq + qi] : 0.f;
    delta_s[threadIdx.x] = qi < Tq ? delta[bh * Tq + qi] : 0.f;
  }
}

template <bool BAND, int D>
__global__ void __launch_bounds__(NT)
flash_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ dout,
                    const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk,
                    int Hq, int Hkv, Strides sq, Strides sk, Strides sv, Strides sd,
                    Strides sdq, int causal, int q_offset, int window, float scale) {
  constexpr int LDK = D + 1, LDS = BN + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BM][LDK]
  float* dOs = Qs + BM * LDK;             // [BM][LDK]
  float* Ks = dOs + BM * LDK;             // [BN][LDK]
  float* Vs = Ks + BN * LDK;              // [BN][LDK]
  float* dSs = Vs + BN * LDK;             // [BM][LDS]
  float* lse_s = dSs + BM * LDS;          // [BM]
  float* delta_s = lse_s + BM;            // [BM]
  int* kval = reinterpret_cast<int*>(delta_s + BM);   // [BN]

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long bh = (long long)b * Hq + h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  load_rows<D, LDK>(Qs, q + b * sq.b + h * sq.h, sq.t, q0, Tq, BM);
  load_rows<D, LDK>(dOs, dout + b * sd.b + h * sd.h, sd.t, q0, Tq, BM);
  load_row_stats(lse_s, delta_s, lse, delta, bh, Tq, q0);

  int k_lo, k_hi;
  key_range<BAND>(q0, min(q0 + BM, Tq), Tk, causal, q_offset, window, k_lo, k_hi);
  float acc[4][NC] = {};
  for (int k0 = k_lo / BN * BN; k0 < k_hi; k0 += BN) {
    __syncthreads();
    load_rows<D, LDK>(Ks, kb, sk.t, k0, Tk, BN);
    load_rows<D, LDK>(Vs, vb, sv.t, k0, Tk, BN);
    load_key_valid(kval, mask, b, Tk, k0);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot2<D, LDK>(Qs, Ks, dOs, Vs, s, dp);
    probs_and_ds<BAND>(s, dp, q0, k0, Tq, kval, lse_s, delta_s, causal, q_offset, window, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty * 4 + i) * LDS + tx + 16 * j] = dp[i][j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float ds[4], kk[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = Ks[j * LDK + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
  }
  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < Tq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) dqb[qi * sdq.t + tx + 16 * c] = acc[i][c] * scale;
    }
  }
}

template <bool BAND, int D>
__global__ void __launch_bounds__(NT)
flash_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ dout,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, int Hq, int Hkv, Strides sq,
                     Strides sk, Strides sv, Strides sd, Strides sdk, Strides sdv, int causal,
                     int q_offset, int window, float scale) {
  constexpr int LDK = D + 1, LDS = BN + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                       // [BN][LDK]
  float* Vs = Ks + BN * LDK;              // [BN][LDK]
  float* Qs = Vs + BN * LDK;              // [BM][LDK]
  float* dOs = Qs + BM * LDK;             // [BM][LDK]
  float* Ps = dOs + BM * LDK;             // [BM][LDS]
  float* dSs = Ps + BM * LDS;             // [BM][LDS]
  float* lse_s = dSs + BM * LDS;          // [BM]
  float* delta_s = lse_s + BM;            // [BM]
  int* kval = reinterpret_cast<int*>(delta_s + BM);   // [BN]

  const int k0 = blockIdx.x * BN, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_rows<D, LDK>(Ks, k + b * sk.b + hk * sk.h, sk.t, k0, Tk, BN);
  load_rows<D, LDK>(Vs, v + b * sv.b + hk * sv.h, sv.t, k0, Tk, BN);
  load_key_valid(kval, mask, b, Tk, k0);

  int q_lo, q_hi;
  query_range<BAND>(k0, min(k0 + BN, Tk), Tq, causal, q_offset, window, q_lo, q_hi);
  float dk_acc[4][NC] = {}, dv_acc[4][NC] = {};
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = (long long)b * Hq + h;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* db = dout + b * sd.b + h * sd.h;
    for (int q0 = q_lo / BM * BM; q0 < q_hi; q0 += BM) {
      __syncthreads();
      load_rows<D, LDK>(Qs, qb, sq.t, q0, Tq, BM);
      load_rows<D, LDK>(dOs, db, sd.t, q0, Tq, BM);
      load_row_stats(lse_s, delta_s, lse, delta, bh, Tq, q0);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      tile_dot2<D, LDK>(Qs, Ks, dOs, Vs, s, dp);
      probs_and_ds<BAND>(s, dp, q0, k0, Tq, kval, lse_s, delta_s, causal, q_offset, window,
                         scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j];
          dSs[(ty * 4 + i) * LDS + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dv[key] += P[:, key]^T dO, dk[key] += dS[:, key]^T Q: this thread's
      // keys are ty*4 + i, its columns tx + 16*c
#pragma unroll 2
      for (int r = 0; r < BM; ++r) {
        float p[4], ds[4], gg[NC], qq[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * LDS + ty * 4 + i];
          ds[i] = dSs[r * LDS + ty * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          gg[c] = dOs[r * LDK + tx + 16 * c];
          qq[c] = Qs[r * LDK + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] = fmaf(p[i], gg[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qq[c], dk_acc[i][c]);
          }
      }
    }
  }
  float* dkb = dk + b * sdk.b + hk * sdk.h;
  float* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj < Tk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dkb[kj * sdk.t + tx + 16 * c] = dk_acc[i][c] * scale;
        dvb[kj * sdv.t + tx + 16 * c] = dv_acc[i][c];
      }
    }
  }
}

template <int D> constexpr int fwd_smem() {
  return (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + BN) * 4;
}
template <int D> constexpr int dq_smem() {
  return (2 * BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1) + 2 * BM + BN) * 4;
}
template <int D> constexpr int dkv_smem() {
  return (2 * BN * (D + 1) + 2 * BM * (D + 1) + 2 * BM * (BN + 1) + 2 * BM + BN) * 4;
}

inline Strides st3(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <bool BAND, int D>
int fwd(const float* q, const float* k, const float* v, const int* mask, float* o, float* lse,
        int B, int Tq, int Tk, int Hq, int Hkv, const long long* s, int causal, int q_offset,
        int window, float scale, cudaStream_t stream) {
  // once per instantiation (and never inside a CUDA graph's capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_fwd_kernel<BAND, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<D>());
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Tq + BM - 1) / BM, Hq, B);
  flash_f32_fwd_kernel<BAND, D><<<grid, NT, fwd_smem<D>(), stream>>>(
      q, k, v, mask, o, lse, Tq, Tk, Hq, Hkv, st3(s), st3(s + 3), st3(s + 6), st3(s + 9),
      causal, q_offset, window, scale);
  return (int)cudaGetLastError();
}

template <bool BAND, int D>
int bwd(const float* q, const float* k, const float* v, const int* mask, const float* o,
        const float* lse, const float* dout, float* dq, float* dk, float* dv, float* delta,
        int B, int Tq, int Tk, int Hq, int Hkv, const long long* s, int causal, int q_offset,
        int window, float scale, cudaStream_t stream) {
  // strides: q k v o dout dq dk dv, three each
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_f32_dq_kernel<BAND, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_f32_dkv_kernel<BAND, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem<D>());
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  cudaError_t err;
  const long long rows = (long long)B * Hq * Tq;
  flash_f32_delta_kernel<<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      o, dout, delta, B, Tq, Hq, D, st3(s + 9), st3(s + 12));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_f32_dq_kernel<BAND, D><<<dim3((Tq + BM - 1) / BM, Hq, B), NT, dq_smem<D>(), stream>>>(
      q, k, v, mask, lse, dout, delta, dq, Tq, Tk, Hq, Hkv, st3(s), st3(s + 3), st3(s + 6),
      st3(s + 12), st3(s + 15), causal, q_offset, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_f32_dkv_kernel<BAND, D><<<dim3((Tk + BN - 1) / BN, Hkv, B), NT, dkv_smem<D>(), stream>>>(
      q, k, v, mask, lse, dout, delta, dk, dv, Tq, Tk, Hq, Hkv, st3(s), st3(s + 3), st3(s + 6),
      st3(s + 12), st3(s + 18), st3(s + 21), causal, q_offset, window, scale);
  return (int)cudaGetLastError();
}

inline bool bad_args(int B, int Tq, int Tk, int Hq, int Hkv, int D, int window) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 ||
         Hq > 65535 || (D != 64 && D != 128) || (window >= 0 && Tq != Tk);
}

}  // namespace f32fa

// Plain C entry (loaded with ctypes): out [B,Tq,Hq,D] fp32 and lse [B,Hq,Tq]
// fp32 of fp32 q, k, v. strides: 12 element strides (batch, time, head) of
// q, k, v, o. window < 0: causal / bidirectional flash attention; window >=
// 0: the band |i - j| <= window (Tq == Tk; causal ignored). Launches on
// `stream`; returns 0 or a cudaError.
extern "C" int flash_f32_fwd(const void* q, const void* k, const void* v, const void* mask,
                             void* o, void* lse, int B, int Tq, int Tk, int Hq, int Hkv, int D,
                             const long long* strides, int causal, int q_offset, int window,
                             float scale, void* stream) {
  using namespace f32fa;
  if (bad_args(B, Tq, Tk, Hq, Hkv, D, window)) return (int)cudaErrorInvalidValue;
  auto* qp = static_cast<const float*>(q);
  auto* kp = static_cast<const float*>(k);
  auto* vp = static_cast<const float*>(v);
  auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  if (window >= 0)
    return D == 64 ? fwd<true, 64>(qp, kp, vp, mp, op, lp, B, Tq, Tk, Hq, Hkv, strides, 0, 0,
                                   window, scale, st)
                   : fwd<true, 128>(qp, kp, vp, mp, op, lp, B, Tq, Tk, Hq, Hkv, strides, 0, 0,
                                    window, scale, st);
  return D == 64 ? fwd<false, 64>(qp, kp, vp, mp, op, lp, B, Tq, Tk, Hq, Hkv, strides, causal,
                                  q_offset, -1, scale, st)
                 : fwd<false, 128>(qp, kp, vp, mp, op, lp, B, Tq, Tk, Hq, Hkv, strides, causal,
                                   q_offset, -1, scale, st);
}

// Plain C entry (loaded with ctypes): dq, dk, dv (fp32, their own strides)
// of `flash_f32_fwd` given its out and lse and the output gradient dout;
// delta [B*Hq*Tq] fp32 is scratch. strides: 24 element strides (batch, time,
// head) of q, k, v, o, dout, dq, dk, dv. Launches the delta pass, the dq
// kernel and the dk/dv kernel on `stream`; returns 0 or a cudaError.
extern "C" int flash_f32_bwd(const void* q, const void* k, const void* v, const void* mask,
                             const void* o, const void* lse, const void* dout, void* dq,
                             void* dk, void* dv, void* delta, int B, int Tq, int Tk, int Hq,
                             int Hkv, int D, const long long* strides, int causal, int q_offset,
                             int window, float scale, void* stream) {
  using namespace f32fa;
  if (bad_args(B, Tq, Tk, Hq, Hkv, D, window)) return (int)cudaErrorInvalidValue;
  auto* qp = static_cast<const float*>(q);
  auto* kp = static_cast<const float*>(k);
  auto* vp = static_cast<const float*>(v);
  auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<const float*>(o);
  auto* lp = static_cast<const float*>(lse);
  auto* dop = static_cast<const float*>(dout);
  auto* dqp = static_cast<float*>(dq);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  auto* dl = static_cast<float*>(delta);
  auto st = static_cast<cudaStream_t>(stream);
  if (window >= 0)
    return D == 64 ? bwd<true, 64>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dl, B, Tq, Tk, Hq,
                                   Hkv, strides, 0, 0, window, scale, st)
                   : bwd<true, 128>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dl, B, Tq, Tk,
                                    Hq, Hkv, strides, 0, 0, window, scale, st);
  return D == 64 ? bwd<false, 64>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dl, B, Tq, Tk, Hq,
                                  Hkv, strides, causal, q_offset, -1, scale, st)
                 : bwd<false, 128>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dl, B, Tq, Tk, Hq,
                                   Hkv, strides, causal, q_offset, -1, scale, st);
}
