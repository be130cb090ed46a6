// Flash attention in fp32 for Hopper (sm_90a): fp32 in, split-TF32 products
// on the tensor cores, fp32 out. The bf16 kernels (flash_fwd.cu,
// flash_bwd.cu) feed the tensor cores bf16 operands; the Pallas kernels they
// replace keep their operands in the input dtype, so on fp32 inputs the TPU
// computes fp32 products. These two kernels are that fp32 route, for every
// Pallas kernel of bioreason_tpu/ops/flash_attention.py and
// ops/local_attention.py:
//
//   flash_f32_fwd (flash_f32_fwd_kernel<BAND, D>): out and the fp32 LSE
//     replaces, on fp32 operands, flash_attention.py _fwd_kernel (:60) and
//     _fwd_single_kernel (:239); with BAND = true local_attention.py
//     _fwd_kernel (:46)
//   flash_f32_bwd (flash_f32_delta_kernel, flash_f32_dq_kernel<BAND, D>,
//     flash_f32_dkv_kernel<BAND, D>): dq, dk, dv
//     replaces, on fp32 operands, flash_attention.py _dq_kernel (:118),
//     _dkv_kernel (:160) and _bwd_single_kernel (:271); with BAND = true
//     local_attention.py _dq_kernel (:95) and _dkv_kernel (:133)
//
// Function (the wrappers' contract, as the bf16 kernels'): q [B,Tq,Hq,D],
// k/v [B,Tk,Hkv,D] with a unit last stride, 16-byte aligned bases and
// strides (TMA's rule), mask [B,Tk] int32 or null (nonzero = valid), D in
// {64, 128}. GQA reads kv head h / (Hq/Hkv); K/V are never repeated.
// Causal: key j visible to query i iff j <= i + q_offset. Band (Tq == Tk):
// iff |i - j| <= window. A query row with no visible key gives out = 0,
// lse = -1e30 and dq = 0.
//
// Precision: split TF32 (3xTF32). Every product of fp32 operands a . b
// runs as three TF32 wgmma passes, lo_a hi_b + hi_a lo_b + hi_a hi_b, into
// fp32 accumulators, with hi = tf32(x) and lo = tf32(x - hi) by
// cvt.rna.tf32.f32: ~2^-22 relative per product, the error of an fp32
// product, where one TF32 pass keeps ~3 decimal digits. It is what
// PyTorch's fp32 SDPA (the memory-efficient kernel, CUTLASS's
// OpMultiplyAddFastF32) does. No product runs as one TF32 pass; the
// softmax, the LSE, delta and dS stay fp32 with expf / logf.
//
// Bound on an H100 SXM: the tensor cores run TF32 at 495 TFLOP/s and three
// passes make 165 TFLOP/s of fp32-accurate products, against 4*D flops per
// visible (query, key) pair forward and 10*D backward and 4 bytes per
// element of q, k, v, o at 3.35 TB/s: operations-bound at the route's
// main shapes (~4,000 flops per byte at the served prefill; the smallest
// calls, a 300-row batch or a band of W <= 64, are bytes-bound). The bound
// is max(3 * FLOPs / 495e12, bytes / 3.35e12); the FFMA bound of the
// CUDA-core design this one replaced (FLOPs / 67e12) is printed beside it.
//
// Design (producer warpgroups and one consumer warpgroup of 64 rows per
// CTA, 224 KB of shared memory at D = 128, so one CTA per SM):
//   * loads: TMA over 4-D tensor maps of the [B, T, H, D] tensors, boxes of
//     32 fp32 (128 bytes) with the 128-byte swizzle (D = 128 is four boxes),
//     completing on mbarriers; one producer thread issues them;
//   * the split step: the producer threads (two warpgroups in the forward
//     at D = 128 and in dq, where the consumer's registers leave room; one
//     in dk/dv, whose consumer holds dk and dv) turn each staged fp32
//     tile into its hi and lo operand tiles in shared memory,
//     K-major and swizzled as wgmma reads them: in place (hi over the fp32
//     tile, lo beside it) where the tile is already K-major, and with a
//     transpose where the contraction runs along time (V for O = P V; K for
//     dQ = dS K; Q and dO for dK = dS^T Q and dV = P^T dO), since TF32
//     wgmma has no transpose bit. Each operand is split once per CTA, and
//     the split of one tile overlaps the products of another;
//   * products: wgmma m64nNk8 TF32, three passes each. S, dP (and S^T,
//     dP^T) take both operands from shared memory; the second product of
//     each pair takes P or dS (P^T, dS^T) as the register A operand, split
//     in registers. Its fragment wants k columns t and t + 4 where the
//     accumulator holds columns 2t and 2t + 1, so the transposed B tile
//     stores the keys (queries) of each 8-block in the order perm8: the
//     fragment is then the thread's own accumulator registers, with no
//     shuffle and no trip through shared memory;
//   * forward: Q once; a ring of two stages of K (TMA'd into the stage and
//     split in place) and V (staged, then split and transposed), 32 keys
//     a tile at D = 128 and 64 at D = 64. S of tile it and P V of tile it - 1
//     are issued together and the softmax of tile it runs while P V does;
//   * dq: Q and dO once; one buffer each for K, V and K^T (32 keys at
//     D = 128, 64 at D = 64), each released as soon as the product that
//     reads it (S and dP, then dQ) is done, so the next tile's loads and
//     split start while this tile's dS and dQ are computed;
//   * dk/dv: K and V once, then 32-row (D = 128) or 64-row (D = 64) q tiles
//     of every q head of the GQA group, staged by TMA, split K-major into a
//     region for S^T and dP^T, then transposed in place in that region for
//     dK and dV; two regions at D = 64 (where they fit), so the next tile's
//     split overlaps this one's products;
//   * the backward recomputes P from the saved LSE: the dq kernel walks key
//     tiles for its q tile, the dk/dv kernel q tiles for its key tile,
//     keeping dk and dv in registers: each gradient element is written once
//     by one CTA, in a fixed order, with no atomics, so dq, dk and dv are
//     bitwise reproducible. A delta pass (rowsum(dO * O)) runs first;
//   * tiles wholly outside the causal reach or the band are never loaded;
//     the per-pair predicate (key valid, query in range, causal reach or
//     |i - j| <= W as one unsigned compare) selects P = 0 elsewhere, and the
//     forward compiles it out of tiles whose pairs are all visible. TMA
//     fills rows past T with zeros; rows past Tq are not stored. The grid
//     is linear, heaviest tiles first.
// `python3 -m bioreason_tpu_torch.tools.kernel_variants flash_f32_fwd
// flash_f32_bwd` times the kernels with parts of the work taken out.

#include "sm90.cuh"

namespace f32fa {

using sm90::fence_regs;
using sm90::make_desc;
using sm90::mbar_arrive;
using sm90::mbar_wait;

constexpr int NC = 128;            // one consumer warpgroup
constexpr int BM = 64;             // query rows of a forward / dq tile, keys of a dk/dv tile
constexpr float NEG_INF = -1e30f;

constexpr int STAGES = 2;         // the forward's K / V ring

template <int D>
struct Tiles {
  static constexpr int FWD_BN = D == 128 ? 32 : 64;  // keys per forward tile
  static constexpr int DQ_BN = D == 128 ? 32 : 64;   // keys per dq tile
  static constexpr int DKV_BQ = D == 128 ? 32 : 64;  // q rows per dk/dv tile
};

struct Strides {                // element strides (batch, time, head) of one tensor
  long long b, t, h;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// key j visible to query i (both in range, mask already applied); the band
// |i - j| <= W as one unsigned compare, (j - i + W) <= 2W
template <bool BAND>
__device__ __forceinline__ bool visible(int i, int j, int causal, int q_offset, int window) {
  if (BAND) return (unsigned)(j - i + window) <= 2u * (unsigned)window;
  return !causal || j <= i + q_offset;
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

// ---- shared-memory tiles ---------------------------------------------------

// The 1024-byte aligned base of the dynamic shared memory, reached by
// pointer arithmetic on the shared array so that the compiler keeps the
// split step's accesses as shared-memory loads and stores (LDS / STS), not
// generic ones.
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024u - (sm90::smem_u32(raw) & 1023u)) & 1023u);
}

// Byte offset of element (r, c) of an fp32 tile of R rows, K-major and
// 128-byte swizzled as TMA writes it: box c / 32 of R rows x 128 bytes,
// 16-byte chunk (c / 4) % 8 of row r at position chunk ^ (r % 8).
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 5) * (R * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
                    ((c & 3) << 2));
}

// The k position of key (or query) e in a transposed B tile: inside each
// 8-block, e = 2t goes to t and e = 2t + 1 to t + 4, so the register A
// fragment's k columns t, t + 4 are the accumulator's columns 2t, 2t + 1.
__device__ __forceinline__ int perm8(int e) {
  return (e & ~7) | ((e & 7) >> 1) | ((e & 1) << 2);
}

// wgmma descriptor of k8 step kk of a K-major tile of R rows
template <int R>
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int kk) {
  return make_desc(tile + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ void split4(const float4 x, uint4& h, uint4& l) {
  sm90::split_tf32(x.x, h.x, l.x);
  sm90::split_tf32(x.y, h.y, l.y);
  sm90::split_tf32(x.z, h.z, l.z);
  sm90::split_tf32(x.w, h.w, l.w);
}

// The split step without a transpose, by the NP producer threads (thread
// pt): the fp32 tile at src (BYTES long) into hi and lo tiles of the same
// layout (src may be hi: in place).
template <int BYTES, int NP>
__device__ __forceinline__ void split_tile(const uint8_t* src, uint8_t* hi, uint8_t* lo,
                                           int pt) {
#pragma unroll 4
  for (int o = pt * 16; o < BYTES; o += NP * 16) {
    const float4 x = *reinterpret_cast<const float4*>(src + o);
    uint4 h, l;
    split4(x, h, l);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// The split step with a transpose: the tile src [R rows x C columns] into
// dst_hi, dst_lo [C rows x R columns], row r of src going to column
// perm8(r). SPLIT: src_hi is fp32, split here; else src_hi and src_lo are
// split tiles, each transposed. A warp's 32 lanes take 32 rows of one
// 4-column chunk, so each transposed store fills one 128-byte row.
template <int R, int C, bool SPLIT, int NP>
__device__ __forceinline__ void transpose_tile(const uint8_t* src_hi, const uint8_t* src_lo,
                                               uint8_t* dst_hi, uint8_t* dst_lo, int pt) {
  constexpr int RG = R / 32, ITEMS = RG * (C / 4);
  const int lane = pt & 31;
#pragma unroll 2
  for (int w = pt >> 5; w < ITEMS; w += NP / 32) {
    const int r = (w % RG) * 32 + lane, c = (w / RG) * 4;
    const uint32_t so = swz<R>(r, c);
    const int pr = perm8(r);
    const float4 x = *reinterpret_cast<const float4*>(src_hi + so);
    uint4 h, l;
    if constexpr (SPLIT) {
      split4(x, h, l);
    } else {
      const float4 y = *reinterpret_cast<const float4*>(src_lo + so);
      h = make_uint4(__float_as_uint(x.x), __float_as_uint(x.y), __float_as_uint(x.z),
                     __float_as_uint(x.w));
      l = make_uint4(__float_as_uint(y.x), __float_as_uint(y.y), __float_as_uint(y.z),
                     __float_as_uint(y.w));
    }
    const uint32_t hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t d = swz<C>(c + i, pr);
      *reinterpret_cast<uint32_t*>(dst_hi + d) = hs[i];
      *reinterpret_cast<uint32_t*>(dst_lo + d) = ls[i];
    }
  }
}

// The tile [R rows x C columns] transposed in place into [C rows x R
// columns], row r going to column perm8(r), by one producer warpgroup:
// every thread reads its chunks, the warpgroup meets, then writes them back
// transposed.
template <int R, int C>
__device__ __forceinline__ void transpose_inplace(uint8_t* tile, int pt) {
  constexpr int RG = R / 32, PER = RG * (C / 4) / 4;
  const int lane = pt & 31;
  float4 x[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int w = (pt >> 5) + 4 * i;
    x[i] = *reinterpret_cast<const float4*>(tile + swz<R>((w % RG) * 32 + lane, (w / RG) * 4));
  }
  sm90::named_barrier(1, 128);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int w = (pt >> 5) + 4 * i, c = (w / RG) * 4, pr = perm8((w % RG) * 32 + lane);
    const float v[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<float*>(tile + swz<C>(c + j, pr)) = v[j];
  }
}

// TMA of rows t0.. of head h, batch b of a [B, T, H, D] map into a tile of
// `rows` rows (D / 32 boxes), completing on bar
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int rows, int h, int t0, int b) {
#pragma unroll
  for (int i = 0; i < D / 32; ++i)
    sm90::tma_load_4d(dst + i * rows * 128, map, bar, 32 * i, h, t0, b);
}

// Key validity of keys k0 .. k0 + 63 (in range and unmasked) as 64 bits, by
// one warp; lane 0 stores it.
__device__ __forceinline__ void key_bits(uint64_t* dst, const int* mask, int b, int Tk, int k0,
                                         int lane) {
  const int* mb = mask ? mask + (long long)b * Tk : nullptr;
  uint32_t w[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kp = k0 + 32 * e + lane;
    w[e] = __ballot_sync(0xffffffffu, kp < Tk && (mb == nullptr || mb[kp] != 0));
  }
  if (lane == 0) *dst = (uint64_t)w[0] | ((uint64_t)w[1] << 32);
}

// ---- split-TF32 products ------------------------------------------------------

// d (+)= A B^T: A [64 x K] and B [N x K], K-major hi and lo tiles; three
// passes per k8 step (lo.hi and hi.lo before hi.hi); scale_d = 0 on the
// first resets d.
template <int N, int K>
__device__ __forceinline__ void ss3(float (&d)[N / 2], const uint8_t* ah, const uint8_t* al,
                                    const uint8_t* bh, const uint8_t* bl) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint64_t dah = kdesc<64>(ah, kk), dal = kdesc<64>(al, kk);
    const uint64_t dbh = kdesc<N>(bh, kk), dbl = kdesc<N>(bl, kk);
    sm90::wgmma_tf32_ss<N>(d, dal, dbh, kk > 0);
    sm90::wgmma_tf32_ss<N>(d, dah, dbl, 1);
    sm90::wgmma_tf32_ss<N>(d, dah, dbh, 1);
  }
}

// d += P B^T: P [64 x K] as register A fragments (frags), B [N x K]
// K-major hi and lo tiles in the perm8 k order.
template <int N, int K>
__device__ __forceinline__ void rs3(float (&d)[N / 2], const uint32_t (&ph)[K / 8][4],
                                    const uint32_t (&pl)[K / 8][4], const uint8_t* bh,
                                    const uint8_t* bl) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint64_t dbh = kdesc<N>(bh, kk), dbl = kdesc<N>(bl, kk);
    sm90::wgmma_tf32_rs<N>(d, pl[kk], dbh, 1);
    sm90::wgmma_tf32_rs<N>(d, ph[kk], dbl, 1);
    sm90::wgmma_tf32_rs<N>(d, ph[kk], dbh, 1);
  }
}

// The split register A fragments of an accumulator p of K columns: k8 step
// kk is the thread's own columns 8 kk + 2t, 2t + 1 of rows r, r + 8 (perm8).
template <int K>
__device__ __forceinline__ void frags(uint32_t (&ph)[K / 8][4], uint32_t (&pl)[K / 8][4],
                                      const float (&p)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    sm90::split_tf32(p[4 * kk + 0], ph[kk][0], pl[kk][0]);
    sm90::split_tf32(p[4 * kk + 2], ph[kk][1], pl[kk][1]);
    sm90::split_tf32(p[4 * kk + 1], ph[kk][2], pl[kk][2]);
    sm90::split_tf32(p[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

// ---- forward ------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int BN = Tiles<D>::FWD_BN;
  // producer threads: two warpgroups at D = 128, where the consumer's
  // registers leave room for them (the split step sets the pace there)
  static constexpr int NP = D == 128 ? 256 : 128, NT = NP + NC;
  static constexpr int QT = BM * D * 4, KT = BN * D * 4;
  static constexpr int QH = 0, QL = QH + QT;          // Q hi (TMA target, split in place), lo
  // per stage: K hi (TMA target) and lo, V as TMA writes it, V^T hi and lo
  // [D x BN] with perm8 keys
  static constexpr int KH = QL + QT, KL = KH + KT, VR = KL + KT, VTH = VR + KT, VTL = VTH + KT;
  static constexpr int STAGE = 5 * KT;
  static constexpr int KV = KH + STAGES * STAGE;      // per stage, the tile's key-valid bits
  static constexpr int BAR = KV + 8 * STAGES;
  // per-stage barriers at [X * STAGES + s]
  enum { K_TMA, K_FULL, K_EMPTY, V_TMA, V_FULL, V_EMPTY, Q_TMA_ = 6 };
  static constexpr int Q_TMA = Q_TMA_ * STAGES, Q_FULL = Q_TMA + 1, NBAR = Q_FULL + 1;
  static constexpr int ALLOC = BAR + NBAR * 8 + 1024;
};

// Masks one S tile (scaled scores in, -1e30 on invalid pairs), moves the
// running row maxima m and this thread's partial row sums l, and leaves P in
// s; returns the factors that rescale the output rows in alpha. NEED = false
// (every pair of the tile visible) compiles without the per-pair predicate.
// kvt: the tile's key-valid bits shifted right by 2t (bit 8j + c is key
// column 8j + 2t + c); s[4j + e] is row row0 + 8 (e >> 1), key k0 + 8j + 2t + (e & 1).
template <bool NEED, bool BAND, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], uint64_t kvt, int k0, int t,
                                             int row0, int Tq, int causal, int q_offset,
                                             int window, float scale, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale;
      if (NEED) {
        const int kc = 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
        const bool ok = ((kvt >> (8 * j + (e & 1))) & 1) && row < Tq &&
                        visible<BAND>(row, k0 + kc, causal, q_offset, window);
        x = ok ? x : NEG_INF;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = expf(m[i] - mx[i]);                    // 0 while no key was visible yet
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      // selected, not multiplied: a row with no visible key so far has
      // m = -1e30 and expf would give 1 on its invalid pairs
      const float p = (NEED && x <= NEG_INF) ? 0.f : expf(x - m[e >> 1]);
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

template <bool BAND, int D>
__global__ void __launch_bounds__(FwdSmem<D>::NT, 1)
flash_f32_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ mask,
                     float* __restrict__ o, float* __restrict__ lse, int B, int Tq, int Tk,
                     int Hq, int Hkv, Strides so, int causal, int q_offset, int window,
                     float scale) {
  using S = FwdSmem<D>;
  constexpr int BN = S::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* kvalid = reinterpret_cast<uint64_t*>(sm + S::KV);
  uint64_t* k_tma = bar + S::K_TMA * STAGES;
  uint64_t* k_full = bar + S::K_FULL * STAGES;
  uint64_t* k_empty = bar + S::K_EMPTY * STAGES;
  uint64_t* v_tma = bar + S::V_TMA * STAGES;
  uint64_t* v_full = bar + S::V_FULL * STAGES;
  uint64_t* v_empty = bar + S::V_EMPTY * STAGES;

  // longest first: the last q tiles of a causal grid see the most keys
  const int n_qt = cdiv(Tq, BM), per = B * Hq;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per);
  const int bh = (int)(blockIdx.x % per), b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BM;
  int k_lo, k_hi;
  key_range<BAND>(q0, min(q0 + BM, Tq), Tk, causal, q_offset, window, k_lo, k_hi);
  const int kt0 = k_lo / BN;
  const int n_kt = k_hi > k_lo ? cdiv(k_hi, BN) - kt0 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::NBAR; ++i) {
      const int x = i / STAGES;
      const bool full = i < S::Q_TMA && (x == S::K_FULL || x == S::V_FULL);
      sm90::mbar_init(&bar[i], (full || i == S::Q_FULL) ? S::NP : 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < S::NP) {
    // ---- producer warpgroup: TMA (thread 0) and the split step (all) -----
    // K of tile it + 1 is requested once S of tile it - 1 has freed its
    // stage, V of tile it + 2 once V of tile it is split; the split of V
    // waits for the P V that read its stage two tiles before.
    const int pt = threadIdx.x;
    if (pt == 0) {
      sm90::mbar_arrive_expect_tx(&bar[S::Q_TMA], S::QT);
      tma_tile<D>(sm + S::QH, &tm_q, &bar[S::Q_TMA], BM, h, q0, b);
      for (int i = 0; i < min(n_kt, STAGES); ++i) {
        sm90::mbar_arrive_expect_tx(&v_tma[i], S::KT);
        tma_tile<D>(sm + S::VR + i * S::STAGE, &tm_v, &v_tma[i], BN, hk, (kt0 + i) * BN, b);
      }
      if (n_kt > 0) {
        sm90::mbar_arrive_expect_tx(&k_tma[0], S::KT);
        tma_tile<D>(sm + S::KH, &tm_k, &k_tma[0], BN, hk, kt0 * BN, b);
      }
    }
    if (pt < 32 && n_kt > 0) key_bits(&kvalid[0], mask, b, Tk, kt0 * BN, pt);
    mbar_wait(&bar[S::Q_TMA], 0);
    split_tile<S::QT, S::NP>(sm + S::QH, sm + S::QH, sm + S::QL, pt);
    sm90::fence_proxy_async();
    mbar_arrive(&bar[S::Q_FULL]);
    for (int it = 0; it < n_kt; ++it) {
      const int st = it % STAGES, ph = (it / STAGES) & 1;
      uint8_t* stage = sm + st * S::STAGE;
      mbar_wait(&k_tma[st], ph);
      split_tile<S::KT, S::NP>(stage + S::KH, stage + S::KH, stage + S::KL, pt);
      sm90::fence_proxy_async();
      mbar_arrive(&k_full[st]);
      if (it + 1 < n_kt) {
        const int s1 = (it + 1) % STAGES, ph1 = ((it + 1) / STAGES) & 1;
        mbar_wait(&k_empty[s1], ph1 ^ 1);            // S of tile it + 1 - STAGES is done
        if (pt == 0) {
          sm90::mbar_arrive_expect_tx(&k_tma[s1], S::KT);
          tma_tile<D>(sm + s1 * S::STAGE + S::KH, &tm_k, &k_tma[s1], BN, hk,
                      (kt0 + it + 1) * BN, b);
        }
        if (pt < 32) key_bits(&kvalid[s1], mask, b, Tk, (kt0 + it + 1) * BN, pt);
      }
      mbar_wait(&v_tma[st], ph);
      mbar_wait(&v_empty[st], ph ^ 1);                // P V of tile it - STAGES is done
      transpose_tile<BN, D, true, S::NP>(stage + S::VR, nullptr, stage + S::VTH, stage + S::VTL, pt);
      sm90::fence_proxy_async();
      mbar_arrive(&v_full[st]);
      sm90::named_barrier(1, S::NP);                    // every thread has read the staged V
      if (pt == 0 && it + STAGES < n_kt) {
        sm90::mbar_arrive_expect_tx(&v_tma[st], S::KT);
        tma_tile<D>(stage + S::VR, &tm_v, &v_tma[st], BN, hk, (kt0 + it + STAGES) * BN, b);
      }
    }
  } else {
    // ---- consumer warpgroup: 64 rows ----------------------------------------
    // S of tile it and P V of tile it - 1 are issued together; the softmax
    // of tile it runs while P V does.
    const int ct = threadIdx.x - S::NP, warp = ct / 32, lane = ct % 32;
    const int t = lane % 4;
    const int wr0 = q0 + 16 * warp;                   // this warp's first row
    const int row0 = wr0 + lane / 4;                  // this thread's rows: row0, row0 + 8
    float acc[D / 2], s[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];   // l: this thread's columns
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
    // the tile's pairs of this warp's 16 rows all visible: no predicate
    auto softmax = [&](int it) {
      const int st = it % STAGES, k0 = (kt0 + it) * BN;
      const uint64_t kv = kvalid[st];
      const uint64_t all = BN == 64 ? ~0ull : 0xffffffffull;
      const bool need = (kv & all) != all || wr0 + 15 >= Tq ||
                        (BAND ? k0 + BN - 1 - wr0 > window || wr0 + 15 - k0 > window
                              : causal && k0 + BN - 1 > wr0 + q_offset);
      if (need)
        softmax_tile<true, BAND, BN>(s, kv >> (2 * t), k0, t, row0, Tq, causal, q_offset,
                                     window, scale, m, l, alpha);
      else
        softmax_tile<false, BAND, BN>(s, kv, k0, t, row0, Tq, causal, q_offset, window, scale,
                                      m, l, alpha);
    };

    mbar_wait(&bar[S::Q_FULL], 0);
    if (n_kt > 0) {
      mbar_wait(&k_full[0], 0);
      sm90::wgmma_fence();
      ss3<BN, D>(s, sm + S::QH, sm + S::QL, sm + S::KH, sm + S::KL);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      if (ct == 0) mbar_arrive(&k_empty[0]);
      frags<BN>(ph, pl, s);
    }
    for (int it = 1; it < n_kt; ++it) {
      const int st = it % STAGES, sp = (it - 1) % STAGES;
      mbar_wait(&k_full[st], (it / STAGES) & 1);
      mbar_wait(&v_full[sp], ((it - 1) / STAGES) & 1);
      sm90::wgmma_fence();
      ss3<BN, D>(s, sm + S::QH, sm + S::QL, sm + st * S::STAGE + S::KH,
                 sm + st * S::STAGE + S::KL);
      sm90::wgmma_commit();
      rs3<D, BN>(acc, ph, pl, sm + sp * S::STAGE + S::VTH, sm + sp * S::STAGE + S::VTL);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();                          // S of this tile
      fence_regs(s);
      softmax(it);                                    // reads the tile's key bits
      if (ct == 0) mbar_arrive(&k_empty[st]);
      sm90::wgmma_wait<0>();                          // P V of the last tile
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (ct == 0) mbar_arrive(&v_empty[sp]);
      if (alpha[0] != 1.f || alpha[1] != 1.f) {       // a row maximum moved
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 0] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
      }
      frags<BN>(ph, pl, s);
    }
    if (n_kt > 0) {                                   // the last tile's P V
      const int sl = (n_kt - 1) % STAGES;
      mbar_wait(&v_full[sl], ((n_kt - 1) / STAGES) & 1);
      sm90::wgmma_fence();
      rs3<D, BN>(acc, ph, pl, sm + sl * S::STAGE + S::VTH, sm + sl * S::STAGE + S::VTL);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_regs(acc);
    }
    // ---- finalize: o = acc / l, lse = m + log(l); empty rows -> 0, -1e30 --
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int qi = row0 + 8 * i;
      if (qi >= Tq) continue;
      const bool any = l[i] > 0.f;
      const float inv = any ? 1.f / l[i] : 0.f;
      float* orow = o + b * so.b + (long long)qi * so.t + h * so.h + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      if (t == 0) lse[(long long)bh * Tq + qi] = any ? m[i] + logf(l[i]) : NEG_INF;
    }
  }
}

// ---- backward: delta ------------------------------------------------------------

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp per row
constexpr int DELTA_NT = 256;
__global__ void __launch_bounds__(DELTA_NT)
flash_f32_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int B, int Tq, int Hq, int D, Strides so,
                       Strides sd) {
  const long long row = (long long)blockIdx.x * (DELTA_NT / 32) + threadIdx.x / 32;
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

// ---- backward: dq ----------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int BN = Tiles<D>::DQ_BN;
  static constexpr int NP = 256, NT = NP + NC;      // two producer warpgroups
  static constexpr int QT = BM * D * 4, KT = BN * D * 4;
  static constexpr int QH = 0, QL = QH + QT;          // Q hi (TMA target), lo
  static constexpr int OH = QL + QT, OL = OH + QT;    // dO hi (TMA target), lo
  static constexpr int KH = OL + QT, KL = KH + KT;    // K hi (TMA target), lo
  static constexpr int VH = KL + KT, VL = VH + KT;    // V hi (TMA target), lo
  static constexpr int KTH = VL + KT, KTL = KTH + KT; // K^T hi, lo [D x BN], perm8 keys
  static constexpr int KV = KTL + KT;
  static constexpr int BAR = KV + 16;
  enum { Q_TMA, Q_FULL, K_TMA, V_TMA, KV_FULL, K_EMPTY, V_EMPTY, KT_FULL, KT_EMPTY, NBAR };
  static constexpr int ALLOC = BAR + NBAR * 8 + 1024;
};

template <bool BAND, int D>
__global__ void __launch_bounds__(DqSmem<D>::NT, 1)
flash_f32_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int B, int Tq, int Tk, int Hq, int Hkv,
                    Strides sdq, int causal, int q_offset, int window, float scale) {
  using S = DqSmem<D>;
  constexpr int BN = S::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* kvalid = reinterpret_cast<uint64_t*>(sm + S::KV);

  const int n_qt = cdiv(Tq, BM), per = B * Hq;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per);
  const int bh = (int)(blockIdx.x % per), b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BM;
  int k_lo, k_hi;
  key_range<BAND>(q0, min(q0 + BM, Tq), Tk, causal, q_offset, window, k_lo, k_hi);
  const int kt0 = k_lo / BN;
  const int n_kt = k_hi > k_lo ? cdiv(k_hi, BN) - kt0 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::NBAR; ++i)
      sm90::mbar_init(&bar[i], (i == S::Q_FULL || i == S::KV_FULL || i == S::KT_FULL) ? S::NP : 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < S::NP) {
    // ---- producer warpgroup ------------------------------------------------
    // One buffer each for K, V and K^T: K of the next tile is requested as
    // soon as S has read this one (and K^T is built from it), V as soon as
    // dP has; K^T is rebuilt once dQ of the last tile is done.
    const int pt = threadIdx.x;
    if (pt == 0) {
      sm90::mbar_arrive_expect_tx(&bar[S::Q_TMA], 2 * S::QT);
      tma_tile<D>(sm + S::QH, &tm_q, &bar[S::Q_TMA], BM, h, q0, b);
      tma_tile<D>(sm + S::OH, &tm_do, &bar[S::Q_TMA], BM, h, q0, b);
      if (n_kt > 0) {
        sm90::mbar_arrive_expect_tx(&bar[S::K_TMA], S::KT);
        tma_tile<D>(sm + S::KH, &tm_k, &bar[S::K_TMA], BN, hk, kt0 * BN, b);
        sm90::mbar_arrive_expect_tx(&bar[S::V_TMA], S::KT);
        tma_tile<D>(sm + S::VH, &tm_v, &bar[S::V_TMA], BN, hk, kt0 * BN, b);
      }
    }
    mbar_wait(&bar[S::Q_TMA], 0);
    split_tile<S::QT, S::NP>(sm + S::QH, sm + S::QH, sm + S::QL, pt);
    split_tile<S::QT, S::NP>(sm + S::OH, sm + S::OH, sm + S::OL, pt);
    sm90::fence_proxy_async();
    mbar_arrive(&bar[S::Q_FULL]);
    for (int it = 0; it < n_kt; ++it) {
      const int k0 = (kt0 + it) * BN, ph = it & 1;
      if (pt < 32) key_bits(kvalid, mask, b, Tk, k0, pt);
      mbar_wait(&bar[S::K_TMA], ph);
      split_tile<S::KT, S::NP>(sm + S::KH, sm + S::KH, sm + S::KL, pt);
      mbar_wait(&bar[S::V_TMA], ph);
      split_tile<S::KT, S::NP>(sm + S::VH, sm + S::VH, sm + S::VL, pt);
      sm90::fence_proxy_async();
      mbar_arrive(&bar[S::KV_FULL]);
      sm90::named_barrier(1, S::NP);                    // every thread's split of K is done
      mbar_wait(&bar[S::KT_EMPTY], ph ^ 1);           // dQ of the previous tile is done
      transpose_tile<BN, D, false, S::NP>(sm + S::KH, sm + S::KL, sm + S::KTH, sm + S::KTL, pt);
      sm90::fence_proxy_async();
      mbar_arrive(&bar[S::KT_FULL]);
      sm90::named_barrier(1, S::NP);                    // K is read before the next TMA
      if (it + 1 < n_kt) {
        mbar_wait(&bar[S::K_EMPTY], ph);              // S of this tile is done
        if (pt == 0) {
          sm90::mbar_arrive_expect_tx(&bar[S::K_TMA], S::KT);
          tma_tile<D>(sm + S::KH, &tm_k, &bar[S::K_TMA], BN, hk, k0 + BN, b);
        }
        mbar_wait(&bar[S::V_EMPTY], ph);              // dP of this tile is done
        if (pt == 0) {
          sm90::mbar_arrive_expect_tx(&bar[S::V_TMA], S::KT);
          tma_tile<D>(sm + S::VH, &tm_v, &bar[S::V_TMA], BN, hk, k0 + BN, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 rows ----------------------------------------
    // each buffer is released as the product that reads it completes.
    const int ct = threadIdx.x - S::NP, warp = ct / 32, lane = ct % 32;
    const int t = lane % 4;
    const int row0 = q0 + 16 * warp + lane / 4;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + 8 * i;
      lse_r[i] = qi < Tq ? lse[(long long)bh * Tq + qi] : 0.f;
      delta_r[i] = qi < Tq ? delta[(long long)bh * Tq + qi] : 0.f;
    }
    float acc[D / 2], s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    uint32_t dh[BN / 8][4], dl[BN / 8][4];

    mbar_wait(&bar[S::Q_FULL], 0);
    for (int it = 0; it < n_kt; ++it) {
      const int k0 = (kt0 + it) * BN, par = it & 1;
      mbar_wait(&bar[S::KV_FULL], par);
      const uint64_t kv = *kvalid >> (2 * t);
      sm90::wgmma_fence();
      ss3<BN, D>(s, sm + S::QH, sm + S::QL, sm + S::KH, sm + S::KL);
      ss3<BN, D>(dp, sm + S::OH, sm + S::OL, sm + S::VH, sm + S::VL);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (ct == 0) {
        mbar_arrive(&bar[S::K_EMPTY]);
        mbar_arrive(&bar[S::V_EMPTY]);
      }
      // P = exp(S * scale - lse) on visible pairs (0 elsewhere), dS = P (dP - delta)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          const bool ok = ((kv >> (8 * j + (e & 1))) & 1) && row < Tq &&
                          visible<BAND>(row, k0 + kc, causal, q_offset, window);
          const float p = ok ? expf(s[4 * j + e] * scale - lse_r[e >> 1]) : 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - delta_r[e >> 1]);
        }
      frags<BN>(dh, dl, dp);
      mbar_wait(&bar[S::KT_FULL], par);
      sm90::wgmma_fence();
      rs3<D, BN>(acc, dh, dl, sm + S::KTH, sm + S::KTL);
      sm90::wgmma_commit();
      // dQ is retired here, not behind the next S and dP: held across them,
      // its A fragments shared registers with their accumulators and ptxas
      // serialized every wgmma of the kernel (its C7515 note)
      sm90::wgmma_wait<0>();
      fence_regs(dh);
      fence_regs(dl);
      if (ct == 0) mbar_arrive(&bar[S::KT_EMPTY]);
    }
    sm90::wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + 8 * i;
      if (qi >= Tq) continue;
      float* drow = dq + b * sdq.b + (long long)qi * sdq.t + h * sdq.h + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(drow + 8 * j) =
            make_float2(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// ---- backward: dk, dv -----------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int BQ = Tiles<D>::DKV_BQ;
  // one producer warpgroup: the consumer keeps dk and dv in registers
  static constexpr int NP = 128, NT = NP + NC;
  static constexpr int REG = D == 64 ? 2 : 1;          // q-tile regions (what fits in 224 KB)
  static constexpr int KT = BM * D * 4, QT = BQ * D * 4;
  static constexpr int KH = 0, KL = KH + KT;          // K hi (TMA target), lo
  static constexpr int VH = KL + KT, VL = VH + KT;    // V hi (TMA target), lo
  // a q-tile region: Q and dO hi / lo, K-major [BQ x D] for S^T and dP^T,
  // then transposed in place [D x BQ] (perm8 queries) for dK and dV
  static constexpr int RG = VL + KT, QH = 0, QL = QT, OH = 2 * QT, OL = 3 * QT, RSZ = 4 * QT;
  static constexpr int QR = RG + REG * RSZ, OR = QR + QT;   // Q and dO as TMA writes them
  static constexpr int LSE = OR + QT, DELTA = LSE + REG * BQ * 4;   // per region
  static constexpr int KV = DELTA + REG * BQ * 4;
  static constexpr int BAR = KV + 16;
  // single barriers, then per-region ones at [X + r]
  enum { KV_TMA, KV_FULL, R_TMA };
  static constexpr int NAT_FULL = 3, NAT_DONE = NAT_FULL + REG, TR_FULL = NAT_DONE + REG,
                       TR_EMPTY = TR_FULL + REG, NBAR = TR_EMPTY + REG;
  static constexpr int ALLOC = BAR + NBAR * 8 + 1024;
};

template <bool BAND, int D>
__global__ void __launch_bounds__(DkvSmem<D>::NT, 1)
flash_f32_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int B, int Tq, int Tk,
                     int Hq, int Hkv, Strides sdk, Strides sdv, int causal, int q_offset,
                     int window, float scale) {
  using S = DkvSmem<D>;
  constexpr int BQ = S::BQ, REG = S::REG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + S::BAR);
  float* lse_s = reinterpret_cast<float*>(sm + S::LSE);
  float* delta_s = reinterpret_cast<float*>(sm + S::DELTA);
  uint64_t* kvalid = reinterpret_cast<uint64_t*>(sm + S::KV);

  // heaviest first: the first key tiles of a causal grid are seen by the most rows
  const int per = B * Hkv;
  const int kt = (int)(blockIdx.x / per);
  const int bhk = (int)(blockIdx.x % per), b = bhk / Hkv, hk = bhk % Hkv;
  const int group = Hq / Hkv;
  const int k0 = kt * BM;
  int q_lo, q_hi;
  query_range<BAND>(k0, min(k0 + BM, Tk), Tq, causal, q_offset, window, q_lo, q_hi);
  const int qt0 = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? cdiv(q_hi, BQ) - qt0 : 0;
  const int total = group * n_qt;                     // (q head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::NBAR; ++i) {
      const bool full = i == S::KV_FULL || (i >= S::NAT_FULL && i < S::NAT_DONE) ||
                        (i >= S::TR_FULL && i < S::TR_EMPTY);
      sm90::mbar_init(&bar[i], full ? S::NP : 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < S::NP) {
    // ---- producer warpgroup ------------------------------------------------
    // Tile n: Q and dO land in the staging tiles, are split into region
    // n % REG once dK and dV of tile n - REG are done, the staging tiles
    // are refilled with tile n + 1, and the region is transposed in place
    // once S^T and dP^T of tile n are done.
    const int pt = threadIdx.x;
    if (pt == 0) {
      sm90::mbar_arrive_expect_tx(&bar[S::KV_TMA], 2 * S::KT);
      tma_tile<D>(sm + S::KH, &tm_k, &bar[S::KV_TMA], BM, hk, k0, b);
      tma_tile<D>(sm + S::VH, &tm_v, &bar[S::KV_TMA], BM, hk, k0, b);
      if (total > 0) {
        sm90::mbar_arrive_expect_tx(&bar[S::R_TMA], 2 * S::QT);
        tma_tile<D>(sm + S::QR, &tm_q, &bar[S::R_TMA], BQ, hk * group, qt0 * BQ, b);
        tma_tile<D>(sm + S::OR, &tm_do, &bar[S::R_TMA], BQ, hk * group, qt0 * BQ, b);
      }
    }
    if (pt < 32) key_bits(kvalid, mask, b, Tk, k0, pt);
    mbar_wait(&bar[S::KV_TMA], 0);
    split_tile<S::KT, S::NP>(sm + S::KH, sm + S::KH, sm + S::KL, pt);
    split_tile<S::KT, S::NP>(sm + S::VH, sm + S::VH, sm + S::VL, pt);
    sm90::fence_proxy_async();
    mbar_arrive(&bar[S::KV_FULL]);
    for (int n = 0; n < total; ++n) {
      const int h = hk * group + n / n_qt, q0 = (qt0 + n % n_qt) * BQ;
      const int r = n % REG, ph = (n / REG) & 1;
      uint8_t* rg = sm + S::RG + r * S::RSZ;
      mbar_wait(&bar[S::R_TMA], n & 1);
      mbar_wait(&bar[S::TR_EMPTY + r], ph ^ 1);       // dK and dV of tile n - REG are done
      split_tile<S::QT, S::NP>(sm + S::QR, rg + S::QH, rg + S::QL, pt);
      split_tile<S::QT, S::NP>(sm + S::OR, rg + S::OH, rg + S::OL, pt);
      if (pt < BQ) {
        const long long row = ((long long)b * Hq + h) * Tq + q0 + pt;
        lse_s[r * BQ + pt] = q0 + pt < Tq ? lse[row] : 0.f;
        delta_s[r * BQ + pt] = q0 + pt < Tq ? delta[row] : 0.f;
      }
      sm90::fence_proxy_async();
      mbar_arrive(&bar[S::NAT_FULL + r]);
      sm90::named_barrier(1, S::NP);                    // every thread has read the staged tiles
      if (pt == 0 && n + 1 < total) {
        const int h1 = hk * group + (n + 1) / n_qt, q1 = (qt0 + (n + 1) % n_qt) * BQ;
        sm90::mbar_arrive_expect_tx(&bar[S::R_TMA], 2 * S::QT);
        tma_tile<D>(sm + S::QR, &tm_q, &bar[S::R_TMA], BQ, h1, q1, b);
        tma_tile<D>(sm + S::OR, &tm_do, &bar[S::R_TMA], BQ, h1, q1, b);
      }
      mbar_wait(&bar[S::NAT_DONE + r], ph);           // S^T and dP^T of tile n are done
      transpose_inplace<BQ, D>(rg + S::QH, pt);
      transpose_inplace<BQ, D>(rg + S::QL, pt);
      transpose_inplace<BQ, D>(rg + S::OH, pt);
      transpose_inplace<BQ, D>(rg + S::OL, pt);
      sm90::fence_proxy_async();
      mbar_arrive(&bar[S::TR_FULL + r]);
    }
  } else {
    // ---- consumer warpgroup: 64 keys ----------------------------------------
    const int ct = threadIdx.x - S::NP, warp = ct / 32, lane = ct % 32;
    const int t = lane % 4;
    const int kr = 16 * warp + lane / 4;              // this thread's keys: k0 + kr, + 8
    float dka[D / 2], dva[D / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    uint32_t fh[BQ / 8][4], fl[BQ / 8][4];            // P^T, then dS^T, split

    mbar_wait(&bar[S::KV_FULL], 0);
    const uint64_t kv = *kvalid;
    const bool kval[2] = {((kv >> kr) & 1) != 0, ((kv >> (kr + 8)) & 1) != 0};
    for (int n = 0; n < total; ++n) {
      const int q0 = (qt0 + n % n_qt) * BQ, r = n % REG, ph = (n / REG) & 1;
      const uint8_t* rg = sm + S::RG + r * S::RSZ;
      const float* lse_r = lse_s + r * BQ;
      const float* delta_r = delta_s + r * BQ;
      mbar_wait(&bar[S::NAT_FULL + r], ph);
      sm90::wgmma_fence();
      ss3<BQ, D>(st, sm + S::KH, sm + S::KL, rg + S::QH, rg + S::QL);
      ss3<BQ, D>(dpt, sm + S::VH, sm + S::VL, rg + S::OH, rg + S::OL);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(fh);
      fence_regs(fl);
      if (ct == 0) mbar_arrive(&bar[S::NAT_DONE + r]);
      // P^T = exp(S^T * scale - lse) on visible pairs (0 elsewhere)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1), qi = q0 + qc;
          const bool ok = kval[e >> 1] && qi < Tq &&
                          visible<BAND>(qi, k0 + kr + 8 * (e >> 1), causal, q_offset, window);
          st[4 * j + e] = ok ? expf(st[4 * j + e] * scale - lse_r[qc]) : 0.f;
        }
      frags<BQ>(fh, fl, st);
      mbar_wait(&bar[S::TR_FULL + r], ph);
      sm90::wgmma_fence();
      rs3<D, BQ>(dva, fh, fl, rg + S::OH, rg + S::OL);       // dV += P^T dO
      sm90::wgmma_commit();
      // dS^T = P^T (dP^T - delta), while dV runs
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - delta_r[8 * j + 2 * t + (e & 1)]);
      sm90::wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(fh);
      fence_regs(fl);
      frags<BQ>(fh, fl, dpt);
      sm90::wgmma_fence();
      rs3<D, BQ>(dka, fh, fl, rg + S::QH, rg + S::QL);       // dK += dS^T Q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(fh);
      fence_regs(fl);
      if (ct == 0) mbar_arrive(&bar[S::TR_EMPTY + r]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = k0 + kr + 8 * i;
      if (kj >= Tk) continue;
      float* krow = dk + b * sdk.b + (long long)kj * sdk.t + hk * sdk.h + 2 * t;
      float* vrow = dv + b * sdv.b + (long long)kj * sdv.t + hk * sdv.h + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(krow + 8 * j) =
            make_float2(dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<float2*>(vrow + 8 * j) =
            make_float2(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---- host ---------------------------------------------------------------------------

inline Strides st3(const long long* s) { return Strides{s[0], s[1], s[2]}; }

// the map of an fp32 [B, T, H, D] tensor with strides s (three) and a box of `rows`
template <int D>
inline int map_of(CUtensorMap* m, const void* p, int B, int T, int H, const long long* s,
                  int rows) {
  return sm90_host::make_map_f32(m, p, B, T, H, D, s[0], s[1], s[2], rows);
}

template <bool BAND, int D>
int fwd(const float* q, const float* k, const float* v, const int* mask, float* o, float* lse,
        int B, int Tq, int Tk, int Hq, int Hkv, const long long* s, int causal, int q_offset,
        int window, float scale, cudaStream_t stream) {
  using S = FwdSmem<D>;
  // once per instantiation (and never inside a CUDA graph's capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_fwd_kernel<BAND, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv;
  int rc = map_of<D>(&mq, q, B, Tq, Hq, s, BM);
  if (rc == 0) rc = map_of<D>(&mk, k, B, Tk, Hkv, s + 3, S::BN);
  if (rc == 0) rc = map_of<D>(&mv, v, B, Tk, Hkv, s + 6, S::BN);
  if (rc != 0) return rc;
  const long long grid = (long long)cdiv(Tq, BM) * B * Hq;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_f32_fwd_kernel<BAND, D><<<(unsigned)grid, S::NT, S::ALLOC, stream>>>(
      mq, mk, mv, mask, o, lse, B, Tq, Tk, Hq, Hkv, st3(s + 9), causal, q_offset, window, scale);
  return (int)cudaGetLastError();
}

template <bool BAND, int D>
int bwd(const float* q, const float* k, const float* v, const int* mask, const float* o,
        const float* lse, const float* dout, float* dq, float* dk, float* dv, float* delta,
        int B, int Tq, int Tk, int Hq, int Hkv, const long long* s, int causal, int q_offset,
        int window, float scale, cudaStream_t stream) {
  // strides: q k v o dout dq dk dv, three each
  using SQ = DqSmem<D>;
  using SK = DkvSmem<D>;
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_f32_dq_kernel<BAND, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SQ::ALLOC);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_f32_dkv_kernel<BAND, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SK::ALLOC);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  CUtensorMap q_dq, k_dq, v_dq, do_dq, q_kv, k_kv, v_kv, do_kv;
  int rc = map_of<D>(&q_dq, q, B, Tq, Hq, s, BM);
  if (rc == 0) rc = map_of<D>(&do_dq, dout, B, Tq, Hq, s + 12, BM);
  if (rc == 0) rc = map_of<D>(&k_dq, k, B, Tk, Hkv, s + 3, SQ::BN);
  if (rc == 0) rc = map_of<D>(&v_dq, v, B, Tk, Hkv, s + 6, SQ::BN);
  if (rc == 0) rc = map_of<D>(&q_kv, q, B, Tq, Hq, s, SK::BQ);
  if (rc == 0) rc = map_of<D>(&do_kv, dout, B, Tq, Hq, s + 12, SK::BQ);
  if (rc == 0) rc = map_of<D>(&k_kv, k, B, Tk, Hkv, s + 3, BM);
  if (rc == 0) rc = map_of<D>(&v_kv, v, B, Tk, Hkv, s + 6, BM);
  if (rc != 0) return rc;
  const long long grid_dq = (long long)cdiv(Tq, BM) * B * Hq;
  const long long grid_dkv = (long long)cdiv(Tk, BM) * B * Hkv;
  if (grid_dq > 0x7fffffffLL || grid_dkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const long long rows = (long long)B * Hq * Tq;
  flash_f32_delta_kernel<<<(unsigned)((rows + DELTA_NT / 32 - 1) / (DELTA_NT / 32)), DELTA_NT, 0,
                           stream>>>(
      o, dout, delta, B, Tq, Hq, D, st3(s + 9), st3(s + 12));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_f32_dq_kernel<BAND, D><<<(unsigned)grid_dq, SQ::NT, SQ::ALLOC, stream>>>(
      q_dq, k_dq, v_dq, do_dq, mask, lse, delta, dq, B, Tq, Tk, Hq, Hkv, st3(s + 15), causal,
      q_offset, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_f32_dkv_kernel<BAND, D><<<(unsigned)grid_dkv, SK::NT, SK::ALLOC, stream>>>(
      q_kv, k_kv, v_kv, do_kv, mask, lse, delta, dk, dv, B, Tq, Tk, Hq, Hkv, st3(s + 18),
      st3(s + 21), causal, q_offset, window, scale);
  return (int)cudaGetLastError();
}

inline bool bad_args(int B, int Tq, int Tk, int Hq, int Hkv, int D, int window) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         (D != 64 && D != 128) || (window >= 0 && Tq != Tk);
}

}  // namespace f32fa

// Plain C entry (loaded with ctypes): out [B,Tq,Hq,D] fp32 and lse [B,Hq,Tq]
// fp32 of fp32 q, k, v. strides: 12 element strides (batch, time, head) of
// q, k, v, o. window < 0: causal / bidirectional flash attention; window >=
// 0: the band |i - j| <= window (Tq == Tk; causal ignored). Encodes the
// tensor maps and launches on `stream`; returns 0 or a cudaError (an
// argument or a layout the kernel does not take, or the launch's error).
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
                 : bwd<false, 128>(qp, kp, vp, mp, op, lp, dop, dqp, dkp, dvp, dl, B, Tq, Tk,
                                   Hq, Hkv, strides, causal, q_offset, -1, scale, st);
}
