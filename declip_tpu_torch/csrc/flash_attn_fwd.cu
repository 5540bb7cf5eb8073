// Fused self-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel declip_tpu/ops/flash_attention.py
// `_fwd_kernel` (l.41, launched by `_flash_fwd`'s pallas_call at l.164):
//   O = softmax(scale * Q K^T, causal mask optional) V
// with fp32 scores, fp32 softmax and fp32 accumulation, operands in the input
// dtype (fp32 or bf16), and P rounded to the operand dtype before P.V as the
// TPU kernel casts it (l.65-68). Here the rounded P is the unnormalised
// exp(s - running max), divided by the row sum once at the end, so a bf16
// output may differ from the TPU kernel's by about one bf16 rounding.
//
// For training, the kernel also writes each row's log-sum-exp of the scaled
// scores, lse = max + log(sum exp(s - max)), in fp32 ([B*H, L]); the backward
// kernels (flash_attn_bwd.cu) recompute P = exp(s - lse) from it instead of
// redoing the row softmax. The serving path passes a null lse.
//
// What bounds it on an H100. Per (batch*head) it reads Q, K, V and writes O
// once, 4*L*Dh elements, for 4*L*L*Dh FLOPs (about half when causal): L/4
// FLOP per byte in fp32 and L/2 in bf16. At the model's shapes (L=50, and
// L=77 causal; Dh=64) that is 12-25 FLOP/byte in fp32 and 25-38 in bf16,
// below the card's ridge points (20 FLOP/byte for fp32 outside the tensor
// cores, 67 TFLOP/s over 3.35 TB/s; 295 for bf16, 989 TFLOP/s), so the
// bytes bound both routes, and what matters is to move each byte once and
// never write the [L, L] probabilities out. In practice, at serving's
// batches (B = 1 to 16, 8 to 192 heads) the bound is 0.2-3 us and what
// sets the time is latency: the copies' round trip and each warp's chain
// of dependent products, with few blocks to hide either.
//
// Two routes, by dtype.
//
// bf16 (the training path): tensor cores, `flash_attn_fwd_bf16_kernel`.
//  * Q, K and V go to shared memory as bf16 in 16-byte cp.async copies, at a
//    padded row stride that makes every ldmatrix conflict-free
//    (attn_mma.cuh); 64-key tiles of K and V are double-buffered, so the
//    next tile's copy overlaps this tile's products.
//  * One warp owns 16 query rows and keeps its Q fragments in registers.
//    S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 operands, fp32
//    accumulators): K by ldmatrix, V by ldmatrix.trans. The scale and the
//    masks apply to the fp32 accumulators; the online softmax (running max
//    and sum in fp32, log2 domain) reduces across the quad that shares a
//    row by shuffles. P is rounded to bf16 and repacked in registers as the
//    A operand of P V, which is where the TPU kernel casts it.
//  * At L <= 128 one block per (batch*head) holds ceil(L/16) warps
//    (attn_mma.cuh's `block_shape`): at L=77 five warps, the fifth with 13
//    live rows, and K/V read once per head. Above, 64-row blocks. Causal
//    warps skip every 8-key tile and 16-key P.V step wholly above their
//    last row, and blocks stop at their last row's key tile.
//  * O is staged through the warp's own Q rows in shared memory and stored
//    in 16-byte writes.
//  * mma.sync and not wgmma/TMA: at these intensities mma.sync gives far
//    more FLOP/s than the bytes can feed, so the products cost little next
//    to the copies. Warpgroup tiles, TMA and warp specialisation belong to
//    the long sequences (L >= 197), which are later work.
//  * What is left: at L=77 the block holds 118 registers a thread, so an
//    SM keeps three 5-warp blocks, and each block copies, computes and
//    stores in turn; the overlap comes from the other resident blocks.
//    Processing 32 keys per softmax step (100 registers, the K/V of the
//    head copied whole) measured 3-5% slower, so the 64-key step stays.
//
// fp32 (serving, and the fp32 checks): tensor cores in split TF32,
// `flash_attn_fwd_tf32_kernel`. The tensor cores take fp32 only as TF32,
// which keeps 11 significant bits, about three decimal digits: alone it
// would break serving's 1e-4 agreement with the plain version. So every
// operand is split, x = hi + lo with hi = tf32(x) and lo = tf32(x - hi),
// and each product is three TF32 mma.sync m16n8k8 (lo.hi, hi.lo, then
// hi.hi, fp32 accumulators), which leaves an error of a few 2^-22 of each
// product instead of TF32's 2^-11.
//  * Latency, not bytes, sets the time here, so the design is about how
//    much serial work each warp does and how many warps hide it. Blocks of
//    64 query rows, four 16-row groups; each group's keys are split
//    between two warps (8-key tiles taken in turn, which also halves a
//    causal group's work evenly), so an SM sub-partition holds two warps
//    and each runs half the chain. At the end the two halves' running
//    max, sum and accumulators are merged through shared memory. At
//    L <= 64 one block holds a head; at L=77 two blocks do.
//  * Q, K and V go to shared memory as fp32 in 16-byte cp.async copies at
//    a row stride of Dh + 4 floats, conflict-free for the 32-bit fragment
//    loads (ldmatrix is for 16-bit elements); 64-key tiles of K and V are
//    double-buffered above L = 64. Above 48 KB the kernel asks for its
//    shared memory.
//  * Operands are split as they are loaded from shared memory, rounding to
//    TF32 in two integer operations (cvt.rna.tf32 runs at a quarter rate),
//    and the three products of a tile are issued pass by pass over the
//    tile's accumulators, so consecutive mma.sync do not wait on each
//    other. Scale and masks apply to the fp32 accumulators; the online
//    softmax (running max and sum, natural exponent as the plain version)
//    reduces across the quad by shuffles; masked keys give exactly 0.
//  * P reaches P.V without a shuffle: the C fragment gives a lane columns
//    2t and 2t + 1 where the A fragment wants t and t + 4, so the keys of
//    each 8-key step are taken in the order the lane holds them, and V's
//    rows are read in the same order (see the P.V loop).
//  * Causal warps skip every 8-key tile wholly above their last row, and
//    blocks stop at their last row's key tile.
//  * Measured on an H100 80GB HBM3 at 700 W against the first design of
//    this route (one warp per 16 rows, cvt rounding): the integer rounding
//    alone took L=50 from 10.6 to 8.7 us at B=8, the split keys then to
//    7.2 us (L=77 causal: 16.8, 13.6, 8.1 us); 119 registers at Dh=64, no
//    spill.
//
// Both routes mask ragged query and key edges by bounds (no padding of L to
// 16 or of Dh to 128: those were TPU tile rules).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "attn_mma.cuh"

namespace {

using attn_mma::bf16;

// ---------------------------------------------------------------- fp32 route

// Shared-memory row stride of the fp32 route, in floats. Four floats of
// padding shift each row by four banks, so every fragment load below is
// conflict-free: lane (g, t) reads row g, column t of an 8-row patch (Q,
// K: bank 4g + t), or rows 2t and 2t + 1, column g (V: banks 8t + g and
// 8t + 4 + g). Rows stay 16-byte aligned for cp.async.
template <int DH>
struct LayoutF32 {
  static constexpr int kStride = DH + 4;
  static constexpr int kChunks = DH / 4;  // 16-byte chunks in a row
};

// rows r0 .. r0 + rows - 1 of a contiguous fp32 [L, DH] matrix into shared
// memory at the padded stride; rows at or past L become zeros
template <int DH>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int rows, int L,
                                              int tid, int nthreads) {
  constexpr int kChunks = LayoutF32<DH>::kChunks;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = r0 + r < L;
    const float* g = src + static_cast<size_t>(ok ? r0 + r : 0) * DH + c * 4;
    attn_mma::cp_async16(dst + r * LayoutF32<DH>::kStride + c * 4, g, ok);
  }
}

// x rounded to TF32 (the 32-bit pattern the tensor cores read): to the
// nearest value with 11 significant bits, ties away from zero, as
// cvt.rna.tf32.f32 rounds, but in two integer operations at full rate
// where cvt runs at a quarter (finite x; infinities and NaN stay so)
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi and lo TF32: hi keeps 11 significant bits, lo the
// next 11, so |x - hi - lo| <= 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));  // the difference is exact
}

// d += a (16x8) . b (8x8), TF32 operands, fp32 accumulation. Fragments
// (PTX m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A: a0 = (row g, col t), a1 = (g + 8, t), a2 = (g, t + 4),
//      a3 = (g + 8, t + 4);
//   B: b0 = (k t, n g), b1 = (k t + 4, n g);
//   C: c0, c1 = (row g, cols 2t, 2t + 1), c2, c3 = (row g + 8, same).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a . b[j] for the n8 tiles j < n, each to fp32 accuracy as three
// TF32 products: a_lo b_hi + a_hi b_lo + a_hi b_hi (what is dropped, a_lo
// b_lo and the rounding of each lo, is at most about 3 * 2^-22 of |a b|).
// The three land on one accumulator, so they are issued pass by pass over
// the tiles: consecutive mma.sync then write different accumulators and do
// not wait for each other's latency.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4], int n,
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) mma_tf32(d[j], a_lo, b_hi[j][0], b_hi[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) mma_tf32(d[j], a_hi, b_lo[j][0], b_lo[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) mma_tf32(d[j], a_hi, b_hi[j][0], b_hi[j][1]);
  }
}

// Rows of an fp32 block: four 16-row groups, each shared by two warps that
// split its keys (warp 2r + h takes the 8-key tiles j = h, h + 2, ... of
// every 64-key tile, which also halves a causal group's work evenly)
constexpr int kRowsF32 = 64;

// One block: rows blockIdx.y * 64 .. + 63 of one (batch*head), against keys
// 0 .. kv_end - 1 in 64-key tiles, with 2 * ceil(min(L, 64) / 16) warps.
// Dynamic shared memory (fp32, LayoutF32 stride): Q [64][S], then 1 or 2
// stages of K [64][S] and V [64][S]; after the last tile the stages hold
// the key halves' softmax states, merged there.
template <int DH>
__global__ void __launch_bounds__(256)
flash_attn_fwd_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int L, int causal,
                           float scale) {
  using attn_mma::cp_async_commit;
  using attn_mma::cp_async_wait;
  using attn_mma::kTile;
  constexpr int S = LayoutF32<DH>::kStride;
  constexpr int KC = DH / 8;  // k8 steps over the head dim
  constexpr int DN = DH / 8;  // n8 tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = qs + kRowsF32 * S;  // stage i: K at kv + 2*i*kTile*S, V after

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRowsF32;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = warp >> 1;  // this warp's 16-row group
  const int half = warp & 1;  // and its half of the keys
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = static_cast<size_t>(bh) * L * DH;
  const int kv_end = causal ? min(L, q0 + kRowsF32) : L;
  const int tiles = (kv_end + kTile - 1) / kTile;

  load_rows_f32<DH>(qs, q + base, q0, kRowsF32, L, tid, blockDim.x);
  for (int i = 0; i < 2; ++i) {
    if (i < tiles) {
      float* ks = kv + 2 * i * kTile * S;
      load_rows_f32<DH>(ks, k + base, i * kTile, kTile, L, tid, blockDim.x);
      load_rows_f32<DH>(ks + kTile * S, v + base, i * kTile, kTile, L, tid,
                        blockDim.x);
    }
    cp_async_commit();  // group i: tile i (and Q with tile 0)
  }

  const int row0 = q0 + 16 * grp;  // this warp's first query row
  const bool live = row0 < L;
  // keys this warp's rows need: [0, key_end)
  const int key_end = causal ? min(L, row0 + 16) : L;
  const int r_lo = row0 + g;
  const int r_hi = r_lo + 8;
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  // running max of the scaled scores over this half's keys (-inf until it
  // has seen one) and this thread's part of the running sum
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<1>();  // tile it (group it) has landed
    __syncthreads();
    const float* ks = kv + 2 * (it & 1) * kTile * S;
    const float* vs = ks + kTile * S;
    const int k0 = it * kTile;
    // 8-key tiles of this tile that hold a key the rows need, and this
    // half's share of them: tiles j = 2 * jj + half, jj < nj
    const int n8 = live ? min(8, (key_end - k0 + 7) / 8) : 0;
    const int nj = (n8 - half + 1) / 2;
    if (nj > 0) {
      // S = Q K^T: B's (k, n) = (head dim, key) is K's row n, column k. Q
      // is split per k8 step from shared memory, K as it is loaded
      float s[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
      }
      const float* qr = qs + (16 * grp + g) * S + t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(qr[8 * kc], a_hi[0], a_lo[0]);
        split_tf32(qr[8 * S + 8 * kc], a_hi[1], a_lo[1]);
        split_tf32(qr[8 * kc + 4], a_hi[2], a_lo[2]);
        split_tf32(qr[8 * S + 8 * kc + 4], a_hi[3], a_lo[3]);
        uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj < nj) {
            const float* kr =
                ks + (8 * (2 * jj + half) + g) * S + 8 * kc + t;
            split_tf32(kr[0], b_hi[jj][0], b_lo[jj][0]);
            split_tf32(kr[4], b_hi[jj][1], b_lo[jj][1]);
          }
        }
        mma_3xtf32(s, nj, a_hi, a_lo, b_hi, b_lo);
      }
      // scale, mask (keys past L; causal key > row), tile max per row
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * (2 * jj + half) + 2 * t + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          const bool ok = jj < nj && key < L && (!causal || key <= row);
          s[jj][e] = ok ? s[jj][e] * scale : -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[jj][0], s[jj][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[jj][2], s[jj][3]));
      }
      mx_lo = attn_mma::quad_max(mx_lo);
      mx_hi = attn_mma::quad_max(mx_hi);
      // a row whose keys in this half are all masked so far keeps a max
      // of -inf; the guards keep it free of NaN (its P is 0)
      const float base_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
      const float base_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
      const float alpha_lo = expf(m_lo - base_lo);  // 0 while m is -inf
      const float alpha_hi = expf(m_hi - base_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      l_lo *= alpha_lo;
      l_hi *= alpha_hi;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        acc[n][0] *= alpha_lo;
        acc[n][1] *= alpha_lo;
        acc[n][2] *= alpha_hi;
        acc[n][3] *= alpha_hi;
      }
      // O += P V, 8 keys at a time. The lane holds P's columns 2t and
      // 2t + 1 (C layout) where A wants t and t + 4; the sum over keys
      // does not care about their order, so A's column t carries key 2t
      // and column t + 4 key 2t + 1, and B's rows t and t + 4 are V's rows
      // 2t and 2t + 1: P goes from accumulator to operand in registers.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj < nj) {
          const float p0 = expf(s[jj][0] - base_lo);  // masked keys: 0
          const float p1 = expf(s[jj][1] - base_lo);
          const float p2 = expf(s[jj][2] - base_hi);
          const float p3 = expf(s[jj][3] - base_hi);
          l_lo += p0 + p1;
          l_hi += p2 + p3;
          uint32_t p_hi[4], p_lo[4];
          split_tf32(p0, p_hi[0], p_lo[0]);
          split_tf32(p2, p_hi[1], p_lo[1]);
          split_tf32(p1, p_hi[2], p_lo[2]);
          split_tf32(p3, p_hi[3], p_lo[3]);
          const float* vr = vs + (8 * (2 * jj + half) + 2 * t) * S + g;
          uint32_t b_hi[DN][2], b_lo[DN][2];
#pragma unroll
          for (int n = 0; n < DN; ++n) {
            split_tf32(vr[8 * n], b_hi[n][0], b_lo[n][0]);
            split_tf32(vr[S + 8 * n], b_hi[n][1], b_lo[n][1]);
          }
          mma_3xtf32(acc, DN, p_hi, p_lo, b_hi, b_lo);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < tiles) {
      float* ks2 = kv + 2 * (it & 1) * kTile * S;
      load_rows_f32<DH>(ks2, k + base, (it + 2) * kTile, kTile, L, tid,
                        blockDim.x);
      load_rows_f32<DH>(ks2 + kTile * S, v + base, (it + 2) * kTile, kTile,
                        L, tid, blockDim.x);
    }
    cp_async_commit();  // group it + 2
  }

  // merge the two halves: the odd warp of each group leaves its state in
  // the K/V stages (free now: the loop ended on a barrier), lane by lane in
  // fragment order, and the even warp, whose lanes hold the same rows and
  // columns, folds it in and stores O
  float4* state = reinterpret_cast<float4*>(kv) + grp * (DN + 1) * 32 + lane;
  if (live && half == 1) {
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      state[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
    state[DN * 32] = make_float4(m_lo, m_hi, l_lo, l_hi);
  }
  __syncthreads();
  if (live && half == 0) {
    const float4 ml = state[DN * 32];
    // half 0 has seen key 0, so its max is finite
    const float mx_lo = fmaxf(m_lo, ml.x);
    const float mx_hi = fmaxf(m_hi, ml.y);
    const float a0_lo = expf(m_lo - mx_lo), a1_lo = expf(ml.x - mx_lo);
    const float a0_hi = expf(m_hi - mx_hi), a1_hi = expf(ml.y - mx_hi);
    l_lo = attn_mma::quad_sum(l_lo * a0_lo + ml.z * a1_lo);
    l_hi = attn_mma::quad_sum(l_hi * a0_hi + ml.w * a1_hi);
    const float inv_lo = 1.f / l_lo;
    const float inv_hi = 1.f / l_hi;
    // the group's Q rows are free now: stage O there, then store rows
    // below L in 16-byte writes
    constexpr int kChunks = LayoutF32<DH>::kChunks;
    float* stage = qs + 16 * grp * S;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const float4 other = state[n * 32];
      *reinterpret_cast<float2*>(stage + g * S + 8 * n + 2 * t) =
          make_float2((acc[n][0] * a0_lo + other.x * a1_lo) * inv_lo,
                      (acc[n][1] * a0_lo + other.y * a1_lo) * inv_lo);
      *reinterpret_cast<float2*>(stage + (g + 8) * S + 8 * n + 2 * t) =
          make_float2((acc[n][2] * a0_hi + other.z * a1_hi) * inv_hi,
                      (acc[n][3] * a0_hi + other.w * a1_hi) * inv_hi);
    }
    __syncwarp();
    float* dst = o + base;
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      if (row0 + r < L) {
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(row0 + r) * DH +
                                   4 * c) =
            *reinterpret_cast<const float4*>(stage + r * S + 4 * c);
      }
    }
    if (lse != nullptr && t == 0) {
      float* lrow = lse + static_cast<size_t>(bh) * L;
      if (r_lo < L) lrow[r_lo] = mx_lo + logf(l_lo);
      if (r_hi < L) lrow[r_hi] = mx_hi + logf(l_hi);
    }
  }
}

// ---------------------------------------------------------------- bf16 route

// One block: `blockDim.x / 32` warps of 16 query rows from row
// blockIdx.y * 16 * warps, against keys 0 .. kv_end - 1 in 64-key tiles.
// Dynamic shared memory: Q [rows][S], then 1 or 2 stages of K [64][S] and
// V [64][S].
template <int DH>
__global__ void __launch_bounds__(256)
flash_attn_fwd_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int L, int causal,
                           float scale_log2) {
  using namespace attn_mma;
  constexpr int S = Layout<DH>::kStride;
  constexpr int KC = DH / 16;  // k16 steps over the head dim
  constexpr int DN = DH / 8;   // n8 tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int rows = 16 * warps;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kv = qs + rows * S;  // stage i: K at kv + 2*i*kTile*S, V after it

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = static_cast<size_t>(bh) * L * DH;
  const int kv_end = causal ? min(L, q0 + rows) : L;
  const int tiles = (kv_end + kTile - 1) / kTile;

  load_rows<DH>(qs, q + base, q0, rows, L, tid, blockDim.x);
  for (int i = 0; i < 2; ++i) {
    if (i < tiles) {
      bf16* ks = kv + 2 * i * kTile * S;
      load_rows<DH>(ks, k + base, i * kTile, kTile, L, tid, blockDim.x);
      load_rows<DH>(ks + kTile * S, v + base, i * kTile, kTile, L, tid,
                    blockDim.x);
    }
    cp_async_commit();  // group i: tile i (and Q with tile 0)
  }

  const int row0 = q0 + 16 * warp;  // this warp's first query row
  const bool live = row0 < L;
  // keys this warp needs: [0, key_end)
  const int key_end = causal ? min(L, row0 + 16) : L;
  const int r_lo = row0 + g;
  const int r_hi = r_lo + 8;
  uint32_t qf[KC][4];
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 domain
  float l_lo = 0.f, l_hi = 0.f;  // this thread's part of the running sum

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<1>();  // tile it (group it) has landed
    __syncthreads();
    if (it == 0 && live) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        load_a<DH>(qf[kc], qs, 16 * warp, 16 * kc, lane);
      }
    }
    const bf16* ks = kv + 2 * (it & 1) * kTile * S;
    const bf16* vs = ks + kTile * S;
    const int k0 = it * kTile;
    // 8-key tiles of this tile that hold a key the warp needs
    const int n8 = live ? min(8, (key_end - k0 + 7) / 8) : 0;
    if (n8 > 0) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // 16 keys at a time
        if (2 * jj < n8) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            uint32_t b[4];
            load_b_rows<DH>(b, ks, 16 * jj, 16 * kc, lane);
            mma_bf16(s[2 * jj], qf[kc], b[0], b[1]);
            mma_bf16(s[2 * jj + 1], qf[kc], b[2], b[3]);
          }
        }
      }
      // scale, mask (keys past L; causal key > row), tile max per row
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          const bool ok = key < L && (!causal || key <= row);
          s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      // every row sees key 0 in the first tile, so the max is finite from
      // then on; the guards keep a row with no key yet free of NaN
      const float base_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
      const float base_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
      const float alpha_lo = exp2f(m_lo - base_lo);
      const float alpha_hi = exp2f(m_hi - base_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      l_lo *= alpha_lo;
      l_hi *= alpha_hi;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        acc[n][0] *= alpha_lo;
        acc[n][1] *= alpha_lo;
        acc[n][2] *= alpha_hi;
        acc[n][3] *= alpha_hi;
      }
      // P = exp2(s - max) in fp32 for the row sums, bf16 for P.V
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[j][0] - base_lo);
        const float p1 = exp2f(s[j][1] - base_lo);
        const float p2 = exp2f(s[j][2] - base_hi);
        const float p3 = exp2f(s[j][3] - base_hi);
        l_lo += p0 + p1;
        l_hi += p2 + p3;
        pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // 16 keys at a time
        if (2 * c < n8) {
#pragma unroll
          for (int n = 0; n < DN; n += 2) {
            uint32_t b[4];
            load_b_cols<DH>(b, vs, 16 * c, 8 * n, lane);
            mma_bf16(acc[n], pa[c], b[0], b[1]);
            mma_bf16(acc[n + 1], pa[c], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < tiles) {
      bf16* ks2 = kv + 2 * (it & 1) * kTile * S;
      load_rows<DH>(ks2, k + base, (it + 2) * kTile, kTile, L, tid,
                    blockDim.x);
      load_rows<DH>(ks2 + kTile * S, v + base, (it + 2) * kTile, kTile, L,
                    tid, blockDim.x);
    }
    cp_async_commit();  // group it + 2
  }

  if (live) {
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    // the warp's own Q rows are free now: stage O there
    store_rows<DH>(qs + 16 * warp * S, o + base, acc, 1.f / l_lo,
                   1.f / l_hi, row0, L, lane);
    if (lse != nullptr && t == 0) {
      float* lrow = lse + static_cast<size_t>(bh) * L;
      if (r_lo < L) lrow[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < L) lrow[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

template <int DH>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int L, int causal, float scale,
                cudaStream_t stream) {
  using attn_mma::kTile;
  const int groups = (L + 15) / 16;
  const int warps = 2 * (groups < 4 ? groups : 4);
  const int stages = L > kTile ? 2 : 1;
  const size_t smem = sizeof(float) * LayoutF32<DH>::kStride *
                      (kRowsF32 + 2 * stages * kTile);
  const int err = attn_mma::allow_smem(flash_attn_fwd_tf32_kernel<DH>, smem);
  if (err != 0) return err;
  const dim3 grid(bh, (L + kRowsF32 - 1) / kRowsF32);
  flash_attn_fwd_tf32_kernel<DH><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, L, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int L, int causal, float scale,
                cudaStream_t stream) {
  using namespace attn_mma;
  const Shape shape = block_shape(L);
  const int rows = 16 * shape.warps;
  const int stages = L > kTile ? 2 : 1;
  const size_t smem =
      sizeof(bf16) * Layout<DH>::kStride * (rows + 2 * stages * kTile);
  const int err = allow_smem(flash_attn_fwd_bf16_kernel<DH>, smem);
  if (err != 0) return err;
  const dim3 grid(bh, shape.blocks_per_head);
  flash_attn_fwd_bf16_kernel<DH><<<grid, 32 * shape.warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, L, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [bh, L, dh]. dtype 0 = float32, 1 = bfloat16.
// lse: null, or fp32 [bh, L] for each row's log-sum-exp (training).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int L, int dh,
                              int dtype, int causal, float scale,
                              void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || L < 1 || (dh != 64 && dh != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return dh == 64
               ? launch_fp32<64>(q, k, v, o, lse_f, bh, L, causal, scale, s)
               : launch_fp32<32>(q, k, v, o, lse_f, bh, L, causal, scale, s);
  }
  if (dtype == 1) {
    return dh == 64
               ? launch_bf16<64>(q, k, v, o, lse_f, bh, L, causal, scale, s)
               : launch_bf16<32>(q, k, v, o, lse_f, bh, L, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
