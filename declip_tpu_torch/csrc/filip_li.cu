// FILIP late interaction for Hopper (sm_90a), forward and backward, plain C
// interface. Three kernels in one source:
//
//   K3 filip_li_fwd     raw[b, l] = mean_n max_m <d1[b, n], d2[l, m]>, and
//                       the max winners as a bit mask
//                       replaces declip_tpu/ops/filip_pallas.py `_fwd_kernel`
//                       (l.89, launched by `_li_raw_fwd`'s pallas_call, l.176)
//   K4 filip_li_bwd_d1  dd1[b, n] = sum_l sum_m W[b, l, n, m] d2[l, m]
//                       replaces `_bwd_d1_kernel` (l.107, pallas_call l.200)
//   K5 filip_li_bwd_d2  dd2[l, m] = sum_b sum_n W[b, l, n, m] d1[b, n]
//                       replaces `_bwd_d2_kernel` (l.130, pallas_call l.210)
//
// with W = g[b, l] / (N1 * ties) on the max winners m of each (b, n, l) and 0
// elsewhere (`_winner_weights`, l.99-104): ties split the gradient evenly, as
// jnp.max autodiff and torch.amax do. d1 is [B, N1, D] and d2 [GB, N2, D], in
// fp32 or bf16; raw and g are fp32 [B, GB]; dd1 and dd2 come out in the
// input dtype. Every similarity and every sum accumulates in fp32.
//
// Winners. The TPU kernels recompute every similarity in the backward to
// find the winners again. Here K3 writes them down while it takes each max:
// winners [B*N1, GB, ceil(N2/32)] int32, bit m % 32 of word m / 32 set
// exactly when sim[r, l, m] equals the key item's max (so exact ties, for
// example duplicated key tokens, set several bits). A NaN max (NaN wins the
// max, as in torch.amax) equals nothing and sets no bit. K4 and K5 read the
// mask and form no similarity, so their winners are K3's by construction.
// For row r and item l, t = popcount(mask) and w = g[b, l] / (N1 * t);
// token m's weight is w on a set bit and 0 elsewhere. Where w is not finite
// (t = 0, or a NaN or infinite g) the plain version's w * 0 is NaN on every
// other token, so the kernels then weight every token w * bit, as it does;
// else they visit the set bits only.
//
// What bounds it on an H100 (training shapes: B = GB = 128, N1 = 49 or 77,
// N2 = 16, D = 256, bf16).
//  * K3 forms every similarity, 2*B*N1*GB*N2*D = 6.6 and 10.3 GFLOP from
//    about 4.3 MB read and 3.2 / 5.0 MB of winners written: the FLOPs bound
//    it on any unit of the card (the bf16 tensor cores at 989 TFLOP/s: 6.7
//    and 10.4 us).
//  * K4 and K5 do one product per winner, 2*D FLOPs for each (row, item)
//    without ties: 0.41 / 0.65 GFLOP, 1/N2 of K3's. K4 reads the winners, g
//    and d2 and writes dd1, about 7.5 MB at N1 = 49 (2.2 us at 3.35 TB/s);
//    K5 reads the winners, g and d1 and writes dd2. Bytes bound both against
//    the tensor cores' rate; on the CUDA cores (67 TFLOP/s fp32) the FMAs
//    take at least 6 / 10 us.
//  * Why not the tensor cores for K4 and K5: each product uses a single
//    winner, so as a matrix product W is N2 - 1 parts zero, and its nonzero
//    weights g / (N1 * t) would round as a bf16 operand. A gather (K4) and a
//    scatter (K5) of fp32 FMAs on the CUDA cores do 1/N2 of a dense
//    product's work and keep the weights exact.
//
// What the design does about it.
//  * K3 in bf16 (li_fwd_bf16_kernel) is one product on the tensor cores,
//    d1 as [B*N1, D] times d2 as [GB*N2, D] transposed, with a segmented
//    max as its epilogue: mma.sync m16n8k16 with bf16 operands and fp32
//    accumulators (attn_mma.cuh's fragments; d2's rows along D are the
//    "col" operand as they stand). Products of bf16 values are exact in
//    fp32, so only the order of the sums differs from the plain version.
//    A block keeps a key tile of whole items (up to 256 key tokens, all of
//    D) in shared memory and walks its run of query rows 32 at a time, so
//    d2 is read once a block and d1 once a key tile (8 times at N2 = 16).
//    Its 8 warps form two groups of 4, each warp 32 rows x 64 tokens; a
//    group takes every other row tile through its own ring of two stages
//    (16-byte cp.async, the next rows in flight while a tile is used).
//    The groups take turns on the tensor cores (named barriers), so that
//    one group's maxima, on the CUDA cores, run under the other's
//    products: with all warps in step the maxima cost a fifth of the
//    kernel's time. At D = 256 the loop over d is unrolled, so that each
//    step's ldmatrix issues ahead of the previous step's mma. Rows are
//    padded to Dk + 8 elements (Dk: D rounded up to 16, zeros past D), so
//    ldmatrix reads no two rows on one bank. At N2 = 16, the FILIP
//    step's width, a key item lies in two n8 tiles of one warp: its max
//    (PTX's max.NaN, one instruction) and winner bits are taken in
//    registers over the four lanes of a quad, and each lane stores one
//    row's items, 16 bytes at a time where aligned. Other N2 land in a
//    shared-memory fp32 tile, as the fp32 route's do, with one stage a
//    group.
//  * K3 in fp32 is the CUDA-core tiled similarity of the first port: a
//    block of 256 threads computes a 64-row tile of the flattened query
//    rows (B*N1) against up to 128 key tokens (whole key items only), each
//    thread a 4 x KC micro-tile, d staged through shared memory 32 at a
//    time, each dot one fmaf chain over d = 0..D-1 in order. The tile lands
//    in shared memory, where each item's max and winner bits are taken.
//    No main path runs it (FILIP trains in bf16).
//  * Either way the similarities never reach device memory.
//  * K4 and K5 do little arithmetic per global read, so what bounds them
//    in practice is latency: a warp whose chain (mask, then token, then
//    sum) waits on device memory once per key item or row spends
//    microseconds per item. So every global read of theirs goes through a
//    ring of three shared-memory stages, filled two steps ahead of use: the
//    tokens of K4 by one bulk copy a stage (Hopper's TMA engine, completion
//    on an mbarrier), the rest with cp.async. Within a step a warp forms 32
//    pairs' weights at once (one a lane), adds each pair's first winner in
//    a straight pass and leaves ties and non-finite weights, which are rare,
//    to a second (`for_rest`).
//  * K4 is a gather: a warp owns 8 query rows and all of d (8 contiguous d
//    a lane, fp32 registers, tokens read 16 bytes at a time) and walks its
//    split's key items S at a time (4 at N2 = 16: 32 KB of d2 in bf16 a
//    stage), adding w * d2[l, m] for each winner. The warps a block (4-8)
//    and the key splits are chosen so that the busiest SM gets the least
//    work: two blocks an SM fit, and a block count just under twice the SMs
//    leaves none with less.
//  * K5 is a scatter: a warp walks its split's query rows 32 at a time,
//    adding w * d1[r] into each winner's slot. At N2 <= 16 a warp owns 8
//    of an item's token slots and the whole d row, the sums in fp32
//    registers (8 x 8 a lane): the rows of a step are bucketed by first
//    winner with a ballot a slot, so that each slot keeps fixed registers,
//    and taken two a turn; an item's 16 slots take two warps, which halves
//    each warp's chain of buckets. A sum in shared memory would cost three
//    shared-memory accesses a FMA, which is what bounded the first version
//    of this kernel. Wider items take a warp and a d slice of 32*QD each,
//    the sums in the warp's own part of shared memory (N2 * 32QD * 4
//    bytes). Either way the lane that owns (token, d) does every update of
//    it: no conflicts, no atomics.
//  * No padding of N1, D, B or GB to tile sizes in device memory (the TPU
//    kernel's Mosaic layout rules, filip_pallas.py:45-72): ragged edges are
//    masked by bounds, or (K3's bf16 route) filled with zeros in shared
//    memory, where a zero adds nothing to a dot product.
//  * Sums across blocks without atomics, so every result is deterministic:
//    K3 writes each row's max [B*N1, GB] and a second small kernel takes the
//    mean over each item's N1 rows in row order; K4 splits the key items and
//    K5 the query rows over a few blocks each (to fill the 132 SMs) into fp32
//    partial sums, which a reduce kernel adds in split order and rounds to
//    the output dtype once (with one split the kernel writes the output).
//
// Rounding against the TPU kernel. The TPU kernel accumulates dd1 across key
// tiles in the output dtype (`o_ref[:] += acc.astype(o_ref.dtype)`, l.127),
// which in bf16 rounds once per 128-key tile; here dd1 and dd2 accumulate in
// fp32 and round once. At GB <= 128 there is one key tile and the two agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "attn_mma.cuh"  // cp.async, ldmatrix, mma.sync

namespace {

using attn_mma::bf16;
using attn_mma::cp_async16;
using attn_mma::cp_async4;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::ldmatrix_x4;
using attn_mma::mma_bf16;

constexpr int kThreads = 256;   // 16 x 16 (K3), 8 warps (K5; K4 at most)
constexpr int kRows = 64;       // K3: query rows per tile (K4: at most)
constexpr int kMaxCols = 128;   // K3: key tokens per tile
constexpr int kChunk = 32;      // K3: d staged per step
constexpr int kMaxN2 = 128;
constexpr int kMaxD = 256;
constexpr int kPerLane = kMaxD / 32;  // K4: d = 8 * lane + j
constexpr int kItems = kThreads / 32;  // K5: key items a block, a warp each
constexpr size_t kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr size_t kSmemPerSm = 233472;  // an SM's
constexpr int kMaxThreadsPerSm = 2048;

__host__ __device__ __forceinline__ int n_words(int N2) {
  return (N2 + 31) / 32;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Shape {
  int R;   // query rows, B * N1 (row r belongs to query item r / N1)
  int N1;
  int GB;
  int N2;
  int D;
};


// The staging buffers and the similarity tile share one shared-memory area:
// the tile is written only after the last staged chunk is consumed.
struct Smem {
  union {
    struct {
      float a[kRows][kChunk + 1];     // +1: conflict-free column reads
      float b[kMaxCols][kChunk + 1];
    } stage;
    float s[kRows][kMaxCols + 1];
  };
};

// s[row][col] = <d1[r0 + row], d2[j0 + col]> for row < kRows, col < C
// (C <= 16 * KC key tokens, all of whole key items), each an fmaf chain over
// d = 0..D-1 in order. Rows past R give 0. Starts and ends with a barrier.
template <typename T, int KC>
__device__ void tile_dots(const T* __restrict__ d1, const T* __restrict__ d2,
                          int r0, int j0, int C, const Shape& sh, Smem& sm) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int jend = sh.GB * sh.N2;
  float acc[4][KC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[i][k] = 0.f;
  }
  for (int d0 = 0; d0 < sh.D; d0 += kChunk) {
    __syncthreads();  // the previous chunk (or tile) is consumed
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int row = e / kChunk, dd = e % kChunk;
      const int r = r0 + row, d = d0 + dd;
      sm.stage.a[row][dd] =
          (r < sh.R && d < sh.D) ? to_f(d1[static_cast<size_t>(r) * sh.D + d])
                                 : 0.f;
    }
    for (int e = threadIdx.x; e < 16 * KC * kChunk; e += kThreads) {
      const int col = e / kChunk, dd = e % kChunk;
      const int j = j0 + col, d = d0 + dd;
      sm.stage.b[col][dd] = (col < C && j < jend && d < sh.D)
                                ? to_f(d2[static_cast<size_t>(j) * sh.D + d])
                                : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < kChunk; ++dd) {
      float a[4], b[KC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.stage.a[ty + 16 * i][dd];
#pragma unroll
      for (int k = 0; k < KC; ++k) b[k] = sm.stage.b[tx + 16 * k][dd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[i][k] = fmaf(a[i], b[k], acc[i][k]);
      }
    }
  }
  __syncthreads();  // the staging area becomes the tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int col = tx + 16 * k;
      if (col < C) sm.s[ty + 16 * i][col] = acc[i][k];
    }
  }
  __syncthreads();
}

// The larger of two similarities, NaN winning, as in jnp.maximum and
// torch.amax (fmaxf would drop it): K3 then gives NaN and sets no winner
// bit, and K4 and K5 make every weight of the pair NaN (`for_rest`).
// One instruction: PTX's max.NaN (sm_80 and later) gives NaN where either
// operand is NaN.
__device__ __forceinline__ float nan_max(float mx, float x) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(mx), "f"(x));
  return r;
}

// The max of a key item's n similarities.
__device__ __forceinline__ float item_max(const float* s, int n) {
  float mx = s[0];
  for (int m = 1; m < n; ++m) mx = nan_max(mx, s[m]);
  return mx;
}

// rowmax[r, l] and winners[r, l, :] of a tile of similarities in shared
// memory, s[row * ld + lk * N2 + m] for query row r0 + row (row < rows)
// and key item l0 + lk (lk < nk), rows at or past r_end left alone;
// threads tid of nthreads take the (row, item) pairs in turn.
__device__ void tile_maxima(const float* s, int ld, int r0, int rows,
                            int r_end, int l0, int nk, const Shape& sh,
                            float* __restrict__ rowmax,
                            uint32_t* __restrict__ winners, int tid,
                            int nthreads) {
  const int W = n_words(sh.N2);
  for (int p = tid; p < rows * nk; p += nthreads) {
    const int row = p / nk, lk = p % nk;
    const int r = r0 + row;
    if (r >= r_end) continue;
    const float* sp = s + row * ld + lk * sh.N2;
    const float mx = item_max(sp, sh.N2);
    const size_t pair = static_cast<size_t>(r) * sh.GB + l0 + lk;
    rowmax[pair] = mx;
    for (int w = 0; w < W; ++w) {
      uint32_t bits = 0;
      const int m_end = min(sh.N2, 32 * w + 32);
      for (int m = 32 * w; m < m_end; ++m) {
        bits |= static_cast<uint32_t>(sp[m] == mx) << (m - 32 * w);
      }
      winners[pair * W + w] = bits;
    }
  }
}

// K3 in fp32, pass 1: grid (row tiles, key groups of kt items).
// rowmax[r, l] = max_m <d1[r], d2[l, m]>, and winners[r, l, :] its bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
li_fwd_kernel(const T* __restrict__ d1, const T* __restrict__ d2,
              float* __restrict__ rowmax, uint32_t* __restrict__ winners,
              Shape sh, int kt) {
  __shared__ Smem sm;
  const int r0 = blockIdx.x * kRows;
  const int l0 = blockIdx.y * kt;
  const int nk = min(kt, sh.GB - l0);
  tile_dots<T, kMaxCols / 16>(d1, d2, r0, l0 * sh.N2, nk * sh.N2, sh, sm);
  tile_maxima(&sm.s[0][0], kMaxCols + 1, r0, kRows, sh.R, l0, nk, sh, rowmax,
              winners, threadIdx.x, kThreads);
}

// K3 in bf16 on the tensor cores (see the note at the top). Block: two
// groups of 4 warps; a group multiplies a tile of 32 query rows by the
// block's key tile of kMmaCols tokens (kt whole items, zeros past GB*N2),
// each warp 32 rows x 64 tokens.
constexpr int kMmaThreads = 256;
constexpr int kGroupThreads = 128;
constexpr int kMmaRows = 32;   // a group's row tile
constexpr int kMmaCols = 256;

// Named barriers: 1 + g holds group g's 128 threads; 3 + g lets group g
// start its products, once the other group's are done (bar.arrive there).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kGroupThreads) : "memory");
}
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kMmaThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kMmaThreads) : "memory");
}

// rows [0, rows) of a stage: src rows row0 + i (zeros at or past n), d in
// [0, Dk) (zeros past D), into dst at stride S, by threads tid of
// nthreads. `vec`: src 16-byte aligned and D a multiple of 8, so that rows
// go by 16-byte cp.async (a copy of zeros where not valid); else element
// by element.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int rows, int n, int D,
                                           int Dk, int S, bool vec, int tid,
                                           int nthreads) {
  for (int i = tid; i < rows * (kMaxD / 8); i += nthreads) {
    const int row = i / (kMaxD / 8), c = (i % (kMaxD / 8)) * 8;
    if (c >= Dk) continue;
    const bool ok = row0 + row < n;
    const size_t at = static_cast<size_t>(ok ? row0 + row : 0) * D + c;
    bf16* p = dst + row * S + c;
    if (vec) {
      cp_async16(p, src + (ok && c < D ? at : 0), ok && c < D);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[j] = ok && c + j < D ? src[at + j] : __ushort_as_bfloat16(0);
      }
    }
  }
}

// N2 = 16: the maxima and winner bits of a warp's 32 x 64 tile (4 key
// items), from its accumulators (rows row0 + 16 i + g and + 8 in
// acc[i][n][0..1] and [2..3], tokens 8 n + 2 q and + 1 of the warp's 64,
// for lane (g, q)). Key item j is n8 tiles 2 j and 2 j + 1, so each of its
// rows lies in one quad: two xor shuffles give the quad its max (NaN
// winning) and its bits. Lane q then stores the items of row (i, h) =
// (q >> 1, q & 1), 16 bytes at a time where aligned.
__device__ __forceinline__ void reg_maxima(const float (&acc)[2][8][4],
                                           int row0, int r_end, int item0,
                                           const Shape& sh,
                                           float* __restrict__ rowmax,
                                           uint32_t* __restrict__ winners) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  float keep_mx[4];
  uint32_t keep_bits[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float mx = acc[i][2 * j][2 * h];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mx = nan_max(mx, acc[i][2 * j + n][2 * h]);
          mx = nan_max(mx, acc[i][2 * j + n][2 * h + 1]);
        }
        mx = nan_max(mx, __shfl_xor_sync(full, mx, 1));
        mx = nan_max(mx, __shfl_xor_sync(full, mx, 2));
        uint32_t bits = 0;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // token 8 n + 2 q + e of the item
            bits |= static_cast<uint32_t>(acc[i][2 * j + n][2 * h + e] == mx)
                    << (8 * n + 2 * q + e);
          }
        }
        bits |= __shfl_xor_sync(full, bits, 1);
        bits |= __shfl_xor_sync(full, bits, 2);
        if (q == 2 * i + h) {
          keep_mx[j] = mx;
          keep_bits[j] = bits;
        }
      }
    }
  }
  const int r = row0 + 16 * (q >> 1) + 8 * (q & 1) + g;
  const int valid = min(4, sh.GB - item0);
  if (r >= r_end || valid <= 0) return;
  const size_t pair0 = static_cast<size_t>(r) * sh.GB + item0;
  if (valid == 4 && pair0 % 4 == 0) {
    *reinterpret_cast<float4*>(rowmax + pair0) =
        make_float4(keep_mx[0], keep_mx[1], keep_mx[2], keep_mx[3]);
    *reinterpret_cast<uint4*>(winners + pair0) =
        make_uint4(keep_bits[0], keep_bits[1], keep_bits[2], keep_bits[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < valid) {
      rowmax[pair0 + j] = keep_mx[j];
      winners[pair0 + j] = keep_bits[j];
    }
  }
}

// One k16 step of a warp's 32 x 64 product: acc[i][n] += A rows 16 i ..
// 16 i + 15 (a_ptr: this lane's ldmatrix row) times B tokens 8 n .. 8 n +
// 7 (b_ptr likewise), d = k0 .. k0 + 15, for the first `pairs` n16 pairs.
__device__ __forceinline__ void mma_step(float (&acc)[2][8][4],
                                         const bf16* a_ptr,
                                         const bf16* b_ptr, int S, int k0,
                                         int pairs) {
  uint32_t a[2][4];
  ldmatrix_x4(a[0], a_ptr + k0);
  ldmatrix_x4(a[1], a_ptr + 16 * S + k0);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (p < pairs) {
      uint32_t b[4];
      ldmatrix_x4(b, b_ptr + 16 * p * S + k0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
        mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// A warp's product over d: KS k16 steps unrolled where KS > 0 (Dk = 16
// KS) and all four pairs hold tokens, so that the compiler can issue each
// step's ldmatrix ahead of the previous step's mma; else a loop.
template <int KS>
__device__ __forceinline__ void warp_product(float (&acc)[2][8][4],
                                             const bf16* a_ptr,
                                             const bf16* b_ptr, int S,
                                             int Dk, int pairs) {
  if constexpr (KS > 0) {
    if (pairs == 4) {
#pragma unroll
      for (int k = 0; k < KS; ++k) mma_step(acc, a_ptr, b_ptr, S, 16 * k, 4);
      return;
    }
  }
#pragma unroll 2
  for (int k0 = 0; k0 < Dk; k0 += 16) {
    mma_step(acc, a_ptr, b_ptr, S, k0, pairs);
  }
}

// REG: N2 = 16, each key item in two n8 tiles of one warp, maxima and
// bits in registers, a ring of two row stages a group. Else any N2, the
// tile in shared memory (fp32, row stride
// kMmaCols + 1) over the group's one row stage. KS: k16 steps unrolled
// (Dk = 16 KS), or 0. Grid (key tiles, row splits); group g takes row
// tiles g, g + 2, ... of its block's split. The groups take turns on the
// tensor cores, so that one's maxima overlap the other's products.
template <bool REG, int KS>
__global__ void __launch_bounds__(kMmaThreads, 1)
li_fwd_bf16_kernel(const bf16* __restrict__ d1, const bf16* __restrict__ d2,
                   float* __restrict__ rowmax, uint32_t* __restrict__ winners,
                   Shape sh, int kt, int rows_per_split, int Dk, int a_bytes,
                   bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NS = REG ? 2 : 1;
  const int S = Dk + 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = warp / 4, wc = warp % 4;  // 64 tokens a warp
  const int gt = threadIdx.x % kGroupThreads;
  bf16* bs = reinterpret_cast<bf16*>(smem);  // [kMmaCols][S]
  // the group's stages, [NS][kMmaRows][S] (!REG: the fp32 tile over it)
  bf16* as = reinterpret_cast<bf16*>(smem + kMmaCols * S * sizeof(bf16) +
                                     grp * a_bytes);
  const int l0 = blockIdx.x * kt;
  const int nk = min(kt, sh.GB - l0);
  const int C = nk * sh.N2;  // valid key tokens
  const int jend = sh.GB * sh.N2;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(sh.R, r_begin + rows_per_split);
  const int tiles = (r_end - r_begin + kMmaRows - 1) / kMmaRows;
  const int turns = (tiles + 1) / 2;  // both groups take as many turns
  // n16 column pairs of this warp that hold valid tokens (warp-uniform)
  const int pairs = max(0, min(4, (C - 64 * wc + 15) / 16));
  const int j0 = l0 * sh.N2;
  auto row_of = [&](int turn) {
    return r_begin + (2 * turn + grp) * kMmaRows;
  };

  stage_rows(bs, d2, j0, (C + 15) / 16 * 16, min(jend, j0 + C), sh.D, Dk, S,
             vec, threadIdx.x, kMmaThreads);
  stage_rows(as, d1, row_of(0), kMmaRows, r_end, sh.D, Dk, S, vec, gt,
             kGroupThreads);
  cp_async_commit();
  if constexpr (NS == 2) {
    stage_rows(as + kMmaRows * S, d1, row_of(1), kMmaRows, r_end, sh.D, Dk,
               S, vec, gt, kGroupThreads);
    cp_async_commit();
  }
  if (grp == 1) turn_pass(3);  // group 0 goes first
  for (int k = 0; k < turns; ++k) {
    const int r0 = row_of(k);
    const bool mine = r0 < r_end;
    cp_async_wait<NS - 1>();
    if (k == 0) {
      __syncthreads();  // the key tile, staged by every thread
    } else {
      group_sync(1 + grp);
    }
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
      }
    }
    turn_wait(3 + grp);
    if (mine && pairs > 0) {
      const int m = lane >> 3;
      warp_product<KS>(
          acc, as + (k % NS) * kMmaRows * S + (lane & 15) * S +
                   (lane >> 4) * 8,
          bs + (64 * wc + (m >> 1) * 8 + (lane & 7)) * S + (m & 1) * 8, S,
          Dk, pairs);
    }
    // the other group's turn (group 1 passes its last one to nobody, so
    // that every bar.arrive meets a bar.sync)
    if (grp == 0 || k + 1 < turns) turn_pass(3 + (1 - grp));
    group_sync(1 + grp);  // every warp of the group is done with the stage
    if constexpr (REG) {
      stage_rows(as + (k % 2) * kMmaRows * S, d1, row_of(k + 2), kMmaRows,
                 r_end, sh.D, Dk, S, vec, gt, kGroupThreads);
      cp_async_commit();
      if (mine) {
        reg_maxima(acc, r0, r_end, l0 + wc * 4, sh, rowmax, winners);
      }
    } else {
      float* tile = reinterpret_cast<float*>(as);
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 64 * wc + 8 * n + 2 * q;
          const int row = 16 * i + g;
          if (n / 2 < pairs) {
            tile[row * (kMmaCols + 1) + col] = acc[i][n][0];
            tile[row * (kMmaCols + 1) + col + 1] = acc[i][n][1];
            tile[(row + 8) * (kMmaCols + 1) + col] = acc[i][n][2];
            tile[(row + 8) * (kMmaCols + 1) + col + 1] = acc[i][n][3];
          }
        }
      }
      group_sync(1 + grp);
      if (mine) {
        tile_maxima(tile, kMmaCols + 1, r0, kMmaRows, r_end, l0, nk, sh,
                    rowmax, winners, gt, kGroupThreads);
      }
      group_sync(1 + grp);  // the tile is read: the stage takes the next rows
      stage_rows(as, d1, row_of(k + 1), kMmaRows, r_end, sh.D, Dk, S, vec,
                 gt, kGroupThreads);
      cp_async_commit();
    }
  }
}

// K3, pass 2: raw[b, l] = (sum over n in order of rowmax[b*N1 + n, l]) / N1.
__global__ void li_mean_kernel(const float* __restrict__ rowmax,
                               float* __restrict__ raw, int B, int N1,
                               int GB) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * GB) return;
  const int b = idx / GB, l = idx % GB;
  const float* src = rowmax + static_cast<size_t>(b) * N1 * GB + l;
  float sum = 0.f;
  for (int n = 0; n < N1; ++n) sum += src[static_cast<size_t>(n) * GB];
  raw[idx] = sum / static_cast<float>(N1);
}

// One (row, item) pair's W mask words: t, the number of winners, m0, the
// first (-1 for none), and the weight g / (N1 * t).
__device__ __forceinline__ void pair_info(const uint32_t* mask, int W,
                                          float g, int N1, float& wt,
                                          int& m0, int& t) {
  t = 0;
  m0 = -1;
  for (int w = W - 1; w >= 0; --w) {
    const uint32_t x = mask[w];
    t += __popc(x);
    if (x) m0 = 32 * w + __ffs(static_cast<int>(x)) - 1;
  }
  wt = g / (static_cast<float>(N1) * static_cast<float>(t));
}

// The one-winner pass adds w * token m0 for each pair whose weight is
// finite, and 0 * token 0 for the others. The rest pass finishes the pairs
// it does not: ties (t > 1) and non-finite weights (t = 0, or a NaN or
// infinite g), which are rare.
__device__ __forceinline__ bool needs_rest(float wt, int t) {
  return !(t == 1 && isfinite(wt));
}
__device__ __forceinline__ float first_weight(float wt, int t) {
  return t >= 1 && isfinite(wt) ? wt : 0.f;
}
__device__ __forceinline__ int first_token(float wt, int m0, int t) {
  return t >= 1 && isfinite(wt) ? m0 : 0;
}

// The rest of a pair, add(m, w_m) for each token (see "Winners" above): the
// set bits but m0, at wt, where wt is finite, else every token at wt * bit.
template <typename F>
__device__ __forceinline__ void for_rest(const uint32_t* mask, int W, int N2,
                                         float wt, int m0, F&& add) {
  if (isfinite(wt)) {
    for (int w = 0; w < W; ++w) {
      for (uint32_t bits = mask[w]; bits; bits &= bits - 1) {
        const int m = 32 * w + __ffs(static_cast<int>(bits)) - 1;
        if (m != m0) add(m, wt);
      }
    }
  } else {
    for (int m = 0; m < N2; ++m) {
      add(m, wt * static_cast<float>((mask[m / 32] >> (m % 32)) & 1u));
    }
  }
}

// v[j] = x[j] for j < N as fp32, read 16 bytes at a time (8 or 4 for
// fewer bytes): x must be aligned to them. Reads past the valid d are the
// caller's to ignore (they land in sums that are never written out).
template <int N, typename T>
__device__ __forceinline__ void read_vec(const T* x, float (&v)[N]) {
  if constexpr (sizeof(T) == 2 && N % 2 == 0) {
    uint32_t u[N / 2];
    if constexpr (N == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(x);
      u[0] = q.x, u[1] = q.y, u[2] = q.z, u[3] = q.w;
    } else if constexpr (N == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(x);
      u[0] = q.x, u[1] = q.y;
    } else {
      u[0] = *reinterpret_cast<const uint32_t*>(x);
    }
#pragma unroll
    for (int h = 0; h < N / 2; ++h) {  // bf16 -> fp32: the high half
      v[2 * h] = __uint_as_float(u[h] << 16);
      v[2 * h + 1] = __uint_as_float(u[h] & 0xffff0000u);
    }
  } else if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 q = *reinterpret_cast<const float4*>(x + 4 * h);
      v[4 * h] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z,
      v[4 * h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f(x[j]);
  }
}

// dst[j] = v[j] for j < N while d0 + j < D, in T: 16-byte stores (8-byte
// for N = 4 in bf16) where `vec` (dst aligned to them, D a multiple of N),
// else element by element.
template <int N, typename T>
__device__ __forceinline__ void write_n(T* dst, int d0, int D, bool vec,
                                        const float (&v)[N]) {
  if constexpr (N >= 4) {
    if (vec && d0 + N <= D) {
      if constexpr (sizeof(T) == 2) {
        uint32_t u[N / 2];
#pragma unroll
        for (int h = 0; h < N / 2; ++h) {
          const __nv_bfloat162 p =
              __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
          u[h] = *reinterpret_cast<const uint32_t*>(&p);
        }
        if constexpr (N == 8) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
        }
      } else {
#pragma unroll
        for (int h = 0; h < N / 4; ++h) {
          *reinterpret_cast<float4*>(dst + 4 * h) = make_float4(
              v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (d0 + j < D) dst[j] = from_f<T>(v[j]);
  }
}

template <int N>
__device__ __forceinline__ void axpy(float (&a)[N], float w,
                                     const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = fmaf(w, v[j], a[j]);
}

// a[m] += w * v for a token slot m < S held in registers (the rest pass of
// K5): a warp-uniform switch, so that every slot keeps a fixed register.
template <int S, int N>
__device__ __forceinline__ void add_to_slot(float (&a)[S][N], int m,
                                            float w, const float (&v)[N]) {
  switch (m) {
#define LI_SLOT(k)                           \
  case k:                                    \
    if constexpr (k < S) axpy(a[k], w, v);   \
    break;
    LI_SLOT(0) LI_SLOT(1) LI_SLOT(2) LI_SLOT(3) LI_SLOT(4) LI_SLOT(5)
    LI_SLOT(6) LI_SLOT(7) LI_SLOT(8) LI_SLOT(9) LI_SLOT(10) LI_SLOT(11)
    LI_SLOT(12) LI_SLOT(13) LI_SLOT(14) LI_SLOT(15)
#undef LI_SLOT
    default:
      break;
  }
}

// Hopper's bulk copy (the TMA engine, no tensor map): `bytes` (a multiple
// of 16, both addresses 16-byte aligned) from global to shared memory, its
// completion counted on an mbarrier that expects them.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      attn_mma::smem_addr(bar)));
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = attn_mma::smem_addr(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(attn_mma::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(attn_mma::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The stage ring of K4 and K5: NS stages of `stage_bytes` in shared memory,
// filled by load(buffer, step) NS - 1 steps ahead of use(buffer, step), so
// that every global read is in flight long before it is needed.
template <int NS, typename Load, typename Use>
__device__ __forceinline__ void ring(int steps, Load&& load, Use&& use) {
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    if (it + NS - 1 < steps) load((it + NS - 1) % NS, it + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    use(it % NS, it);
    __syncthreads();  // the buffer is consumed
  }
}

// K4: grid (row tiles, key splits); 4-8 warps a block, 8 query rows a warp,
// 8 contiguous d a lane (fp32 registers). The block walks its split's key
// items S at a time through the stage ring: each stage holds the S items'
// d2[l] (rows padded to Dp elements, a multiple of 16 bytes, so that every
// token row is read 16 bytes at a time), its rows' mask words and g. Lane
// p forms the weight of pair (row p % 8, item p / 8); the warp then adds,
// for each of the stage's items and its 8 rows, w * d2[l, m0] from shared
// memory (straight-line code, the 8 rows' reads in flight together), and
// the rare rest after. With `part` the block writes its fp32 sum to
// part[split, r, :], else dd1 in the dtype. `vec`: d2 16-byte aligned and
// D * sizeof(T) a multiple of 16 (Dp = D; 16-byte copies and stores).
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, 2)
li_bwd_d1_kernel(const uint32_t* __restrict__ winners,
                 const T* __restrict__ d2, const float* __restrict__ g,
                 float* __restrict__ part, T* __restrict__ out, Shape sh,
                 int items_per_split, int S, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPerElem = 16 / sizeof(T);
  const unsigned full = 0xffffffffu;
  const int W = n_words(sh.N2);
  const int Dp = (sh.D + kPerElem - 1) / kPerElem * kPerElem;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rows = blockDim.x / 4;  // 8 a warp
  const int r0 = blockIdx.x * rows;
  const int l_begin = blockIdx.y * items_per_split;
  const int n_items = max(0, min(sh.GB, l_begin + items_per_split) - l_begin);
  const int tok_bytes = S * sh.N2 * Dp * static_cast<int>(sizeof(T));
  const int stage_bytes = tok_bytes + rows * S * (W + 1) * 4;
  auto tokens = [&](int b) {
    return reinterpret_cast<T*>(smem + b * stage_bytes);
  };
  auto masks = [&](int b) {
    return reinterpret_cast<uint32_t*>(smem + b * stage_bytes + tok_bytes);
  };
  auto gs = [&](int b) {
    return reinterpret_cast<float*>(smem + b * stage_bytes + tok_bytes +
                                    rows * S * W * 4);
  };
  // with `vec` the tokens come by bulk copy: an mbarrier a stage, past the
  // stages and their 1 KB of slack
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NS * stage_bytes + 1024);
  if (vec && threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < NS; ++b) mbar_init(bars + b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the staging thread's row (4 threads a row) and its g row
  const int my_row = threadIdx.x / 4;
  const bool my_row_ok = r0 + my_row < sh.R;
  const size_t my_g = static_cast<size_t>((my_row_ok ? r0 + my_row : 0) /
                                          sh.N1) * sh.GB;

  const int d0 = 8 * lane;  // this lane's d: d0 .. d0 + 7
  float acc[8][kPerLane];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[i][j] = 0.f;
  }
  ring<NS>(
      (n_items + S - 1) / S,
      [&](int b, int step) {
        const int l0 = l_begin + step * S;
        const int nk = min(S, l_begin + n_items - l0);
        const T* src = d2 + static_cast<size_t>(l0) * sh.N2 * sh.D;
        T* dst = tokens(b);
        if (vec) {
          if (threadIdx.x == 0) {
            bulk_copy(dst, src, nk * sh.N2 * sh.D * sizeof(T), bars + b);
          }
        } else {
          for (int e = threadIdx.x; e < nk * sh.N2 * sh.D; e += blockDim.x) {
            dst[e / sh.D * Dp + e % sh.D] = src[e];
          }
        }
        uint32_t* mk = masks(b) + my_row * S * W;
        for (int q = threadIdx.x % 4; q < S * W; q += 4) {
          const int k = W == 1 ? q : q / W;
          const bool ok = my_row_ok && k < nk;
          cp_async4(mk + q,
                    winners + (ok ? (static_cast<size_t>(r0 + my_row) *
                                         sh.GB + l0) * W + q
                                  : 0),
                    ok);
        }
        const int k = threadIdx.x % 4;
        if (k < S) {
          const bool ok = my_row_ok && k < nk;
          cp_async4(gs(b) + my_row * S + k, g + (ok ? my_g + l0 + k : 0),
                    ok);
        }
      },
      [&](int b, int step) {
        if (vec) mbar_wait(bars + b, (step / NS) & 1);
        const int nk = min(S, n_items - step * S);
        const T* tok = tokens(b);
        const uint32_t* mk = masks(b);
        const int i = lane & 7, k = lane >> 3;  // this lane's pair
        const int row = 8 * warp + i;
        const bool valid = k < nk && r0 + row < sh.R;
        float wt = 0.f;
        int m0 = 0, t = 1;
        if (valid) {
          pair_info(mk + (row * S + k) * W, W, gs(b)[row * S + k], sh.N1, wt,
                    m0, t);
        }
        const float wf = valid ? first_weight(wt, t) : 0.f;
        const int mf = valid ? first_token(wt, m0, t) : 0;
        const unsigned rest = __ballot_sync(full, valid && needs_rest(wt, t));
        for (int kk = 0; kk < nk; ++kk) {
          const T* item = tok + kk * sh.N2 * Dp + d0;
          float w[8], v[8][kPerLane];
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            w[ii] = __shfl_sync(full, wf, 8 * kk + ii);
            read_vec(item + __shfl_sync(full, mf, 8 * kk + ii) * Dp, v[ii]);
          }
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) axpy(acc[ii], w[ii], v[ii]);
        }
        for (unsigned left = rest; left; left &= left - 1) {  // uniform
          const int p = __ffs(static_cast<int>(left)) - 1;
          const float wt_p = __shfl_sync(full, wt, p);
          const int m0_p = __shfl_sync(full, m0, p);
          const T* item = tok + (p >> 3) * sh.N2 * Dp + d0;
          float sum[kPerLane] = {};
          for_rest(mk + ((8 * warp + (p & 7)) * S + (p >> 3)) * W, W, sh.N2,
                   wt_p, m0_p, [&](int m, float w) {
                     float v[kPerLane];
                     read_vec(item + m * Dp, v);
                     axpy(sum, w, v);
                   });
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            if ((p & 7) == ii) axpy(acc[ii], 1.f, sum);
          }
        }
      });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 8 * warp + i;
    if (r >= sh.R) continue;
    const size_t idx = static_cast<size_t>(r) * sh.D + d0;
    if (part) {
      write_n(part + static_cast<size_t>(blockIdx.y) * sh.R * sh.D + idx,
              d0, sh.D, vec, acc[i]);
    } else {
      write_n(out + idx, d0, sh.D, vec, acc[i]);
    }
  }
}

// K5: grid (key groups, row splits, d slices of 32*QD), 8 warps, lane d =
// slice + QD * lane + j. For N2 <= 16 (REG) a warp owns one key item and a
// group of 8 of its token slots, their fp32 sums in registers (8 x QD a
// lane): an item takes 1 or 2 warps, a block 8 or 4 items. The rows are
// bucketed by first winner, a ballot a slot, so that every slot's
// registers are fixed (only the rest pass picks a slot, by switch). Wider
// items take one warp each, the sums in the warp's own part of shared
// memory, [m][32*QD]. Either way each sum is read and written only by its
// own lane: no conflicts, no atomics. The block walks its split's query
// rows 32 at a time through the stage ring: each stage holds the 32 rows'
// d1 (the d slice), their mask words for the block's items and g. Lane j
// forms row j's weight; the warp then adds each row's w * d1[r] into its
// first winner's slot, and the rare rest after. With `part` the block
// writes its fp32 sums to part[split, l*N2 + m, :], else dd2 in the dtype.
template <typename T, int QD, bool REG>
__global__ void __launch_bounds__(kThreads, 2)
li_bwd_d2_kernel(const uint32_t* __restrict__ winners,
                 const T* __restrict__ d1, const float* __restrict__ g,
                 float* __restrict__ part, T* __restrict__ out, Shape sh,
                 int rows_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DS = 32 * QD;
  constexpr int kStep = 32;  // rows a stage
  constexpr int kSlots = REG ? 8 : 1;
  const unsigned full = 0xffffffffu;
  const int W = n_words(sh.N2);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int groups = REG ? (sh.N2 + kSlots - 1) / kSlots : 1;  // 1 or 2
  const int items = kItems / groups;  // a block's: 8 or 4
  const int items_log = items == 8 ? 3 : 2;
  const int item = warp / groups;
  const int base = REG ? (warp % groups) * kSlots : 0;  // first slot
  const int l0 = blockIdx.x * items;
  const int l = l0 + item;
  const int dbase = blockIdx.z * DS;
  const int cols = min(DS, sh.D - dbase);
  const int c0 = QD * lane;  // this lane's d: dbase + c0 .. + QD - 1
  const int r_begin = blockIdx.y * rows_per_split;
  const int n_rows = max(0, min(sh.R, r_begin + rows_per_split) - r_begin);
  const int sums_bytes = REG ? 0 : kItems * sh.N2 * DS * 4;
  const int rows_bytes = kStep * DS * static_cast<int>(sizeof(T));
  const int stage_bytes = rows_bytes + kStep * kItems * (W + 1) * 4;
  float* my = reinterpret_cast<float*>(smem) +
              static_cast<size_t>(warp) * sh.N2 * DS;
  auto rows_of = [&](int b) {
    return reinterpret_cast<T*>(smem + sums_bytes + b * stage_bytes);
  };
  auto masks = [&](int b) {
    return reinterpret_cast<uint32_t*>(smem + sums_bytes + b * stage_bytes +
                                       rows_bytes);
  };
  auto gs = [&](int b) {
    return reinterpret_cast<float*>(smem + sums_bytes + b * stage_bytes +
                                    rows_bytes + kStep * kItems * W * 4);
  };
  float acc[kSlots][QD];  // REG: slot base + m of this lane's d
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
#pragma unroll
    for (int j = 0; j < QD; ++j) acc[m][j] = 0.f;
  }
  // slot m += w * v (REG: this warp's slots only)
  auto add = [&](int m, float w, const float (&v)[QD]) {
    if constexpr (REG) {
      add_to_slot(acc, m - base, w, v);
    } else {
      float* a = my + m * DS + c0;
#pragma unroll
      for (int j = 0; j < QD; ++j) a[j] = fmaf(w, v[j], a[j]);
    }
  };

  if (!REG) {
    for (int e = lane; e < sh.N2 * DS; e += 32) my[e] = 0.f;
  }
  ring<3>(
      (n_rows + kStep - 1) / kStep,
      [&](int b, int step) {
        // no division by a run-time value: d1 by (row, chunk lane of 8),
        // masks and g by (row, item)
        const int rs = r_begin + step * kStep;
        const int nr = min(kStep, r_begin + n_rows - rs);
        {
          const int sj = threadIdx.x / 8, sk = threadIdx.x % 8;
          if (sj < nr) {
            const T* src = d1 + static_cast<size_t>(rs + sj) * sh.D + dbase;
            T* dst = rows_of(b) + sj * DS;
            if (vec) {
              constexpr int kPer16 = 16 / sizeof(T);
              for (int c = sk; c < cols / kPer16; c += 8) {
                cp_async16(dst + c * kPer16, src + c * kPer16, true);
              }
            } else {
              for (int c = sk; c < cols; c += 8) dst[c] = src[c];
            }
          }
        }
        for (int e = threadIdx.x; e < kStep * items; e += kThreads) {
          const int sj = e >> items_log, sk = e & (items - 1);
          const int li = l0 + sk;
          const bool ok = sj < nr && li < sh.GB;
          const size_t r = static_cast<size_t>(ok ? rs + sj : 0);
          uint32_t* mk = masks(b) + e * W;
          for (int w = 0; w < W; ++w) {
            cp_async4(mk + w, winners + (ok ? (r * sh.GB + li) * W + w : 0),
                      ok);
          }
          cp_async4(gs(b) + e, g + (ok ? r / sh.N1 * sh.GB + li : 0), ok);
        }
      },
      [&](int b, int step) {
        if (l >= sh.GB) return;  // warp-uniform
        const int nr = min(kStep, n_rows - step * kStep);
        const T* xs = rows_of(b);
        const uint32_t* mine = masks(b) + item * W;  // row j: + j*items*W
        float wt = 0.f;
        int m0 = 0, t = 1;
        if (lane < nr) {
          pair_info(mine + lane * items * W, W, gs(b)[lane * items + item],
                    sh.N1, wt, m0, t);
        }
        const float wf = lane < nr ? first_weight(wt, t) : 0.f;
        const int mf = lane < nr ? first_token(wt, m0, t) : 0;
        const unsigned rest =
            __ballot_sync(full, lane < nr && needs_rest(wt, t));
        if constexpr (REG) {
          // the rows bucketed by first winner, so that each slot's sums
          // stay in fixed registers
#pragma unroll
          for (int m = 0; m < kSlots; ++m) {
            // two rows a turn, so that their reads are in flight together
            for (unsigned bits =
                     __ballot_sync(full, lane < nr && mf == base + m);
                 bits;) {  // warp-uniform
              const int j1 = __ffs(static_cast<int>(bits)) - 1;
              bits &= bits - 1;
              const bool two = bits != 0;
              const int j2 = two ? __ffs(static_cast<int>(bits)) - 1 : j1;
              bits &= bits - 1;
              const float w1 = __shfl_sync(full, wf, j1);
              const float w2 = two ? __shfl_sync(full, wf, j2) : 0.f;
              float v1[QD], v2[QD];
              read_vec(xs + j1 * DS + c0, v1);
              read_vec(xs + j2 * DS + c0, v2);
              axpy(acc[m], w1, v1);
              axpy(acc[m], w2, v2);
            }
          }
        } else {
#pragma unroll 4
          for (int j = 0; j < nr; ++j) {
            const float w = __shfl_sync(full, wf, j);
            const int m = __shfl_sync(full, mf, j);
            float v[QD];
            read_vec(xs + j * DS + c0, v);
            add(m, w, v);
          }
        }
        for (unsigned left = rest; left; left &= left - 1) {  // uniform
          const int j = __ffs(static_cast<int>(left)) - 1;
          const float wt_j = __shfl_sync(full, wt, j);
          const int m0_j = __shfl_sync(full, m0, j);
          float v[QD];
          read_vec(xs + j * DS + c0, v);
          for_rest(mine + j * items * W, W, sh.N2, wt_j, m0_j,
                   [&](int m, float w) {
                     if (!REG || (m >= base && m < base + kSlots)) {
                       add(m, w, v);
                     }
                   });
        }
      });
  if (l >= sh.GB) return;
  auto write = [&](int m, const float (&v)[QD]) {
    const size_t idx =
        (static_cast<size_t>(l) * sh.N2 + m) * sh.D + dbase + c0;
    if (part) {
      write_n(part + static_cast<size_t>(blockIdx.y) * sh.GB * sh.N2 * sh.D +
                  idx,
              c0, cols, vec, v);
    } else {
      write_n(out + idx, c0, cols, vec, v);
    }
  };
  if constexpr (REG) {
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      if (base + m < sh.N2) write(base + m, acc[m]);
    }
  } else {
    for (int m = 0; m < sh.N2; ++m) {
      float v[QD];
#pragma unroll
      for (int j = 0; j < QD; ++j) v[j] = my[m * DS + c0 + j];
      write(m, v);
    }
  }
}

// out[i] = sum over s in order of part[s, i], in the output dtype.
template <typename T>
__global__ void li_reduce_kernel(const float* __restrict__ part,
                                 T* __restrict__ out, size_t n, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = part[i];
  for (int s = 1; s < splits; ++s) sum += part[static_cast<size_t>(s) * n + i];
  out[i] = from_f<T>(sum);
}

bool valid(const Shape& sh, int B, int dtype) {
  return B >= 1 && sh.N1 >= 1 && sh.GB >= 1 && sh.N2 >= 1 &&
         sh.N2 <= kMaxN2 && sh.D >= 1 && sh.D <= kMaxD &&
         (dtype == 0 || dtype == 1);
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int sm_count() {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of `smem` bytes (and kThreads threads) that one SM holds at once.
int blocks_per_sm(size_t smem) {
  const size_t by_threads = kMaxThreadsPerSm / kThreads;
  const size_t by_smem = kSmemPerSm / (smem + 1024);
  return static_cast<int>(by_smem < by_threads ? by_smem : by_threads);
}

// Splits of `limit` units over `blocks` blocks: as many as fill the SMs
// with `per_sm` blocks each, at least 1, at most `limit`.
int splits_for(int blocks, int per_sm, int limit) {
  const int want = per_sm * sm_count() / blocks;
  return want < 1 ? 1 : (want > limit ? limit : want);
}

// K4's plan: S items a stage (up to 4, one per 8 lanes) in a ring of 3
// stages that leaves room for two blocks an SM, else one item a stage (in a
// single stage where three do not fit); then the warps a block (4-8, 8 rows
// each) and key splits that put the least work (rows x items) on the
// busiest SM, two blocks an SM at most. The token rows are padded to 16
// bytes, and 1 KB of slack takes the last row's 16-byte reads past the
// valid d.
struct D1Plan {
  int S, NS, warps, splits;
  size_t smem;
};
D1Plan d1_plan(const Shape& sh, int esz) {
  const int W = n_words(sh.N2);
  const int per16 = 16 / esz;
  const size_t row_bytes =
      static_cast<size_t>((sh.D + per16 - 1) / per16 * per16) * esz;
  auto smem = [&](int S, int NS) {
    return NS * (S * sh.N2 * row_bytes +
                 static_cast<size_t>(kRows) * S * (W + 1) * 4) +
           1024 + 8 * NS;
  };
  int S = 4, NS = 3;
  while (S > 1 && smem(S, NS) > kMaxSmem / 2) S /= 2;
  if (smem(S, NS) > kMaxSmem) NS = 1;
  const int per_sm = blocks_per_sm(smem(S, NS)) < 2 ? blocks_per_sm(smem(S, NS))
                                                    : 2;
  const int sms = sm_count();
  D1Plan best{S, NS, 8, 1, smem(S, NS)};
  long long best_cost = -1;
  for (int warps = 8; warps >= 4; --warps) {
    const int tiles = (sh.R + 8 * warps - 1) / (8 * warps);
    const int splits = splits_for(tiles, per_sm, sh.GB);
    const long long waves = (static_cast<long long>(tiles) * splits +
                             static_cast<long long>(per_sm) * sms - 1) /
                            (static_cast<long long>(per_sm) * sms);
    const long long cost = waves * per_sm * 8 * warps *
                           ((sh.GB + splits - 1) / splits);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best.warps = warps;
      best.splits = splits;
    }
  }
  return best;
}

// K5's plan: N2 <= 16 keeps the sums in registers (REG) and the d row
// whole (QD = 8); wider items keep them in shared memory, with the widest
// d slice (32*QD, QD <= 4) that leaves room for two blocks an SM, else
// QD = 1. Either narrows QD where D is small. Then the row splits (whole
// 32-row steps) that fill the SMs, two blocks an SM: each warp walks its
// split's rows one after another, so the rows a warp set the time.
struct D2Plan {
  bool reg;
  int qd, splits, rows_per_split;
  size_t smem;
};
// K5's key items a block: 8, or 4 where an item's N2 > 8 slots take two
// warps (REG).
int d2_items(const Shape& sh, bool reg) {
  return reg && sh.N2 > 8 ? kItems / 2 : kItems;
}
size_t d2_smem(const Shape& sh, int esz, int qd, bool reg) {
  const size_t ds = 32 * qd;
  return (reg ? 0 : kItems * sh.N2 * ds * 4) +
         3 * (32 * ds * esz + 32 * kItems * (n_words(sh.N2) + 1) * 4);
}
D2Plan d2_plan(const Shape& sh, int esz) {
  const bool reg = sh.N2 <= 16;
  int qd = reg ? 8 : 4;
  while (qd > 1 && 32 * (qd / 2) >= sh.D) qd /= 2;
  while (qd > 1 && d2_smem(sh, esz, qd, reg) > kMaxSmem / 2) qd /= 2;
  const size_t smem = d2_smem(sh, esz, qd, reg);
  const int per_sm = blocks_per_sm(smem) < 2 ? blocks_per_sm(smem) : 2;
  const int blocks = ((sh.GB + d2_items(sh, reg) - 1) / d2_items(sh, reg)) *
                     ((sh.D + 32 * qd - 1) / (32 * qd));
  const int steps = (sh.R + 31) / 32;
  const int splits = splits_for(blocks, per_sm, steps);
  const int per = (steps + splits - 1) / splits;
  return {reg, qd, (steps + per - 1) / per, 32 * per, smem};
}

template <typename T>
void reduce(const float* part, void* out, size_t n, int splits,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  li_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(out),
                                                  n, splits);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   static_cast<int>(bytes))
             : cudaSuccess;
}

template <typename T, int NS>
int launch_d1_ns(const uint32_t* winners, const void* d2, const float* g,
                 float* part, void* dd1, const Shape& sh, const D1Plan& p,
                 cudaStream_t s) {
  const bool vec = aligned16(d2) && (sh.D * sizeof(T)) % 16 == 0;
  const dim3 grid((sh.R + 8 * p.warps - 1) / (8 * p.warps), p.splits);
  const cudaError_t err = allow_smem(li_bwd_d1_kernel<T, NS>, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  li_bwd_d1_kernel<T, NS><<<grid, 32 * p.warps, p.smem, s>>>(
      winners, static_cast<const T*>(d2), g, p.splits > 1 ? part : nullptr,
      static_cast<T*>(dd1), sh, (sh.GB + p.splits - 1) / p.splits, p.S, vec);
  if (p.splits > 1) {
    reduce<T>(part, dd1, static_cast<size_t>(sh.R) * sh.D, p.splits, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d1(const uint32_t* winners, const void* d2, const float* g,
              float* part, void* dd1, const Shape& sh, cudaStream_t s) {
  const D1Plan p = d1_plan(sh, sizeof(T));
  return p.NS == 3 ? launch_d1_ns<T, 3>(winners, d2, g, part, dd1, sh, p, s)
                   : launch_d1_ns<T, 1>(winners, d2, g, part, dd1, sh, p, s);
}

template <typename T, int QD, bool REG>
int launch_d2_qd(const uint32_t* winners, const void* d1, const float* g,
                 float* part, void* dd2, const Shape& sh, const D2Plan& p,
                 cudaStream_t s) {
  const bool vec = aligned16(d1) && (sh.D * sizeof(T)) % 16 == 0;
  const int items = d2_items(sh, REG);
  const dim3 grid((sh.GB + items - 1) / items, p.splits,
                  (sh.D + 32 * QD - 1) / (32 * QD));
  const cudaError_t err = allow_smem(li_bwd_d2_kernel<T, QD, REG>, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  li_bwd_d2_kernel<T, QD, REG><<<grid, kThreads, p.smem, s>>>(
      winners, static_cast<const T*>(d1), g, p.splits > 1 ? part : nullptr,
      static_cast<T*>(dd2), sh, p.rows_per_split, vec);
  if (p.splits > 1) {
    reduce<T>(part, dd2, static_cast<size_t>(sh.GB) * sh.N2 * sh.D, p.splits,
              s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool REG>
int launch_d2_reg(const uint32_t* winners, const void* d1, const float* g,
                  float* part, void* dd2, const Shape& sh, const D2Plan& p,
                  cudaStream_t s) {
  if constexpr (REG) {
    if (p.qd == 8) {
      return launch_d2_qd<T, 8, REG>(winners, d1, g, part, dd2, sh, p, s);
    }
  }
  switch (p.qd) {
    case 4:
      return launch_d2_qd<T, 4, REG>(winners, d1, g, part, dd2, sh, p, s);
    case 2:
      return launch_d2_qd<T, 2, REG>(winners, d1, g, part, dd2, sh, p, s);
    default:
      return launch_d2_qd<T, 1, REG>(winners, d1, g, part, dd2, sh, p, s);
  }
}

template <typename T>
int launch_d2(const uint32_t* winners, const void* d1, const float* g,
              float* part, void* dd2, const Shape& sh, cudaStream_t s) {
  const D2Plan p = d2_plan(sh, sizeof(T));
  return p.reg ? launch_d2_reg<T, true>(winners, d1, g, part, dd2, sh, p, s)
               : launch_d2_reg<T, false>(winners, d1, g, part, dd2, sh, p, s);
}

// K3's bf16 plan: key tiles of kt = kMmaCols / N2 whole items (at least
// 2, as N2 <= 128); rows split into runs of whole 32-row tiles, as many
// runs as fill the SMs with the blocks that fit one (one at D = 256). The
// groups alternate tiles, so an odd run leaves group 1 one turn short: at
// N1 = 49 (196 tiles, 8 key tiles) runs of 13 fill 128 SMs in 7 turns,
// and runs of 14 would take as many turns on 112. Shared memory: the key
// tile, then each group's row stages (!REG: one, and room for the fp32
// tile over it).
template <bool REG, int KS>
int launch_fwd_bf16_ks(const bf16* d1, const bf16* d2, float* rowmax,
                       uint32_t* winners, const Shape& sh, cudaStream_t s) {
  const int Dk = (sh.D + 15) / 16 * 16;
  const size_t row_bytes = static_cast<size_t>(Dk + 8) * sizeof(bf16);
  const size_t stage = kMmaRows * row_bytes;
  const size_t tile = static_cast<size_t>(kMmaRows) * (kMmaCols + 1) * 4;
  const size_t a_bytes = REG ? 2 * stage : (stage > tile ? stage : tile);
  const size_t smem = kMmaCols * row_bytes + 2 * a_bytes;
  const int kt = kMmaCols / sh.N2;
  const int key_tiles = (sh.GB + kt - 1) / kt;
  const int row_tiles = (sh.R + kMmaRows - 1) / kMmaRows;
  const int splits = splits_for(key_tiles, blocks_per_sm(smem), row_tiles);
  const int per = (row_tiles + splits - 1) / splits;
  const cudaError_t err = allow_smem(li_fwd_bf16_kernel<REG, KS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the wrapper refuses bf16 inputs off a 16-byte boundary
  const bool vec = sh.D % 8 == 0;
  const dim3 grid(key_tiles, (row_tiles + per - 1) / per);
  li_fwd_bf16_kernel<REG, KS><<<grid, kMmaThreads, smem, s>>>(
      d1, d2, rowmax, winners, sh, kt, per * kMmaRows, Dk,
      static_cast<int>(a_bytes), vec);
  return static_cast<int>(cudaGetLastError());
}

// D = 256, the FILIP heads' width, unrolls the product over d
template <bool REG>
int launch_fwd_bf16_reg(const bf16* d1, const bf16* d2, float* rowmax,
                        uint32_t* winners, const Shape& sh, cudaStream_t s) {
  return sh.D > kMaxD - 16
             ? launch_fwd_bf16_ks<REG, kMaxD / 16>(d1, d2, rowmax, winners,
                                                   sh, s)
             : launch_fwd_bf16_ks<REG, 0>(d1, d2, rowmax, winners, sh, s);
}

int launch_fwd_bf16(const bf16* d1, const bf16* d2, float* rowmax,
                    uint32_t* winners, const Shape& sh, cudaStream_t s) {
  return sh.N2 == 16
             ? launch_fwd_bf16_reg<true>(d1, d2, rowmax, winners, sh, s)
             : launch_fwd_bf16_reg<false>(d1, d2, rowmax, winners, sh, s);
}

}  // namespace

// The launch functions. d1: contiguous [B, N1, D]; d2: contiguous
// [GB, N2, D]; dtype 0 = float32, 1 = bfloat16 (both inputs); g: fp32
// [B, GB]; winners: int32 [B*N1, GB, ceil(N2/32)]. Workspace (fp32) and
// outputs are allocated by the caller:
//   filip_li_fwd:    rowmax [B*N1, GB], raw [B, GB], winners;
//   filip_li_bwd_d1: part, dd1 [B, N1, D] in the dtype;
//   filip_li_bwd_d2: part, dd2 [GB, N2, D] in the dtype;
// `part` holds filip_li_bwd_workspace(which, ...) floats (0 where the kernel
// writes its output itself), which 1 for filip_li_bwd_d1 and 2 for
// filip_li_bwd_d2, asked on the device they run on. Limits: N2 <= 128,
// D <= 256. Each returns cudaGetLastError() after its launches (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.

extern "C" int filip_li_fwd(const void* d1, const void* d2, void* rowmax,
                            void* raw, void* winners, int B, int N1, int GB,
                            int N2, int D, int dtype, void* stream) {
  const Shape sh{B * N1, N1, GB, N2, D};
  if (!valid(sh, B, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rm = static_cast<float*>(rowmax);
  uint32_t* win = static_cast<uint32_t*>(winners);
  if (dtype == 0) {
    const int kt = N2 >= kMaxCols ? 1 : kMaxCols / N2;
    const dim3 grid((sh.R + kRows - 1) / kRows, (GB + kt - 1) / kt);
    li_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(d1), static_cast<const float*>(d2), rm, win,
        sh, kt);
  } else {
    const int err = launch_fwd_bf16(static_cast<const bf16*>(d1),
                                    static_cast<const bf16*>(d2), rm, win, sh,
                                    s);
    if (err) return err;
  }
  li_mean_kernel<<<(B * GB + 255) / 256, 256, 0, s>>>(
      rm, static_cast<float*>(raw), B, N1, GB);
  return static_cast<int>(cudaGetLastError());
}

extern "C" size_t filip_li_bwd_workspace(int which, int B, int N1, int GB,
                                         int N2, int D, int dtype) {
  const Shape sh{B * N1, N1, GB, N2, D};
  if (!valid(sh, B, dtype)) return 0;
  const int esz = elem_bytes(dtype);
  const int splits = which == 1 ? d1_plan(sh, esz).splits
                                : d2_plan(sh, esz).splits;
  const size_t rows = which == 1 ? static_cast<size_t>(sh.R)
                                 : static_cast<size_t>(GB) * N2;
  return splits > 1 ? static_cast<size_t>(splits) * rows * D : 0;
}

extern "C" int filip_li_bwd_d1(const void* winners, const void* d2,
                               const void* g, void* part, void* dd1, int B,
                               int N1, int GB, int N2, int D, int dtype,
                               void* stream) {
  const Shape sh{B * N1, N1, GB, N2, D};
  if (!valid(sh, B, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* win = static_cast<const uint32_t*>(winners);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_d1<float>(win, d2, gf, pf, dd1, sh, s)
             : launch_d1<__nv_bfloat16>(win, d2, gf, pf, dd1, sh, s);
}

extern "C" int filip_li_bwd_d2(const void* winners, const void* d1,
                               const void* g, void* part, void* dd2, int B,
                               int N1, int GB, int N2, int D, int dtype,
                               void* stream) {
  const Shape sh{B * N1, N1, GB, N2, D};
  if (!valid(sh, B, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* win = static_cast<const uint32_t*>(winners);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_d2<float>(win, d1, gf, pf, dd2, sh, s)
             : launch_d2<__nv_bfloat16>(win, d1, gf, pf, dd2, sh, s);
}
