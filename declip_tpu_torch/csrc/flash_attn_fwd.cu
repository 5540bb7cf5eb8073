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
// L=77 causal; Dh=64) that is 12-25 FLOP/byte in fp32 and 25-38 in bf16.
// The card's ridge points are 20 FLOP/byte for fp32 on the CUDA cores (67
// TFLOP/s over 3.35 TB/s) and 295 for bf16 on the tensor cores (989 TFLOP/s),
// so at these shapes the bytes bound both routes (fp32 turns compute-bound
// from L of about 80, ViT-L/14's 257 and 577 among them), and what matters
// is to move each byte once and never write the [L, L] probabilities out.
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
// fp32 (serving, and the fp32 checks): CUDA cores, `flash_attn_fwd_kernel`.
// The tensor cores take fp32 only as TF32, which keeps about three decimal
// digits and would break the serving path's 1e-4 agreement with the plain
// version. One block per (batch*head, 64-query tile); K and V staged per
// 64-key tile in shared memory; four threads share a query row, each owning
// Dh/4 of Q and of the accumulator in float4 chunks interleaved so that a
// warp's reads of a K or V row are conflict-free, the partial dot products
// summed with two shuffles; fp32 FMAs.
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

constexpr int kTileQ = 64;                  // queries per block
constexpr int kTileK = 64;                  // keys per shared-memory tile
constexpr int kSplit = 4;                   // threads per query row
constexpr int kThreads = kTileQ * kSplit;   // 256

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int L, int causal,
                      float scale) {
  constexpr int kVec = DH / 4;               // float4 chunks in one row
  constexpr int kChunks = kVec / kSplit;     // float4 chunks per thread
  __shared__ float4 ks[kTileK][kVec];
  __shared__ float4 vs[kTileK][kVec];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTileQ;
  const int tid = threadIdx.x;
  const int row = q0 + tid / kSplit;
  const int part = tid % kSplit;
  const size_t base = static_cast<size_t>(bh) * L * DH;

  // this thread's slice of the query row: chunks part, part+4, part+8, ...
  float4 qr[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (part + kSplit * c) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L) {
      const float* src = q + base + static_cast<size_t>(row) * DH + col;
      x = make_float4(src[0], src[1], src[2], src[3]);
    }
    qr[c] = x;
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;  // running max of the scaled scores
  float l = 0.f;        // running sum of exp(s - m)

  const int kv_end = causal ? min(L, q0 + kTileQ) : L;
  for (int k0 = 0; k0 < kv_end; k0 += kTileK) {
    __syncthreads();  // the previous tile is fully consumed
    // stage the K and V tiles (contiguous rows k0.. in global memory)
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    for (int i = tid; i < kTileK * DH; i += kThreads) {
      const int r = i / DH;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < L) {
        const size_t g = base + static_cast<size_t>(k0) * DH + i;
        kx = k[g];
        vx = v[g];
      }
      kf[i] = kx;
      vf[i] = vx;
    }
    __syncthreads();

    float s[kTileK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = ks[j][part + kSplit * c];
        d = fmaf(qr[c].x, kk.x, d);
        d = fmaf(qr[c].y, kk.y, d);
        d = fmaf(qr[c].z, kk.z, d);
        d = fmaf(qr[c].w, kk.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int key = k0 + j;
      const bool ok = key < L && (!causal || key <= row);
      s[j] = ok ? d * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {  // false only for rows past L
      const float alpha = expf(m - m_new);  // 0 on the first tile
      l *= alpha;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        acc[c].x *= alpha;
        acc[c].y *= alpha;
        acc[c].z *= alpha;
        acc[c].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kTileK; ++j) {
        const float p = expf(s[j] - m_new);  // masked keys give exactly 0
        l += p;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 vv = vs[j][part + kSplit * c];
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
      m = m_new;
    }
  }

  if (row < L) {
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (part + kSplit * c) * 4;
      float* dst = o + base + static_cast<size_t>(row) * DH + col;
      dst[0] = acc[c].x * inv;
      dst[1] = acc[c].y * inv;
      dst[2] = acc[c].z * inv;
      dst[3] = acc[c].w * inv;
    }
    if (lse != nullptr && part == 0) {
      lse[static_cast<size_t>(bh) * L + row] = m + logf(l);
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

int launch_fp32(int dh, const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int L, int causal, float scale,
                cudaStream_t stream) {
  const dim3 grid(bh, (L + kTileQ - 1) / kTileQ);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (dh == 64) {
    flash_attn_fwd_kernel<64><<<grid, kThreads, 0, stream>>>(
        qf, kf, vf, of, lse, L, causal, scale);
  } else {
    flash_attn_fwd_kernel<32><<<grid, kThreads, 0, stream>>>(
        qf, kf, vf, of, lse, L, causal, scale);
  }
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
    return launch_fp32(dh, q, k, v, o, lse_f, bh, L, causal, scale, s);
  }
  if (dtype == 1) {
    return dh == 64
               ? launch_bf16<64>(q, k, v, o, lse_f, bh, L, causal, scale, s)
               : launch_bf16<32>(q, k, v, o, lse_f, bh, L, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
