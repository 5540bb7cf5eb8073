// Fused self-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel declip_tpu/ops/flash_attention.py
// `_bwd_kernel` (l.72, launched by `_flash_bwd`'s pallas_call at l.181).
// Given q, k, v, the forward's o and per-row lse (flash_attn_fwd.cu), and the
// output gradient do, it computes
//   P  = exp(scale * Q K^T - lse)        (causal mask optional)
//   dV = P^T dO
//   dP = dO V^T
//   dS = P o (dP - rowsum(dO o O)), masked, times scale
//   dQ = dS K,  dK = dS^T Q
// with fp32 scores, fp32 P and dS algebra and fp32 accumulation; P and dS are
// rounded to the operand dtype (fp32 or bf16) at each matmul boundary, as the
// TPU kernel casts them (l.99-101, l.107), and the outputs are written in the
// operand dtype.
//
// Two departures from the TPU kernel's arithmetic, both exact in exact
// arithmetic:
//  * P comes from the forward's saved log-sum-exp, not from a second row
//    softmax (one exp per pair, no row max or row sum to recompute);
//  * the row term rowsum(dP o P) (l.106) is taken as rowsum(dO o O), one dot
//    product per row (FlashAttention-2's Delta). The two are equal in exact
//    arithmetic; in bf16 they differ by O's rounding, well inside the bf16
//    tolerance the tests state.
//
// What bounds it on an H100. Per (batch*head) the function needs q, k, v,
// do read and dq, dk, dv written, 7*L*Dh elements (and L fp32 lse), for 4
// contractions of 2*L*L*Dh FLOPs (about half when causal): L/3.5 FLOP per
// byte in fp32 and L/1.75 in bf16. At the training shapes (L=50, and L=77
// causal; Dh=64) that is 22-29 FLOP per byte in bf16, far below the tensor
// cores' ridge (295), so the bytes bound it and the [L, L] matrices P, dP
// and dS must never reach device memory. This kernel also reads o, for that
// row term: 8/7 of the bound's bytes. Taking the row term from P and
// dP instead (two more products per 16 keys, no o) was measured on the
// H100 and was no faster at L=50 and 3-5% slower at L=77 causal.
// No atomics anywhere (deterministic results).
//
// bf16 (the training path): tensor cores, `*_bf16_kernel`, from the blocks
// of attn_mma.cuh (16-byte cp.async copies of bf16 tiles at a padded stride
// that keeps ldmatrix conflict-free; mma.sync m16n8k16 with fp32
// accumulators; P and dS rounded to bf16 and repacked in registers as the
// next product's A operand).
//  * L <= 128, every training shape: one pass,
//    `flash_attn_bwd_fused_bf16_kernel`. One block per (batch*head) of
//    ceil(L/16) warps holds the head's Q, K, V and dO in shared memory, so
//    each input is read once and each output written once: the bound's
//    bytes. Each warp first owns 16 query rows: Delta = rowsum(dO o O) from
//    O read once, then per 16 keys
//    S = Q K^T and dP = dO V^T, P = exp(scale S - lse) and
//    dS = P o (dP - Delta) scale in fp32, masked; P and dS go to shared
//    memory in bf16 and dQ += dS K accumulates in registers. After a block
//    barrier each warp owns 16 key rows: dV += P^T dO and dK += dS^T Q,
//    with P^T and dS^T read by ldmatrix.trans. Causal warps skip every
//    16-row step on the masked side of the diagonal.
//  * L > 128: three kernels on one stream. (1) delta: one warp per row,
//    Delta = rowsum(dO o O) in fp32. (2) dk/dv: blocks of 64 key rows, each
//    warp keeping its K and V rows as A fragments and dK, dV in fp32
//    registers, looping over the 64-query tiles that can see its keys (Q,
//    dO, lse and Delta double-buffered): S^T = K Q^T, dP^T = V dO^T, P^T and
//    dS^T in fp32, then dV += P^T dO and dK += dS^T Q. (3) dq: blocks of 64
//    query rows, Q and dO as A fragments, looping over the key tiles:
//    S, dP, dS, then dQ += dS K. This form reads Q, K, V and dO twice and
//    recomputes S and dP, which the tensor cores make cheap; at L=50/77 it
//    took about twice the one-pass kernel's time on the H100, which is why
//    the one pass owns L <= 128.
//  * mma.sync and not wgmma/TMA for the reason the forward gives: the bytes
//    bound these shapes.
//
// fp32 (the fp32 checks): the same three kernels on the CUDA cores,
// `flash_attn_bwd_dkdv_kernel` and `flash_attn_bwd_dq_kernel` (TF32 would
// break the fp32 agreement). Four threads share one row and hold its slices
// of the operands and of the accumulators in registers, the other side's
// 64-row tiles staged in shared memory as fp32 and read in interleaved
// float4 chunks, conflict-free; fp32 FMAs.
//
// Ragged query and key edges are masked by bounds (no padding of L to 16 or
// of Dh to 128: those were TPU tile rules).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "attn_mma.cuh"

namespace {

using attn_mma::bf16;

constexpr int kTile = 64;                  // query or key rows per block
constexpr int kSplit = 4;                  // threads per row
constexpr int kThreads = kTile * kSplit;   // 256
constexpr int kDeltaWarps = 8;             // rows per delta block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Delta[row] = sum_d dO[row, d] * O[row, d]; one warp per row
template <typename T, int DH>
__global__ void __launch_bounds__(kDeltaWarps * 32)
flash_attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                            float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const size_t base = static_cast<size_t>(row) * DH;
  float d = 0.f;
  for (int c = lane; c < DH; c += 32) {
    d = fmaf(to_f(dout[base + c]), to_f(o[base + c]), d);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  if (lane == 0) delta[row] = d;
}

template <typename T>
int launch_delta(int dh, const void* o, const void* dout, float* delta,
                 int rows, cudaStream_t stream) {
  const int blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  const T* ot = static_cast<const T*>(o);
  const T* dt = static_cast<const T*>(dout);
  if (dh == 64) {
    flash_attn_bwd_delta_kernel<T, 64>
        <<<blocks, kDeltaWarps * 32, 0, stream>>>(ot, dt, delta, rows);
  } else {
    flash_attn_bwd_delta_kernel<T, 32>
        <<<blocks, kDeltaWarps * 32, 0, stream>>>(ot, dt, delta, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- fp32 route

// load 4 consecutive elements of a row (zeros past the end)
__device__ __forceinline__ float4 load4(const float* src, bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float d) {
  d = fmaf(a.x, b.x, d);
  d = fmaf(a.y, b.y, d);
  d = fmaf(a.z, b.z, d);
  return fmaf(a.w, b.w, d);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& acc) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// sum over the kSplit threads that share a row (lanes 4r .. 4r+3)
__device__ __forceinline__ float row_sum(float d) {
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  return d;
}

// stage rows r0 .. r0+kTile of a [L, DH] matrix into shared memory
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int L, int tid) {
  for (int i = tid; i < kTile * DH; i += kThreads) {
    const int r = r0 + i / DH;
    dst[i] = r < L ? src[static_cast<size_t>(r0) * DH + i] : 0.f;
  }
}

// dK, dV for one 64-key tile of one (batch*head)
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int L, int causal, float scale) {
  constexpr int kVec = DH / 4;            // float4 chunks in one row
  constexpr int kChunks = kVec / kSplit;  // float4 chunks per thread
  __shared__ float4 qs[kTile][kVec];
  __shared__ float4 dos[kTile][kVec];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int key = k0 + tid / kSplit;
  const int part = tid % kSplit;
  const size_t base = static_cast<size_t>(bh) * L * DH;
  const size_t row_base = static_cast<size_t>(bh) * L;

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const size_t off = base + static_cast<size_t>(key) * DH +
                       (part + kSplit * c) * 4;
    kr[c] = load4(k + off, key < L);
    vr[c] = load4(v + off, key < L);
    dk_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // query tiles that can see this key tile: all, or those at or after it
  for (int q0 = causal ? k0 : 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the previous tile is fully consumed
    stage<DH>(reinterpret_cast<float*>(qs), q + base, q0, L, tid);
    stage<DH>(reinterpret_cast<float*>(dos), dout + base, q0, L, tid);
    if (tid < kTile) {
      const int r = q0 + tid;
      // rows past L: lse = +inf gives P = 0 for them
      lse_s[tid] = r < L ? lse[row_base + r] : INFINITY;
      delta_s[tid] = r < L ? delta[row_base + r] : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < kTile; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        s = dot4(qs[i][part + kSplit * c], kr[c], s);
        dp = dot4(dos[i][part + kSplit * c], vr[c], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int query = q0 + i;
      const bool ok = key < L && query < L && (!causal || key <= query);
      const float p = ok ? expf(s * scale - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i]) * scale;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        axpy4(p, dos[i][part + kSplit * c], dv_acc[c]);
        axpy4(ds, qs[i][part + kSplit * c], dk_acc[c]);
      }
    }
  }

  if (key < L) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const size_t off = base + static_cast<size_t>(key) * DH +
                         (part + kSplit * c) * 4;
      store4(dk + off, dk_acc[c]);
      store4(dv + off, dv_acc[c]);
    }
  }
}

// dQ for one 64-query tile of one (batch*head)
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int L, int causal,
                         float scale) {
  constexpr int kVec = DH / 4;
  constexpr int kChunks = kVec / kSplit;
  __shared__ float4 ks[kTile][kVec];
  __shared__ float4 vs[kTile][kVec];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int row = q0 + tid / kSplit;
  const int part = tid % kSplit;
  const size_t base = static_cast<size_t>(bh) * L * DH;
  const size_t row_base = static_cast<size_t>(bh) * L;

  float4 qr[kChunks], dor[kChunks], dq_acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const size_t off = base + static_cast<size_t>(row) * DH +
                       (part + kSplit * c) * 4;
    qr[c] = load4(q + off, row < L);
    dor[c] = load4(dout + off, row < L);
    dq_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float row_lse = row < L ? lse[row_base + row] : INFINITY;
  const float row_delta = row < L ? delta[row_base + row] : 0.f;

  const int kv_end = causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile is fully consumed
    stage<DH>(reinterpret_cast<float*>(ks), k + base, k0, L, tid);
    stage<DH>(reinterpret_cast<float*>(vs), v + base, k0, L, tid);
    __syncthreads();

    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        s = dot4(qr[c], ks[j][part + kSplit * c], s);
        dp = dot4(dor[c], vs[j][part + kSplit * c], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int key = k0 + j;
      const bool ok = key < L && row < L && (!causal || key <= row);
      const float p = ok ? expf(s * scale - row_lse) : 0.f;
      const float ds = p * (dp - row_delta) * scale;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        axpy4(ds, ks[j][part + kSplit * c], dq_acc[c]);
      }
    }
  }

  if (row < L) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      store4(dq + base + static_cast<size_t>(row) * DH +
                 (part + kSplit * c) * 4,
             dq_acc[c]);
    }
  }
}

template <int DH>
int launch_fp32(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int bh, int L, int causal, float scale,
                cudaStream_t stream) {
  int err = launch_delta<float>(DH, o, dout, delta, bh * L, stream);
  if (err != 0) return err;
  const dim3 grid(bh, (L + kTile - 1) / kTile);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  flash_attn_bwd_dkdv_kernel<DH><<<grid, kThreads, 0, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), L, causal, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_attn_bwd_dq_kernel<DH><<<grid, kThreads, 0, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dq), L, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 route

// bytes of one streamed stage of the dk/dv kernel: Q and dO tiles, then
// the tile's lse and Delta
template <int DH>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * kTile * attn_mma::Layout<DH>::kStride *
             static_cast<int>(sizeof(bf16)) +
         2 * kTile * static_cast<int>(sizeof(float));
}

// One block: `blockDim.x / 32` warps of 16 key rows from key
// blockIdx.y * 16 * warps, against the query tiles that can see them.
// Dynamic shared memory: K [rows][S], V [rows][S], then 1 or 2 stages of
// Q [64][S], dO [64][S], lse [64], Delta [64].
template <int DH>
__global__ void __launch_bounds__(256)
flash_attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int L, int causal, float scale,
                                float scale_log2) {
  using namespace attn_mma;
  constexpr int S = Layout<DH>::kStride;
  constexpr int KC = DH / 16;
  constexpr int DN = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int rows = 16 * warps;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + rows * S;
  unsigned char* streamed = reinterpret_cast<unsigned char*>(vs + rows * S);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = static_cast<size_t>(bh) * L * DH;
  const size_t rbase = static_cast<size_t>(bh) * L;
  // query tiles that can see these keys: all, or from the one holding k0
  const int qt0 = causal ? k0 / kTile : 0;
  const int tiles = (L + kTile - 1) / kTile - qt0;

  auto stage_ptr = [&](int slot) {
    return streamed + slot * dkdv_stage_bytes<DH>();
  };
  auto load_stage = [&](int slot, int qt) {
    bf16* qs = reinterpret_cast<bf16*>(stage_ptr(slot));
    bf16* dos = qs + kTile * S;
    float* ls = reinterpret_cast<float*>(dos + kTile * S);
    load_rows<DH>(qs, q + base, qt * kTile, kTile, L, tid, blockDim.x);
    load_rows<DH>(dos, dout + base, qt * kTile, kTile, L, tid, blockDim.x);
    load_vec(ls, lse + rbase, qt * kTile, kTile, L, tid);
    load_vec(ls + kTile, delta + rbase, qt * kTile, kTile, L, tid);
  };

  load_rows<DH>(ks, k + base, k0, rows, L, tid, blockDim.x);
  load_rows<DH>(vs, v + base, k0, rows, L, tid, blockDim.x);
  for (int i = 0; i < 2; ++i) {
    if (i < tiles) load_stage(i, qt0 + i);
    cp_async_commit();  // group i: query tile qt0 + i (and K, V with 0)
  }

  const int key0 = k0 + 16 * warp;  // this warp's first key row
  const bool live = key0 < L;
  const int key_lo = key0 + g;
  const int key_hi = key_lo + 8;
  uint32_t kf[KC][4], vf[KC][4];
  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<1>();  // query tile qt0 + it has landed
    __syncthreads();
    if (it == 0 && live) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        load_a<DH>(kf[kc], ks, 16 * warp, 16 * kc, lane);
        load_a<DH>(vf[kc], vs, 16 * warp, 16 * kc, lane);
      }
    }
    const bf16* qs = reinterpret_cast<const bf16*>(stage_ptr(it & 1));
    const bf16* dos = qs + kTile * S;
    const float* ls = reinterpret_cast<const float*>(dos + kTile * S);
    const float* ds_row = ls + kTile;  // Delta
    const int qbase = (qt0 + it) * kTile;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 queries at a time
      const int qc0 = qbase + 16 * c;
      if (!live || qc0 >= L || (causal && qc0 + 15 < key0)) continue;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        load_b_rows<DH>(b, qs, 16 * c, 16 * kc, lane);
        mma_bf16(st[0], kf[kc], b[0], b[1]);
        mma_bf16(st[1], kf[kc], b[2], b[3]);
        load_b_rows<DH>(b, dos, 16 * c, 16 * kc, lane);
        mma_bf16(dpt[0], vf[kc], b[0], b[1]);
        mma_bf16(dpt[1], vf[kc], b[2], b[3]);
      }
      // P^T and dS^T in fp32: rows are keys, columns queries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 16 * c + 8 * j + 2 * t + (e & 1);  // in the tile
          const int query = qbase + qi;
          const int key = e < 2 ? key_lo : key_hi;
          const bool ok = key < L && query < L && (!causal || key <= query);
          const float p =
              ok ? exp2f(st[j][e] * scale_log2 - ls[qi] * kLog2e) : 0.f;
          dpt[j][e] = ok ? p * (dpt[j][e] - ds_row[qi]) * scale : 0.f;
          st[j][e] = p;
        }
      }
      const uint32_t pa[4] = {
          pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
          pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
      const uint32_t da[4] = {
          pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
          pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
#pragma unroll
      for (int n = 0; n < DN; n += 2) {
        uint32_t b[4];
        load_b_cols<DH>(b, dos, 16 * c, 8 * n, lane);
        mma_bf16(dv_acc[n], pa, b[0], b[1]);
        mma_bf16(dv_acc[n + 1], pa, b[2], b[3]);
        load_b_cols<DH>(b, qs, 16 * c, 8 * n, lane);
        mma_bf16(dk_acc[n], da, b[0], b[1]);
        mma_bf16(dk_acc[n + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < tiles) load_stage(it & 1, qt0 + it + 2);
    cp_async_commit();  // group it + 2
  }

  if (live) {  // the warp's own K and V rows are free now: stage there
    store_rows<DH>(ks + 16 * warp * S, dk + base, dk_acc, 1.f, 1.f, key0, L,
                   lane);
    store_rows<DH>(vs + 16 * warp * S, dv + base, dv_acc, 1.f, 1.f, key0, L,
                   lane);
  }
}

// One block: `blockDim.x / 32` warps of 16 query rows from row
// blockIdx.y * 16 * warps, against the key tiles they can see.
// Dynamic shared memory: Q [rows][S], dO [rows][S], then 1 or 2 stages of
// K [64][S] and V [64][S].
template <int DH>
__global__ void __launch_bounds__(256)
flash_attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int L, int causal,
                              float scale, float scale_log2) {
  using namespace attn_mma;
  constexpr int S = Layout<DH>::kStride;
  constexpr int KC = DH / 16;
  constexpr int DN = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int rows = 16 * warps;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + rows * S;
  bf16* kv = dos + rows * S;  // stage i: K at kv + 2*i*kTile*S, V after it

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = static_cast<size_t>(bh) * L * DH;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int kv_end = causal ? min(L, q0 + rows) : L;
  const int tiles = (kv_end + kTile - 1) / kTile;

  load_rows<DH>(qs, q + base, q0, rows, L, tid, blockDim.x);
  load_rows<DH>(dos, dout + base, q0, rows, L, tid, blockDim.x);
  for (int i = 0; i < 2; ++i) {
    if (i < tiles) {
      bf16* ks = kv + 2 * i * kTile * S;
      load_rows<DH>(ks, k + base, i * kTile, kTile, L, tid, blockDim.x);
      load_rows<DH>(ks + kTile * S, v + base, i * kTile, kTile, L, tid,
                    blockDim.x);
    }
    cp_async_commit();  // group i: key tile i (and Q, dO with tile 0)
  }

  const int row0 = q0 + 16 * warp;
  const bool live = row0 < L;
  const int key_end = causal ? min(L, row0 + 16) : L;
  const int r_lo = row0 + g;
  const int r_hi = r_lo + 8;
  const float lse_lo = r_lo < L ? lse[rbase + r_lo] * kLog2e : 0.f;
  const float lse_hi = r_hi < L ? lse[rbase + r_hi] * kLog2e : 0.f;
  const float delta_lo = r_lo < L ? delta[rbase + r_lo] : 0.f;
  const float delta_hi = r_hi < L ? delta[rbase + r_hi] : 0.f;
  uint32_t qf[KC][4], df[KC][4];
  float dq_acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<1>();  // key tile it has landed
    __syncthreads();
    if (it == 0 && live) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        load_a<DH>(qf[kc], qs, 16 * warp, 16 * kc, lane);
        load_a<DH>(df[kc], dos, 16 * warp, 16 * kc, lane);
      }
    }
    const bf16* ks = kv + 2 * (it & 1) * kTile * S;
    const bf16* vs = ks + kTile * S;
    const int k0 = it * kTile;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 keys at a time
      if (!live || k0 + 16 * c >= key_end) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        load_b_rows<DH>(b, ks, 16 * c, 16 * kc, lane);
        mma_bf16(s[0], qf[kc], b[0], b[1]);
        mma_bf16(s[1], qf[kc], b[2], b[3]);
        load_b_rows<DH>(b, vs, 16 * c, 16 * kc, lane);
        mma_bf16(dp[0], df[kc], b[0], b[1]);
        mma_bf16(dp[1], df[kc], b[2], b[3]);
      }
      uint32_t da[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 16 * c + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          const bool ok = key < L && row < L && (!causal || key <= row);
          const float p =
              ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi))
                 : 0.f;
          ds[e] = ok ? p * (dp[j][e] - (e < 2 ? delta_lo : delta_hi)) * scale
                     : 0.f;
        }
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int n = 0; n < DN; n += 2) {
        uint32_t b[4];
        load_b_cols<DH>(b, ks, 16 * c, 8 * n, lane);
        mma_bf16(dq_acc[n], da, b[0], b[1]);
        mma_bf16(dq_acc[n + 1], da, b[2], b[3]);
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

  if (live) {  // the warp's own Q rows are free now: stage dQ there
    store_rows<DH>(qs + 16 * warp * S, dq + base, dq_acc, 1.f, 1.f, row0, L,
                   lane);
  }
}

// L <= 128: one block per (batch*head) does the whole backward in one pass,
// `blockDim.x / 32` warps of 16 rows, R = 16 * warps >= L rows of each
// operand. Dynamic shared memory: Q, K, V, dO [R][S], then P and dS
// [R][R + 8] (bf16, as the products take them).
//  1. Each warp owns 16 query rows: its Delta = rowsum(dO o O) (O read from
//     device memory once), then per 16 keys S, dP, P, dS in fp32; P and dS
//     rounded to bf16 into shared memory, and dQ += dS K in registers.
//  2. After a block barrier each warp owns 16 key rows: dV += P^T dO and
//     dK += dS^T Q, with P^T and dS^T read by ldmatrix.trans.
// Each input is read once and each output written once: the bytes of the
// bound.
template <int DH>
__global__ void __launch_bounds__(256)
flash_attn_bwd_fused_bf16_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const bf16* __restrict__ o,
                                 const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 bf16* __restrict__ dq, bf16* __restrict__ dk,
                                 bf16* __restrict__ dv, int L, int causal,
                                 float scale, float scale_log2) {
  using namespace attn_mma;
  constexpr int S = Layout<DH>::kStride;
  constexpr int KC = DH / 16;
  constexpr int DN = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int R = 16 * warps;
  const int PS = R + 8;  // row stride of P and dS
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + R * S;
  bf16* vs = ks + R * S;
  bf16* dos = vs + R * S;
  bf16* ps = dos + R * S;  // P [query][key]
  bf16* dss = ps + R * PS;  // dS [query][key]

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = static_cast<size_t>(bh) * L * DH;
  const size_t rbase = static_cast<size_t>(bh) * L;
  load_rows<DH>(qs, q + base, 0, R, L, tid, blockDim.x);
  load_rows<DH>(ks, k + base, 0, R, L, tid, blockDim.x);
  load_rows<DH>(vs, v + base, 0, R, L, tid, blockDim.x);
  load_rows<DH>(dos, dout + base, 0, R, L, tid, blockDim.x);
  cp_async_commit();

  // phase 1: this warp's 16 query rows
  const int row0 = 16 * warp;
  const int r_lo = row0 + g;
  const int r_hi = r_lo + 8;
  const float lse_lo = r_lo < L ? lse[rbase + r_lo] * kLog2e : 0.f;
  const float lse_hi = r_hi < L ? lse[rbase + r_hi] * kLog2e : 0.f;
  // this lane's half of row row0 + lane / 2 of O, while the copies land
  constexpr int kHalf = DH / 2;
  const int d_row = row0 + lane / 2;
  uint4 o_part[kHalf / 8];
#pragma unroll
  for (int c = 0; c < kHalf / 8; ++c) {
    o_part[c] = d_row < L ? *reinterpret_cast<const uint4*>(
                                o + base + static_cast<size_t>(d_row) * DH +
                                (lane & 1) * kHalf + c * 8)
                          : make_uint4(0, 0, 0, 0);
  }
  cp_async_wait<0>();
  __syncthreads();
  // Delta of row d_row: this lane's half, then its neighbour's
  float delta_part = 0.f;
#pragma unroll
  for (int c = 0; c < kHalf / 8; ++c) {
    const uint4 d4 = *reinterpret_cast<const uint4*>(
        dos + (lane / 2 + row0) * S + (lane & 1) * kHalf + c * 8);
    const bf16* ov = reinterpret_cast<const bf16*>(&o_part[c]);
    const bf16* dv8 = reinterpret_cast<const bf16*>(&d4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      delta_part = fmaf(__bfloat162float(dv8[e]), __bfloat162float(ov[e]),
                        delta_part);
    }
  }
  delta_part += __shfl_xor_sync(0xffffffffu, delta_part, 1);
  const float delta_lo = __shfl_sync(0xffffffffu, delta_part, 2 * g);
  const float delta_hi = __shfl_sync(0xffffffffu, delta_part, 2 * g + 16);

  uint32_t qf[KC][4], df[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    load_a<DH>(qf[kc], qs, row0, 16 * kc, lane);
    load_a<DH>(df[kc], dos, row0, 16 * kc, lane);
  }
  float dq_acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  }
  // key chunks this warp computes; phase 2 reads exactly these entries
  const int chunks = causal ? warp + 1 : (L + 15) / 16;
  for (int c = 0; c < chunks; ++c) {
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t b[4];
      load_b_rows<DH>(b, ks, 16 * c, 16 * kc, lane);
      mma_bf16(s[0], qf[kc], b[0], b[1]);
      mma_bf16(s[1], qf[kc], b[2], b[3]);
      load_b_rows<DH>(b, vs, 16 * c, 16 * kc, lane);
      mma_bf16(dp[0], df[kc], b[0], b[1]);
      mma_bf16(dp[1], df[kc], b[2], b[3]);
    }
    uint32_t da[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * c + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        const bool ok = key < L && row < L && (!causal || key <= row);
        p[e] = ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi))
                  : 0.f;
        ds[e] = ok ? p[e] * (dp[j][e] - (e < 2 ? delta_lo : delta_hi)) *
                         scale
                   : 0.f;
      }
      const int col = 16 * c + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + r_lo * PS + col) =
          pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(ps + r_hi * PS + col) =
          pack_bf16(p[2], p[3]);
      da[2 * j] = pack_bf16(ds[0], ds[1]);
      da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      *reinterpret_cast<uint32_t*>(dss + r_lo * PS + col) = da[2 * j];
      *reinterpret_cast<uint32_t*>(dss + r_hi * PS + col) = da[2 * j + 1];
    }
#pragma unroll
    for (int n = 0; n < DN; n += 2) {
      uint32_t b[4];
      load_b_cols<DH>(b, ks, 16 * c, 8 * n, lane);
      mma_bf16(dq_acc[n], da, b[0], b[1]);
      mma_bf16(dq_acc[n + 1], da, b[2], b[3]);
    }
  }
  __syncthreads();  // every P and dS entry is in shared memory

  // phase 2: this warp's 16 key rows, over the query chunks that see them
  const int key0 = 16 * warp;
  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }
  for (int c = causal ? warp : 0; c < (L + 15) / 16; ++c) {
    uint32_t pa[4], da[4];
    load_a_trans(pa, ps, PS, key0, 16 * c, lane);
    load_a_trans(da, dss, PS, key0, 16 * c, lane);
#pragma unroll
    for (int n = 0; n < DN; n += 2) {
      uint32_t b[4];
      load_b_cols<DH>(b, dos, 16 * c, 8 * n, lane);
      mma_bf16(dv_acc[n], pa, b[0], b[1]);
      mma_bf16(dv_acc[n + 1], pa, b[2], b[3]);
      load_b_cols<DH>(b, qs, 16 * c, 8 * n, lane);
      mma_bf16(dk_acc[n], da, b[0], b[1]);
      mma_bf16(dk_acc[n + 1], da, b[2], b[3]);
    }
  }
  // K and V are no longer read: stage dK and dV in this warp's rows there
  store_rows<DH>(ks + key0 * S, dk + base, dk_acc, 1.f, 1.f, key0, L, lane);
  store_rows<DH>(vs + key0 * S, dv + base, dv_acc, 1.f, 1.f, key0, L, lane);
  __syncthreads();  // no warp reads Q any more
  store_rows<DH>(qs + row0 * S, dq + base, dq_acc, 1.f, 1.f, row0, L, lane);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int bh, int L, int causal, float scale,
                cudaStream_t stream) {
  using namespace attn_mma;
  const Shape shape = block_shape(L);
  const float scale_log2 = scale * kLog2e;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  const dim3 grid(bh, shape.blocks_per_head);
  const int threads = 32 * shape.warps;
  if (shape.blocks_per_head == 1) {  // L <= 128: one pass
    const int rows = 16 * shape.warps;
    const size_t smem = sizeof(bf16) * (4 * rows * Layout<DH>::kStride +
                                         2 * rows * (rows + 8));
    int err = allow_smem(flash_attn_bwd_fused_bf16_kernel<DH>, smem);
    if (err != 0) return err;
    flash_attn_bwd_fused_bf16_kernel<DH><<<grid, threads, smem, stream>>>(
        qb, kb, vb, static_cast<const bf16*>(o), dob, lse,
        static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), L, causal, scale, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  int err = launch_delta<bf16>(DH, o, dout, delta, bh * L, stream);
  if (err != 0) return err;
  const int stages = L > kTile ? 2 : 1;
  const size_t own =
      2 * sizeof(bf16) * Layout<DH>::kStride * 16 * shape.warps;
  const size_t smem_dkdv = own + stages * dkdv_stage_bytes<DH>();
  const size_t smem_dq =
      own + stages * 2 * sizeof(bf16) * Layout<DH>::kStride * kTile;
  err = allow_smem(flash_attn_bwd_dkdv_bf16_kernel<DH>, smem_dkdv);
  if (err != 0) return err;
  err = allow_smem(flash_attn_bwd_dq_bf16_kernel<DH>, smem_dq);
  if (err != 0) return err;
  flash_attn_bwd_dkdv_bf16_kernel<DH><<<grid, threads, smem_dkdv, stream>>>(
      qb, kb, vb, dob, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, causal, scale, scale_log2);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_attn_bwd_dq_bf16_kernel<DH><<<grid, threads, smem_dq, stream>>>(
      qb, kb, vb, dob, lse, delta, static_cast<bf16*>(dq), L, causal, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous [bh, L, dh] of one dtype
// (0 = float32, 1 = bfloat16). lse: fp32 [bh, L] from flash_attn_fwd.
// delta: fp32 [bh, L] scratch. Returns the first cudaGetLastError() that is
// not 0 after the three launches (0 on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int bh, int L, int dh,
                              int dtype, int causal, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (bh < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && dh == 64) {
    return launch_fp32<64>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bh,
                           L, causal, scale, s);
  } else if (dtype == 0 && dh == 32) {
    return launch_fp32<32>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bh,
                           L, causal, scale, s);
  } else if (dtype == 1 && dh == 64) {
    return launch_bf16<64>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bh,
                           L, causal, scale, s);
  } else if (dtype == 1 && dh == 32) {
    return launch_bf16<32>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bh,
                           L, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
