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
//    product per row in a pre-pass (FlashAttention-2's Delta). The two are
//    equal in exact arithmetic; in bf16 they differ by O's rounding, well
//    inside the bf16 tolerance the tests state.
//
// What bounds it on an H100. Per (batch*head) it reads q, k, v, o, do and
// writes dq, dk, dv, 8*L*Dh elements, for 4 contractions of 2*L*L*Dh FLOPs
// (about half when causal): L/4 FLOP per byte in fp32 and L/2 in bf16. At
// the training shapes (L=50, and L=77 causal; Dh=64) that is 12-25 FLOP per
// byte, below both ridge points (20 for fp32 on the CUDA cores, 295 for bf16
// on the tensor cores), so the bytes bound it and the [L, L] matrices P, dP
// and dS must never reach device memory. This kernel recomputes Q K^T and
// dO V^T in both passes and does every product on the CUDA cores in fp32
// FMAs, so its own ceiling is the fp32 FMA rate; tensor cores (mma.sync or
// wgmma), TMA and a single fused pass are later work.
//
// What the design does about it. Three kernels on one stream, no atomics
// (deterministic results):
//  1. delta: one warp per row, Delta = rowsum(dO o O) in fp32.
//  2. dk/dv: one block per (batch*head, 64-key tile). Four threads share one
//     key row and hold its K and V slices and its dK and dV accumulators in
//     registers; the block loops over the 64-query tiles that can see the
//     key tile (query tiles at or after it when causal), staging Q, dO, lse
//     and Delta in shared memory as fp32.
//  3. dq: one block per (batch*head, 64-query tile), holding Q, dO and the
//     dQ accumulator per row and looping over the 64-key tiles it can see,
//     with K and V staged in shared memory as in the forward kernel.
// Ragged query and key edges are masked by bounds (no padding of L to 16 or
// of Dh to 128: those were TPU tile rules). Shared-memory reads of a staged
// row use the forward kernel's interleaved float4 chunks, conflict-free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;                  // query or key rows per block
constexpr int kSplit = 4;                  // threads per row
constexpr int kThreads = kTile * kSplit;   // 256
constexpr int kDeltaWarps = 8;             // rows per delta block

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

// x rounded to the operand dtype and widened back (the cast at a matmul
// boundary)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// load 4 consecutive elements of a row as fp32 (zeros past the end)
template <typename T>
__device__ __forceinline__ float4 load4(const T* src, bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(to_f(src[0]), to_f(src[1]), to_f(src[2]), to_f(src[3]));
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 x) {
  dst[0] = from_f<T>(x.x);
  dst[1] = from_f<T>(x.y);
  dst[2] = from_f<T>(x.z);
  dst[3] = from_f<T>(x.w);
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

// stage rows r0 .. r0+kTile of a [L, DH] matrix into shared memory as fp32
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int L, int tid) {
  for (int i = tid; i < kTile * DH; i += kThreads) {
    const int r = r0 + i / DH;
    dst[i] = r < L ? to_f(src[static_cast<size_t>(r0) * DH + i]) : 0.f;
  }
}

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

// dK, dV for one 64-key tile of one (batch*head)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int L,
                           int causal, float scale) {
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
    stage<T, DH>(reinterpret_cast<float*>(qs), q + base, q0, L, tid);
    stage<T, DH>(reinterpret_cast<float*>(dos), dout + base, q0, L, tid);
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
      const float ds = p * (dp - delta_s[i]);
      const float pr = round_to<T>(p);           // P in the operand dtype
      const float dsr = round_to<T>(ds * scale);  // dS in the operand dtype
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        axpy4(pr, dos[i][part + kSplit * c], dv_acc[c]);
        axpy4(dsr, qs[i][part + kSplit * c], dk_acc[c]);
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
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int L, int causal, float scale) {
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
    stage<T, DH>(reinterpret_cast<float*>(ks), k + base, k0, L, tid);
    stage<T, DH>(reinterpret_cast<float*>(vs), v + base, k0, L, tid);
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
      const float dsr = round_to<T>(p * (dp - row_delta) * scale);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        axpy4(dsr, ks[j][part + kSplit * c], dq_acc[c]);
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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int L, int causal, float scale,
           cudaStream_t stream) {
  const int rows = bh * L;
  flash_attn_bwd_delta_kernel<T, DH>
      <<<(rows + kDeltaWarps - 1) / kDeltaWarps, kDeltaWarps * 32, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                   delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (L + kTile - 1) / kTile);
  flash_attn_bwd_dkdv_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), L, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attn_bwd_dq_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), L, causal, scale);
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
    return launch<float, 64>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv,
                             bh, L, causal, scale, s);
  } else if (dtype == 0 && dh == 32) {
    return launch<float, 32>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv,
                             bh, L, causal, scale, s);
  } else if (dtype == 1 && dh == 64) {
    return launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse_f, delta_f, dq,
                                     dk, dv, bh, L, causal, scale, s);
  } else if (dtype == 1 && dh == 32) {
    return launch<__nv_bfloat16, 32>(q, k, v, o, dout, lse_f, delta_f, dq,
                                     dk, dv, bh, L, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
