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
// kernel (flash_attn_bwd.cu) recomputes P = exp(s - lse) from it instead of
// redoing the row softmax. The serving path passes a null lse.
//
// What bounds it on an H100. Per (batch*head) it reads Q, K, V and writes O
// once, 4*L*Dh elements, for 4*L*L*Dh FLOPs (about half when causal): L/4
// FLOP per byte in fp32 and L/2 in bf16. At the serving shapes (L=50, and
// L=77 causal; Dh=64) that is 10-25 FLOP/byte. Against the card's peaks
// (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores, 989 TFLOP/s bf16 on the
// tensor cores) fp32 work turns compute-bound above 20 FLOP/byte and bf16
// above 295, so at these shapes the bytes bound it, and what matters is to
// move each byte once and never write the [L, L] probabilities to device
// memory. At L=577 in fp32 (ViT-L/14 at 336 px) the FLOPs bound it instead.
// This kernel does its bf16 products on the CUDA cores too, so its own
// ceiling for bf16 is the fp32 FMA rate; tensor cores are later work.
//
// What the design does about it.
//  * One block per (batch*head, 64-query tile); a loop over 64-key tiles of K
//    and V staged in shared memory (converted to fp32 once there), with an
//    online softmax in fp32 (running max, running sum, rescaled accumulator).
//    The TPU kernel kept the whole [L, L] tile in VMEM; that does not fit a
//    Hopper block at L=577, and the online softmax makes any L one pass over
//    K and V per query tile. Scores and probabilities live in registers only.
//  * Four threads share one query row, each owning Dh/4 of Q and of the
//    accumulator in float4 chunks interleaved so that a warp's shared-memory
//    reads of a K or V row are conflict-free; the partial dot products are
//    summed with two warp shuffles.
//  * Ragged query and key edges are masked by bounds (no padding of L to 16
//    or of Dh to 128: those were TPU tile rules). Causal blocks stop at their
//    last query's key tile and skip masked keys entirely.
//  * Products are plain fp32 FMAs: no TF32 for fp32 inputs. wgmma, TMA and
//    warp specialisation are left for later work; at these arithmetic
//    intensities they would buy little until the byte traffic is minimal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTileQ = 64;                  // queries per block
constexpr int kTileK = 64;                  // keys per shared-memory tile
constexpr int kSplit = 4;                   // threads per query row
constexpr int kThreads = kTileQ * kSplit;   // 256

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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
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
      const T* src = q + base + static_cast<size_t>(row) * DH + col;
      x = make_float4(to_f(src[0]), to_f(src[1]), to_f(src[2]),
                      to_f(src[3]));
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
        kx = to_f(k[g]);
        vx = to_f(v[g]);
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
        const float pv = to_f(from_f<T>(p));  // P in the operand dtype
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 vv = vs[j][part + kSplit * c];
          acc[c].x = fmaf(pv, vv.x, acc[c].x);
          acc[c].y = fmaf(pv, vv.y, acc[c].y);
          acc[c].z = fmaf(pv, vv.z, acc[c].z);
          acc[c].w = fmaf(pv, vv.w, acc[c].w);
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
      T* dst = o + base + static_cast<size_t>(row) * DH + col;
      dst[0] = from_f<T>(acc[c].x * inv);
      dst[1] = from_f<T>(acc[c].y * inv);
      dst[2] = from_f<T>(acc[c].z * inv);
      dst[3] = from_f<T>(acc[c].w * inv);
    }
    if (lse != nullptr && part == 0) {
      lse[static_cast<size_t>(bh) * L + row] = m + logf(l);
    }
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int bh, int L, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (L + kTileQ - 1) / kTileQ);
  flash_attn_fwd_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, causal, scale);
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
  if (bh < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && dh == 64) {
    launch<float, 64>(q, k, v, o, lse_f, bh, L, causal, scale, s);
  } else if (dtype == 0 && dh == 32) {
    launch<float, 32>(q, k, v, o, lse_f, bh, L, causal, scale, s);
  } else if (dtype == 1 && dh == 64) {
    launch<__nv_bfloat16, 64>(q, k, v, o, lse_f, bh, L, causal, scale, s);
  } else if (dtype == 1 && dh == 32) {
    launch<__nv_bfloat16, 32>(q, k, v, o, lse_f, bh, L, causal, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
