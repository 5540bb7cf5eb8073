// Building blocks of the bf16 attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu) on Hopper's tensor cores through the warp-level
// mma.sync instruction (sm_80 and later, so sm_90a too).
//
// Tiles of a [L, DH] bf16 matrix are staged in shared memory as rows of
// DH + 8 elements: 16 bytes of padding shift each row by four banks, so
// the eight 16-byte rows that one ldmatrix 8x8 matrix reads fall on
// distinct banks (conflict-free for DH = 32 and 64). Rows are copied with
// 16-byte cp.async, rows past L filled with zeros.
//
// Fragments follow PTX's m16n8k16 layout. With g = lane / 4, t = lane % 4:
//  A (16x16, row-major), four b32 registers of two bf16 each:
//    a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, cols 2t, 2t+1),
//    a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, cols 2t+8, 2t+9);
//  B (16x8, "col": stored as 8 rows of 16), two registers:
//    b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g);
//  C (16x8 fp32), four floats: c0, c1 = (row g, cols 2t, 2t+1),
//    c2, c3 = (row g+8, cols 2t, 2t+1).
// So the accumulators of two neighbouring n8 tiles, rounded to bf16 and
// packed in pairs, are the A fragment of the next product (P.V, dS.K)
// without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;  // rows of a streamed K/V or Q/dO tile

// shared-memory row stride, in elements
template <int DH>
struct Layout {
  static constexpr int kStride = DH + 8;
  static constexpr int kChunks = DH / 8;  // 16-byte chunks in a row
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zeros when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte global -> shared copy; zero when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows r0 .. r0 + rows - 1 of a contiguous [L, DH] matrix into shared
// memory at the padded stride; rows at or past L become zeros
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int rows, int L, int tid,
                                          int nthreads) {
  constexpr int kChunks = Layout<DH>::kChunks;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = r0 + r < L;
    const bf16* g = src + static_cast<size_t>(ok ? r0 + r : 0) * DH + c * 8;
    cp_async16(dst + r * Layout<DH>::kStride + c * 8, g, ok);
  }
}

// n fp32 values of a [L] vector from r0 on into shared memory (zeros past L)
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int n, int L, int tid) {
  if (tid < n) {
    const bool ok = r0 + tid < L;
    cp_async4(dst + tid, src + (ok ? r0 + tid : 0), ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16) . b (16x8), bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment (16 rows x 16 cols) of rows row0 .. row0+15 of a staged
// matrix, cols col0 .. col0+15
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int row0, int col0, int lane) {
  ldmatrix_x4(a, s + (row0 + (lane & 15)) * Layout<DH>::kStride + col0 +
                     (lane >> 4) * 8);
}

// B fragments of two n8 tiles for a product X . Y^T, where Y is staged
// with its n index along rows: rows n0 .. n0+15 (b[0], b[1] for rows
// n0 .. n0+7; b[2], b[3] for n0+8 ..), cols (the k index) k0 .. k0+15
template <int DH>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* s,
                                            int n0, int k0, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4(b, s + (n0 + (m >> 1) * 8 + (lane & 7)) * Layout<DH>::kStride +
                     k0 + (m & 1) * 8);
}

// B fragments of two n8 tiles for a product X . Y, where Y is staged with
// its k index along rows: rows (k) k0 .. k0+15, cols (n) n0 .. n0+15
template <int DH>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* s,
                                            int k0, int n0, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4_trans(b, s + (k0 + (m & 1) * 8 + (lane & 7)) *
                               Layout<DH>::kStride +
                           n0 + (m >> 1) * 8);
}

// A fragment (16 rows x 16 cols) of X^T, where X is staged in a matrix of
// row stride `stride`: X rows (A's cols) c0 .. c0+15, X cols (A's rows)
// r0 .. r0+15
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* s,
                                             int stride, int r0, int c0,
                                             int lane) {
  const int m = lane >> 3;
  ldmatrix_x4_trans(a, s + (c0 + (m >> 1) * 8 + (lane & 7)) * stride + r0 +
                           (m & 1) * 8);
}

// acc (16 rows x DH, fp32 C fragments) rounded to bf16 into the warp's 16
// staged rows (stride as Layout), then rows below L copied to dst rows
// row0 .. row0+15 in 16-byte stores
template <int DH>
__device__ __forceinline__ void store_rows(bf16* stage, bf16* dst,
                                           const float (&acc)[DH / 8][4],
                                           float scale_lo, float scale_hi,
                                           int row0, int L, int lane) {
  constexpr int S = Layout<DH>::kStride;
  constexpr int kChunks = Layout<DH>::kChunks;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * S + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * scale_lo, acc[n][1] * scale_lo);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * S + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * scale_hi, acc[n][3] * scale_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (row0 + r < L) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * DH +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * S + c * 8);
    }
  }
}

// max and sum over the four lanes of a quad (the threads sharing a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Block shape shared by the three bf16 kernels: at L <= 128 one block per
// (batch*head) with ceil(L/16) warps of 16 rows, so that the L=77 tail
// costs one partly filled warp, not a block of dead rows, and K/V (or
// Q/dO) are read once per head; above, blocks of 4 warps (64 rows).
struct Shape {
  int warps;
  int blocks_per_head;
};

inline Shape block_shape(int L) {
  if (L <= 2 * kTile) return {(L + 15) / 16, 1};
  return {kTile / 16, (L + kTile - 1) / kTile};
}

// lets `kernel` launch with `bytes` of dynamic shared memory (above 48 KB
// a kernel must ask); 0 or the CUDA error
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace attn_mma
