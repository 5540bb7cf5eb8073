// FILIP late interaction for Hopper (sm_90a), forward and backward, plain C
// interface. Three kernels in one source, so that they share one similarity
// routine (see "Winners" below):
//
//   K3 filip_li_fwd     raw[b, l] = mean_n max_m <d1[b, n], d2[l, m]>
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
// What bounds it on an H100. Each kernel computes the similarities of every
// query row with every key token, 2*B*N1*GB*N2*D FLOPs, from inputs of
// (B*N1 + GB*N2)*D elements: at the training shapes (B = GB = 128, N1 = 49 or
// 77, N2 = 16, D = 256, bf16) 6.6 and 10.3 GFLOP from about 4.3 MB, some 1,500
// FLOP per byte, so the FLOPs bound it on any unit of the card (the bf16
// tensor cores at 989 TFLOP/s: 6.7 and 10.4 us). The backward kernels add
// 2*B*N1*GB*D FLOPs for the winners' products (one winner per row and key
// item when there are no ties), 1/N2 of the similarities' work.
//
// What the design does about it. This first version runs its products as
// fp32 FMAs on the CUDA cores (67 TFLOP/s peak, 15x below the tensor cores);
// mma.sync/wgmma are later work. Within that:
//  * The similarities are a register-tiled GEMM of the flattened query rows
//    (B*N1) against the flattened key tokens (GB*N2): a block of 256 threads
//    computes a 64-row tile against up to 128 key tokens (whole key items
//    only), each thread a 4 x KC micro-tile, d staged through shared memory
//    32 at a time (converted to fp32 once there). The similarity tile never
//    reaches device memory: it lands in shared memory, where the max over the
//    N2 tokens of each key item is taken (and, in the backward, the winner
//    weights are formed in place).
//  * No padding of N1, D, B or GB to tile sizes (the TPU kernel's Mosaic
//    layout rules, filip_pallas.py:45-72): ragged edges are masked by bounds,
//    so there are no padded query rows to mask out of the mean or the
//    gradient.
//  * Sums across blocks without atomics, so every result is deterministic:
//    K3 writes each row's max [B*N1, GB] and a second small kernel takes the
//    mean over each item's N1 rows in row order; K4 splits the key items and
//    K5 the query rows over a few blocks each (to fill the 132 SMs) into fp32
//    partial sums, which a reduce kernel adds in split order and rounds to
//    the output dtype once.
//
// Winners. K3, K4 and K5 must agree on which tokens win each max, so they
// compute every similarity bit-identically: `tile_dots` below is the only
// routine that forms one, and it accumulates each dot as one fmaf chain in
// the order d = 0, 1, ..., D-1 (zero padding past D adds exact zeros), so the
// value depends neither on the tiling nor on the kernel. Exact ties (for
// example duplicated key tokens) are found by equality with the max.
//
// Rounding against the TPU kernel. The TPU kernel accumulates dd1 across key
// tiles in the output dtype (`o_ref[:] += acc.astype(o_ref.dtype)`, l.127),
// which in bf16 rounds once per 128-key tile; here dd1 and dd2 accumulate in
// fp32 and round once. At GB <= 128 there is one key tile and the two agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = 64;       // query rows per tile: 4 per thread row
constexpr int kMaxCols = 128;   // key tokens per tile: up to 8 per thread col
constexpr int kChunk = 32;      // d staged per step
constexpr int kMaxN2 = 128;
constexpr int kMaxD = 256;      // K4 keeps a row's dd1 slice in registers

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
  int R;   // query rows, B * N1 (row r is item r / N1)
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

// The max of a key item's n similarities. NaN wins, as in jnp.maximum and
// torch.amax (fmaxf would drop it): K3 then gives NaN, and K4 and K5 find no
// winner and make every weight of the row NaN (winner_weights).
__device__ __forceinline__ float item_max(const float* s, int n) {
  float mx = s[0];
  for (int m = 1; m < n; ++m) mx = (s[m] > mx || isnan(s[m])) ? s[m] : mx;
  return mx;
}

// In place over the tile of rows r0.. and key items l0..l0+nk-1: each
// similarity becomes g[b, l] / (N1 * ties) times 1 where it equals its key
// item's max and times 0 elsewhere, the product `_winner_weights` forms. A
// weight that is not finite (a NaN g, or a NaN max, which no token equals,
// so ties = 0) thus gives NaN on every token, as on the plain path. Rows
// past R get 0 everywhere. Ends with a barrier.
__device__ void winner_weights(Smem& sm, int r0, int l0, int nk,
                               const float* __restrict__ g, const Shape& sh) {
  for (int p = threadIdx.x; p < kRows * nk; p += kThreads) {
    const int row = p / nk, lk = p % nk;
    const int r = r0 + row, l = l0 + lk;
    float* s = &sm.s[row][lk * sh.N2];
    if (r >= sh.R) {
      for (int m = 0; m < sh.N2; ++m) s[m] = 0.f;
      continue;
    }
    const float mx = item_max(s, sh.N2);
    int ties = 0;
    for (int m = 0; m < sh.N2; ++m) ties += (s[m] == mx);
    const float w = g[static_cast<size_t>(r / sh.N1) * sh.GB + l] /
                    (static_cast<float>(sh.N1) * static_cast<float>(ties));
    for (int m = 0; m < sh.N2; ++m) s[m] = w * static_cast<float>(s[m] == mx);
  }
  __syncthreads();
}

// K3, pass 1: grid (row tiles, key groups of kt items).
// rowmax[r, l] = max_m <d1[r], d2[l, m]>.
template <typename T>
__global__ void __launch_bounds__(kThreads)
li_fwd_kernel(const T* __restrict__ d1, const T* __restrict__ d2,
              float* __restrict__ rowmax, Shape sh, int kt) {
  __shared__ Smem sm;
  const int r0 = blockIdx.x * kRows;
  const int l0 = blockIdx.y * kt;
  const int nk = min(kt, sh.GB - l0);
  tile_dots<T, kMaxCols / 16>(d1, d2, r0, l0 * sh.N2, nk * sh.N2, sh, sm);
  for (int p = threadIdx.x; p < kRows * nk; p += kThreads) {
    const int row = p / nk, lk = p % nk;
    const int r = r0 + row;
    if (r >= sh.R) continue;
    rowmax[static_cast<size_t>(r) * sh.GB + l0 + lk] =
        item_max(&sm.s[row][lk * sh.N2], sh.N2);
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

// K4: grid (row tiles, key splits). Each block owns 64 query rows and adds,
// over its split's key groups in order, the winners' weighted key tokens into
// fp32 registers: thread (tx, ty) holds rows ty + 16i and d = tx + 16q.
// part[split, r, :] receives the block's sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
li_bwd_d1_kernel(const T* __restrict__ d1, const T* __restrict__ d2,
                 const float* __restrict__ g, float* __restrict__ part,
                 Shape sh, int kt, int groups_per_split) {
  __shared__ Smem sm;
  constexpr int kQ = kMaxD / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * kRows;
  const int n_groups = (sh.GB + kt - 1) / kt;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  float acc[4][kQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[i][q] = 0.f;
  }
  for (int grp = g_begin; grp < g_end; ++grp) {
    const int l0 = grp * kt;
    const int nk = min(kt, sh.GB - l0);
    const int C = nk * sh.N2;
    tile_dots<T, kMaxCols / 16>(d1, d2, r0, l0 * sh.N2, C, sh, sm);
    winner_weights(sm, r0, l0, nk, g, sh);
    for (int col = 0; col < C; ++col) {
      float w[4];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = sm.s[ty + 16 * i][col];
        any |= w[i] != 0.f;
      }
      if (!any) continue;
      const T* src = d2 + static_cast<size_t>(l0 * sh.N2 + col) * sh.D;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int d = tx + 16 * q;
        const float v = d < sh.D ? to_f(src[d]) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(w[i], v, acc[i][q]);
      }
    }
  }
  float* dst = part + static_cast<size_t>(blockIdx.y) * sh.R * sh.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= sh.R) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int d = tx + 16 * q;
      if (d < sh.D) dst[static_cast<size_t>(r) * sh.D + d] = acc[i][q];
    }
  }
}

// K5: grid (key groups of kt items, row splits, d slices of 16*QD). Each
// block owns C = kt*N2 <= 16*KC key tokens and one d slice, and adds, over
// its split's row tiles in order, the winners' weighted query rows into fp32
// registers: thread (tx, ty) holds tokens ty + 16k and d = slice + tx + 16q.
// part[split, j, :] receives the block's sum.
template <typename T, int KC, int QD>
__global__ void __launch_bounds__(kThreads)
li_bwd_d2_kernel(const T* __restrict__ d1, const T* __restrict__ d2,
                 const float* __restrict__ g, float* __restrict__ part,
                 Shape sh, int kt, int tiles_per_split) {
  __shared__ Smem sm;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int l0 = blockIdx.x * kt;
  const int nk = min(kt, sh.GB - l0);
  const int C = nk * sh.N2;
  const int j0 = l0 * sh.N2;
  const int dbase = blockIdx.z * 16 * QD;
  const int n_tiles = (sh.R + kRows - 1) / kRows;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  float acc[KC][QD];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
#pragma unroll
    for (int q = 0; q < QD; ++q) acc[k][q] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int r0 = t * kRows;
    tile_dots<T, KC>(d1, d2, r0, j0, C, sh, sm);
    winner_weights(sm, r0, l0, nk, g, sh);
    const int rows = min(kRows, sh.R - r0);
    for (int row = 0; row < rows; ++row) {
      float w[KC];
      bool any = false;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int col = ty + 16 * k;
        w[k] = col < C ? sm.s[row][col] : 0.f;
        any |= w[k] != 0.f;
      }
      if (!any) continue;
      const T* src = d1 + static_cast<size_t>(r0 + row) * sh.D;
#pragma unroll
      for (int q = 0; q < QD; ++q) {
        const int d = dbase + tx + 16 * q;
        const float v = d < sh.D ? to_f(src[d]) : 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k][q] = fmaf(w[k], v, acc[k][q]);
      }
    }
  }
  float* dst = part + static_cast<size_t>(blockIdx.y) * sh.GB * sh.N2 * sh.D;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int col = ty + 16 * k;
    if (col >= C) continue;
#pragma unroll
    for (int q = 0; q < QD; ++q) {
      const int d = dbase + tx + 16 * q;
      if (d < sh.D) dst[static_cast<size_t>(j0 + col) * sh.D + d] = acc[k][q];
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

template <typename T>
void reduce(const float* part, void* out, size_t n, int splits,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  li_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(out),
                                                  n, splits);
}

// Key items per tile: as many whole items as fit in `cols` key tokens.
int items_per_tile(int N2, int cols) { return N2 >= cols ? 1 : cols / N2; }

// K5's tiling: N2 <= 64, 64 key tokens a block, all of d (4 x 16 registers a
// thread); wider key items, one item (up to 128 tokens) and 128 of d a block.
bool d2_wide(int N2) { return N2 > kMaxCols / 2; }
int d2_items(int N2) {
  return items_per_tile(N2, d2_wide(N2) ? kMaxCols : kMaxCols / 2);
}

// The number of key splits (K4, which 1) or row splits (K5, which 2): enough
// blocks for two per SM of the current device, at most one key group or row
// tile each. The caller's `part` holds this many partial sums.
int bwd_splits(int which, const Shape& sh) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (sh.R + kRows - 1) / kRows;
  int limit, blocks;
  if (which == 1) {
    const int kt = items_per_tile(sh.N2, kMaxCols);
    limit = (sh.GB + kt - 1) / kt;
    blocks = row_tiles;
  } else {
    const int kt = d2_items(sh.N2);
    limit = row_tiles;
    blocks = ((sh.GB + kt - 1) / kt) * (d2_wide(sh.N2) ? (sh.D + 127) / 128
                                                         : 1);
  }
  const int want = (2 * sms + blocks - 1) / blocks;
  return want < 1 ? 1 : (want > limit ? limit : want);
}

}  // namespace

// The launch functions. d1: contiguous [B, N1, D]; d2: contiguous
// [GB, N2, D]; dtype 0 = float32, 1 = bfloat16 (both inputs); g: fp32
// [B, GB]. Workspace (fp32) and outputs are allocated by the caller:
//   filip_li_fwd:    rowmax [B*N1, GB], raw [B, GB];
//   filip_li_bwd_d1: part [splits, B*N1, D], dd1 [B, N1, D] in the dtype;
//   filip_li_bwd_d2: part [splits, GB*N2, D], dd2 [GB, N2, D] in the dtype;
// `part` holds filip_li_bwd_workspace(which, ...) floats, which 1 for
// filip_li_bwd_d1 and 2 for filip_li_bwd_d2, asked on the device they run on.
// Limits: N2 <= 128, D <= 256. Each returns cudaGetLastError() after its
// launches (0 on success), or cudaErrorInvalidValue for arguments it does
// not take.

extern "C" int filip_li_fwd(const void* d1, const void* d2, void* rowmax,
                            void* raw, int B, int N1, int GB, int N2, int D,
                            int dtype, void* stream) {
  const Shape sh{B * N1, N1, GB, N2, D};
  if (!valid(sh, B, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kt = items_per_tile(N2, kMaxCols);
  const dim3 grid((sh.R + kRows - 1) / kRows, (GB + kt - 1) / kt);
  float* rm = static_cast<float*>(rowmax);
  if (dtype == 0) {
    li_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(d1), static_cast<const float*>(d2), rm, sh,
        kt);
  } else {
    li_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(d1),
        static_cast<const __nv_bfloat16*>(d2), rm, sh, kt);
  }
  li_mean_kernel<<<(B * GB + 255) / 256, 256, 0, s>>>(
      rm, static_cast<float*>(raw), B, N1, GB);
  return static_cast<int>(cudaGetLastError());
}

extern "C" size_t filip_li_bwd_workspace(int which, int B, int N1, int GB,
                                         int N2, int D) {
  const Shape sh{B * N1, N1, GB, N2, D};
  const size_t rows = which == 1 ? static_cast<size_t>(sh.R)
                                 : static_cast<size_t>(GB) * N2;
  return static_cast<size_t>(bwd_splits(which, sh)) * rows * D;
}

extern "C" int filip_li_bwd_d1(const void* d1, const void* d2, const void* g,
                               void* part, void* dd1, int B, int N1, int GB,
                               int N2, int D, int dtype, void* stream) {
  const Shape sh{B * N1, N1, GB, N2, D};
  if (!valid(sh, B, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const int kt = items_per_tile(N2, kMaxCols);
  const int n_groups = (GB + kt - 1) / kt;
  const int splits = bwd_splits(1, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_split = (n_groups + splits - 1) / splits;
  const dim3 grid((sh.R + kRows - 1) / kRows, splits);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part);
  const size_t n = static_cast<size_t>(sh.R) * D;
  if (dtype == 0) {
    li_bwd_d1_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(d1), static_cast<const float*>(d2), gf, pf,
        sh, kt, per_split);
    reduce<float>(pf, dd1, n, splits, s);
  } else {
    li_bwd_d1_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(d1),
        static_cast<const __nv_bfloat16*>(d2), gf, pf, sh, kt, per_split);
    reduce<__nv_bfloat16>(pf, dd1, n, splits, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int filip_li_bwd_d2(const void* d1, const void* d2, const void* g,
                               void* part, void* dd2, int B, int N1, int GB,
                               int N2, int D, int dtype, void* stream) {
  const Shape sh{B * N1, N1, GB, N2, D};
  if (!valid(sh, B, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (sh.R + kRows - 1) / kRows;
  const int splits = bwd_splits(2, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_split = (row_tiles + splits - 1) / splits;
  const bool wide = d2_wide(N2);
  const int kt = d2_items(N2);
  const dim3 grid((GB + kt - 1) / kt, splits, wide ? (D + 127) / 128 : 1);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part);
  const size_t n = static_cast<size_t>(GB) * N2 * D;
  if (dtype == 0) {
    const float* a = static_cast<const float*>(d1);
    const float* b = static_cast<const float*>(d2);
    if (wide) {
      li_bwd_d2_kernel<float, 8, 8><<<grid, kThreads, 0, s>>>(
          a, b, gf, pf, sh, kt, per_split);
    } else {
      li_bwd_d2_kernel<float, 4, 16><<<grid, kThreads, 0, s>>>(
          a, b, gf, pf, sh, kt, per_split);
    }
    reduce<float>(pf, dd2, n, splits, s);
  } else {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(d1);
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(d2);
    if (wide) {
      li_bwd_d2_kernel<__nv_bfloat16, 8, 8><<<grid, kThreads, 0, s>>>(
          a, b, gf, pf, sh, kt, per_split);
    } else {
      li_bwd_d2_kernel<__nv_bfloat16, 4, 16><<<grid, kThreads, 0, s>>>(
          a, b, gf, pf, sh, kt, per_split);
    }
    reduce<__nv_bfloat16>(pf, dd2, n, splits, s);
  }
  return static_cast<int>(cudaGetLastError());
}
