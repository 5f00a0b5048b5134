// The tile code of the 27-tap column conv, shared by kernel A1
// (conv3_columns.cu, float32 or bf16 feats) and kernel A4
// (conv3_columns_q.cu, int8 feats). Each source defines the feats loader
// of its feats types, ALoad<Ta>, and its C entry point; the kernels here are
// generic in the loader. The build hashes this header into both libraries.
//
// Design: a 64x64 output tile per block. For each column the block reads
// its rows' three z-tap positions; a z-tap that no row of the tile hits is
// skipped, gathers and products alike. The hit rows of each tap are
// gathered into shared memory with the matching weight slice, and the
// product accumulates in float32:
//   * bf16 weights run on the tensor cores through WMMA (mma.sync,
//     16x16x16 bf16 fragments, four warps of 32x32 each). The loader stages
//     each feats row as bf16, with 16-byte row loads where the widths allow;
//   * float32 weights stay on the CUDA cores (a 4x4 register tile per
//     thread), exact float32 products.
// Bias, ReLU and the mask are applied to the float32 sum, which is cast to
// the output type once. The wgmma/TMA pipeline of a fast Hopper GEMM is
// later work. The TPU's DMA window and one-hot row picks are not needed: a
// GPU gathers rows directly, so every hit tap is read and none is dropped.
// Tiles whose first row is at or past nvalid (valid voxels come first)
// write zeros without reading anything, like the TPU kernel's dead tiles.
//
// ALoad<Ta> provides, for feats of type Ta:
//   static float to_float(Ta)             the CUDA-core kernel's A operand;
//   static __nv_bfloat16 to_bf16(Ta)       the WMMA kernel's, one channel;
//   static constexpr int kCh               channels per 16-byte load;
//   static void stage(uint4, __nv_bfloat16*)  one 16-byte load as kCh bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // slab depth per shared-memory stage
constexpr int kThreads = 256;
constexpr int kWarpThreads = 128;  // tensor-core variant: 4 warps
constexpr int kWBK = 32;            // its slab depth per stage

template <typename Ta>
struct ALoad;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The column set-up both variants share: rows[j][r] is the feats row of
// z-tap j for output row m0 + r (-1 on a miss), tap_any[j] whether any row
// of the tile hits tap j.
__device__ __forceinline__ void column_rows(
    const int* __restrict__ col_idx, const unsigned char* __restrict__ hit,
    int V, int m0, int col, int (*rows)[kBM], int* tap_any) {
  const int tid = threadIdx.x;
  __syncthreads();  // the previous column is done with rows[]
  if (tid < 3) tap_any[tid] = 0;
  __syncthreads();
  if (tid < kBM) {
    const int v = m0 + tid;
    int r0 = -1, r1 = -1, r2 = -1;
    if (v < V) {
      const int p = col_idx[(long long)v * 9 + col];
      const unsigned char* h = hit + (long long)v * 27 + 3 * col;
      const int h0 = h[0] != 0, h1 = h[1] != 0, h2 = h[2] != 0;
      if (h0) r0 = p;
      if (h1) r1 = p + h0;
      if (h2) r2 = p + h0 + h1;
    }
    rows[0][tid] = r0;
    rows[1][tid] = r1;
    rows[2][tid] = r2;
    // benign race: every writer stores 1
    if (r0 >= 0) tap_any[0] = 1;
    if (r1 >= 0) tap_any[1] = 1;
    if (r2 >= 0) tap_any[2] = 1;
  }
  __syncthreads();
}

template <typename Tout>
__device__ __forceinline__ void epilogue(float v, const float* bias, int n,
                                         bool relu, bool keep, Tout* dst) {
  if (bias != nullptr) v += bias[n];
  if (relu) v = fmaxf(v, 0.f);
  store(dst, keep ? v : 0.f);
}

template <typename Tout>
__device__ __forceinline__ bool dead_tile(const int* nvalid, int V, int Co,
                                          int m0, int n0, int g,
                                          long long GCo, int nthreads,
                                          Tout* out) {
  if (m0 < *nvalid) return false;
  for (int e = threadIdx.x; e < kBM * kBN; e += nthreads) {
    const int r = m0 + e / kBN;
    const int n = n0 + e % kBN;
    if (r < V && n < Co) store(out + r * GCo + g * Co + n, 0.f);
  }
  return true;
}

template <typename Ta, typename Tw, typename Tout>
__global__ void __launch_bounds__(kThreads)
conv3_columns_kernel(const Ta* __restrict__ feats,
                     const int* __restrict__ col_idx,
                     const unsigned char* __restrict__ hit,
                     const Tw* __restrict__ w,
                     const float* __restrict__ bias,
                     const unsigned char* __restrict__ out_mask,
                     const int* __restrict__ nvalid,
                     Tout* __restrict__ out, int V, int C, int Co, int G,
                     int relu) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  __shared__ int rows[3][kBM];
  __shared__ int tap_any[3];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g = blockIdx.z;
  const long long GC = (long long)G * C;
  const long long GCo = (long long)G * Co;

  if (dead_tile(nvalid, V, Co, m0, n0, g, GCo, kThreads, out)) return;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int col = 0; col < 9; ++col) {
    column_rows(col_idx, hit, V, m0, col, rows, tap_any);
    for (int j = 0; j < 3; ++j) {
      if (!tap_any[j]) continue;  // no row of the tile hits this tap
      const Tw* wj = w + (long long)(col * 3 + j) * C * Co;
      for (int c0 = 0; c0 < C; c0 += kBK) {
        for (int e = tid; e < kBM * kBK; e += kThreads) {
          const int kk = e % kBK;
          const int r = e / kBK;
          const int ch = c0 + kk;
          const int row = rows[j][r];
          As[kk][r] = (ch < C && row >= 0)
                          ? ALoad<Ta>::to_float(feats[row * GC + g * C + ch])
                          : 0.f;
        }
        for (int e = tid; e < kBK * kBN; e += kThreads) {
          const int n = e % kBN;
          const int kk = e / kBN;
          const int ch = c0 + kk;
          Bs[kk][n] = (ch < C && n0 + n < Co)
                          ? to_f(wj[(long long)ch * Co + n0 + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) b[jj] = Bs[kk][tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= V) continue;
    const bool keep = out_mask[r] != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Co) continue;
      epilogue(acc[i][j], bias, n, relu, keep, out + r * GCo + g * Co + n);
    }
  }
}

template <typename Ta, typename Tout, bool kVec>
__global__ void __launch_bounds__(kWarpThreads)
conv3_columns_wmma_kernel(const Ta* __restrict__ feats,
                          const int* __restrict__ col_idx,
                          const unsigned char* __restrict__ hit,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias,
                          const unsigned char* __restrict__ out_mask,
                          const int* __restrict__ nvalid,
                          Tout* __restrict__ out, int V, int C, int Co, int G,
                          int relu) {
  using namespace nvcuda;
  constexpr int kCh = ALoad<Ta>::kCh;
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kWBK + 8];
  __shared__ __align__(32) __nv_bfloat16 Bs[kWBK][kBN + 8];
  __shared__ __align__(32) float Cs[kBM][kBN + 4];
  __shared__ int rows[3][kBM];
  __shared__ int tap_any[3];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // rows wm*32 .. +32 of the tile
  const int wn = warp % 2;   // cols wn*32 .. +32
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g = blockIdx.z;
  const long long GC = (long long)G * C;
  const long long GCo = (long long)G * Co;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  if (dead_tile(nvalid, V, Co, m0, n0, g, GCo, kWarpThreads, out)) return;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int col = 0; col < 9; ++col) {
    column_rows(col_idx, hit, V, m0, col, rows, tap_any);
    for (int j = 0; j < 3; ++j) {
      if (!tap_any[j]) continue;  // no row of the tile hits this tap
      const __nv_bfloat16* wj = w + (long long)(col * 3 + j) * C * Co;
      for (int c0 = 0; c0 < C; c0 += kWBK) {
        if (kVec) {
          // kCh feats channels (16 bytes) per load: C is a multiple of kCh;
          // 8 weight channels per load: Co is a multiple of 8
          for (int e = tid; e < kBM * kWBK / kCh; e += kWarpThreads) {
            const int r = e / (kWBK / kCh);
            const int kk = (e % (kWBK / kCh)) * kCh;
            const int ch = c0 + kk;
            const int row = rows[j][r];
            uint4 v = make_uint4(0, 0, 0, 0);
            if (ch < C && row >= 0)
              v = *reinterpret_cast<const uint4*>(feats + row * GC + g * C
                                                  + ch);
            ALoad<Ta>::stage(v, &As[r][kk]);
          }
          for (int e = tid; e < kWBK * kBN / 8; e += kWarpThreads) {
            const int kk = e / (kBN / 8);
            const int n = (e % (kBN / 8)) * 8;
            const int ch = c0 + kk;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (ch < C && n0 + n < Co)
              v = *reinterpret_cast<const uint4*>(wj + (long long)ch * Co
                                                  + n0 + n);
            *reinterpret_cast<uint4*>(&Bs[kk][n]) = v;
          }
        } else {
          for (int e = tid; e < kBM * kWBK; e += kWarpThreads) {
            const int kk = e % kWBK;
            const int r = e / kWBK;
            const int ch = c0 + kk;
            const int row = rows[j][r];
            As[r][kk] = (ch < C && row >= 0)
                            ? ALoad<Ta>::to_bf16(feats[row * GC + g * C + ch])
                            : zero;
          }
          for (int e = tid; e < kWBK * kBN; e += kWarpThreads) {
            const int n = e % kBN;
            const int kk = e / kBN;
            const int ch = c0 + kk;
            Bs[kk][n] = (ch < C && n0 + n < Co)
                            ? wj[(long long)ch * Co + n0 + n] : zero;
          }
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kWBK / 16; ++ks) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][ks * 16],
                                   kWBK + 8);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            wmma::load_matrix_sync(b[jj], &Bs[ks * 16][wn * 32 + jj * 16],
                                   kBN + 8);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              wmma::mma_sync(acc[i][jj], a[i], b[jj], acc[i][jj]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], kBN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kWarpThreads) {
    const int r = m0 + e / kBN;
    const int n = n0 + e % kBN;
    if (r >= V || n >= Co) continue;
    epilogue(Cs[e / kBN][e % kBN], bias, n, relu, out_mask[r] != 0,
             out + r * GCo + g * Co + n);
  }
}

// One column conv: feats [V, G*C] of type Ta, w [27, C, Co] of type Tw
// (bf16 weights take the tensor cores, float32 ones the CUDA cores), bias
// [Co] float32 or null, out_mask [V] bool, nvalid [1] int32 on the device,
// out [V, G*Co] of type Tout.
template <typename Ta, typename Tw, typename Tout>
void launch(const void* feats, const void* col_idx, const void* hit,
            const void* w, const void* bias, const void* out_mask,
            const void* nvalid, void* out, int V, int C, int Co, int G,
            int relu, cudaStream_t stream) {
  const dim3 grid((V + kBM - 1) / kBM, (Co + kBN - 1) / kBN, G);
  if constexpr (std::is_same<Tw, __nv_bfloat16>::value) {
    // 16-byte loads need rows of whole loads (every width but the stem's 3)
    auto kernel = (C % ALoad<Ta>::kCh == 0 && Co % 8 == 0)
                      ? conv3_columns_wmma_kernel<Ta, Tout, true>
                      : conv3_columns_wmma_kernel<Ta, Tout, false>;
    kernel<<<grid, kWarpThreads, 0, stream>>>(
        (const Ta*)feats, (const int*)col_idx, (const unsigned char*)hit,
        (const Tw*)w, (const float*)bias, (const unsigned char*)out_mask,
        (const int*)nvalid, (Tout*)out, V, C, Co, G, relu);
  } else {
    conv3_columns_kernel<Ta, Tw, Tout><<<grid, kThreads, 0, stream>>>(
        (const Ta*)feats, (const int*)col_idx, (const unsigned char*)hit,
        (const Tw*)w, (const float*)bias, (const unsigned char*)out_mask,
        (const int*)nvalid, (Tout*)out, V, C, Co, G, relu);
  }
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
