// Kernel A3: the weight gradient of the 27-tap column convolution.
//
// Replaces the TPU kernel conv_columns_pallas_dw_v2
// (lidiff_tpu/ops/pallas_conv.py:568, body _make_dw_kernel_v2 :492). It
// computes, for tap k = 3 * col + j of column col,
//   dW[k, c, co] = sum_o sum_g hit(o, k) * f_g[row(o, k), c] * gm_g[o, co]
// where row(o, k) is the z-tap's feats row (p, p+m0, p+m0+m1 for j = 0, 1,
// 2, with p = col_idx[o, col] and m0/m1/m2 the column's hits), gm is the
// cotangent with the rows outside out_mask zeroed, and the G groups share
// the weights, so their contributions add. Products accumulate in float32
// and dW is float32 whatever the input type.
//
// What bounds it on an H100: like the forward, it depends on the data. It
// reads feats, the cotangent and the map once (tens of MB) and does
// 2 * (hit taps) * C * Co * G FLOP; at the fine levels, where a voxel has
// about one neighbour, the bytes bound it, at the coarse wide levels the
// tensor-core rate.
// Design: the TPU kernel keeps one [9, 3C, Co] accumulator in fast memory
// across a sequential grid. Here blocks run in parallel, so the sum over the
// V rows is a reduction across blocks: a block owns one tap, one 64x64 tile
// of its [C, Co] matrix and one slice of the rows. It walks its slice 32
// rows at a time; a stage in which no row hits the tap is skipped. Else it
// gathers the hit feats rows and the matching cotangent rows into shared
// memory (misses as zeros) and accumulates feats^T @ cotangent in registers:
//   * bf16 inputs on the tensor cores through WMMA (the feats tile read as
//     a column-major A, four warps of 32x32 each), with 16-byte row loads
//     where the widths are multiples of 8;
//   * float32 inputs on the CUDA cores (a 4x4 register tile per thread).
// At its end a block adds its tile into the zeroed dW with float32
// atomicAdd, so the order of the sum over rows changes from run to run. No
// DMA window: every hit tap is read. Rows at or past nvalid (valid voxels
// come first) are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kTC = 64;     // input channels (rows of the dW tile) per block
constexpr int kTN = 64;     // output channels per block
constexpr int kRows = 32;   // voxel rows per shared-memory stage
constexpr int kThreads = 256;
constexpr int kWarpThreads = 128;   // tensor-core variant: 4 warps
constexpr int kTargetBlocks = 3072; // row slices are cut to reach about this

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The stage set-up both variants share: rows[r] is the feats row of the tap
// for output row m0 + r, or -1 on a miss, a masked row or a row past the
// slice; *any_hit whether any row of the stage hits.
__device__ __forceinline__ void stage_rows(
    const int* __restrict__ col_idx, const unsigned char* __restrict__ hit,
    const unsigned char* __restrict__ out_mask, int m0, int r_end, int col,
    int j, int* rows, int* any_hit) {
  const int tid = threadIdx.x;
  __syncthreads();  // the previous stage is done with rows[] and the tiles
  if (tid == 0) *any_hit = 0;
  __syncthreads();
  if (tid < kRows) {
    const int v = m0 + tid;
    int r = -1;
    if (v < r_end && out_mask[v] != 0) {
      const unsigned char* h = hit + (long long)v * 27 + 3 * col;
      if (h[j] != 0) {
        r = col_idx[(long long)v * 9 + col];
        if (j >= 1) r += h[0] != 0;
        if (j >= 2) r += h[1] != 0;
      }
    }
    rows[tid] = r;
    if (r >= 0) *any_hit = 1;  // benign race: every writer stores 1
  }
  __syncthreads();
}

__device__ __forceinline__ int slice_end(const int* nvalid, int V,
                                         int r_begin, int rows_per_slice) {
  int r_end = r_begin + rows_per_slice;
  if (r_end > V) r_end = V;
  const int nv = *nvalid;
  return r_end < nv ? r_end : nv;
}

__global__ void __launch_bounds__(kThreads)
conv3_columns_dw_kernel(const float* __restrict__ feats,
                        const float* __restrict__ g,
                        const int* __restrict__ col_idx,
                        const unsigned char* __restrict__ hit,
                        const unsigned char* __restrict__ out_mask,
                        const int* __restrict__ nvalid,
                        float* __restrict__ dw, int V, int C, int Co, int G,
                        int n_cotiles, int rows_per_slice) {
  __shared__ float As[kRows][kTC + 4];
  __shared__ float Bs[kRows][kTN + 4];
  __shared__ int rows[kRows];
  __shared__ int any_hit;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int tap = blockIdx.z;
  const int col = tap / 3;
  const int j = tap % 3;
  const int c0 = (blockIdx.y / n_cotiles) * kTC;
  const int n0 = (blockIdx.y % n_cotiles) * kTN;
  const long long GC = (long long)G * C;
  const long long GCo = (long long)G * Co;
  const int r_begin = blockIdx.x * rows_per_slice;
  const int r_end = slice_end(nvalid, V, r_begin, rows_per_slice);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  bool found = false;

  for (int m0 = r_begin; m0 < r_end; m0 += kRows) {
    stage_rows(col_idx, hit, out_mask, m0, r_end, col, j, rows, &any_hit);
    if (!any_hit) continue;  // no row of the stage hits this tap
    found = true;
    for (int gi = 0; gi < G; ++gi) {
      if (gi > 0) __syncthreads();  // the previous group is done
      for (int e = tid; e < kRows * kTC; e += kThreads) {
        const int c = e % kTC;
        const int r = e / kTC;
        const int row = rows[r];
        As[r][c] = (row >= 0 && c0 + c < C)
                       ? feats[row * GC + gi * C + c0 + c] : 0.f;
      }
      for (int e = tid; e < kRows * kTN; e += kThreads) {
        const int n = e % kTN;
        const int r = e / kTN;
        Bs[r][n] = (rows[r] >= 0 && n0 + n < Co)
                       ? g[(m0 + r) * GCo + gi * Co + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
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
    }
  }

  if (!found) return;
  float* out = dw + (long long)tap * C * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < Co) atomicAdd(out + (long long)c * Co + n, acc[i][jj]);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarpThreads)
conv3_columns_dw_wmma_kernel(const __nv_bfloat16* __restrict__ feats,
                             const __nv_bfloat16* __restrict__ g,
                             const int* __restrict__ col_idx,
                             const unsigned char* __restrict__ hit,
                             const unsigned char* __restrict__ out_mask,
                             const int* __restrict__ nvalid,
                             float* __restrict__ dw, int V, int C, int Co,
                             int G, int n_cotiles, int rows_per_slice) {
  using namespace nvcuda;
  // As[r][c] holds A(c, r) = feats[row(r), c]: a column-major A tile
  __shared__ __align__(32) __nv_bfloat16 As[kRows][kTC + 8];
  __shared__ __align__(32) __nv_bfloat16 Bs[kRows][kTN + 8];
  __shared__ __align__(32) float Cs[kTC][kTN + 4];
  __shared__ int rows[kRows];
  __shared__ int any_hit;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // rows wm*32 .. +32 of the dW tile
  const int wn = warp % 2;   // cols wn*32 .. +32
  const int tap = blockIdx.z;
  const int col = tap / 3;
  const int j = tap % 3;
  const int c0 = (blockIdx.y / n_cotiles) * kTC;
  const int n0 = (blockIdx.y % n_cotiles) * kTN;
  const long long GC = (long long)G * C;
  const long long GCo = (long long)G * Co;
  const int r_begin = blockIdx.x * rows_per_slice;
  const int r_end = slice_end(nvalid, V, r_begin, rows_per_slice);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);
  bool found = false;

  for (int m0 = r_begin; m0 < r_end; m0 += kRows) {
    stage_rows(col_idx, hit, out_mask, m0, r_end, col, j, rows, &any_hit);
    if (!any_hit) continue;  // no row of the stage hits this tap
    found = true;
    for (int gi = 0; gi < G; ++gi) {
      if (gi > 0) __syncthreads();  // the previous group is done
      if (kVec) {
        // 8 channels (16 bytes) per load: C and Co are multiples of 8
        for (int e = tid; e < kRows * kTC / 8; e += kWarpThreads) {
          const int r = e / (kTC / 8);
          const int c = (e % (kTC / 8)) * 8;
          const int row = rows[r];
          uint4 v = make_uint4(0, 0, 0, 0);
          if (row >= 0 && c0 + c < C)
            v = *reinterpret_cast<const uint4*>(feats + row * GC + gi * C
                                                + c0 + c);
          *reinterpret_cast<uint4*>(&As[r][c]) = v;
        }
        for (int e = tid; e < kRows * kTN / 8; e += kWarpThreads) {
          const int r = e / (kTN / 8);
          const int n = (e % (kTN / 8)) * 8;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (rows[r] >= 0 && n0 + n < Co)
            v = *reinterpret_cast<const uint4*>(g + (m0 + r) * GCo + gi * Co
                                                + n0 + n);
          *reinterpret_cast<uint4*>(&Bs[r][n]) = v;
        }
      } else {
        for (int e = tid; e < kRows * kTC; e += kWarpThreads) {
          const int c = e % kTC;
          const int r = e / kTC;
          const int row = rows[r];
          As[r][c] = (row >= 0 && c0 + c < C)
                         ? feats[row * GC + gi * C + c0 + c] : zero;
        }
        for (int e = tid; e < kRows * kTN; e += kWarpThreads) {
          const int n = e % kTN;
          const int r = e / kTN;
          Bs[r][n] = (rows[r] >= 0 && n0 + n < Co)
                         ? g[(m0 + r) * GCo + gi * Co + n0 + n] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[ks * 16][wm * 32 + i * 16],
                                 kTC + 8);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          wmma::load_matrix_sync(b[jj], &Bs[ks * 16][wn * 32 + jj * 16],
                                 kTN + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            wmma::mma_sync(acc[i][jj], a[i], b[jj], acc[i][jj]);
      }
    }
  }

  if (!found) return;  // uniform: `found` follows the shared any_hit
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + jj * 16],
                              acc[i][jj], kTN + 4, wmma::mem_row_major);
  __syncthreads();
  float* out = dw + (long long)tap * C * Co;
  for (int e = tid; e < kTC * kTN; e += kWarpThreads) {
    const int c = c0 + e / kTN;
    const int n = n0 + e % kTN;
    if (c < C && n < Co)
      atomicAdd(out + (long long)c * Co + n, Cs[e / kTN][e % kTN]);
  }
}

template <typename Tin>
void launch(const void* feats, const void* g, const void* col_idx,
            const void* hit, const void* out_mask, const void* nvalid,
            void* dw, int V, int C, int Co, int G, cudaStream_t stream) {
  const int n_ctiles = (C + kTC - 1) / kTC;
  const int n_cotiles = (Co + kTN - 1) / kTN;
  const int tiles = 27 * n_ctiles * n_cotiles;
  const int stages = (V + kRows - 1) / kRows;
  int slices = (kTargetBlocks + tiles - 1) / tiles;
  if (slices > stages) slices = stages;
  const int rows_per_slice = ((stages + slices - 1) / slices) * kRows;
  slices = (V + rows_per_slice - 1) / rows_per_slice;
  const dim3 grid(slices, n_ctiles * n_cotiles, 27);
  if constexpr (std::is_same<Tin, __nv_bfloat16>::value) {
    // 16-byte loads need 8-channel rows (every width but the stem's 3)
    auto kernel = (C % 8 == 0 && Co % 8 == 0)
                      ? conv3_columns_dw_wmma_kernel<true>
                      : conv3_columns_dw_wmma_kernel<false>;
    kernel<<<grid, kWarpThreads, 0, stream>>>(
        (const Tin*)feats, (const Tin*)g, (const int*)col_idx,
        (const unsigned char*)hit, (const unsigned char*)out_mask,
        (const int*)nvalid, (float*)dw, V, C, Co, G, n_cotiles,
        rows_per_slice);
  } else {
    conv3_columns_dw_kernel<<<grid, kThreads, 0, stream>>>(
        (const float*)feats, (const float*)g, (const int*)col_idx,
        (const unsigned char*)hit, (const unsigned char*)out_mask,
        (const int*)nvalid, (float*)dw, V, C, Co, G, n_cotiles,
        rows_per_slice);
  }
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype codes: 0 float32, 1 bfloat16. feats [V, G*C] and the cotangent g
// [V, G*Co] in the input type, out_mask [V] bool, nvalid [1] int32 on the
// device, dw [27, C, Co] float32, zeroed by the caller.
extern "C" int conv3_columns_dw(int tin, const void* feats, const void* g,
                                const void* col_idx, const void* hit,
                                const void* out_mask, const void* nvalid,
                                void* dw, int V, int C, int Co, int G,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tin == 0) {
    launch<float>(feats, g, col_idx, hit, out_mask, nvalid, dw, V, C, Co, G,
                  s);
  } else if (tin == 1) {
    launch<__nv_bfloat16>(feats, g, col_idx, hit, out_mask, nvalid, dw, V, C,
                          Co, G, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
