// Training-mode masked BatchNorm on the card, with its epilogue (a
// residual added, then a ReLU): the batch moments, the normalization, and
// the backward.
//
// Replaces no TPU kernel: the JAX package leaves masked BatchNorm to XLA
// (lidiff_tpu/models/blocks.py:67-100, lidiff_tpu/ops/sparse_conv.py
// `masked_moments`), which fuses it. Eager PyTorch ran it as separate
// float32 kernels over every capacity row: `feats * mask`, two products,
// two column sums, four broadcast ops of the affine, a `where`, the
// residual's add and the ReLU, and a backward op for each of them, about
// 76 bytes an element forward and 150 backward. In a refiner training step
// on an H100 that glue took about 62% of the card's busy time.
//
// The autograd function around these kernels is
// lidiff_tpu_torch/ops/batchnorm.py `MaskedBatchNormFunction`. For x
// [rows, C] (float32 or bf16), mask [rows] and the float32 affine
// (scale, bias):
//
//   masked_bn_stats    per block of rows, one pass over x: the count of
//                      valid rows, s1 = sum of x and s2 = sum of x * x
//                      (rounded to x's dtype, as the plain code's
//                      `(feats * mask) * feats`), in float32; then
//                      masked_bn_sum_kernel adds the blocks' partials.
//   masked_bn_moments  JAX's one-pass moments from [cnt, s1, s2] (summed
//                      over a process group in between, by the caller):
//                      cnt = max(cnt, 1), mean = s1 / cnt, var =
//                      max(s2 / cnt - mean^2, 0), rstd = rsqrt(var + eps),
//                      and vok = 1 where s2 / cnt - mean^2 >= 0 (the
//                      clamp passed the gradient), else 0.
//   masked_bn_apply    out = where(m, (x - mean) * rstd * scale + bias, 0),
//                      + residual, then ReLU, with the plain code's float32
//                      operations in its order (no contraction to fused
//                      multiply-adds), so that it equals the plain code bit
//                      for bit given the same moments; bf16 x takes the
//                      plain code's low-precision branch, x * k + c with k
//                      and c rounded to bf16 and every operation rounded
//                      to bf16 as PyTorch rounds it.
//   masked_bn_grad     with g = dy, zeroed where ReLU and out <= 0 (the
//                      gate PyTorch's ReLU backward takes from its
//                      output), and xh = (x - mean) * rstd: per block of
//                      rows the sums of m * g and m * g * xh over the
//                      valid rows (dbias and dscale), then the blocks'.
//   masked_bn_dx       dx = m * rstd * scale * (g - Sg / n - xh * vok *
//                      Sgx / n), the sums those of the group where there
//                      is one; dresidual = g where a residual was added.
//
// Deterministic: no atomics. Each block sums its rows in a fixed order
// (each thread its own rows in turn, then the threads' sums in turn), the
// row blocks depend only on the shape and the card, and the blocks'
// partials are added in a fixed order by a second launch. So a call, and
// remat's recompute of it, gives the same bits.
//
// What bounds it on an H100: bytes. A forward reads x twice (the moments,
// then the normalization) and writes out: 12 bytes an element in float32,
// 4 more with a residual. A backward reads x, out (where a ReLU gates) and
// dy twice and writes dx: 28 bytes an element, 8 more with a residual. Nothing of x, out or dy
// is read for an invalid row, which costs only the write of its zeros (and
// the residual's passage). At the refiner's shapes (1.44M rows of 96 to
// 1.15M of 256 channels, every row valid) a forward's bound is 0.5-1.1 ms
// at 3.35 TB/s; on an H100 the kernels run at 70-75% of it. The
// reductions give every thread one vector of up to 16 bytes of a row
// (4 float32 or 8 bf16 channels) and walk the rows of a block, neighbouring
// threads on neighbouring vectors of a row and the block's row lanes on
// neighbouring rows, so a block reads a contiguous run of x; a thread loads
// four rows before it adds, to keep loads in flight. The elementwise
// kernels keep the same layout, so each thread loads its channels'
// constants once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads a block, at most
constexpr int kMaxBlocks = 2048;   // row blocks, at most: the rows of the
                                   // partials (ops/batchnorm.py MAX_BLOCKS)
constexpr int kUnroll = 4;         // rows a thread loads before it adds
constexpr int kLanes = 32;         // row lanes of masked_bn_sum_kernel

using bf16 = __nv_bfloat16;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: PyTorch rounds each bf16 op's float result
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// PyTorch's ReLU (clamp_min(x, 0)): NaN stays NaN
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

// The operands of every entry point; pointers that an entry does not use
// are null. Kernels cast them to their T.
struct Args {
  const void* x;
  const void* out;     // the forward's output (the ReLU's gate)
  const void* dy;
  const bool* mask;
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* bias;
  const float* vok;
  const float* sums;   // the group's [sum of g, sum of g * xh] (backward)
  const float* cnt;
  const void* res;
  void* y;             // the forward's out, or the backward's dx
  void* dres;
  float* partial;      // [blocks][width] (reductions)
  int rows, C;
  int per;             // rows of a row block (reductions)
};

// A block is tx channel vectors by ty rows (tx * ty <= kThreads); `chunks`
// column blocks cover the vectors of a row; `blocks` row blocks, of `per`
// rows each in a reduction, cover the rows.
struct Layout {
  int tx, ty, chunks, blocks, per;
};

Layout block_shape(int cvec) {
  Layout l = {};
  l.tx = cvec < kThreads ? cvec : kThreads;
  l.ty = kThreads / l.tx;
  l.chunks = (cvec + l.tx - 1) / l.tx;
  return l;
}

// At most as many row blocks as the card holds at once (one wave: a
// block's rows are many, and a second, partial wave would leave SMs
// idle), and no more than there are rows of ty. They depend on the shape
// and the card alone, so a repeated call sums in the same order.
template <typename K>
void row_blocks(Layout& l, int rows, K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                l.tx * l.ty, smem);
  int cap = sms * (per_sm > 0 ? per_sm : 1);
  cap = (cap < kMaxBlocks ? cap : kMaxBlocks) / l.chunks;
  if (cap < 1) cap = 1;
  const int want = (rows + l.ty - 1) / l.ty;
  l.blocks = want < cap ? want : cap;
  if (l.blocks < 1) l.blocks = 1;
  l.per = (rows + l.blocks - 1) / l.blocks;
}

// Lane 0 of the block adds the row lanes' sums a and b (each thread's N
// channels) lane by lane in order, into partial[blockIdx.x] at columns
// off_a + c and off_b + c. Every thread of the block calls it.
template <int N>
__device__ __forceinline__ void block_sums(const float (&a)[N],
                                           const float (&b)[N], float* smem,
                                           float* partial, int width,
                                           int off_a, int off_b, int cvec) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int cv = blockIdx.y * TX + tx;
  float* sa = smem;
  float* sb = smem + TY * TX * N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sa[(ty * TX + tx) * N + k] = a[k];
    sb[(ty * TX + tx) * N + k] = b[k];
  }
  __syncthreads();
  if (ty != 0 || cv >= cvec) return;
  float* row = partial + (size_t)blockIdx.x * width;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float ta = 0.f, tb = 0.f;
    for (int l = 0; l < TY; ++l) {
      ta = __fadd_rn(ta, sa[(l * TX + tx) * N + k]);
      tb = __fadd_rn(tb, sb[(l * TX + tx) * N + k]);
    }
    row[off_a + cv * N + k] = ta;
    row[off_b + cv * N + k] = tb;
  }
}

// partial[b] = [count, s1 (C), s2 (C)] over row block b's valid rows.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    masked_bn_stats_kernel(const Args p) {
  extern __shared__ float smem[];
  using V = Vec<T, N>;
  const V* __restrict__ x = (const V*)p.x;
  const bool* __restrict__ mask = p.mask;
  const int cvec = p.C / N, TY = blockDim.y;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.x * p.per;
  const int r1 = min(p.rows, r0 + p.per);
  float s1[N], s2[N];
#pragma unroll
  for (int k = 0; k < N; ++k) s1[k] = s2[k] = 0.f;
  int cnt = 0;
  if (cv < cvec) {
    for (int r = r0 + (int)threadIdx.y; r < r1; r += TY * kUnroll) {
      V v[kUnroll];
      bool m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * TY;
        m[u] = rr < r1 && mask[rr];
        if (m[u]) v[u] = x[(size_t)rr * cvec + cv];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!m[u]) continue;
        ++cnt;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float f = to_float(v[u].v[k]);
          s1[k] = __fadd_rn(s1[k], f);
          s2[k] = __fadd_rn(s2[k], round_to<T>(__fmul_rn(f, f)));
        }
      }
    }
  }
  // the count: lane by lane, from each lane's first thread
  int* counts = (int*)(smem + 2 * TY * blockDim.x * N);
  if (threadIdx.x == 0) counts[threadIdx.y] = cnt;
  const int width = 2 * p.C + 1;
  block_sums<N>(s1, s2, smem, p.partial, width, 1, 1 + p.C, cvec);
  if (blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    int t = 0;
    for (int l = 0; l < TY; ++l) t += counts[l];
    p.partial[(size_t)blockIdx.x * width] = (float)t;
  }
}

// The ReLU's gate on the cotangent, as PyTorch's threshold_backward takes
// it from the ReLU's output: 0 where out <= 0.
template <bool kRelu>
__device__ __forceinline__ float gate(float dy, float out) {
  return kRelu && out <= 0.f ? 0.f : dy;
}

// partial[b] = [sum of g (C), sum of g * xh (C)] over row block b's valid
// rows.
template <typename T, int N, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    masked_bn_grad_kernel(const Args p) {
  extern __shared__ float smem[];
  using V = Vec<T, N>;
  const V* __restrict__ x = (const V*)p.x;
  const V* __restrict__ out = (const V*)p.out;
  const V* __restrict__ dy = (const V*)p.dy;
  const bool* __restrict__ mask = p.mask;
  const int cvec = p.C / N, TY = blockDim.y;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.x * p.per;
  const int r1 = min(p.rows, r0 + p.per);
  float sg[N], sgx[N], mean[N], rstd[N];
#pragma unroll
  for (int k = 0; k < N; ++k) sg[k] = sgx[k] = 0.f;
  if (cv < cvec) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      mean[k] = p.mean[cv * N + k];
      rstd[k] = p.rstd[cv * N + k];
    }
    for (int r = r0 + (int)threadIdx.y; r < r1; r += TY * kUnroll) {
      V xv[kUnroll], ov[kUnroll], gv[kUnroll];
      bool m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * TY;
        m[u] = rr < r1 && mask[rr];
        if (m[u]) {
          const size_t i = (size_t)rr * cvec + cv;
          xv[u] = x[i];
          gv[u] = dy[i];
          if (kRelu) ov[u] = out[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!m[u]) continue;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float g = gate<kRelu>(to_float(gv[u].v[k]),
                                      kRelu ? to_float(ov[u].v[k]) : 0.f);
          const float xh =
              __fmul_rn(__fsub_rn(to_float(xv[u].v[k]), mean[k]), rstd[k]);
          sg[k] = __fadd_rn(sg[k], g);
          sgx[k] = __fadd_rn(sgx[k], __fmul_rn(g, xh));
        }
      }
    }
  }
  block_sums<N>(sg, sgx, smem, p.partial, 2 * p.C, 0, p.C, cvec);
}

// sums[c] = the sum of partial[0..blocks)[c], added in a fixed order: lane
// l adds rows l, l + kLanes, ... in turn, then lane 0 adds the lanes' sums
// in turn. A block is 32 columns by kLanes lanes.
__global__ void __launch_bounds__(32 * kLanes)
    masked_bn_sum_kernel(const float* __restrict__ partial, int blocks,
                         int width, float* __restrict__ sums) {
  __shared__ float lanes[kLanes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f;
  if (c < width) {
#pragma unroll 8
    for (int b = ty; b < blocks; b += kLanes)
      a = __fadd_rn(a, partial[(size_t)b * width + c]);
  }
  lanes[ty][tx] = a;
  __syncthreads();
  if (ty != 0 || c >= width) return;
  float s = 0.f;
  for (int l = 0; l < kLanes; ++l) s = __fadd_rn(s, lanes[l][tx]);
  sums[c] = s;
}

// The moments from [cnt, s1, s2], as the plain code computes them.
__global__ void masked_bn_moments_kernel(const float* __restrict__ sums,
                                         int C, float eps,
                                         float* __restrict__ stats,
                                         float* __restrict__ cnt_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  float n = sums[0];
  n = n < 1.f ? 1.f : n;
  if (c == 0) *cnt_out = n;
  if (c >= C) return;
  const float mean = __fdiv_rn(sums[1 + c], n);
  const float raw = __fsub_rn(__fdiv_rn(sums[1 + C + c], n),
                              __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;
  stats[c] = mean;
  stats[C + c] = var;
  stats[2 * C + c] = rsqrtf(__fadd_rn(var, eps));
  stats[3 * C + c] = raw >= 0.f ? 1.f : 0.f;
}

// out = relu(where(m, bn(x), 0) + res), each part as the template asks.
template <typename T, int N, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    masked_bn_apply_kernel(const Args p) {
  using V = Vec<T, N>;
  const V* __restrict__ x = (const V*)p.x;
  const V* __restrict__ res = (const V*)p.res;
  V* __restrict__ y = (V*)p.y;
  const bool* __restrict__ mask = p.mask;
  const int cvec = p.C / N;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= cvec) return;
  // float32: mean, rstd, scale, bias; bf16: k and c rounded to bf16
  float c0[N], c1[N], c2[N], c3[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int ch = cv * N + k;
    c0[k] = p.mean[ch];
    c1[k] = p.rstd[ch];
    c2[k] = p.scale[ch];
    c3[k] = p.bias[ch];
    if constexpr (sizeof(T) == 2) {
      const float kk = __fmul_rn(c2[k], c1[k]);
      const float cc = __fsub_rn(c3[k], __fmul_rn(c0[k], kk));
      c0[k] = round_to<T>(kk);
      c1[k] = round_to<T>(cc);
    }
  }
  const int stride = gridDim.x * blockDim.y;
  for (int r = blockIdx.x * blockDim.y + threadIdx.y; r < p.rows;
       r += stride * kUnroll) {
    V xv[kUnroll], rv[kUnroll];
    bool m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * stride;
      m[u] = rr < p.rows && mask[rr];
      if (m[u]) xv[u] = x[(size_t)rr * cvec + cv];
      if (kRes && rr < p.rows) rv[u] = res[(size_t)rr * cvec + cv];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * stride;
      if (rr >= p.rows) break;
      V o;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float v = 0.f;
        if (m[u]) {
          const float f = to_float(xv[u].v[k]);
          if constexpr (sizeof(T) == 2)
            v = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(f, c0[k])),
                                      c1[k]));
          else
            v = __fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(f, c0[k]), c1[k]), c2[k]),
                c3[k]);
        }
        if (kRes) v = round_to<T>(__fadd_rn(v, to_float(rv[u].v[k])));
        if (kRelu) v = relu(v);
        o.v[k] = from_float<T>(v);
      }
      y[(size_t)rr * cvec + cv] = o;
    }
  }
}

// dx = m * rstd * scale * (g - Sg / n - xh * vok * Sgx / n), and
// dres = g.
template <typename T, int N, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    masked_bn_dx_kernel(const Args p) {
  using V = Vec<T, N>;
  const V* __restrict__ x = (const V*)p.x;
  const V* __restrict__ out = (const V*)p.out;
  const V* __restrict__ dy = (const V*)p.dy;
  V* __restrict__ dx = (V*)p.y;
  V* __restrict__ dres = (V*)p.dres;
  const bool* __restrict__ mask = p.mask;
  const int cvec = p.C / N;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= cvec) return;
  const float n = *p.cnt;
  float mean[N], rstd[N], kk[N], a[N], b[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int ch = cv * N + k;
    mean[k] = p.mean[ch];
    rstd[k] = p.rstd[ch];
    kk[k] = __fmul_rn(rstd[k], p.scale[ch]);
    a[k] = __fdiv_rn(p.sums[ch], n);
    b[k] = __fdiv_rn(__fmul_rn(p.sums[p.C + ch], p.vok[ch]), n);
  }
  const int stride = gridDim.x * blockDim.y;
  for (int r = blockIdx.x * blockDim.y + threadIdx.y; r < p.rows;
       r += stride * kUnroll) {
    V xv[kUnroll], ov[kUnroll], gv[kUnroll];
    bool m[kUnroll], need[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * stride;
      m[u] = rr < p.rows && mask[rr];
      need[u] = m[u] || (kRes && rr < p.rows);
      const size_t i = (size_t)rr * cvec + cv;
      if (need[u]) {
        gv[u] = dy[i];
        if (kRelu) ov[u] = out[i];
      }
      if (m[u]) xv[u] = x[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * stride;
      if (rr >= p.rows) break;
      const size_t i = (size_t)rr * cvec + cv;
      V d, e;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float g = need[u] ? gate<kRelu>(to_float(gv[u].v[k]),
                                              kRelu ? to_float(ov[u].v[k])
                                                    : 0.f)
                                : 0.f;
        float v = 0.f;
        if (m[u]) {
          const float xh =
              __fmul_rn(__fsub_rn(to_float(xv[u].v[k]), mean[k]), rstd[k]);
          v = __fmul_rn(kk[k],
                        __fsub_rn(__fsub_rn(g, a[k]), __fmul_rn(xh, b[k])));
        }
        d.v[k] = from_float<T>(v);
        e.v[k] = from_float<T>(g);
      }
      dx[i] = d;
      if (kRes) dres[i] = e;
    }
  }
}

// The widest vector (channels a thread) that divides C, holds at most 16
// bytes, and that every operand's base aligns to.
template <typename T>
int vector_width(const Args& p) {
  int n = 16 / (int)sizeof(T);
  const void* ptrs[] = {p.x, p.out, p.dy, p.res, p.y, p.dres};
  for (;;) {
    bool ok = p.C % n == 0;
    for (const void* q : ptrs)
      if (q && (uintptr_t)q % (n * sizeof(T))) ok = false;
    if (ok || n == 1) return n;
    n /= 2;
  }
}

enum Entry { kStats, kGrad, kApply, kDx };

// One launch of entry E at vector width N (the reductions: the row
// blocks, then masked_bn_sum_kernel into `sums`).
template <typename T, int N, bool kRes, bool kRelu>
cudaError_t launch_n(Entry e, const Args& p, float* sums, cudaStream_t s) {
  Layout l = block_shape(p.C / N);
  const dim3 block(l.tx, l.ty);
  if (e == kStats || e == kGrad) {
    const size_t smem = (size_t)2 * l.ty * l.tx * N * sizeof(float) +
                        l.ty * sizeof(int);
    Args q = p;
    int width;
    if (e == kStats) {
      auto kernel = masked_bn_stats_kernel<T, N>;
      row_blocks(l, p.rows, kernel, smem);
      q.per = l.per;
      kernel<<<dim3(l.blocks, l.chunks), block, smem, s>>>(q);
      width = 2 * p.C + 1;
    } else {
      auto kernel = masked_bn_grad_kernel<T, N, kRelu>;
      row_blocks(l, p.rows, kernel, smem);
      q.per = l.per;
      kernel<<<dim3(l.blocks, l.chunks), block, smem, s>>>(q);
      width = 2 * p.C;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    masked_bn_sum_kernel<<<(width + 31) / 32, dim3(32, kLanes), 0, s>>>(
        p.partial, l.blocks, width, sums);
    return cudaGetLastError();
  }
  if (p.rows == 0) return cudaSuccess;
  if (e == kApply) {
    auto kernel = masked_bn_apply_kernel<T, N, kRes, kRelu>;
    row_blocks(l, p.rows, kernel, 0);
    kernel<<<dim3(l.blocks, l.chunks), block, 0, s>>>(p);
  } else {
    auto kernel = masked_bn_dx_kernel<T, N, kRes, kRelu>;
    row_blocks(l, p.rows, kernel, 0);
    kernel<<<dim3(l.blocks, l.chunks), block, 0, s>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, bool kRes, bool kRelu>
cudaError_t launch_t(Entry e, const Args& p, float* sums, cudaStream_t s) {
  switch (vector_width<T>(p)) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_n<T, 8, kRes, kRelu>(e, p, sums, s);
      return cudaErrorInvalidValue;
    case 4:
      return launch_n<T, 4, kRes, kRelu>(e, p, sums, s);
    case 2:
      return launch_n<T, 2, kRes, kRelu>(e, p, sums, s);
    default:
      return launch_n<T, 1, kRes, kRelu>(e, p, sums, s);
  }
}

template <typename T>
cudaError_t launch_flags(Entry e, const Args& p, bool res, bool relu,
                         float* sums, cudaStream_t s) {
  if (res)
    return relu ? launch_t<T, true, true>(e, p, sums, s)
                : launch_t<T, true, false>(e, p, sums, s);
  return relu ? launch_t<T, false, true>(e, p, sums, s)
              : launch_t<T, false, false>(e, p, sums, s);
}

// dtype codes as ops/batchnorm.py `_CODE`: 0 float32, 1 bf16
cudaError_t launch(int code, Entry e, const Args& p, bool res, bool relu,
                   float* sums, void* stream) {
  if (code < 0 || code > 1 || p.rows < 0 || p.C <= 0 ||
      (unsigned long long)p.rows * p.C >= (1ull << 40))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return code ? launch_flags<bf16>(e, p, res, relu, sums, s)
              : launch_flags<float>(e, p, res, relu, sums, s);
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x [rows, C] (code), mask [rows] bool; partial [kMaxBlocks, 2C + 1]
// float32 scratch; sums [2C + 1] = [count, s1 (C), s2 (C)] over the valid
// rows.
extern "C" int masked_bn_stats(int code, const void* x, const void* mask,
                               int rows, int C, void* partial, void* sums,
                               void* stream) {
  Args p = {};
  p.x = x;
  p.mask = (const bool*)mask;
  p.partial = (float*)partial;
  p.rows = rows;
  p.C = C;
  return (int)launch(code, kStats, p, false, false, (float*)sums, stream);
}

// sums [2C + 1] as masked_bn_stats writes them (summed over a group's
// ranks where there is one); stats [4, C] = mean, var, rstd, vok; cnt [1]
// the count, at least 1.
extern "C" int masked_bn_moments(const void* sums, int C, float eps,
                                 void* stats, void* cnt, void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  masked_bn_moments_kernel<<<(C + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)sums, C, eps, (float*)stats, (float*)cnt);
  return (int)cudaGetLastError();
}

// out [rows, C] (code) from x, the moments (stats as masked_bn_moments
// writes them), scale and bias [C] float32, and residual [rows, C] (code)
// or null; relu 0 or 1.
extern "C" int masked_bn_apply(int code, const void* x, const void* mask,
                               const void* stats, const void* scale,
                               const void* bias, const void* residual,
                               int relu, void* out, int rows, int C,
                               void* stream) {
  Args p = {};
  p.x = x;
  p.mask = (const bool*)mask;
  p.mean = (const float*)stats;
  p.rstd = (const float*)stats + 2 * (size_t)C;
  p.scale = (const float*)scale;
  p.bias = (const float*)bias;
  p.res = residual;
  p.y = out;
  p.rows = rows;
  p.C = C;
  return (int)launch(code, kApply, p, residual != nullptr, relu != 0,
                     nullptr, stream);
}

// The backward's sums over this rank's valid rows: sums [2C] = [sum of g,
// sum of g * xh]; x, out (read where relu) and dy [rows, C] (code);
// partial [kMaxBlocks, 2C] float32 scratch.
extern "C" int masked_bn_grad(int code, const void* x, const void* out,
                              const void* dy, const void* mask,
                              const void* stats, int relu, int rows, int C,
                              void* partial, void* sums, void* stream) {
  Args p = {};
  p.x = x;
  p.out = relu ? out : nullptr;
  p.dy = dy;
  p.mask = (const bool*)mask;
  p.mean = (const float*)stats;
  p.rstd = (const float*)stats + 2 * (size_t)C;
  p.partial = (float*)partial;
  p.rows = rows;
  p.C = C;
  return (int)launch(code, kGrad, p, false, relu != 0, (float*)sums, stream);
}

// dx [rows, C] (code) and, where dres is not null, dres [rows, C] = g;
// sums [2C] the group's sums of masked_bn_grad (this rank's without a
// group), cnt [1] the forward's count.
extern "C" int masked_bn_dx(int code, const void* x, const void* out,
                            const void* dy, const void* mask,
                            const void* stats, const void* scale,
                            const void* sums, const void* cnt, int relu,
                            void* dx, void* dres, int rows, int C,
                            void* stream) {
  Args p = {};
  p.x = x;
  p.out = relu ? out : nullptr;
  p.dy = dy;
  p.mask = (const bool*)mask;
  p.mean = (const float*)stats;
  p.rstd = (const float*)stats + 2 * (size_t)C;
  p.vok = (const float*)stats + 3 * (size_t)C;
  p.scale = (const float*)scale;
  p.sums = (const float*)sums;
  p.cnt = (const float*)cnt;
  p.y = dx;
  p.dres = dres;
  p.rows = rows;
  p.C = C;
  return (int)launch(code, kDx, p, dres != nullptr, relu != 0, nullptr,
                     stream);
}
