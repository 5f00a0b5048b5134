// The transpose conv's parent-row gather and its transpose, on the card.
//
// Replaces no TPU kernel: the JAX package leaves this gather and its
// transpose to XLA (lidiff_tpu/ops/sparse_conv.py:377-431). It was added
// because PyTorch's backward of the gather (`index_put_` with accumulate)
// sorts the indices and walks each run of equal indices in one warp: every
// padding row of a fine level, and every child of a dropped parent, clamps
// to one slot, so hundreds of thousands of zeros were added there in
// series, about 1.1 s of a 2.5 s refiner training step on an H100.
//
// The transpose conv (lidiff_tpu_torch/ops/sparse_conv.py
// `sparse_conv_transpose`) runs one GEMM of all 8 taps per coarse voxel,
// y [Vc, G, 8, Cout] in the compute dtype, and then, for each fine row v
// and group g,
//
//     out[v, g, :] = ok[v] ? y[parent[v], g, tap[v], :] : 0
//
// in the activations' dtype. `transpose_gather_fwd` writes that in one
// pass: the widening of y to the output dtype, the row gather and the
// masks, with no float32 copy of y. `transpose_scatter_bwd` writes its
// transpose, dy in y's dtype: each ok row's cotangent in its own slot
// (parent, g, tap), rounded once to nearest even from 0 + g in float32
// (the sum the plain backward forms in a zeroed buffer), and zeros in
// every other slot, by a memset first. Nothing is read for a masked row.
//
// Precondition: the ok rows have pairwise distinct slots parent * 8 + tap.
// `up_maps` (ops/grid.py) gives that: the valid voxels of a level have
// distinct coordinates, and a child's tap is its coordinates' low bits
// under its parent's, so two children of one parent differ in tap. The
// backward writes each slot with a plain store, with no atomics and no
// sort; two ok rows on one slot would race. It is not checked here.
//
// What bounds it on an H100: bytes. The forward reads the ok rows' slots
// of y and writes out; the backward writes dy (the memset, then the ok
// slots again) and reads the ok rows of the cotangent. At the refiner's
// four up stages dy is 9.14 GB in bf16 and the ok rows about 1.8 GB, so
// the backward's bound is about 3.3 ms a training step at 3.35 TB/s.
// Zeroing dy by a memset and then writing the ok slots moves those slots
// twice; writing every slot once from an inverse slot -> child map moves
// the map instead, and measured slower on an H100 at those shapes (4.04
// against 3.90 ms over the four stages: a memset runs at the full write
// rate, and the ok rows' second write is a quarter of the time at most).
// Each thread moves one vector of up to 16 bytes of its side of the pair
// (8 bf16 or 4 float32 channels of one row and group), neighbouring
// threads on neighbouring channels, so every load and store is a whole
// 16-byte access in a coalesced run; the width drops to 4, 2 or 1 where
// Cout or an operand's alignment does not allow it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 8;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One thread a vector of N channels: i = (v * G + g) * cvec + c, with
// cvec = Cout / N vectors a row and group.
template <typename TI, typename TO, int N>
__global__ void __launch_bounds__(kThreads) transpose_gather_fwd_kernel(
    const TI* __restrict__ y, const int* __restrict__ parent,
    const int* __restrict__ tap, const bool* __restrict__ ok,
    TO* __restrict__ out, unsigned total, unsigned per_row, unsigned cvec,
    unsigned G) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned v = i / per_row;
  const unsigned j = i - v * per_row;
  Vec<TO, N> o;
  if (ok[v]) {
    const unsigned g = j / cvec, c = j - g * cvec;
    const size_t src =
        (((size_t)parent[v] * G + g) * kTaps + (unsigned)tap[v]) * cvec + c;
    const Vec<TI, N> x = reinterpret_cast<const Vec<TI, N>*>(y)[src];
#pragma unroll
    for (int k = 0; k < N; ++k) o.v[k] = from_float<TO>(to_float(x.v[k]));
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) o.v[k] = from_float<TO>(0.f);
  }
  reinterpret_cast<Vec<TO, N>*>(out)[i] = o;
}

// The transpose: each ok row's vector into its slot of dy (zeroed before).
template <typename TG, typename TD, int N>
__global__ void __launch_bounds__(kThreads) transpose_scatter_bwd_kernel(
    const TG* __restrict__ grad, const int* __restrict__ parent,
    const int* __restrict__ tap, const bool* __restrict__ ok,
    TD* __restrict__ dy, unsigned total, unsigned per_row, unsigned cvec,
    unsigned G) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned v = i / per_row;
  if (!ok[v]) return;
  const unsigned j = i - v * per_row;
  const unsigned g = j / cvec, c = j - g * cvec;
  const Vec<TG, N> x = reinterpret_cast<const Vec<TG, N>*>(grad)[i];
  Vec<TD, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k)
    o.v[k] = from_float<TD>(0.f + to_float(x.v[k]));   // -0 -> +0
  const size_t dst =
      (((size_t)parent[v] * G + g) * kTaps + (unsigned)tap[v]) * cvec + c;
  reinterpret_cast<Vec<TD, N>*>(dy)[dst] = o;
}

// The widest vector (channels a thread) that divides cout, holds at most
// 16 bytes of the narrower operand, and that both operands' bases align
// to.
int vector_width(int cout, size_t narrow_bytes, const void* a,
                 size_t a_bytes, const void* b, size_t b_bytes) {
  int n = (int)(16 / narrow_bytes);
  while (n > 1 && (cout % n || (uintptr_t)a % (n * a_bytes) ||
                   (uintptr_t)b % (n * b_bytes)))
    n /= 2;
  return n;
}

// fwd: src = y, dst = out. bwd: src = grad, dst = dy.
template <bool kFwd, typename TS, typename TD, int N>
cudaError_t launch_n(const void* src, const int* parent, const int* tap,
                     const bool* ok, void* dst, int rows, int G, int cout,
                     cudaStream_t s) {
  const unsigned cvec = (unsigned)(cout / N);
  const unsigned per_row = (unsigned)G * cvec;
  const unsigned total = (unsigned)rows * per_row;
  const unsigned blocks = (total - 1) / kThreads + 1;   // total > 0
  if constexpr (kFwd)
    transpose_gather_fwd_kernel<TS, TD, N><<<blocks, kThreads, 0, s>>>(
        (const TS*)src, parent, tap, ok, (TD*)dst, total, per_row, cvec,
        (unsigned)G);
  else
    transpose_scatter_bwd_kernel<TS, TD, N><<<blocks, kThreads, 0, s>>>(
        (const TS*)src, parent, tap, ok, (TD*)dst, total, per_row, cvec,
        (unsigned)G);
  return cudaGetLastError();
}

template <bool kFwd, typename TS, typename TD>
cudaError_t launch(const void* src, const int* parent, const int* tap,
                   const bool* ok, void* dst, int rows, int G, int cout,
                   cudaStream_t s) {
  const size_t narrow = sizeof(TS) < sizeof(TD) ? sizeof(TS) : sizeof(TD);
  switch (vector_width(cout, narrow, src, sizeof(TS), dst, sizeof(TD))) {
    case 8:
      return launch_n<kFwd, TS, TD, 8>(src, parent, tap, ok, dst, rows, G,
                                       cout, s);
    case 4:
      return launch_n<kFwd, TS, TD, 4>(src, parent, tap, ok, dst, rows, G,
                                       cout, s);
    case 2:
      return launch_n<kFwd, TS, TD, 2>(src, parent, tap, ok, dst, rows, G,
                                       cout, s);
    default:
      return launch_n<kFwd, TS, TD, 1>(src, parent, tap, ok, dst, rows, G,
                                       cout, s);
  }
}

// dtype codes as ops/sparse_conv.py `_DTYPE_CODE`: 0 float32, 1 bf16
template <bool kFwd>
cudaError_t dispatch(int src_code, int dst_code, const void* src,
                     const void* parent, const void* tap, const void* ok,
                     void* dst, int rows, int G, int cout, void* stream) {
  if (rows < 0 || G <= 0 || cout <= 0 || src_code < 0 || src_code > 1 ||
      dst_code < 0 || dst_code > 1 ||
      (unsigned long long)rows * G * cout >= (1ull << 32))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)parent;
  const int* t = (const int*)tap;
  const bool* m = (const bool*)ok;
  using bf16 = __nv_bfloat16;
  switch (src_code * 2 + dst_code) {
    case 0:
      return launch<kFwd, float, float>(src, p, t, m, dst, rows, G, cout, s);
    case 1:
      return launch<kFwd, float, bf16>(src, p, t, m, dst, rows, G, cout, s);
    case 2:
      return launch<kFwd, bf16, float>(src, p, t, m, dst, rows, G, cout, s);
    default:
      return launch<kFwd, bf16, bf16>(src, p, t, m, dst, rows, G, cout, s);
  }
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// y [Vc, G, 8, cout] (code y_code), parent/tap [rows] int32, ok [rows]
// bool, out [rows, G * cout] (code out_code). Rows with ok false are
// written as zeros and their parent and tap are not read.
extern "C" int transpose_gather_fwd(int y_code, int out_code, const void* y,
                                    const void* parent, const void* tap,
                                    const void* ok, void* out, int rows,
                                    int G, int cout, void* stream) {
  return (int)dispatch<true>(y_code, out_code, y, parent, tap, ok, out, rows,
                             G, cout, stream);
}

// grad [rows, G * cout] (code grad_code), dy [Vc, G, 8, cout] (code
// dy_code): dy is zeroed, then each ok row's cotangent goes to its slot.
// The ok rows' slots must be pairwise distinct.
extern "C" int transpose_scatter_bwd(int grad_code, int dy_code,
                                     const void* grad, const void* parent,
                                     const void* tap, const void* ok,
                                     void* dy, int rows, int vc, int G,
                                     int cout, void* stream) {
  if (vc < 0 || G <= 0 || cout <= 0 || dy_code < 0 || dy_code > 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)vc * G * kTaps * cout * (dy_code ? 2 : 4);
  cudaError_t err = cudaMemsetAsync(dy, 0, bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch<false>(grad_code, dy_code, grad, parent, tap, ok, dy,
                              rows, G, cout, stream);
}
