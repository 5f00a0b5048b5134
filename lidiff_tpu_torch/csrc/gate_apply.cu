// The eval-mode conditioning gate's apply step, on the card.
//
// Replaces no TPU kernel: the JAX package gates every voxel through the
// gate's MLPs, as XLA code (lidiff_tpu/models/minkunet.py `StageGate`). In
// eval mode a gate's value depends only on the bank row the voxel's 1-NN
// match picked, its batch item and the step's timestep, so the port
// evaluates the MLPs once per (item, bank row) pair into a table
// (lidiff_tpu_torch/models/minkunet.py `StageGate.apply_table`) and this
// kernel applies it: for each row v and group g of feats [V, G * C],
//
//     w = mask[v] ? table[item(v) * n_bank + rows[v, g], :] : 0
//     out[v, g * C + c] = feats[v, g * C + c] * w[c]
//
// with item(v) = coords[v, 0], the product taken in float32 and rounded
// once to the feats' dtype (nearest even), as PyTorch's `feats * w` is.
// A masked row's product is feats * 0 (so -0 where feats is negative, as
// the plain version gives); its item and rows are not read. A valid row's
// item must lie in [0, table_rows / n_bank) and its rows in [0, n_bank):
// they index the table unchecked (C1 returns a bank row of the item's
// bank, and the voxels' items are those of the batch).
//
// What bounds it on an H100: bytes. It reads feats and writes out (2 C
// bytes a row and group each in bf16), and reads a row's int32 item and
// G int32 bank rows and its mask byte; the table (B * n_bank rows, at most
// 8.3 MB at the sampling path's widest gate) stays in the 50 MB L2. Each
// thread moves one vector of up to 16 bytes (8 bf16 or 4 float32 channels
// of one row and group), neighbouring threads on neighbouring channels, so
// the loads and stores of feats, out and the table row are whole 16-byte
// accesses in coalesced runs; the threads of one row and group read the
// same item, bank row and mask, which the hardware broadcasts. The width
// drops to 4, 2 or 1 where C or an operand's alignment does not allow it.
// No atomics, no synchronisation, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
// cvec = C / N vectors a row and group.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) gate_apply_kernel(
    const T* __restrict__ feats, const T* __restrict__ table,
    const int* __restrict__ rows, const int* __restrict__ coords,
    const bool* __restrict__ mask, T* __restrict__ out, unsigned total,
    unsigned cvec, unsigned G, unsigned n_bank) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned vg = i / cvec;               // v * G + g
  const unsigned c = i - vg * cvec;
  const unsigned v = vg / G;
  const Vec<T, N> f = reinterpret_cast<const Vec<T, N>*>(feats)[i];
  Vec<T, N> o;
  if (mask[v]) {
    const size_t r = (size_t)(unsigned)coords[(size_t)v * 4] * n_bank +
                     (unsigned)rows[vg];
    const Vec<T, N> w =
        reinterpret_cast<const Vec<T, N>*>(table)[r * cvec + c];
#pragma unroll
    for (int k = 0; k < N; ++k)
      o.v[k] = from_float<T>(to_float(f.v[k]) * to_float(w.v[k]));
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      o.v[k] = from_float<T>(to_float(f.v[k]) * 0.f);
  }
  reinterpret_cast<Vec<T, N>*>(out)[i] = o;
}

// The widest vector (channels a thread) that divides C, holds at most 16
// bytes, and that every vector operand's base aligns to.
template <typename T>
int vector_width(int C, const void* feats, const void* table,
                 const void* out) {
  int n = (int)(16 / sizeof(T));
  while (n > 1 && (C % n || (uintptr_t)feats % (n * sizeof(T)) ||
                   (uintptr_t)table % (n * sizeof(T)) ||
                   (uintptr_t)out % (n * sizeof(T))))
    n /= 2;
  return n;
}

template <typename T, int N>
cudaError_t launch_n(const void* feats, const void* table, const int* rows,
                     const int* coords, const bool* mask, void* out, int V,
                     int G, int C, int n_bank, cudaStream_t s) {
  const unsigned cvec = (unsigned)(C / N);
  const unsigned total = (unsigned)V * G * cvec;
  const unsigned blocks = (total - 1) / kThreads + 1;   // total > 0
  gate_apply_kernel<T, N><<<blocks, kThreads, 0, s>>>(
      (const T*)feats, (const T*)table, rows, coords, mask, (T*)out, total,
      cvec, (unsigned)G, (unsigned)n_bank);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* feats, const void* table, const int* rows,
                   const int* coords, const bool* mask, void* out, int V,
                   int G, int C, int n_bank, cudaStream_t s) {
  switch (vector_width<T>(C, feats, table, out)) {
    case 8:
      return launch_n<T, 8>(feats, table, rows, coords, mask, out, V, G, C,
                            n_bank, s);
    case 4:
      return launch_n<T, 4>(feats, table, rows, coords, mask, out, V, G, C,
                            n_bank, s);
    case 2:
      return launch_n<T, 2>(feats, table, rows, coords, mask, out, V, G, C,
                            n_bank, s);
    default:
      return launch_n<T, 1>(feats, table, rows, coords, mask, out, V, G, C,
                            n_bank, s);
  }
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// code 0 float32, 1 bf16 (feats, table and out alike). feats, out [V,
// G * C]; table [table_rows, C]; rows [V, G] int32; coords [V, 4] int32
// (the item in column 0); mask [V] bool.
extern "C" int gate_apply(int code, const void* feats, const void* table,
                          const void* rows, const void* coords,
                          const void* mask, void* out, int V, int G, int C,
                          int n_bank, void* stream) {
  if (V < 0 || G <= 0 || C <= 0 || n_bank <= 0 || code < 0 || code > 1 ||
      (unsigned long long)V * G * C >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  if (V == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* r = (const int*)rows;
  const int* c = (const int*)coords;
  const bool* m = (const bool*)mask;
  if (code == 0)
    return (int)launch<float>(feats, table, r, c, m, out, V, G, C, n_bank,
                              s);
  return (int)launch<__nv_bfloat16>(feats, table, r, c, m, out, V, G, C,
                                    n_bank, s);
}
