// Kernel B1: the 27-tap column kernel map of one voxel pyramid level.
//
// Replaces the TPU kernel build_kmap3_columns_pallas
// (lidiff_tpu/ops/pallas_kmap.py:120, body _make_kernel :50), and computes
// exactly lidiff_tpu/ops/grid.py:309-354 build_kmap3_columns.
//
// For voxel v and column (dx, dy), the query is the int64 key of
// (b, x + dx*s, y + dy*s, z - s). col_idx = lower bound of the query in the
// sorted level keys (clamped to V-1); the three z-taps hit when the keys at
// p, p+m0, p+m0+m1 equal q, q+s, q+2s. A query out of the coordinate range,
// or a padding row, packs to PAD_KEY and never hits (q_valid & mask).
//
// What bounds it on an H100: memory. Each (voxel, column) thread does one
// ~18-probe binary search over at most 1.4 MB of keys, which stay in L2;
// the output (9 int32 + 27 bytes per voxel) is written once, coalesced.
// The TPU needed windowed compares because its per-probe row gathers were
// slow; a GPU thread walks the search in L2/L1 directly, so there is no
// window and no window overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCoordOff = 2048;
constexpr int kCoordSpan = 4096;
constexpr long long kPadKey = (0x7fffffffLL << 32) | 0x7fffffffLL;

__device__ __forceinline__ bool in_range(int c) {
  return c >= -kCoordOff && c <= kCoordOff - 1;
}

__global__ void kmap3_columns_kernel(const long long* __restrict__ keys,
                                     const int* __restrict__ coords,
                                     const unsigned char* __restrict__ mask,
                                     int V, int s, int* __restrict__ col_idx,
                                     unsigned char* __restrict__ hit) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * 9) return;
  const int v = (int)(t / 9);
  const int col = (int)(t % 9);
  const int dx = col / 3 - 1;
  const int dy = col % 3 - 1;

  const int b = coords[4 * v + 0];
  const int x = coords[4 * v + 1] + dx * s;
  const int y = coords[4 * v + 2] + dy * s;
  const int z = coords[4 * v + 3] - s;
  const bool q_valid = in_range(x) && in_range(y) && in_range(z);
  const bool m = mask[v] != 0;

  long long q = kPadKey;
  if (m && q_valid) {
    const long long hi = (long long)b * kCoordSpan + (x + kCoordOff);
    const long long lo = (long long)(y + kCoordOff) * kCoordSpan + (z + kCoordOff);
    q = (hi << 32) | lo;
  }

  // lower bound of q in keys[0, V)
  int lo_b = 0, hi_b = V;
  while (lo_b < hi_b) {
    const int mid = (lo_b + hi_b) >> 1;
    if (keys[mid] < q) lo_b = mid + 1; else hi_b = mid;
  }
  const int p = min(lo_b, V - 1);
  const bool m0 = (keys[p] == q) && q_valid;
  const int p1 = min(p + (int)m0, V - 1);
  const bool m1 = keys[p1] == q + s;
  const int p2 = min(p1 + (int)m1, V - 1);
  const bool m2 = keys[p2] == q + 2LL * s;
  const bool ok = m && q_valid;

  col_idx[9 * v + col] = p;
  unsigned char* h = hit + 27 * v + 3 * col;
  h[0] = (unsigned char)(m0 && ok);
  h[1] = (unsigned char)(m1 && ok);
  h[2] = (unsigned char)(m2 && ok);
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys [V] int64 sorted, coords [V, 4] int32, mask [V] bool;
// col_idx [V, 9] int32 and hit [V, 27] bool are written.
extern "C" int kmap3_columns(const void* keys, const void* coords,
                             const void* mask, int V, int s, void* col_idx,
                             void* hit, void* stream) {
  const int threads = 256;
  const long long n = (long long)V * 9;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  kmap3_columns_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const int*)coords, (const unsigned char*)mask,
      V, s, (int*)col_idx, (unsigned char*)hit);
  return (int)cudaGetLastError();
}
