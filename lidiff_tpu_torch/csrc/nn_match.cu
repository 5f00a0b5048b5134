// Kernel C1: batched 1-NN over integer voxel coordinates.
//
// Replaces the TPU kernel nn_match_idx_pallas on its full grid
// (lidiff_tpu/ops/pallas_knn.py:289, body _make_kernel :78), and computes
// the XLA path lidiff_tpu/ops/knn.py:42-65: for each query, the argmin over
// same-batch valid refs of d = |r|^2 - 2 q.r, ties to the first index; no
// valid ref in the batch item gives index 0.
//
// d is exact in int32: |c| <= 2047 keeps |r|^2 and |2 q.r| below 2^31.
// Updates happen on strictly-less, which keeps the first index on ties.
//
// What bounds it on an H100: operations. Each (query, ref) pair costs three
// multiply-adds, a subtraction and a compare on the CUDA cores; at the
// sampling point (180096 queries x 11264 refs) that is ~2e9 pairs per call.
// Design: one thread per query, refs staged through shared memory in tiles
// that every thread of the block reads as broadcasts, so the inner loop has
// no global traffic. The TPU's exact block pruning (pallas_knn.py:31-44)
// is left for later work: this kernel scans every ref.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;

__global__ void __launch_bounds__(kThreads)
nn_match_kernel(const int4* __restrict__ q, int Vq,
                const int4* __restrict__ r,
                const unsigned char* __restrict__ r_mask, int Vr,
                int batched, int* __restrict__ out) {
  // ref x, y, z, |r|^2, and the batch id (-1 for an invalid ref)
  __shared__ int4 s_r[kTile];
  __shared__ int s_b[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  int4 qc = make_int4(0, 0, 0, 0);
  if (i < Vq) qc = q[i];          // (batch, x, y, z)
  int best = INT_MAX;
  int best_idx = 0;

  for (int base = 0; base < Vr; base += kTile) {
    const int n = min(kTile, Vr - base);
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int4 rc = r[base + k];
      const int sq = rc.y * rc.y + rc.z * rc.z + rc.w * rc.w;
      s_r[k] = make_int4(rc.y, rc.z, rc.w, sq);
      s_b[k] = r_mask[base + k] ? rc.x : -1;
    }
    __syncthreads();
    if (batched) {
      for (int k = 0; k < n; ++k) {
        if (s_b[k] != qc.x) continue;
        const int4 rr = s_r[k];
        const int d = rr.w - 2 * (qc.y * rr.x + qc.z * rr.y + qc.w * rr.z);
        if (d < best) { best = d; best_idx = base + k; }
      }
    } else {
      for (int k = 0; k < n; ++k) {
        if (s_b[k] < 0) continue;
        const int4 rr = s_r[k];
        const int d = rr.w - 2 * (qc.y * rr.x + qc.z * rr.y + qc.w * rr.z);
        if (d < best) { best = d; best_idx = base + k; }
      }
    }
    __syncthreads();
  }
  if (i < Vq) out[i] = best_idx;
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [Vq, 4] int32, r [Vr, 4] int32, r_mask [Vr] bool -> out [Vq] int32.
// batched == 0 drops the batch compare (all items are batch 0).
extern "C" int nn_match(const void* q, int Vq, const void* r,
                        const void* r_mask, int Vr, int batched, void* out,
                        void* stream) {
  const unsigned blocks = (unsigned)((Vq + kThreads - 1) / kThreads);
  nn_match_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)q, Vq, (const int4*)r, (const unsigned char*)r_mask, Vr,
      batched, (int*)out);
  return (int)cudaGetLastError();
}
