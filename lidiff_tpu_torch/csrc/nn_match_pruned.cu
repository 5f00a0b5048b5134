// Kernel C2: batched 1-NN over integer voxel coordinates, each tile of
// queries scanning only an interval of reference rows; and the kernel that
// finds the distance bound the intervals are derived from.
//
// Replaces the TPU kernel nn_match_idx_pallas on its compact grid
// (lidiff_tpu/ops/pallas_knn.py:403, body _make_kernel_compact :138-195) and,
// with it, the bit-masked full grid of the same function (:366): both visit
// the ref blocks that the key-gap bound of _prune_mask (:198-284) cannot
// rule out. It computes the XLA path lidiff_tpu/ops/knn.py:42-65 exactly as
// kernel C1 (nn_match.cu) does: per query the argmin over same-batch valid
// refs of d = |r|^2 - 2 q.r, ties to the first index, index 0 without a
// valid ref; the caller's intervals only leave out rows that are provably no
// argmin (lidiff_tpu_torch/ops/knn.py prune_intervals).
//
// What differs from the TPU kernel, by design:
//   * The TPU grid is static, (query tiles, MAXB ref blocks), so an interval
//     longer than MAXB needs a second, bit-masked full-grid kernel behind a
//     lax.cond. Here a block loops over its own interval, however long: one
//     kernel, no budget, no fallback.
//   * The TPU tiles (512 queries x 2048 refs) follow the MXU and VMEM. Here
//     a block is 256 threads, one query each, and refs pass through shared
//     memory 512 rows at a time; the 256-query tile makes the intervals
//     tighter than a 512-query tile would.
//   * The TPU kernel packs distance, lane group and an offset into one f32-
//     exact word because its MXU computes in f32. Here d is exact in int32
//     (|c| <= 2047 keeps |r|^2 and |2 q.r| below 2^31), and updates on
//     strictly-less in ascending row order keep the first index on ties.
//
// What bounds it on an H100: operations, as C1: three multiply-adds, a
// subtraction and a compare per (query, ref) pair on the CUDA cores, with no
// global traffic in the inner loop (every thread reads the staged ref as a
// broadcast). The design's answer is to do fewer pairs: at the chamfer's
// shape (1.08M x 360k) the intervals keep a small share of them.
//
// nn_window_bound is the prolog's only heavy step (the TPU package leaves it
// to XLA as a [tiles, T, U] einsum): per query tile, the largest over its
// valid queries of the exact squared distance to the nearest valid
// same-batch ref inside a window of rows.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;   // = QTILE of ops/knn.py
constexpr int kTile = 512;      // refs staged per pass

// ref x, y, z, |r|^2 into s_r and the batch id (-1 for an invalid ref) into
// s_b, for rows [base, base + n)
__device__ __forceinline__ void stage_refs(const int4* __restrict__ r,
                                           const unsigned char* __restrict__ m,
                                           int base, int n, int4* s_r,
                                           int* s_b) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int4 rc = r[base + k];
    const int sq = rc.y * rc.y + rc.z * rc.z + rc.w * rc.w;
    s_r[k] = make_int4(rc.y, rc.z, rc.w, sq);
    s_b[k] = m[base + k] ? rc.x : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
nn_match_pruned_kernel(const int4* __restrict__ q, int Vq,
                       const int4* __restrict__ r,
                       const unsigned char* __restrict__ r_mask, int Vr,
                       const int* __restrict__ start,
                       const int* __restrict__ cnt, int batched,
                       int* __restrict__ out) {
  __shared__ int4 s_r[kTile];
  __shared__ int s_b[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  int4 qc = make_int4(0, 0, 0, 0);
  if (i < Vq) qc = q[i];          // (batch, x, y, z)
  int best = INT_MAX;
  int best_idx = 0;
  const int lo = max(start[blockIdx.x], 0);
  const int hi = min(lo + cnt[blockIdx.x], Vr);

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    stage_refs(r, r_mask, base, n, s_r, s_b);
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

__global__ void __launch_bounds__(kThreads)
nn_window_bound_kernel(const int4* __restrict__ q,
                       const unsigned char* __restrict__ q_mask, int Vq,
                       const int4* __restrict__ r,
                       const unsigned char* __restrict__ r_mask, int Vr,
                       const int* __restrict__ win_start, int window,
                       int batched, int* __restrict__ out) {
  __shared__ int4 s_r[kTile];
  __shared__ int s_b[kTile];
  __shared__ int s_max[kThreads / 32];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < Vq && q_mask[i];
  int4 qc = make_int4(0, 0, 0, 0);
  if (i < Vq) qc = q[i];
  // |q - r|^2 = |q|^2 + (|r|^2 - 2 q.r); at most 3 * 4094^2 < 2^31
  const int qsq = qc.y * qc.y + qc.z * qc.z + qc.w * qc.w;
  int best = INT_MAX;
  const int lo = min(max(win_start[blockIdx.x], 0), Vr);
  const int hi = min(lo + window, Vr);

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    stage_refs(r, r_mask, base, n, s_r, s_b);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if (batched ? s_b[k] != qc.x : s_b[k] < 0) continue;
      const int4 rr = s_r[k];
      const int d = rr.w - 2 * (qc.y * rr.x + qc.z * rr.y + qc.w * rr.z);
      best = min(best, d);
    }
    __syncthreads();
  }
  // INT_MAX: no valid ref in the window (no bound); invalid queries give 0
  int u2 = valid ? (best == INT_MAX ? INT_MAX : best + qsq) : 0;
  u2 = __reduce_max_sync(0xffffffffu, u2);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = u2;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = s_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, s_max[w]);
    out[blockIdx.x] = m;
  }
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [Vq, 4] int32, r [Vr, 4] int32, r_mask [Vr] bool, start and cnt
// [ceil(Vq / 256)] int32 (rows) -> out [Vq] int32. batched == 0 drops the
// batch compare (all items are batch 0).
extern "C" int nn_match_pruned(const void* q, int Vq, const void* r,
                               const void* r_mask, int Vr, const void* start,
                               const void* cnt, int batched, void* out,
                               void* stream) {
  const unsigned blocks = (unsigned)((Vq + kThreads - 1) / kThreads);
  nn_match_pruned_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)q, Vq, (const int4*)r, (const unsigned char*)r_mask, Vr,
      (const int*)start, (const int*)cnt, batched, (int*)out);
  return (int)cudaGetLastError();
}

// As above plus q_mask [Vq] bool and win_start [ceil(Vq / 256)] int32 ->
// out [ceil(Vq / 256)] int32: per query tile the largest squared distance
// from a valid query to its nearest valid same-batch ref among the rows
// [win_start, win_start + window); INT_MAX where a valid query has none.
extern "C" int nn_window_bound(const void* q, const void* q_mask, int Vq,
                               const void* r, const void* r_mask, int Vr,
                               const void* win_start, int window, int batched,
                               void* out, void* stream) {
  const unsigned blocks = (unsigned)((Vq + kThreads - 1) / kThreads);
  nn_window_bound_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)q, (const unsigned char*)q_mask, Vq, (const int4*)r,
      (const unsigned char*)r_mask, Vr, (const int*)win_start, window,
      batched, (int*)out);
  return (int)cudaGetLastError();
}
