// Kernel F1: farthest-point sampling of one cloud on the card.
//
// Replaces the host C++ kernel lidiff_fps
// (lidiff_tpu/native/src/lidiff_native.cpp:54) that the JAX package's
// pipeline calls (lidiff_tpu/ops/fps.py:34-38), and computes exactly
// lidiff_tpu_torch/ops/fps.py fps_numpy: start at index 0; d[i] is the
// float32 squared distance of point i to the picks so far, each
// (dx*dx + dy*dy) + dz*dz rounded once per operation (__fsub_rn,
// __fmul_rn, __fadd_rn: nothing contracts into an FMA); each pick is the
// first index of the largest d.
//
// One launch for the whole sampling: one cluster of up to 16 blocks of
// 1024 threads (16 needs cudaFuncAttributeNonPortableClusterSizeAllowed;
// 8 where no 16 fit), block b owning points [b*per, (b+1)*per). A block
// keeps its points and their d in shared memory as float4 (x, y, z, d):
// 16 bytes a point, 120 KB a block at N = 120k over 16 blocks; a slice
// that does not fit is read from global memory (L2) instead. A round
// lowers d over the slice and reduces it to one 64-bit key: the float bits
// of d above (for d >= 0 they order as unsigned integers), 0xffffffff - i
// below, so the largest key is the largest d at its first index. Thread 0
// puts the block's key and that point's coordinates in a slot of shared
// memory; one cluster barrier a round publishes the slots (two of them,
// by the round's parity, so a slot is rewritten only after every block
// has passed the next barrier and read it), and every block reads all of
// them through distributed shared memory and takes the same winner. Ties
// across blocks resolve like ties inside one: to the smallest index.
//
// What bounds it on an H100: neither bytes nor operations. A round does 9
// operations a point (19.4 GFLOP for 18k picks of 120k points: 0.29 ms at
// the float32 peak) and touches no device memory; the k - 1 rounds depend
// on each other, so the time is k - 1 times a round's latency: its share
// of the slice, two block barriers, one cluster barrier and the reads of
// the other blocks' slots: about 2.6 us a round on an H100, where a
// launch a pick would pay a launch's latency for each. A thread keeps its
// best d and index in 32-bit registers over its points and forms the
// 64-bit key once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024 - 1024;   // dynamic, beside the statics

struct Cand {
  unsigned long long key;
  float x, y, z, pad;
};

__device__ __forceinline__ unsigned long long make_key(float d, int i) {
  return ((unsigned long long)__float_as_uint(d) << 32) |
         (unsigned long long)(0xffffffffu - (unsigned)i);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float px,
                                         float py, float pz) {
  const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py),
              dz = __fsub_rn(z, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// kSmem: the block's slice lives in shared memory (float4 x, y, z, d);
// else its points are read from pts and its d from dg (global scratch).
template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster(const float* __restrict__ pts, int n, int k, int per,
            float* __restrict__ dg, long long* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int lo = rank * per;
  const int m = max(min(n - lo, per), 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 sp[];
  __shared__ Cand slot[2];
  __shared__ unsigned long long warp_key[kWarps];
  __shared__ float4 pick;             // the last pick's x, y, z

  for (int i = tid; i < m; i += kThreads) {
    const float* q = pts + 3ll * (lo + i);
    if (kSmem)
      sp[i] = make_float4(q[0], q[1], q[2], __int_as_float(0x7f800000));
    else
      dg[lo + i] = __int_as_float(0x7f800000);
  }
  if (tid == 0) pick = make_float4(pts[0], pts[1], pts[2], 0.f);
  if (rank == 0 && tid == 0) out[0] = 0;
  __syncthreads();

  for (int r = 1; r < k; ++r) {
    const float px = pick.x, py = pick.y, pz = pick.z;
    // a thread's largest d and its first index (its i ascend), in 32-bit
    // registers; the 64-bit key is formed once, after the loop
    float best_d = -1.f;
    int best_i = 0;
    for (int i = tid; i < m; i += kThreads) {
      float x, y, z, d;
      if (kSmem) {
        const float4 q = sp[i];
        x = q.x; y = q.y; z = q.z; d = q.w;
      } else {
        const float* q = pts + 3ll * (lo + i);
        x = q[0]; y = q[1]; z = q[2]; d = dg[lo + i];
      }
      const float di = fminf(d, sq_dist(x, y, z, px, py, pz));
      if (kSmem) sp[i].w = di; else dg[lo + i] = di;
      if (di > best_d) { best_d = di; best_i = i; }
    }
    unsigned long long key =
        best_d < 0.f ? 0ull : make_key(best_d, lo + best_i);
    for (int o = 16; o > 0; o >>= 1)
      key = key_max(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (lane == 0) warp_key[warp] = key;
    __syncthreads();
    const int par = r & 1;
    if (warp == 0) {
      key = warp_key[lane];
      for (int o = 16; o > 0; o >>= 1)
        key = key_max(key, __shfl_xor_sync(0xffffffffu, key, o));
      if (lane == 0) {
        Cand c{key, 0.f, 0.f, 0.f, 0.f};
        if (m > 0) {                  // key 0 (no point) loses to any point
          const int j = key_index(key) - lo;
          if (kSmem) {
            c.x = sp[j].x; c.y = sp[j].y; c.z = sp[j].z;
          } else {
            const float* q = pts + 3ll * (lo + j);
            c.x = q[0]; c.y = q[1]; c.z = q[2];
          }
        }
        slot[par] = c;
      }
    }
    cluster.sync();                   // every block's slot[par] is written
    if (warp == 0) {
      Cand c{0ull, 0.f, 0.f, 0.f, 0.f};
      if (lane < csize) c = *cluster.map_shared_rank(&slot[par], lane);
      unsigned long long best = c.key;
      for (int o = 16; o > 0; o >>= 1)
        best = key_max(best, __shfl_xor_sync(0xffffffffu, best, o));
      const unsigned who = __ballot_sync(0xffffffffu, c.key == best);
      if (lane == __ffs(who) - 1) {   // the one block whose key won
        pick = make_float4(c.x, c.y, c.z, 0.f);
        if (rank == 0) out[r] = key_index(best);
      }
    }
    __syncthreads();                  // pick is the new point
  }
  cluster.sync();   // no block leaves while another may read its slots
}

template <bool kSmem>
cudaError_t launch(int csize, size_t smem, const float* pts, int n, int k,
                   int per, float* dg, long long* out, cudaStream_t s,
                   bool probe_only, int* fits) {
  auto kernel = fps_cluster<kSmem>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (probe_only)
    return cudaOccupancyMaxActiveClusters(fits, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, pts, n, k, per, dg, out);
}

cudaError_t run(int csize, const float* pts, int n, int k, float* dg,
                long long* out, cudaStream_t s, bool probe_only, int* fits) {
  const int per = (n + csize - 1) / csize;
  const size_t smem = (size_t)per * sizeof(float4);
  if (smem <= (size_t)kMaxSmem)
    return launch<true>(csize, smem, pts, n, k, per, dg, out, s, probe_only,
                        fits);
  return launch<false>(csize, 0, pts, n, k, per, dg, out, s, probe_only,
                       fits);
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// pts [n, 3] float32 (finite); d [n] float32 scratch (used where a block's
// slice does not fit shared memory); out [k] int64, 1 <= k < n. *cluster
// is the largest cluster size to try (16, or 8 to test the smaller
// cluster); the size taken (16 or 8) goes back to it.
extern "C" int fps(const void* pts, int n, int k, void* d, void* out,
                   int* cluster, void* stream) {
  if (n <= 0 || k <= 0 || k >= n || (*cluster != 16 && *cluster != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int sizes[2] = {16, 8};
  for (int csize : sizes) {
    if (csize > *cluster) continue;
    int fits = 0;
    cudaError_t err = run(csize, (const float*)pts, n, k, (float*)d,
                          (long long*)out, s, true, &fits);
    if (err != cudaSuccess) {
      cudaGetLastError();             // clear it, try the smaller cluster
      continue;
    }
    if (fits < 1) continue;
    *cluster = csize;
    err = run(csize, (const float*)pts, n, k, (float*)d, (long long*)out, s,
              false, &fits);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  return (int)cudaErrorInvalidConfiguration;
}
