// Kernel B1: the 27-tap column kernel map of one voxel pyramid level, and
// the sort key of the column conv's tile plan.
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
// A block owns 128 consecutive voxels, one thread each. Their keys are
// sorted and every in-range query of a column is its voxel's key plus one
// constant, so a column's queries are sorted too: the first and last voxel
// whose query is in range bound them (found by a ballot per column). The
// block first finds its nine windows of keys: the lower bounds of each
// column's first query and of its last one plus 2s (two rows more for the
// z-taps), and that of PAD_KEY, 19 searches at once, each by a group of six
// lanes that probe six rows a step (a 7-ary search: 7 steps at V = 180k,
// where a binary search takes 18 dependent loads). It stages the windows
// into shared memory, a warp per column, and every thread searches its
// nine queries there (a window that does not fit is searched where it
// lies). A thread keeps its 27 hits in a register and writes col_idx and
// hit through shared memory, so the stores coalesce, and writes the tile
// plan's sort key: the 27-bit hit pattern (bit 3 col + k), or 1 << 27
// where no tap hits (ops/grid.py `plan_keys`).
//
// kmap3_tile_taps takes that key sorted (the plan's order) and ORs each 64
// of its patterns: the taps of each tile of the plan, one warp a tile.
//
// What bounds it on an H100: memory. The level's keys (at most 1.4 MB)
// stay in L2; each voxel's key, coords and mask are read once and its
// col_idx, hit and plan key written once. The old kernel ran one ~18-probe
// search of the whole level per (voxel, column), neighbours repeating each
// other's probes; here 19 short searches serve a block, and its threads
// search windows of about a block's keys in shared memory. What is left is
// latency (a block's window searches are 7 dependent loads before its
// staging) and the issue of the nine searches a thread makes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVox = 128;      // voxels per block, one thread each
constexpr int kWarps = kVox / 32;
constexpr int kPool = 2048;    // keys staged per block, all nine columns
constexpr int kSearches = 19;  // per block: 9 columns x 2 ends, then PAD
constexpr int kLanes = 6;      // lanes of a search: probes per step
constexpr int kNoTap = 1 << 27;
constexpr int kCoordOff = 2048;
constexpr int kCoordSpan = 4096;
constexpr long long kPadKey = (0x7fffffffLL << 32) | 0x7fffffffLL;

__device__ __forceinline__ bool in_range(int c) {
  return c >= -kCoordOff && c <= kCoordOff - 1;
}

// the query of column col for voxel (b, x, y, z) at stride s, and whether
// its coordinates are in range
__device__ __forceinline__ bool column_query(int4 c, int col, int s,
                                             long long& q) {
  const int x = c.y + (col / 3 - 1) * s;
  const int y = c.z + (col % 3 - 1) * s;
  const int z = c.w - s;
  if (!(in_range(x) && in_range(y) && in_range(z))) return false;
  const long long hi = (long long)c.x * kCoordSpan + (x + kCoordOff);
  const long long lo = (long long)(y + kCoordOff) * kCoordSpan + (z + kCoordOff);
  q = (hi << 32) | lo;
  return true;
}

// lower bound of q in keys[0, V), by the six lanes j = 0..5 of a group
// that starts at bit `first` of the warp; every lane of the warp calls it
// (`live` false: no search, returns 0). A step probes the rows lo +
// (j + 1) len / 7, and the count of probes below q picks the seventh of
// [lo, hi) that holds the bound.
__device__ __forceinline__ int group_lower_bound(
    const long long* __restrict__ keys, int V, long long q, bool live,
    int j, int first) {
  int lo = 0, hi = live ? V : 0;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int len = hi - lo;
    const bool below = lo < hi && keys[lo + (j + 1) * len / 7] < q;
    const unsigned mask = __ballot_sync(0xffffffffu, below);
    const int c = __popc((mask >> first) & ((1u << kLanes) - 1));
    if (lo < hi) {
      const int next_hi = c < kLanes ? lo + (c + 1) * len / 7 : hi;
      if (c > 0) lo = lo + c * len / 7 + 1;
      hi = next_hi;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kVox)
kmap3_columns_kernel(const long long* __restrict__ keys,
                     const int4* __restrict__ coords,
                     const unsigned char* __restrict__ mask, int V, int s,
                     int* __restrict__ col_idx, unsigned char* __restrict__ hit,
                     int* __restrict__ plan_key) {
  __shared__ long long s_keys[kPool];
  __shared__ int s_col[kVox * 9];
  __shared__ __align__(4) unsigned char s_hit[kVox * 27];
  __shared__ int4 s_c[kVox];
  __shared__ unsigned s_ok[9][kWarps];   // per column, a ballot per warp
  __shared__ int s_bnd[kSearches];
  __shared__ int s_win[9][3];            // window: first row, end, pool slot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * kVox, v = v0 + tid;
  const int n = min(kVox, V - v0);
  int4 c = make_int4(0, 0, 0, 0);
  bool m = false;
  if (v < V) {
    c = coords[v];
    m = mask[v] != 0;
  }
  s_c[tid] = c;
#pragma unroll
  for (int col = 0; col < 9; ++col) {
    long long q;
    const unsigned ok = __ballot_sync(0xffffffffu,
                                      m && column_query(c, col, s, q));
    if (lane == 0) s_ok[col][warp] = ok;
  }
  __syncthreads();
  {
    // search g = 2 col + side of the block's nine windows, 18 the PAD
    // bound: five groups of six lanes a warp
    const int grp = lane / kLanes, j = lane % kLanes, g = warp * 5 + grp;
    const bool mine = lane < 5 * kLanes && g < kSearches;
    long long q = kPadKey;
    bool live = mine;
    if (mine && g < 18) {
      // the first (side 0) or last (side 1) voxel whose query is in range
      const int col = g >> 1, side = g & 1;
      int t = -1;
      for (int k = 0; k < kWarps; ++k) {
        const int w = side ? kWarps - 1 - k : k;
        const unsigned ok = s_ok[col][w];
        if (ok) {
          t = w * 32 + (side ? 31 - __clz(ok) : __ffs(ok) - 1);
          break;
        }
      }
      live = t >= 0 && column_query(s_c[t], col, s, q);
      if (side) q += 2LL * s + 1;
    }
    const int b = group_lower_bound(keys, V, q, live, j, grp * kLanes);
    if (mine && j == 0)
      s_bnd[g] = g == 18 ? min(b, V - 1) : live ? b : -1;
  }
  __syncthreads();
  if (tid == 0) {
    const int* b = s_bnd;
    int used = 0;
    for (int col = 0; col < 9; ++col) {
      // from row V - 1 at the latest: a lower bound of V is clamped there
      const int lo = min(b[2 * col], V - 1), hi = min(b[2 * col + 1] + 3, V);
      int slot = -1;
      if (lo >= 0 && used + (hi - lo) <= kPool) {
        slot = used;
        used += hi - lo;
      }
      s_win[col][0] = lo;
      s_win[col][1] = hi;
      s_win[col][2] = slot;
    }
  }
  __syncthreads();
  const int pad = s_bnd[18];
  // a warp stages columns warp, warp + 4, ...
  for (int col = warp; col < 9; col += kWarps) {
    const int lo = s_win[col][0], len = s_win[col][1] - lo, slot = s_win[col][2];
    if (slot < 0) continue;
#pragma unroll 4
    for (int i = lane; i < len; i += 32) s_keys[slot + i] = keys[lo + i];
  }
  __syncthreads();

  unsigned bits = 0;
#pragma unroll
  for (int col = 0; col < 9; ++col) {
    int p = pad;
    long long q = 0;
    if (m && column_query(c, col, s, q)) {
      // every key this query reads lies in its column's window: staged
      // (in shared memory from row lo) or not
      const int lo = s_win[col][0], hi = s_win[col][1], slot = s_win[col][2];
      auto search = [&](auto key) {
        int a = lo, len = hi - lo;
        while (len > 0) {
          const int half = len >> 1;
          if (key(a + half) < q) { a += half + 1; len -= half + 1; }
          else len = half;
        }
        p = min(a, V - 1);
        const bool m0 = key(p) == q;
        const int p1 = min(p + (int)m0, V - 1);
        const bool m1 = key(p1) == q + s;
        const int p2 = min(p1 + (int)m1, V - 1);
        const bool m2 = key(p2) == q + 2LL * s;
        bits |= ((unsigned)m0 | (unsigned)m1 << 1 | (unsigned)m2 << 2)
                << (3 * col);
      };
      if (slot >= 0) {
        const long long* staged = s_keys + slot;
        search([&](int i) { return staged[i - lo]; });
      } else {
        search([&](int i) { return keys[i]; });
      }
    }
    s_col[tid * 9 + col] = p;
  }
#pragma unroll
  for (int k = 0; k < 27; ++k) s_hit[tid * 27 + k] = (bits >> k) & 1u;
  if (v < V) plan_key[v] = bits ? (int)bits : kNoTap;
  __syncthreads();
  for (int i = tid; i < n * 9; i += kVox) col_idx[v0 * 9 + i] = s_col[i];
  // 27 * 128 bytes a block: whole words but in the ragged last block
  const int words = n * 27 / 4;
  for (int i = tid; i < words; i += kVox)
    reinterpret_cast<unsigned*>(hit + (size_t)v0 * 27)[i] =
        reinterpret_cast<const unsigned*>(s_hit)[i];
  for (int i = words * 4 + tid; i < n * 27; i += kVox)
    hit[(size_t)v0 * 27 + i] = s_hit[i];
}

__global__ void kmap3_tile_taps_kernel(const int* __restrict__ sorted_key,
                                       int V, int* __restrict__ taps) {
  const int t = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (t * 64 >= V) return;                  // a whole warp
  int a = 0;
  for (int i = t * 64 + lane; i < min(t * 64 + 64, V); i += 32)
    a |= sorted_key[i] & (kNoTap - 1);
  a = __reduce_or_sync(0xffffffffu, a);
  if (lane == 0) taps[t] = a;
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys [V] int64 sorted, coords [V, 4] int32, mask [V] bool; col_idx
// [V, 9] int32, hit [V, 27] bool and plan_key [V] int32 are written.
extern "C" int kmap3_columns(const void* keys, const void* coords,
                             const void* mask, int V, int s, void* col_idx,
                             void* hit, void* plan_key, void* stream) {
  const int blocks = (V + kVox - 1) / kVox;
  kmap3_columns_kernel<<<blocks, kVox, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const int4*)coords, (const unsigned char*)mask,
      V, s, (int*)col_idx, (unsigned char*)hit, (int*)plan_key);
  return (int)cudaGetLastError();
}

// sorted_key [V] int32 (plan keys in plan order) -> taps [ceil(V / 64)]
// int32: the OR of the 27-bit patterns of each 64 consecutive rows.
extern "C" int kmap3_tile_taps(const void* sorted_key, int V, void* taps,
                               void* stream) {
  const int tiles = (V + 63) / 64;
  const unsigned blocks = (unsigned)((tiles + 7) / 8);
  kmap3_tile_taps_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)sorted_key, V, (int*)taps);
  return (int)cudaGetLastError();
}
