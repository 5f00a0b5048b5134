// Kernel C2: batched 1-NN over integer voxel coordinates for the grid
// chamfer's large matches, tiles of queries searching a grid index of the
// reference rows together.
//
// Replaces the TPU kernel nn_match_idx_pallas on its compact grid
// (lidiff_tpu/ops/pallas_knn.py:403, body _make_kernel_compact :138-195)
// and, with it, the bit-masked pruned grid (:366) and the XLA prolog
// _prune_mask (:198-284) that found the ref blocks both visit. It computes
// the XLA path lidiff_tpu/ops/knn.py:42-65 on every valid query, as kernel
// C1 (nn_match.cu) does: the argmin over same-batch valid refs of
// |q - r|^2, ties to the lowest row; no valid ref in the item gives index
// 0. Queries that are not searched (invalid, or of an item out of range)
// get 0.
//
// The index (lidiff_tpu_torch/ops/knn.py `build_tile_index`) is C1's
// layout built without a host read: the valid rows sorted by uniform cubic
// cells per batch item, each row as (x, y, z, its row), a cell's rows in
// ascending row order, the first row of every cell; the grid (corner, cell
// edge, cells per axis, items) is read here from a small device array.
//
// One warp owns one tile of 32 queries, taken in the order the caller
// gives (`tile_order`: by index cell, so a tile is a few neighbouring
// cells; in lex order it would be a slab one x wide and long in y). For
// each batch item and cell x among its searched queries, in ascending
// order (a tile that runs from one cell x into the next would otherwise
// take a box as long as the grid in y), the warp takes the box of their
// cells and visits the index cells in shells of growing Chebyshev radius r
// around it: the box grown by r less the box grown by r - 1, both cut to
// the grid (the first shell is the first radius that reaches the grid). A shell is a set of (x, y) columns, each
// one run of cells along z or two where it crosses the inner box, and a
// run is contiguous in the index. The lanes find 32 columns' runs at a
// time, a warp scan lays them end to end, and the warp stages their rows
// through shared memory 256 at a time; every lane reads each staged row (a
// broadcast) against its own query and keeps the lexicographic minimum of
// (|q - r|^2, row). After shell r every unvisited row lies outside the box
// grown by r, so at least m away, m the least gap from the query to a side
// of that box with grid cells beyond it; a query is done once m^2 > best
// (strictly: an equal distance can still be a lower row) or no cell is
// left, and the warp stops when all of the group's queries are done. Every
// distance is an exact integer: |c| <= 2047 keeps |q - r|^2 < 2^31.
//
// What bounds it on an H100: the work depends on the data. Without the
// index a query would meet every ref (3 multiply-adds, a subtract and a
// compare per pair on the CUDA cores); the tiles cut that to the rows of
// the few shells around them (the rows each tile staged are counted and
// returned). What is left moves the queries, their order and mask, the
// index and the output once; the index rows a tile stages come from L2.
// A warp needs no block barrier, so a tile that needs more shells holds
// back no other tile.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kWarps = 4;      // tiles per block
constexpr int kChunk = 256;    // rows staged per pass of a warp
constexpr int kRuns = 64;      // runs per round: two for each of 32 columns
constexpr int kFar = 1 << 20;  // a gap beyond every grid: no cell that side
constexpr unsigned kAll = 0xffffffffu;

struct Grid {
  int lox, loy, loz;   // corner of cell (0, 0, 0)
  int cell;            // cell edge
  int nx, ny, nz;      // cells per axis
  int items;           // batch items
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Cells from the range [c0, c1] to the range [0, n), one branch per side
// (nvcc 12.8 miscompiled this as a nested maximum in kernel C1).
__device__ __forceinline__ int cells_outside(int c0, int c1, int n) {
  if (c1 < 0) return 0 - c1;
  if (c0 >= n) return c0 - (n - 1);
  return 0;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0)) ? q - 1 : q;
}

// the least gap from coordinate v (in a cell of [b0, b1] on this axis) to
// a cell outside [b0 - r, b1 + r]; kFar where the grid has none
__device__ __forceinline__ int axis_gap(int v, int lo, int cell, int n,
                                        int b0, int b1, int r) {
  int m = kFar;
  if (b0 - r - 1 >= 0) m = imin(m, v - (lo + (b0 - r) * cell) + 1);
  if (b1 + r + 1 <= n - 1) m = imin(m, lo + (b1 + r + 1) * cell - v);
  return m;
}

__global__ void __launch_bounds__(kWarps * 32)
nn_match_tiled_kernel(const int4* __restrict__ q,
                      const unsigned char* __restrict__ q_mask, int Vq,
                      const int* __restrict__ order,
                      const int4* __restrict__ pts,
                      const int* __restrict__ cell_start,
                      const int* __restrict__ geo, int batched,
                      int* __restrict__ out, int* __restrict__ staged_out) {
  __shared__ int4 s_rows[kWarps][kChunk];
  __shared__ int s_first[kWarps][kRuns];   // the run's first index row
  __shared__ int s_off[kWarps][kRuns];     // its place in the round's rows

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + w;
  if (tile * 32 >= Vq) return;             // a whole warp; no block barrier
  const Grid g{__ldg(geo + 0), __ldg(geo + 1), __ldg(geo + 2), __ldg(geo + 3),
               __ldg(geo + 4), __ldg(geo + 5), __ldg(geo + 6), __ldg(geo + 7)};
  const int ncell = g.nx * g.ny * g.nz;

  const int i = tile * 32 + lane;
  const int qi = i < Vq ? order[i] : -1;
  int4 qc = make_int4(0, 0, 0, 0);
  bool live = false;
  if (qi >= 0) {
    qc = q[qi];                            // (batch, x, y, z)
    if (!batched) qc.x = 0;
    live = q_mask[qi] != 0 && qc.x >= 0 && qc.x < g.items;
  }
  const int cx = floor_div(qc.y - g.lox, g.cell);
  const int cy = floor_div(qc.z - g.loy, g.cell);
  const int cz = floor_div(qc.w - g.loz, g.cell);
  int best_d = INT_MAX, best_i = INT_MAX, staged = 0;

  unsigned pending = __ballot_sync(kAll, live);
  while (pending != 0u) {
    // the lowest (item, cell x) among the queries not yet searched
    const bool waiting = (pending >> lane) & 1u;
    const int item = __reduce_min_sync(kAll, waiting ? qc.x : INT_MAX);
    const bool of_item = waiting && qc.x == item;
    const int gx = __reduce_min_sync(kAll, of_item ? cx : INT_MAX);
    const bool mine = of_item && cx == gx;
    pending &= ~__ballot_sync(kAll, mine);
    const int* start = cell_start + (long long)item * ncell;
    if (start[ncell] == start[0]) continue;   // no valid ref: index 0

    // the box of their cells, and the first radius that reaches the grid
    const int bx0 = gx, bx1 = gx;
    const int by0 = __reduce_min_sync(kAll, mine ? cy : INT_MAX);
    const int bz0 = __reduce_min_sync(kAll, mine ? cz : INT_MAX);
    const int by1 = __reduce_max_sync(kAll, mine ? cy : INT_MIN);
    const int bz1 = __reduce_max_sync(kAll, mine ? cz : INT_MIN);
    const int r0 = imax(imax(cells_outside(bx0, bx1, g.nx),
                             cells_outside(by0, by1, g.ny)),
                        cells_outside(bz0, bz1, g.nz));
    for (int r = r0;; ++r) {
      // the box grown by r (a), and by r - 1 (b, none at the first radius)
      const int ax0 = imax(bx0 - r, 0), ax1 = imin(bx1 + r, g.nx - 1);
      const int ay0 = imax(by0 - r, 0), ay1 = imin(by1 + r, g.ny - 1);
      const int az0 = imax(bz0 - r, 0), az1 = imin(bz1 + r, g.nz - 1);
      const bool inner = r > r0;
      const int ix0 = imax(bx0 - r + 1, 0), ix1 = imin(bx1 + r - 1, g.nx - 1);
      const int iy0 = imax(by0 - r + 1, 0), iy1 = imin(by1 + r - 1, g.ny - 1);
      const int iz0 = imax(bz0 - r + 1, 0), iz1 = imin(bz1 + r - 1, g.nz - 1);
      const int wy = ay1 - ay0 + 1;
      const int ncols = (ax1 - ax0 + 1) * wy;
      for (int c0 = 0; c0 < ncols; c0 += 32) {
        // this lane's column: one run of cells along z, or two around the
        // inner box; [s, e) rows of the index each
        int s0 = 0, e0 = 0, s1 = 0, e1 = 0;
        const int j = c0 + lane;
        if (j < ncols) {
          const int x = ax0 + j / wy, y = ay0 + j % wy;
          const int col = (x * g.ny + y) * g.nz;
          if (inner && x >= ix0 && x <= ix1 && y >= iy0 && y <= iy1) {
            if (iz0 > az0) { s0 = start[col + az0]; e0 = start[col + iz0]; }
            if (iz1 < az1) { s1 = start[col + iz1 + 1]; e1 = start[col + az1 + 1]; }
          } else {
            s0 = start[col + az0];
            e0 = start[col + az1 + 1];
          }
        }
        const int n0 = e0 - s0, n = n0 + e1 - s1;
        int incl = n;                       // warp scan of the lengths
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(kAll, incl, d);
          if (lane >= d) incl += t;
        }
        const int total = __shfl_sync(kAll, incl, 31);
        __syncwarp();                       // the last round's reads are done
        s_first[w][2 * lane] = s0;
        s_off[w][2 * lane] = incl - n;
        s_first[w][2 * lane + 1] = s1;
        s_off[w][2 * lane + 1] = incl - n + n0;
        staged += total;
        __syncwarp();
        for (int p0 = 0; p0 < total; p0 += kChunk) {
          const int cnt = imin(kChunk, total - p0);
          // every lane finds its rows' runs first, then issues all of its
          // loads together
          int src[kChunk / 32];
#pragma unroll
          for (int u = 0; u < kChunk / 32; ++u) {
            // the last run that starts at or before row p of the round
            const int p = p0 + u * 32 + lane;
            int lo = 0;
#pragma unroll
            for (int step = kRuns / 2; step > 0; step >>= 1)
              if (s_off[w][lo + step] <= p) lo += step;
            src[u] = s_first[w][lo] + p - s_off[w][lo];
          }
#pragma unroll
          for (int u = 0; u < kChunk / 32; ++u)
            if (u * 32 + lane < cnt) s_rows[w][u * 32 + lane] = pts[src[u]];
          __syncwarp();
          if (mine) {
            for (int k = 0; k < cnt; ++k) {
              const int4 rr = s_rows[w][k];
              const int dx = rr.x - qc.y, dy = rr.y - qc.z, dz = rr.z - qc.w;
              const int d = dx * dx + dy * dy + dz * dz;
              if (d < best_d || (d == best_d && rr.w < best_i)) {
                best_d = d;
                best_i = rr.w;
              }
            }
          }
          __syncwarp();
        }
      }
      // done: no unvisited cell is as near as the best row
      bool done = true;
      if (mine) {
        const int m = imin(imin(
            axis_gap(qc.y, g.lox, g.cell, g.nx, bx0, bx1, r),
            axis_gap(qc.z, g.loy, g.cell, g.ny, by0, by1, r)),
            axis_gap(qc.w, g.loz, g.cell, g.nz, bz0, bz1, r));
        done = m == kFar || (long long)m * m > (long long)best_d;
      }
      if (__all_sync(kAll, done)) break;
    }
  }
  if (qi >= 0) out[qi] = (live && best_i != INT_MAX) ? best_i : 0;
  if (lane == 0) staged_out[tile] = staged;
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [Vq, 4] int32, q_mask [Vq] bool, order [Vq] int32 (a permutation of
// the queries: tile t is order[32 t, 32 t + 32)); the index: pts [n, 4]
// int32 (x, y, z, row), cell_start [cells + 1] int32, geo [8] int32 (lo x,
// y, z, cell, nx, ny, nz, items); batched == 0 puts every query in item 0.
// out [Vq] int32; staged [ceil(Vq / 32)] int32: the index rows each tile
// staged.
extern "C" int nn_match_tiled(const void* q, const void* q_mask, int Vq,
                              const void* order, const void* pts,
                              const void* cell_start, const void* geo,
                              int batched, void* out, void* staged,
                              void* stream) {
  const int tiles = (Vq + 31) / 32;
  const unsigned blocks = (unsigned)((tiles + kWarps - 1) / kWarps);
  nn_match_tiled_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int4*)q, (const unsigned char*)q_mask, Vq, (const int*)order,
      (const int4*)pts, (const int*)cell_start, (const int*)geo, batched,
      (int*)out, (int*)staged);
  return (int)cudaGetLastError();
}
