// Kernel C1: batched 1-NN over integer voxel coordinates, searched in a
// grid index of the reference rows.
//
// Replaces the TPU kernel nn_match_idx_pallas on its full grid
// (lidiff_tpu/ops/pallas_knn.py:289, body _make_kernel :78), and computes
// the XLA path lidiff_tpu/ops/knn.py:42-65 on every valid query: the argmin
// over same-batch valid refs of |r|^2 - 2 q.r, ties to the first index; no
// valid ref in the batch item gives index 0. Invalid queries get 0.
//
// The index (lidiff_tpu_torch/ops/knn.py `build_nn_index`) holds the valid
// rows sorted by uniform cubic cells per batch item, each row as (x, y, z,
// its row in the bank), a cell's rows in ascending row order, and the first
// row of every cell. The bank of one completion does not change over its
// solver steps, so the index is built once (`VoxelGeom.nn_index`).
//
// One thread per query. It visits the cells in shells of growing Chebyshev
// radius r around its own cell (which may lie outside the grid: the search
// starts at the first radius that reaches the grid), each shell cut to the
// grid, and keeps the lexicographic minimum of (|q - r|^2, row): cells are
// not visited in row order. |q - r|^2 ranks as |r|^2 - 2 q.r and ties
// where it does. After shell r, every unvisited row lies outside the cube
// of radius r, so at least m away, m the least gap from q to that cube's
// faces that still have grid cells beyond them; the search stops once
// m^2 > best (strictly: an equal distance can still be a lower row) or no
// cell is left. A query far from the bank therefore ends, at worst, in a
// scan of the rest of its item. Every distance is an exact integer:
// |c| <= 2047 keeps |q - r|^2 <= 3 * 4094^2 < 2^31.
//
// A bank whose items share one voxel (the uncond bank: zeros, one voxel
// per item) comes out of the same cell rule as one cell per item: the
// kernel then scans the item's rows, and its wrapper counts those
// launches apart (`_nn_kernel.scans`).
//
// What bounds it on an H100: the work depends on the data. A full scan
// would cost 3 multiply-adds, a subtract and a compare per (query, valid
// ref) pair on the CUDA cores; the index cuts that to the rows of a few
// dozen cells per query (the pairs examined are counted when asked for).
// What is left moves the queries (16 B), the index and the output (4 B)
// once, tens of microseconds at most; the index lookups hit L1/L2.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

struct Grid {
  int lox, loy, loz;   // corner of cell (0, 0, 0)
  int cell;            // cell edge
  int nx, ny, nz;      // cells per axis
  int items;           // batch items
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Cells from index c to the range [0, n), one branch per side. Written as
// one nested maximum over (-cx, cx - (nx - 1), ..., 0), the first radius
// came out wrong from nvcc 12.8 at -O3 and -O0 alike (6 for a query in
// cell (1, 4, 6) of an 8^3 grid, where the host build gives 0); branches,
// a sum of abs() or PTX max.s32 give the right value.
__device__ __forceinline__ int cells_outside(int c, int n) {
  if (c < 0) return 0 - c;
  if (c >= n) return c - (n - 1);
  return 0;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0)) ? q - 1 : q;
}

__device__ __forceinline__ void visit_cell(const int4* __restrict__ pts,
                                           const int* __restrict__ start,
                                           int cell, int qx, int qy, int qz,
                                           int& best_d, int& best_i,
                                           int& pairs) {
  const int s = start[cell], e = start[cell + 1];
  pairs += e - s;
  for (int p = s; p < e; ++p) {
    const int4 r = pts[p];
    const int dx = r.x - qx, dy = r.y - qy, dz = r.z - qz;
    const int d = dx * dx + dy * dy + dz * dz;
    if (d < best_d || (d == best_d && r.w < best_i)) {
      best_d = d;
      best_i = r.w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nn_match_kernel(const int4* __restrict__ q,
                const unsigned char* __restrict__ q_mask, int Vq,
                const int4* __restrict__ pts,
                const int* __restrict__ cell_start, Grid g, int batched,
                int* __restrict__ out, int* __restrict__ pairs_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= Vq) return;
  int best_d = INT_MAX, best_i = INT_MAX, pairs = 0;
  const int4 qc = q[i];   // (batch, x, y, z)
  const int b = batched ? qc.x : 0;
  const int ncell = g.nx * g.ny * g.nz;
  const int* start = cell_start + (long long)b * ncell;
  const bool live = (q_mask == nullptr || q_mask[i] != 0) && b >= 0 &&
                    b < g.items && start[ncell] > start[0];
  if (live) {
    const int cx = floor_div(qc.y - g.lox, g.cell);
    const int cy = floor_div(qc.z - g.loy, g.cell);
    const int cz = floor_div(qc.w - g.loz, g.cell);
    // the first radius whose cube reaches the grid on every axis
    int r = imax(imax(cells_outside(cx, g.nx), cells_outside(cy, g.ny)),
                 cells_outside(cz, g.nz));
    for (;; ++r) {
      const int x0 = imax(cx - r, 0), x1 = imin(cx + r, g.nx - 1);
      const int y0 = imax(cy - r, 0), y1 = imin(cy + r, g.ny - 1);
      for (int x = x0; x <= x1; ++x) {
        const bool xface = x == cx - r || x == cx + r;
        for (int y = y0; y <= y1; ++y) {
          const int col = (x * g.ny + y) * g.nz;
          if (xface || y == cy - r || y == cy + r) {
            const int z0 = imax(cz - r, 0), z1 = imin(cz + r, g.nz - 1);
            for (int z = z0; z <= z1; ++z)
              visit_cell(pts, start, col + z, qc.y, qc.z, qc.w, best_d,
                         best_i, pairs);
          } else {   // inside the shell's x and y faces: its two z faces
            if (cz - r >= 0 && cz - r < g.nz)
              visit_cell(pts, start, col + cz - r, qc.y, qc.z, qc.w, best_d,
                         best_i, pairs);
            if (cz + r >= 0 && cz + r < g.nz)
              visit_cell(pts, start, col + cz + r, qc.y, qc.z, qc.w, best_d,
                         best_i, pairs);
          }
        }
      }
      // least gap to a cell outside the cube of radius r
      int m = INT_MAX;
      if (cx - r - 1 >= 0)
        m = imin(m, qc.y - (g.lox + (cx - r) * g.cell) + 1);
      if (cx + r + 1 < g.nx)
        m = imin(m, g.lox + (cx + r + 1) * g.cell - qc.y);
      if (cy - r - 1 >= 0)
        m = imin(m, qc.z - (g.loy + (cy - r) * g.cell) + 1);
      if (cy + r + 1 < g.ny)
        m = imin(m, g.loy + (cy + r + 1) * g.cell - qc.z);
      if (cz - r - 1 >= 0)
        m = imin(m, qc.w - (g.loz + (cz - r) * g.cell) + 1);
      if (cz + r + 1 < g.nz)
        m = imin(m, g.loz + (cz + r + 1) * g.cell - qc.w);
      if (m == INT_MAX) break;                           // no cell left
      if ((long long)m * m > (long long)best_d) break;   // none can tie
    }
  }
  out[i] = best_i == INT_MAX ? 0 : best_i;
  if (pairs_out != nullptr) pairs_out[i] = pairs;
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [Vq, 4] int32, q_mask [Vq] bool or null (all valid); the index: pts
// [n, 4] int32 (x, y, z, row), cell_start [items * nx * ny * nz + 1] int32,
// the grid's corner, cell edge and cells per axis; batched == 0 puts every
// query in item 0. out [Vq] int32; pairs [Vq] int32 or null: the rows each
// query examined.
extern "C" int nn_match(const void* q, const void* q_mask, int Vq,
                        const void* pts, const void* cell_start, int lox,
                        int loy, int loz, int cell, int nx, int ny, int nz,
                        int items, int batched, void* out, void* pairs,
                        void* stream) {
  if (cell <= 0 || nx <= 0 || ny <= 0 || nz <= 0 || items <= 0)
    return (int)cudaErrorInvalidValue;
  const Grid g{lox, loy, loz, cell, nx, ny, nz, items};
  const unsigned blocks = (unsigned)((Vq + kThreads - 1) / kThreads);
  nn_match_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)q, (const unsigned char*)q_mask, Vq, (const int4*)pts,
      (const int*)cell_start, g, batched, (int*)out, (int*)pairs);
  return (int)cudaGetLastError();
}
