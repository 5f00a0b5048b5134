// Kernel A3: the weight gradient of the 27-tap column convolution.
//
// Replaces the TPU kernel conv_columns_pallas_dw_v2
// (lidiff_tpu/ops/pallas_conv.py:568, body _make_dw_kernel_v2 :492). It
// computes, for tap k = 3 * col + j of column col,
//   dW[k, c, co] = sum_o sum_g hit(o, k) * f_g[row(o, k), c] * gm_g[o, co]
// where row(o, k) is the z-tap's feats row (p, p+m0, p+m0+m1 for j = 0, 1,
// 2, with p = col_idx[o, col] and m0/m1/m2 the column's hits), gm is the
// cotangent with the rows outside out_mask zeroed, and the G groups share
// the weights, so their contributions add. Products accumulate in float32
// and dW is float32 whatever the input type.
//
// What bounds it on an H100: it reads feats, the cotangent and the map once
// (tens of MB) and does 2 * (hit taps) * C * Co * G FLOP; at the fine
// levels, where a voxel has about one neighbour, the bytes bound it, at the
// coarse wide levels the tensor-core rate. A block that rereads a 512-byte
// cotangent row for 64 x 256 products per row would run at about 51
// FLOP/byte, under the card's ridge of about 295: the design has to win
// reuse of the cotangent rows.
//
// bf16 (the training path): the forward's tile plan (ops/grid.py
// `tile_plan`) sorts the rows by hit pattern into 64-row tiles and gives
// each tile the OR of its rows' taps. The schedule (ops/sparse_conv.py
// `dw_schedule`) cuts each tap's list of active tiles into chunks of about
// equal work and orders the chunks by their first tile. A block takes one
// chunk and 128 channels of C and the whole output width (Co <= 256, in
// 64-channel blocks; the wrapper splits wider Co): per tile of its chunk
// and group, a producer warpgroup gathers the tile's feats rows at the
// chunk's tap (16-byte cp.async, zero-filled where a row misses the tap or
// is masked) and its cotangent rows in plan order into a ring of
// 128-byte-swizzled stages; two consumer warpgroups, 64 channels of C
// each, run wgmma with both operands MN-major (a stage holds 64 rows of
// channels: the gathered feats are A^T, the cotangent B), accumulating the
// 64 x Co tile in float32 registers over the chunk. Blocks run in launch
// order, so the blocks in flight share tiles across taps and channel
// blocks, and may reread the cotangent rows from L2 (on the card a stage
// still fills at about a third of A1's rate; PERF.md). Each block
// writes its chunk's [C, Co] float32 partial once; a second pass adds the
// partials of each tap in chunk order, so the sum over rows is
// deterministic, with no atomics.
//
// float32 (the small card-against-CPU training checks only) keeps the
// first design's CUDA-core kernel: a block owns one tap, one 64x64 tile of
// its [C, Co] matrix and one slice of the rows, walks its slice 32 rows at
// a time (a stage in which no row hits the tap is skipped), and adds its
// tile into the zeroed dW with float32 atomicAdd, so the order of its sum
// over rows changes from run to run. Rows at or past nvalid are never read.
//
// No DMA window: every hit tap is read.

#include "conv3_columns_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kTC = 64;     // input channels (rows of the dW tile) per block
constexpr int kTN = 64;     // output channels per block
constexpr int kRows = 32;   // voxel rows per shared-memory stage
constexpr int kTargetBlocks = 3072; // row slices are cut to reach about this

// The stage set-up: rows[r] is the feats row of the tap
// for output row m0 + r, or -1 on a miss, a masked row or a row past the
// slice; *any_hit whether any row of the stage hits.
__device__ __forceinline__ void stage_rows(
    const int* __restrict__ col_idx, const unsigned char* __restrict__ hit,
    const unsigned char* __restrict__ out_mask, int m0, int r_end, int col,
    int j, int* rows, int* any_hit) {
  const int tid = threadIdx.x;
  __syncthreads();  // the previous stage is done with rows[] and the tiles
  if (tid == 0) *any_hit = 0;
  __syncthreads();
  if (tid < kRows) {
    const int v = m0 + tid;
    int r = -1;
    if (v < r_end && out_mask[v] != 0) {
      const unsigned char* h = hit + (long long)v * 27 + 3 * col;
      if (h[j] != 0) {
        r = col_idx[(long long)v * 9 + col];
        if (j >= 1) r += h[0] != 0;
        if (j >= 2) r += h[1] != 0;
      }
    }
    rows[tid] = r;
    if (r >= 0) *any_hit = 1;  // benign race: every writer stores 1
  }
  __syncthreads();
}

__device__ __forceinline__ int slice_end(const int* nvalid, int V,
                                         int r_begin, int rows_per_slice) {
  int r_end = r_begin + rows_per_slice;
  if (r_end > V) r_end = V;
  const int nv = *nvalid;
  return r_end < nv ? r_end : nv;
}

__global__ void __launch_bounds__(kThreads)
conv3_columns_dw_kernel(const float* __restrict__ feats,
                        const float* __restrict__ g,
                        const int* __restrict__ col_idx,
                        const unsigned char* __restrict__ hit,
                        const unsigned char* __restrict__ out_mask,
                        const int* __restrict__ nvalid,
                        float* __restrict__ dw, int V, int C, int Co, int G,
                        int n_cotiles, int rows_per_slice) {
  __shared__ float As[kRows][kTC + 4];
  __shared__ float Bs[kRows][kTN + 4];
  __shared__ int rows[kRows];
  __shared__ int any_hit;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int tap = blockIdx.z;
  const int col = tap / 3;
  const int j = tap % 3;
  const int c0 = (blockIdx.y / n_cotiles) * kTC;
  const int n0 = (blockIdx.y % n_cotiles) * kTN;
  const long long GC = (long long)G * C;
  const long long GCo = (long long)G * Co;
  const int r_begin = blockIdx.x * rows_per_slice;
  const int r_end = slice_end(nvalid, V, r_begin, rows_per_slice);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  bool found = false;

  for (int m0 = r_begin; m0 < r_end; m0 += kRows) {
    stage_rows(col_idx, hit, out_mask, m0, r_end, col, j, rows, &any_hit);
    if (!any_hit) continue;  // no row of the stage hits this tap
    found = true;
    for (int gi = 0; gi < G; ++gi) {
      if (gi > 0) __syncthreads();  // the previous group is done
      for (int e = tid; e < kRows * kTC; e += kThreads) {
        const int c = e % kTC;
        const int r = e / kTC;
        const int row = rows[r];
        As[r][c] = (row >= 0 && c0 + c < C)
                       ? feats[row * GC + gi * C + c0 + c] : 0.f;
      }
      for (int e = tid; e < kRows * kTN; e += kThreads) {
        const int n = e % kTN;
        const int r = e / kTN;
        Bs[r][n] = (rows[r] >= 0 && n0 + n < Co)
                       ? g[(m0 + r) * GCo + gi * Co + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b[jj] = Bs[kk][tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      }
    }
  }

  if (!found) return;
  float* out = dw + (long long)tap * C * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < Co) atomicAdd(out + (long long)c * Co + n, acc[i][jj]);
    }
  }
}

void launch_dw_f32(const void* feats, const void* g, const void* col_idx,
                   const void* hit, const void* out_mask, const void* nvalid,
                   void* dw, int V, int C, int Co, int G,
                   cudaStream_t stream) {
  const int n_ctiles = (C + kTC - 1) / kTC;
  const int n_cotiles = (Co + kTN - 1) / kTN;
  const int tiles = 27 * n_ctiles * n_cotiles;
  const int stages = (V + kRows - 1) / kRows;
  int slices = (kTargetBlocks + tiles - 1) / tiles;
  if (slices > stages) slices = stages;
  const int rows_per_slice = ((stages + slices - 1) / slices) * kRows;
  slices = (V + rows_per_slice - 1) / rows_per_slice;
  const dim3 grid(slices, n_ctiles * n_cotiles, 27);
  conv3_columns_dw_kernel<<<grid, kThreads, 0, stream>>>(
      (const float*)feats, (const float*)g, (const int*)col_idx,
      (const unsigned char*)hit, (const unsigned char*)out_mask,
      (const int*)nvalid, (float*)dw, V, C, Co, G, n_cotiles,
      rows_per_slice);
}

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA over the tile plan
// ---------------------------------------------------------------------------

constexpr int kCB = 128;   // channels of C per block: two consumers x 64

template <int kN>
struct DwCfg {
  static constexpr int kStageB = 2 * kATile;        // B after the 2 A halves
  static constexpr int kStageBytes = kStageB + kN / 64 * kATile;
  // the narrowest width keeps two blocks on an SM
  static constexpr int kMinBlocks = kN == 64 ? 2 : 1;
  static constexpr int kBudget = (kMinBlocks == 2 ? 110 : 220) * 1024;
  // three stages: on an H100 four were 2-3% slower at the wide widths and
  // no faster at the others (scripts/torch_a3_variants.py)
  static constexpr int kStages = 3;
  static_assert(kBudget / kStageBytes >= kStages, "the ring does not fit");
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;  // + align
  // as GemmCfg: the consumers take what the producer gives back
  static constexpr int kLaunchRegs = 65536 / (kGemmThreads * kMinBlocks) / 8
                                     * 8;
  // 56, not A1's 40: this producer walks a chain of index loads per tile
  // and ran slower at 40 (scripts/torch_a3_variants.py); 56 is the most the
  // two-block width leaves the consumers
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kGemmThreads - kProducerRegs * 128) / 256 / 8 * 8;
  static_assert(kConsumerRegs >= kLaunchRegs, "setmaxnreg.inc must grow");
};

// Descriptor of an MN-major operand in 128-byte-swizzled shared memory: a
// row of 64 bf16 per k, 8-row swizzle atoms 1024 bytes apart along k
// (SBO), 64-element blocks along M or N kATile bytes apart (LBO). Adding
// 128 steps it 16 rows (2048 bytes) along k.
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | ((uint64_t)(kATile >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// partial[chunk, c, co] for the block's chunk and channels c0 .. c0 + 127;
// see the header comment. feats [V, G*ldf] and g [V, G*ldg] bf16 (ldf,
// ldg multiples of 8, zero-padded past C and Co), kN >= Co.
template <int kN>
__global__ void __launch_bounds__(kGemmThreads, DwCfg<kN>::kMinBlocks)
conv3_columns_dw_wgmma_kernel(const __nv_bfloat16* __restrict__ feats,
                              const __nv_bfloat16* __restrict__ g,
                              const int* __restrict__ col_idx,
                              const unsigned char* __restrict__ hit,
                              const unsigned char* __restrict__ out_mask,
                              const int* __restrict__ order,
                              const int* __restrict__ act,
                              const int* __restrict__ chunk_tap,
                              const int* __restrict__ chunk_lo,
                              const int* __restrict__ chunk_len,
                              const int* __restrict__ launch_order,
                              float* __restrict__ partial, int V, int C,
                              int ldf, int Co, int ldg, int G, int ntiles,
                              int ncb) {
  using Cfg = DwCfg<kN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // full[s] at bar + 8 s, empty[s] at bar + 8 (kStages + s)
  const uint32_t bar = base + Cfg::kBars;

  // consecutive blocks: the channel blocks of one chunk, then the next
  // chunk in launch order
  const int cb = blockIdx.x % ncb;
  const int chunk = launch_order[blockIdx.x / ncb];
  const int tap = chunk_tap[chunk];
  const int* tiles = act + (long long)tap * ntiles + chunk_lo[chunk];
  const int len = chunk_len[chunk];
  const int c0 = cb * kCB;
  const bool busy1 = c0 + 64 < C;   // the second consumer has channels

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(bar + 8 * s, 128);                     // producer threads
      mbar_init(bar + 8 * (Cfg::kStages + s), 8);      // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: the gathers ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(Cfg::kProducerRegs));
    const int t = threadIdx.x;
    const int r = t >> 1;         // its plan row in each tile
    const int half = t & 1;       // A: its consumer's 64 channels; B: half
                                  // of the row's 16-byte chunks
    const int col = tap / 3, z = tap - 3 * col;
    // The row's indices form a chain of loads: tile -> order -> mask, hits,
    // col_idx. Each link is loaded an iteration ahead, before the copies
    // of the current tile are issued, so its latency overlaps them.
    auto row_of = [&](int i) {
      const int pr = tiles[i] * kTileRows + r;
      return pr < V ? order[pr] : -1;
    };
    unsigned char m = 0, h0 = 0, h1 = 0, hz = 0;   // map entries of a row
    int p = 0;
    auto load_map = [&](int orow) {
      m = 0;
      if (orow < 0) return;
      const unsigned char* h = hit + (long long)orow * 27 + 3 * col;
      m = out_mask[orow], h0 = h[0], h1 = h[1], hz = h[z];
      p = col_idx[(long long)orow * 9 + col];
    };
    int orow = len > 0 ? row_of(0) : -1;     // tile i's row
    int orow1 = len > 1 ? row_of(1) : -1;    // tile i + 1's row
    load_map(orow);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < len; ++i) {
      // element offsets of the row's feats at the tap and of its
      // cotangent, -1 where the row misses the tap or is masked
      long long fsrc = -1, gsrc = -1;
      if (orow >= 0 && m != 0) {
        gsrc = (long long)orow * G * ldg;
        if (hz)
          fsrc = (long long)(p + (z > 0 && h0) + (z > 1 && h1)) * G * ldf;
      }
      // the next links: tile i + 1's map entries, tile i + 2's row
      orow = orow1;
      load_map(orow);
      orow1 = i + 2 < len ? row_of(i + 2) : -1;
      for (int gi = 0; gi < G; ++gi) {
        mbar_wait(bar + 8 * (Cfg::kStages + stage), phase ^ 1);
        const uint32_t sb = base + stage * Cfg::kStageBytes;
        if (half == 0 || busy1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {          // 8 bf16 per chunk
            const int ch = c0 + half * 64 + 8 * j;
            const bool ok = fsrc >= 0 && ch < ldf;
            cp_async16(sb + half * kATile + swz(r, j),
                       ok ? (const void*)(feats + fsrc + gi * ldf + ch)
                          : (const void*)feats,
                       ok ? 16 : 0);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kN / 16; ++jj) {
          const int j = half * (kN / 16) + jj;   // chunk j of the row
          const int ch = 8 * j;
          const bool ok = gsrc >= 0 && ch < ldg;
          cp_async16(sb + Cfg::kStageB + (j >> 3) * kATile + swz(r, j & 7),
                     ok ? (const void*)(g + gsrc + gi * ldg + ch)
                        : (const void*)g,
                     ok ? 16 : 0);
        }
        // the stage is full when these copies land; go on to the next
        cp_async_arrive(bar + 8 * stage);
        if (++stage == Cfg::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    cp_async_wait_all();
  } else {
    // ---------------- consumers: wgmma and the partial ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(Cfg::kConsumerRegs));
    const int slot = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128;
    const int warp = ct >> 5, lane = ct & 31;
    const bool mine = slot == 0 || busy1;

    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int step = 0; step < len * G; ++step) {
      mbar_wait(bar + 8 * stage, phase);
      if (mine) {
        const uint32_t sb = base + stage * Cfg::kStageBytes;
        fence_proxy_async();
        const uint64_t da = desc_mn(sb + slot * kATile);
        const uint64_t db = desc_mn(sb + Cfg::kStageB);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kTileRows / 16; ++ks)
          wgmma<kN, 1>(acc, da + 128 * ks, db + 128 * ks);
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0)
        mbar_arrive(bar + 8 * (Cfg::kStages + prev));
      prev = stage;
      if (++stage == Cfg::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) reg_fence(acc[i]);
    if (!mine) return;

    // accumulator layout: acc[4 j + 2 h + e] is row (input channel)
    // 16 warp + 8 h + lane/4, column (output channel) 8 j + 2 (lane % 4) + e
    float* dst = partial + (long long)chunk * C * Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + slot * 64 + warp * 16 + h * 8 + (lane >> 2);
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int n = 8 * j + 2 * (lane & 3);
        float* row = dst + (long long)c * Co + n;
        if (n < Co) row[0] = acc[4 * j + 2 * h];
        if (n + 1 < Co) row[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// dw[k] = the sum of the partials of tap k's chunks, in chunk order
__global__ void __launch_bounds__(kThreads)
conv3_columns_dw_reduce_kernel(const float* __restrict__ partial,
                               const int* __restrict__ tap_first,
                               float* __restrict__ dw, long long CCo) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= 27 * CCo) return;
  const int k = (int)(e / CCo);
  const long long off = e - k * CCo;
  float s = 0.f;
  for (int i = tap_first[k]; i < tap_first[k + 1]; ++i)
    s += partial[i * CCo + off];
  dw[e] = s;
}

template <int kN>
cudaError_t launch_wgmma_dw(const void* feats, const void* g,
                            const void* col_idx, const void* hit,
                            const void* out_mask, const void* order,
                            const void* act, const void* chunk_tap,
                            const void* chunk_lo, const void* chunk_len,
                            const void* launch_order, int nchunks,
                            void* partial, int V, int C, int ldf, int Co,
                            int ldg, int G, cudaStream_t stream) {
  using Cfg = DwCfg<kN>;
  auto kernel = conv3_columns_dw_wgmma_kernel<kN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const int ncb = (C + kCB - 1) / kCB;
  const int ntiles = (V + kTileRows - 1) / kTileRows;
  kernel<<<nchunks * ncb, kGemmThreads, Cfg::kSmem, stream>>>(
      (const __nv_bfloat16*)feats, (const __nv_bfloat16*)g,
      (const int*)col_idx, (const unsigned char*)hit,
      (const unsigned char*)out_mask, (const int*)order, (const int*)act,
      (const int*)chunk_tap, (const int*)chunk_lo, (const int*)chunk_len,
      (const int*)launch_order, (float*)partial, V, C, ldf, Co, ldg, G,
      ntiles, ncb);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16; the cotangent g [V, G*ldg] in the
// input type, out_mask [V] bool, dw [27, C, Co] float32.
// float32: feats [V, G*C] (ldf = C, ldg = Co), nvalid [1] int32 on the
// device, dw zeroed by the caller; the schedule's pointers unused.
// bfloat16: feats [V, G*ldf], ldf and ldg multiples of 8 (zero-padded),
// Co <= 256; the tile plan's order [V] and the schedule (ops/sparse_conv.py
// `dw_schedule`): act [27, ceil(V/64)], chunk_tap, chunk_lo, chunk_len and
// launch_order [nchunks], tap_first [28], all int32; partial [nchunks, C,
// Co] float32 scratch. Every element of dw is written.
extern "C" int conv3_columns_dw(int tin, const void* feats, const void* g,
                                const void* col_idx, const void* hit,
                                const void* out_mask, const void* nvalid,
                                const void* order, const void* act,
                                const void* chunk_tap, const void* chunk_lo,
                                const void* chunk_len,
                                const void* launch_order,
                                const void* tap_first, int nchunks,
                                void* partial, void* dw, int V, int C,
                                int ldf, int Co, int ldg, int G,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tin == 0) {
    launch_dw_f32(feats, g, col_idx, hit, out_mask, nvalid, dw, V, C, Co, G,
                  s);
    return (int)cudaGetLastError();
  }
  if (tin != 1 || Co > 256 || ldf % 8 || ldg % 8 || (G != 1 && G != 2))
    return (int)cudaErrorInvalidValue;
  if (nchunks > 0) {
    cudaError_t err;
#define LIDIFF_DW(N)                                                        \
  err = launch_wgmma_dw<N>(feats, g, col_idx, hit, out_mask, order, act,    \
                           chunk_tap, chunk_lo, chunk_len, launch_order,    \
                           nchunks, partial, V, C, ldf, Co, ldg, G, s)
    if (ldg <= 64) LIDIFF_DW(64);
    else if (ldg <= 128) LIDIFF_DW(128);
    else if (ldg <= 192) LIDIFF_DW(192);
    else LIDIFF_DW(256);
#undef LIDIFF_DW
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = 27LL * C * Co;
  conv3_columns_dw_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                                   kThreads, 0, s>>>(
      (const float*)partial, (const int*)tap_first, (float*)dw,
      (long long)C * Co);
  return (int)cudaGetLastError();
}
