// The tile code of the 27-tap column conv, shared by kernel A1
// (conv3_columns.cu, float32 or bf16 feats) and kernel A4
// (conv3_columns_q.cu, int8 feats). Each source defines the feats loader
// of its feats types, ALoad<Ta>, and its C entry point; the kernels here are
// generic in the loader. The build hashes this header into both libraries.
//
// Two kernels:
//   * bf16 weights: conv3_columns_wgmma_kernel, Hopper's warpgroup MMA over
//     a tile plan (lidiff_tpu_torch/ops/grid.py `tile_plan`). The plan sorts
//     the rows stably by their 27-bit hit pattern, so a 64-row tile of the
//     plan hits few more taps than its rows do, and gives each tile the OR
//     of its rows' patterns (`tile_taps`). A block takes 64 plan rows and a
//     whole output width (Co <= 256; wider Co splits evenly over blockIdx.y)
//     and loops over the active taps of its tiles x 64-channel K chunks.
//     One producer warpgroup gathers the feats rows of each step with
//     16-byte cp.async, zero-filled where a row misses the tap, into a ring
//     of 128-byte-swizzled stages, and one of its threads loads the K-major
//     weight slice beside them by TMA. Two consumer warpgroups run one
//     wgmma.m64nNk16 per 16 channels (bf16 in, float32 accumulators, N the
//     block's width) on each stage while the next ones load. Full and empty
//     mbarriers hand the stages over: the copies arrive on a stage's full
//     barrier as they land, so the producer runs as far ahead as the ring.
//     At G=2 the two consumers take the two groups of the same 64 rows (one
//     tap mask, every weight tile read once for both); at G=1 two
//     consecutive plan tiles, each skipping the taps its own mask lacks. The
//     epilogue applies bias, ReLU and the mask to the accumulator
//     registers, casts once and stores output row order[r]: every output
//     row is written by one block, no atomics. A tile with no active tap
//     writes act(bias) * mask. int8 feats (A4) are gathered into a staging
//     buffer; each consumer converts its rows exactly to bf16 into the
//     swizzled tile before its products.
//   * float32 weights: conv3_columns_kernel, a 64x64 output tile per block
//     on the CUDA cores (a 4x4 register tile per thread), exact float32
//     products. For each column the block reads its rows' three z-tap
//     positions; a z-tap that no row of the tile hits is skipped. Tiles
//     whose first row is at or past nvalid (valid voxels come first) write
//     zeros without reading anything. Only the small float32 checks run it.
// Both sum all 27 taps in float32 and apply bias, ReLU and the mask to the
// float32 sum, which is cast to the output type once. The TPU's DMA window
// and one-hot row picks are not needed: a GPU gathers rows directly, so
// every hit tap is read and none is dropped.
//
// ALoad<Ta> provides, for feats of type Ta:
//   static float to_float(Ta)        the CUDA-core kernel's A operand
//                                    (float32 and int8 feats);
//   static constexpr int kCh         channels per 16-byte copy of the wgmma
//                                    kernel (bf16 and int8 feats; the
//                                    wrapper pads C to a multiple);
//   static void convert(uint4, uint4& lo, uint4& hi)   int8 only: 16
//                                    channels as 2 x 8 bf16.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // slab depth per shared-memory stage
constexpr int kThreads = 256;

template <typename Ta>
struct ALoad;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The column set-up both variants share: rows[j][r] is the feats row of
// z-tap j for output row m0 + r (-1 on a miss), tap_any[j] whether any row
// of the tile hits tap j.
__device__ __forceinline__ void column_rows(
    const int* __restrict__ col_idx, const unsigned char* __restrict__ hit,
    int V, int m0, int col, int (*rows)[kBM], int* tap_any) {
  const int tid = threadIdx.x;
  __syncthreads();  // the previous column is done with rows[]
  if (tid < 3) tap_any[tid] = 0;
  __syncthreads();
  if (tid < kBM) {
    const int v = m0 + tid;
    int r0 = -1, r1 = -1, r2 = -1;
    if (v < V) {
      const int p = col_idx[(long long)v * 9 + col];
      const unsigned char* h = hit + (long long)v * 27 + 3 * col;
      const int h0 = h[0] != 0, h1 = h[1] != 0, h2 = h[2] != 0;
      if (h0) r0 = p;
      if (h1) r1 = p + h0;
      if (h2) r2 = p + h0 + h1;
    }
    rows[0][tid] = r0;
    rows[1][tid] = r1;
    rows[2][tid] = r2;
    // benign race: every writer stores 1
    if (r0 >= 0) tap_any[0] = 1;
    if (r1 >= 0) tap_any[1] = 1;
    if (r2 >= 0) tap_any[2] = 1;
  }
  __syncthreads();
}

template <typename Tout>
__device__ __forceinline__ void epilogue(float v, const float* bias, int n,
                                         bool relu, bool keep, Tout* dst) {
  if (bias != nullptr) v += bias[n];
  if (relu) v = fmaxf(v, 0.f);
  store(dst, keep ? v : 0.f);
}

template <typename Tout>
__device__ __forceinline__ bool dead_tile(const int* nvalid, int V, int Co,
                                          int m0, int n0, int g,
                                          long long GCo, int nthreads,
                                          Tout* out) {
  if (m0 < *nvalid) return false;
  for (int e = threadIdx.x; e < kBM * kBN; e += nthreads) {
    const int r = m0 + e / kBN;
    const int n = n0 + e % kBN;
    if (r < V && n < Co) store(out + r * GCo + g * Co + n, 0.f);
  }
  return true;
}

template <typename Ta, typename Tw, typename Tout>
__global__ void __launch_bounds__(kThreads)
conv3_columns_kernel(const Ta* __restrict__ feats,
                     const int* __restrict__ col_idx,
                     const unsigned char* __restrict__ hit,
                     const Tw* __restrict__ w,
                     const float* __restrict__ bias,
                     const unsigned char* __restrict__ out_mask,
                     const int* __restrict__ nvalid,
                     Tout* __restrict__ out, int V, int C, int Co, int G,
                     int relu) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  __shared__ int rows[3][kBM];
  __shared__ int tap_any[3];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g = blockIdx.z;
  const long long GC = (long long)G * C;
  const long long GCo = (long long)G * Co;

  if (dead_tile(nvalid, V, Co, m0, n0, g, GCo, kThreads, out)) return;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int col = 0; col < 9; ++col) {
    column_rows(col_idx, hit, V, m0, col, rows, tap_any);
    for (int j = 0; j < 3; ++j) {
      if (!tap_any[j]) continue;  // no row of the tile hits this tap
      const Tw* wj = w + (long long)(col * 3 + j) * C * Co;
      for (int c0 = 0; c0 < C; c0 += kBK) {
        for (int e = tid; e < kBM * kBK; e += kThreads) {
          const int kk = e % kBK;
          const int r = e / kBK;
          const int ch = c0 + kk;
          const int row = rows[j][r];
          As[kk][r] = (ch < C && row >= 0)
                          ? ALoad<Ta>::to_float(feats[row * GC + g * C + ch])
                          : 0.f;
        }
        for (int e = tid; e < kBK * kBN; e += kThreads) {
          const int n = e % kBN;
          const int kk = e / kBN;
          const int ch = c0 + kk;
          Bs[kk][n] = (ch < C && n0 + n < Co)
                          ? to_f(wj[(long long)ch * Co + n0 + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
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
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= V) continue;
    const bool keep = out_mask[r] != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Co) continue;
      epilogue(acc[i][j], bias, n, relu, keep, out + r * GCo + g * Co + n);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 weights: the warpgroup-MMA kernel over a tile plan
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;       // plan rows per consumer tile (wgmma M)
constexpr int kKC = 64;             // channels per K chunk: 128 bytes of bf16
constexpr int kGemmThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kATile = kTileRows * 128;   // bytes of one bf16 A tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` 0 writes 16 zero bytes, reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
// arrives on `bar` once every cp.async this thread issued so far has
// landed; counts as one of the arrivals the barrier was initialised with
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// arrives and adds `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// box {x, y, z} of a 3-D tensor map -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x),
         "r"(y), "r"(z) : "memory");
}
// until the phase of parity `parity` has completed. A wait of more than
// about 10 s (2^34 cycles) can only be a broken hand-over: it traps, and
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// shared-memory writes this thread has seen become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n"
               :: "n"(kPending) : "memory");
}
// keeps the compiler from touching an accumulator across a wgmma boundary
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// Descriptor of a K-major operand in 128-byte-swizzled shared memory: rows
// of 64 bf16 (128 bytes), 8-row swizzle atoms 1024 bytes apart (SBO), the
// atoms 1024-byte aligned. Adding 2 steps it 16 channels (32 bytes) along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4));
}

// D[64 x kN] += A[64 x 16] B[16 x kN], A and B K-major in 128-byte-swizzled
// shared memory, kN / 2 float32 accumulators per thread: one
// wgmma.m64nNk16 per width the kernel is built for
template <int kN>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<192>(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <typename Ta, int kN>
struct GemmCfg {
  static constexpr bool kInt8 = sizeof(Ta) == 1;
  static constexpr int kStageB = 2 * kATile;              // B after 2 A tiles
  static constexpr int kStageStaging = kStageB + kN * 128;  // int8 staging
  static constexpr int kStageRaw =
      kStageStaging + (kInt8 ? 2 * kTileRows * 64 : 0);
  static constexpr int kStageBytes = (kStageRaw + 1023) / 1024 * 1024;
  // narrow tiles keep two blocks on an SM: half the registers and memory
  static constexpr int kMinBlocks = kN <= 96 ? 2 : 1;
  static constexpr int kBudget = (kMinBlocks == 2 ? 110 : 220) * 1024;
  static constexpr int kStages =
      kBudget / kStageBytes >= 4 ? 4 : kBudget / kStageBytes;
  static_assert(kStages >= 3, "the ring needs 3 stages (see the producer)");
  static constexpr int kBars = kStages * kStageBytes;      // 2 x kStages x 8
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;  // + align
  // setmaxnreg moves registers within the block only: the consumers may
  // take what the producer gives back from the launch's per-thread count
  // (65536 / (384 x kMinBlocks), rounded down to 8: 168 or 80), or their
  // setmaxnreg.inc waits forever
  static constexpr int kLaunchRegs = 65536 / (kGemmThreads * kMinBlocks) / 8
                                     * 8;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kGemmThreads - kProducerRegs * 128) / 256 / 8 * 8;
  static_assert(kConsumerRegs >= kLaunchRegs, "setmaxnreg.inc must grow");
};

// out[order[r], g] for the 64 plan rows of each consumer tile; see the
// header comment. `wmap` is a tensor map of the K-major weights [27, Co, C]
// (C padded to ALoad<Ta>::kCh) with 64 x kN x 1 boxes, 128-byte swizzled;
// a block covers output channels n0 .. n0 + ncols of Co, n0 = blockIdx.y *
// ncols_split (box rows past ncols are loaded and never stored).
template <typename Ta, typename Tout, int kN>
__global__ void __launch_bounds__(kGemmThreads, GemmCfg<Ta, kN>::kMinBlocks)
conv3_columns_wgmma_kernel(const Ta* __restrict__ feats,
                           const int* __restrict__ col_idx,
                           const unsigned char* __restrict__ hit,
                           const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ bias,
                           const unsigned char* __restrict__ out_mask,
                           const int* __restrict__ order,
                           const int* __restrict__ tile_taps,
                           Tout* __restrict__ out, int V, int C, int Co,
                           int G, int ncols_split, int relu) {
  using Cfg = GemmCfg<Ta, kN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const base_p = smem_raw + (base - raw);
  // full[s] at bar + 8 s, empty[s] at bar + 8 (kStages + s)
  const uint32_t bar = base + Cfg::kBars;

  const int ntiles = (V + kTileRows - 1) / kTileRows;
  // consumer tile of slot s: G=2 one tile, group s; G=1 tiles 2x and 2x+1
  const int tile0 = G == 2 ? blockIdx.x : 2 * blockIdx.x;
  const int tile1 = G == 2 ? blockIdx.x : 2 * blockIdx.x + 1;
  const uint32_t mask0 = tile0 < ntiles ? (uint32_t)tile_taps[tile0] : 0u;
  const uint32_t mask1 = tile1 < ntiles ? (uint32_t)tile_taps[tile1] : 0u;
  const uint32_t bmask = mask0 | mask1;
  const int n0 = blockIdx.y * ncols_split;
  const int ncols = min(ncols_split, Co - n0);
  const int nk = (C + kKC - 1) / kKC;
  const long long GC = (long long)G * C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(bar + 8 * s, 129);   // producer threads + the TMA's
      mbar_init(bar + 8 * (Cfg::kStages + s), 8);      // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: gathers and weight slices ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(Cfg::kProducerRegs));
    const int t = threadIdx.x;
    const int r = t >> 1;         // its plan row in each tile
    const int half = t & 1;       // which half of the row's chunks
    const int pr0 = tile0 * kTileRows + r, pr1 = tile1 * kTileRows + r;
    const int orow0 = (tile0 < ntiles && pr0 < V) ? order[pr0] : -1;
    const int orow1 = (tile1 < ntiles && pr1 < V) ? order[pr1] : -1;
    const int grp1 = G == 2 ? 1 : 0;
    int stage = 0;
    uint32_t phase = 0;

    for (uint32_t m = bmask; m; m &= m - 1) {
      const int tap = __ffs(m) - 1;
      const int col = tap / 3, z = tap - 3 * col;
      const uint32_t act = ((mask0 >> tap) & 1) | (((mask1 >> tap) & 1) << 1);
      // feats element offset of this row's group at the tap, -1 on a miss
      long long src0 = -1, src1 = -1;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int orow = s ? orow1 : orow0;
        if (!((act >> s) & 1) || orow < 0) continue;
        const unsigned char* h = hit + (long long)orow * 27 + 3 * col;
        if (!h[z]) continue;
        int p = col_idx[(long long)orow * 9 + col];
        if (z > 0) p += h[0] != 0;
        if (z > 1) p += h[1] != 0;
        const long long off = (long long)p * GC + (s ? grp1 : 0) * C;
        if (s) src1 = off; else src0 = off;
      }
      for (int kc = 0; kc < nk; ++kc) {
        const int c0 = kc * kKC;
        mbar_wait(bar + 8 * (Cfg::kStages + stage), phase ^ 1);
        const uint32_t sb = base + stage * Cfg::kStageBytes;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (!((act >> s) & 1)) continue;
          const long long src = s ? src1 : src0;
          if constexpr (!Cfg::kInt8) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {        // 8 bf16 per chunk
              const int j = half * 4 + i;
              const int ch = c0 + 8 * j;
              const bool ok = src >= 0 && ch < C;
              cp_async16(sb + s * kATile + swz(r, j),
                         ok ? (const void*)(feats + src + ch) : feats,
                         ok ? 16 : 0);
            }
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {        // 16 int8 per chunk
              const int j = half * 2 + i;
              const int ch = c0 + 16 * j;
              const bool ok = src >= 0 && ch < C;
              cp_async16(sb + Cfg::kStageStaging + s * (kTileRows * 64)
                             + r * 64 + j * 16,
                         ok ? (const void*)(feats + src + ch) : feats,
                         ok ? 16 : 0);
            }
          }
        }
        if (t == 0) {   // the weight slice W[tap][n0 .., c0 ..], one box
          mbar_arrive_expect_tx(bar + 8 * stage, kN * 128);
          tma_load_3d(sb + Cfg::kStageB, &wmap, c0, n0, tap,
                      bar + 8 * stage);
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
    // ---------------- consumers: wgmma and the epilogue ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(Cfg::kConsumerRegs));
    const int slot = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128;
    const int warp = ct >> 5, lane = ct & 31;
    const int tile = slot ? tile1 : tile0;
    const int grp = (G == 2) ? slot : 0;
    const uint32_t my_mask = slot ? mask1 : mask0;

    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (uint32_t m = bmask; m; m &= m - 1) {
      const bool mine = (my_mask >> (__ffs(m) - 1)) & 1;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(bar + 8 * stage, phase);
        if (mine) {
          const uint32_t sb = base + stage * Cfg::kStageBytes;
          if constexpr (Cfg::kInt8) {
            // this warpgroup's rows: int8 staging -> bf16 swizzled tile,
            // two 16-channel chunks per thread
            uint8_t* sp = base_p + stage * Cfg::kStageBytes;
            const int r = ct >> 1;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int j = (ct & 1) * 2 + i;
              const uint4 v = *reinterpret_cast<const uint4*>(
                  sp + Cfg::kStageStaging + slot * (kTileRows * 64)
                  + r * 64 + j * 16);
              uint4 lo, hi;
              ALoad<Ta>::convert(v, lo, hi);
              *reinterpret_cast<uint4*>(sp + slot * kATile + swz(r, 2 * j)) =
                  lo;
              *reinterpret_cast<uint4*>(sp + slot * kATile
                                        + swz(r, 2 * j + 1)) = hi;
            }
          }
          fence_proxy_async();
          if constexpr (Cfg::kInt8)   // the whole tile is converted
            asm volatile("bar.sync %0, 128;\n" :: "r"(1 + slot) : "memory");
          const uint64_t da = desc_sw128(sb + slot * kATile);
          const uint64_t db = desc_sw128(sb + Cfg::kStageB);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kKC / 16; ++ks)
            wgmma<kN>(acc, da + 2 * ks, db + 2 * ks);
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
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) reg_fence(acc[i]);

    // accumulator layout: acc[4 j + 2 h + e] is row 16 warp + 8 h + lane/4,
    // column 8 j + 2 (lane % 4) + e of the 64 x kN tile
    const long long GCo = (long long)G * Co;
    const bool pairs = (Co % 2 == 0);   // even offsets: 2-element stores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = tile * kTileRows + warp * 16 + h * 8 + (lane >> 2);
      if (tile >= ntiles || pr >= V) continue;
      const int orow = order[pr];
      const bool keep = out_mask[orow] != 0;
      Tout* dst = out + orow * GCo + grp * Co + n0;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        if (c >= ncols) continue;
        const bool two = c + 1 < ncols;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (bias != nullptr) {
          v0 += bias[n0 + c];
          if (two) v1 += bias[n0 + c + 1];
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (!keep) v0 = v1 = 0.f;
        if (two && pairs) {
          store2(dst + c, v0, v1);
        } else {
          store(dst + c, v0);
          if (two) store(dst + c + 1, v1);
        }
      }
    }
  }
}

// The bf16 kernel at width kN for one (Ta, Tout); Co splits into
// `nsplit` blocks of ncols_split <= kN channels each.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor map of wt [27, Co, C] bf16 for boxes of 64 channels x kN
// rows x 1 tap, 128-byte swizzled as wgmma reads them; reads past C or Co
// fill zeros. The driver's encoder is looked up through the runtime, so
// the library needs no link to libcuda.
cudaError_t weight_map(CUtensorMap* map, const void* wt, int C, int Co,
                       int kN) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)Co, 27};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)Co * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kKC, (cuuint32_t)kN, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wt), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Ta, typename Tout, int kN>
cudaError_t launch_wgmma(const void* feats, const void* col_idx,
                         const void* hit, const void* wt, const void* bias,
                         const void* out_mask, const void* order,
                         const void* tile_taps, void* out, int V, int C,
                         int Co, int G, int nsplit, int ncols_split,
                         int relu, cudaStream_t stream) {
  using Cfg = GemmCfg<Ta, kN>;
  auto kernel = conv3_columns_wgmma_kernel<Ta, Tout, kN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap wmap;
  err = weight_map(&wmap, wt, C, Co, kN);
  if (err != cudaSuccess) return err;
  const int ntiles = (V + kTileRows - 1) / kTileRows;
  const dim3 grid(G == 2 ? ntiles : (ntiles + 1) / 2, nsplit);
  kernel<<<grid, kGemmThreads, Cfg::kSmem, stream>>>(
      (const Ta*)feats, (const int*)col_idx, (const unsigned char*)hit,
      wmap, (const float*)bias, (const unsigned char*)out_mask,
      (const int*)order,
      (const int*)tile_taps, (Tout*)out, V, C, Co, G, ncols_split, relu);
  return cudaGetLastError();
}

// One bf16 column conv over a tile plan: feats [V, G*C] of type Ta (C a
// multiple of ALoad<Ta>::kCh), wt [27, Co, C] bf16 K-major (16-byte
// aligned), bias [Co]
// float32 or null, out_mask [V] bool, order [V] and tile_taps
// [ceil(V/64)] int32, out [V, G*Co] of type Tout. Co <= 256 takes one
// block's width; wider Co splits evenly into multiples of 8.
template <typename Ta, typename Tout>
cudaError_t launch_bf16(const void* feats, const void* col_idx,
                        const void* hit, const void* wt, const void* bias,
                        const void* out_mask, const void* order,
                        const void* tile_taps, void* out, int V, int C,
                        int Co, int G, int relu, cudaStream_t stream) {
  if (C % ALoad<Ta>::kCh != 0 || (G != 1 && G != 2) || Co <= 0)
    return cudaErrorInvalidValue;
  const int nsplit = (Co + 255) / 256;
  const int per = ((Co + nsplit - 1) / nsplit + 7) / 8 * 8;
#define LIDIFF_WGMMA(N)                                                   \
  return launch_wgmma<Ta, Tout, N>(feats, col_idx, hit, wt, bias,         \
                                   out_mask, order, tile_taps, out, V, C, \
                                   Co, G, nsplit, per, relu, stream)
  if (per <= 32) LIDIFF_WGMMA(32);
  if (per <= 64) LIDIFF_WGMMA(64);
  if (per <= 96) LIDIFF_WGMMA(96);
  if (per <= 128) LIDIFF_WGMMA(128);
  if (per <= 192) LIDIFF_WGMMA(192);
  LIDIFF_WGMMA(256);
#undef LIDIFF_WGMMA
}

// One float32 column conv on the CUDA cores: feats [V, G*C] of type Ta, w
// [27, C, Co] float32, bias [Co] float32 or null, out_mask [V] bool, nvalid
// [1] int32 on the device, out [V, G*Co] float32.
template <typename Ta>
cudaError_t launch_f32(const void* feats, const void* col_idx,
                       const void* hit, const void* w, const void* bias,
                       const void* out_mask, const void* nvalid, void* out,
                       int V, int C, int Co, int G, int relu,
                       cudaStream_t stream) {
  const dim3 grid((V + kBM - 1) / kBM, (Co + kBN - 1) / kBN, G);
  conv3_columns_kernel<Ta, float, float><<<grid, kThreads, 0, stream>>>(
      (const Ta*)feats, (const int*)col_idx, (const unsigned char*)hit,
      (const float*)w, (const float*)bias, (const unsigned char*)out_mask,
      (const int*)nvalid, (float*)out, V, C, Co, G, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
