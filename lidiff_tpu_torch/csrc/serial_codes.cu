// The serialization codes of a Point Transformer V3 level, on the card.
//
// Replaces no TPU kernel: the JAX package has no PTv3. It was added
// because `ops/serialize.py` computes a level's four codes with bit loops
// of tensor operations: about six kernels a bit for the Hilbert transform
// and three for the Morton interleave, some 800 launches of a few
// microseconds each at level 0 of a step. They run just after the step's
// one host sync, when nothing else is queued, so the card waited on the
// host for all of them.
//
// For each row i < n of coords [V, 4] int32 (element, x, y, z; the
// coordinates plus (sx, sy, sz) are in [0, 2^depth)), writes out [4, n]
// int64: the z, z-trans, hilbert and hilbert-trans codes (`ORDERS`), each
// the element shifted above the 3 * depth code bits. "-trans" swaps x and
// y. The Morton code puts bit b of x, y, z at 3b + 2, 3b + 1, 3b; the
// Hilbert code is Skilling's transform ("Programming the Hilbert curve",
// AIP Conf. Proc. 707, 2004, AxestoTranspose) of (x, y, z), its
// transposed index interleaved the same way: the integer arithmetic of
// `serialize.hilbert_code`, one thread a row.
//
// What bounds it on an H100: bytes (16 read and 32 written a row); the
// Hilbert loop is about 40 integer operations a bit, a few microseconds
// at level 0 of the ptv3.train cell (about 0.9M rows).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int64_t morton(int64_t x, int64_t y, int64_t z,
                                          int depth) {
  int64_t code = 0;
  for (int b = 0; b < depth; ++b) {
    code |= ((x >> b) & 1) << (3 * b + 2);
    code |= ((y >> b) & 1) << (3 * b + 1);
    code |= ((z >> b) & 1) << (3 * b);
  }
  return code;
}

__device__ __forceinline__ int64_t hilbert(int64_t x, int64_t y, int64_t z,
                                           int depth) {
  int64_t X[3] = {x, y, z};
  for (int64_t q = int64_t(1) << (depth - 1); q > 1; q >>= 1) {
    const int64_t p = q - 1;
    for (int i = 0; i < 3; ++i) {
      if (X[i] & q) {
        X[0] ^= p;                        // invert the low bits of X[0]
      } else {                            // exchange those of X[0], X[i]
        const int64_t t = (X[0] ^ X[i]) & p;
        X[0] ^= t;
        X[i] ^= t;
      }
    }
  }
  X[1] ^= X[0];                           // Gray encode
  X[2] ^= X[1];
  int64_t t = 0;
  for (int64_t q = int64_t(1) << (depth - 1); q > 1; q >>= 1)
    if (X[2] & q) t ^= q - 1;
  return morton(X[0] ^ t, X[1] ^ t, X[2] ^ t, depth);
}

__global__ void serial_codes_kernel(const int4* __restrict__ coords, int n,
                                    int depth, int sx, int sy, int sz,
                                    int64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int4 c = coords[i];
  const int64_t x = c.y + sx, y = c.z + sy, z = c.w + sz;
  const int64_t e = (int64_t)c.x << (3 * depth);
  out[i] = e | morton(x, y, z, depth);
  out[(int64_t)n + i] = e | morton(y, x, z, depth);
  out[2 * (int64_t)n + i] = e | hilbert(x, y, z, depth);
  out[3 * (int64_t)n + i] = e | hilbert(y, x, z, depth);
}

}  // namespace

extern "C" const char* lidiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// coords [>= n, 4] int32, 16-byte aligned; out [4, n] int64.
extern "C" int serial_codes(const void* coords, int n, int depth, int sx,
                            int sy, int sz, void* out, void* stream) {
  if (n < 0 || depth < 1 || depth > 20) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  serial_codes_kernel<<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int4*)coords, n, depth, sx, sy, sz, (int64_t*)out);
  return (int)cudaGetLastError();
}
