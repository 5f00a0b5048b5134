// Kernel A1: the fused 27-tap sparse convolution in column form, eval
// epilogue included.
//
// Replaces the TPU kernel conv_columns_pallas_v2
// (lidiff_tpu/ops/pallas_conv.py:840, body _make_kernel_v2 :750), reached
// through conv_columns_dispatch. It computes
//   out[o, g] = mask[o] * act(bias + sum_{col < 9} slab_g(o, col) @ W[col])
// where slab_g(o, col) = [f_g(p), f_g(p+m0), f_g(p+m0+m1)] with each z-tap
// zeroed where its hit is 0 (p = col_idx[o, col], m0/m1/m2 = hits), and
// W[col] is the [3C, Co] slice of W[27, C, Co]. All 27 taps accumulate in
// float32; bias, ReLU and the mask are applied to the float32 sum, which is
// cast to the output type once, as the TPU kernel does.
//
// What bounds it on an H100: it depends on the data. A conv moves ~10-100 MB
// and does 2 * (hit taps) * C * Co * G FLOP. At the finest level in the
// noisy early solver steps a voxel has about one neighbour, and the bound
// is the bytes; on the coarse levels, at up to 384 input channels and with
// more neighbours, it is the tensor-core rate.
// Design: the 64x64 tile kernels of conv3_columns_tile.cuh (WMMA for bf16,
// CUDA cores for float32), with the float32 and bf16 feats loaders below:
// a bf16 row is staged as it is read, 8 channels per 16-byte load where
// the widths are multiples of 8.

#include "conv3_columns_tile.cuh"

namespace {

template <>
struct ALoad<float> {
  __device__ static float to_float(float x) { return x; }
};

template <>
struct ALoad<__nv_bfloat16> {
  static constexpr int kCh = 8;
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
  __device__ static void stage(uint4 v, __nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. feats [V, G*C] and w [27, C, Co] in
// the input type, bias [Co] float32 or null, out_mask [V] bool, nvalid [1]
// int32 on the device, out [V, G*Co] in the output type.
extern "C" int conv3_columns(int tin, int tout, const void* feats,
                             const void* col_idx, const void* hit,
                             const void* w, const void* bias,
                             const void* out_mask, const void* nvalid,
                             void* out, int V, int C, int Co, int G, int relu,
                             void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tin == 0 && tout == 0) {
    launch<float, float, float>(feats, col_idx, hit, w, bias, out_mask,
                                nvalid, out, V, C, Co, G, relu, s);
  } else if (tin == 1 && tout == 1) {
    launch<bf16, bf16, bf16>(feats, col_idx, hit, w, bias, out_mask, nvalid,
                             out, V, C, Co, G, relu, s);
  } else if (tin == 1 && tout == 0) {
    launch<bf16, bf16, float>(feats, col_idx, hit, w, bias, out_mask, nvalid,
                              out, V, C, Co, G, relu, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
