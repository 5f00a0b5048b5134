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
// Design (conv3_columns_tile.cuh): bf16 runs the warpgroup-MMA kernel over
// the map's tile plan: 64 plan rows x a whole output width per block, only
// the taps some row of the tile hits, the feats rows gathered once per
// block by cp.async into a swizzled ring that overlaps the products.
// Float32 runs the CUDA-core 64x64 tile kernel. The loaders below: a bf16
// row moves 8 channels per 16-byte copy (the wrapper pads C to a multiple
// of 8).

#include "conv3_columns_tile.cuh"

namespace {

template <>
struct ALoad<float> {
  __device__ static float to_float(float x) { return x; }
};

template <>
struct ALoad<__nv_bfloat16> {
  static constexpr int kCh = 8;
};

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, of the input (feats and weights) and
// of the output. float32: feats [V, G*C], w [27, C, Co], nvalid [1] int32 on
// the device (order, tile_taps unused). bfloat16: feats [V, G*C] with C a
// multiple of 8, w [27, Co, C] (K-major), order [V] and tile_taps
// [ceil(V/64)] int32 from the map's tile plan (nvalid unused). bias [Co]
// float32 or null, out_mask [V] bool, out [V, G*Co].
extern "C" int conv3_columns(int tin, int tout, const void* feats,
                             const void* col_idx, const void* hit,
                             const void* w, const void* bias,
                             const void* out_mask, const void* nvalid,
                             const void* order, const void* tile_taps,
                             void* out, int V, int C, int Co, int G, int relu,
                             void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tin == 0 && tout == 0)
    return (int)launch_f32<float>(feats, col_idx, hit, w, bias, out_mask,
                                  nvalid, out, V, C, Co, G, relu, s);
  if (tin == 1 && tout == 1)
    return (int)launch_bf16<bf16, bf16>(feats, col_idx, hit, w, bias,
                                        out_mask, order, tile_taps, out, V,
                                        C, Co, G, relu, s);
  if (tin == 1 && tout == 0)
    return (int)launch_bf16<bf16, float>(feats, col_idx, hit, w, bias,
                                         out_mask, order, tile_taps, out, V,
                                         C, Co, G, relu, s);
  return (int)cudaErrorInvalidValue;
}
