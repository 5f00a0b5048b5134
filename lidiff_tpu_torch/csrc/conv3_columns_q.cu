// Kernel A4: the int8 eval conv, kernel A1 on per-channel int8 feats.
//
// Replaces the TPU kernel conv_columns_pallas_v2(quant=True)
// (lidiff_tpu/ops/pallas_conv.py:840, int8 body of _make_kernel_v2
// :750-834). Its prologue (:911-927: per-channel amax over all rows and
// groups, int8 feats, scales folded into the weights) is tensor code in
// lidiff_tpu_torch/ops/sparse_conv.py `quantize_feats`. It computes
//   out[o, g] = mask[o] * act(bias + sum_{col < 9} slabq_g(o, col) @ W'[col])
// where slabq_g(o, col) = [q_g(p), q_g(p+m0), q_g(p+m0+m1)], each z-tap
// zeroed where its hit is 0, converted exactly to W's type (|q| <= 127),
// and W' [27, C, Co] holds the scale-folded weights. All 27 taps accumulate
// in float32; bias, ReLU and the mask are applied to the float32 sum, which
// is cast to the output type once.
//
// What bounds it on an H100: as A1, the tensor-core rate on the coarse
// levels and the bytes on the fine ones. The int8 payload buys what the
// gather reads: half the bytes of each gathered row. The weights are not
// quantized (that would compute another function), so the product stays on
// the bf16 tensor cores and not on the int8 ones.
// Design: A1's kernels (conv3_columns_tile.cuh) with the int8 loader below.
// With bf16 weights, A1's warpgroup-MMA kernel over the tile plan: the
// producer gathers each row's int8 channels, 16 per 16-byte cp.async (the
// wrapper pads C to a multiple of 16), into a staging buffer, and the
// consumers convert them exactly to bf16 into the swizzled tile that wgmma
// reads. Float32
// weights run A1's CUDA-core kernel, exact float32 products.

#include "conv3_columns_tile.cuh"

namespace {

// Two int8 values of `word` (bytes 2*half and 2*half+1, the lower address
// first) as one packed bf16 pair, the lower channel in the low half. Exact.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t word,
                                                     int half) {
  const float lo = (float)(int8_t)(word >> (16 * half));
  const float hi = (float)(int8_t)(word >> (16 * half + 8));
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <>
struct ALoad<int8_t> {
  static constexpr int kCh = 16;
  __device__ static float to_float(int8_t x) { return (float)x; }
  // 16 int8 channels (16 bytes) in; channels 0-7 and 8-15 as bf16 out
  __device__ static void convert(uint4 v, uint4& lo, uint4& hi) {
    lo = make_uint4(int8x2_to_bf16x2(v.x, 0), int8x2_to_bf16x2(v.x, 1),
                    int8x2_to_bf16x2(v.y, 0), int8x2_to_bf16x2(v.y, 1));
    hi = make_uint4(int8x2_to_bf16x2(v.z, 0), int8x2_to_bf16x2(v.z, 1),
                    int8x2_to_bf16x2(v.w, 0), int8x2_to_bf16x2(v.w, 1));
  }
};

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (of the weights, and of the output).
// q [V, G*C] int8. float32: w [27, C, Co], nvalid [1] int32 on the device.
// bfloat16: C a multiple of 16, w [27, Co, C] (K-major), order [V] and
// tile_taps [ceil(V/64)] int32 from the map's tile plan. Scale-folded
// weights, bias [Co] float32 or null, out_mask [V] bool, out [V, G*Co] in
// the output type.
extern "C" int conv3_columns_q(int tw, int tout, const void* q,
                               const void* col_idx, const void* hit,
                               const void* w, const void* bias,
                               const void* out_mask, const void* nvalid,
                               const void* order, const void* tile_taps,
                               void* out, int V, int C, int Co, int G,
                               int relu, void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tw == 0 && tout == 0)
    return (int)launch_f32<int8_t>(q, col_idx, hit, w, bias, out_mask,
                                   nvalid, out, V, C, Co, G, relu, s);
  if (tw == 1 && tout == 1)
    return (int)launch_bf16<int8_t, bf16>(q, col_idx, hit, w, bias,
                                          out_mask, order, tile_taps, out, V,
                                          C, Co, G, relu, s);
  if (tw == 1 && tout == 0)
    return (int)launch_bf16<int8_t, float>(q, col_idx, hit, w, bias,
                                           out_mask, order, tile_taps, out,
                                           V, C, Co, G, relu, s);
  return (int)cudaErrorInvalidValue;
}
