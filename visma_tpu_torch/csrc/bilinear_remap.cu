// Bilinear remap through a source-coordinate table: the undistortion gather,
// batched over frames and channels, for float32 and uint8 images.
//
// Replaces the TPU kernel visma_tpu/image/remap.py::_remap_tile_kernel
// (called by bilinear_remap_pallas), generalised to what the reference's
// production function bilinear_remap accepts: a batch of frames, 1-4
// interleaved channels, uint8 storage. It computes what the plain PyTorch
// twin (visma_tpu_torch/image/remap.py::bilinear_remap_plain) computes:
//   (sx, sy) = table[oy, ox]; valid = sx >= 0 (false for NaN);
//   x0 = clamp(floor(sx), 0, W-2), y0 likewise; fx = clamp(sx - x0, 0, 1),
//   fy likewise; fxy = fx * fy;
//   out = fxy*p11 + (fy-fxy)*p10 + (fx-fxy)*p01 + (1-fx-fy+fxy)*p00,
//   added left to right; invalid -> 0; uint8: round half to even, clip to
//   [0, 255].
// The TPU kernel keeps one whole frame in fast memory and walks the table in
// row tiles. Here one thread owns one output pixel: it reads its table entry
// and derives its taps and weights once, then loops over the batch and the
// channels, so the table is read once per launch, not once per frame.
//
// What bounds it on an H100: device-memory traffic (each frame read once and
// written once, the table once; ~12 operations per value). The taps of
// neighbouring output pixels are neighbouring source pixels, so the gathers
// coalesce almost as a copy does. The library is built with -fmad=false and
// the sum is taken in the plain version's order, so the kernel rounds as the
// plain version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_W = 32;
constexpr int BLOCK_H = 8;

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_value(uint8_t* p, float v) {
  // rintf: round half to even, as torch.round and jnp.round
  *p = (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// 8 blocks of 256 threads an SM: the register cap (32) that keeps the SM
// full. Without it the kernel took 40 registers and the 240-frame uint8
// batch ran 0.38 ms instead of 0.29 ms (H100, 700 W).
template <typename T>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H, 8)
bilinear_remap_kernel(const T* __restrict__ img,
                      const float* __restrict__ table, T* __restrict__ out,
                      int B, int H, int W, int C, int oh, int ow) {
  const int ox = blockIdx.x * BLOCK_W + threadIdx.x;
  const int oy = blockIdx.y * BLOCK_H + threadIdx.y;
  if (ox >= ow || oy >= oh) return;
  const size_t opix = (size_t)oy * ow + ox;
  const float sx = __ldg(table + 2 * opix);
  const float sy = __ldg(table + 2 * opix + 1);
  const bool valid = sx >= 0.0f;

  // fmaxf / fminf return the other operand for a NaN, so a NaN or huge
  // entry is clamped into the frame before the cast to int
  const float x0f = fminf(fmaxf(floorf(sx), 0.0f), (float)(W - 2));
  const float y0f = fminf(fmaxf(floorf(sy), 0.0f), (float)(H - 2));
  const float fx = fminf(fmaxf(sx - x0f, 0.0f), 1.0f);
  const float fy = fminf(fmaxf(sy - y0f, 0.0f), 1.0f);
  const float fxy = fx * fy;
  const float w11 = fxy;
  const float w10 = fy - fxy;
  const float w01 = fx - fxy;
  const float w00 = ((1.0f - fx) - fy) + fxy;

  const size_t row = (size_t)W * C;
  const size_t tap = ((size_t)(int)y0f * W + (size_t)(int)x0f) * C;
  const size_t in_frame = (size_t)H * W * C;
  const size_t out_frame = (size_t)oh * ow * C;
  const T* p = img + tap;
  T* o = out + opix * C;
  if (!valid) {
    for (int b = 0; b < B; ++b, o += out_frame)
      for (int c = 0; c < C; ++c) store_value(o + c, 0.0f);
    return;
  }
#pragma unroll 4
  for (int b = 0; b < B; ++b, p += in_frame, o += out_frame) {
    for (int c = 0; c < C; ++c) {
      const float p00 = (float)p[c];
      const float p01 = (float)p[C + c];
      const float p10 = (float)p[row + c];
      const float p11 = (float)p[row + C + c];
      store_value(o + c, ((w11 * p11 + w10 * p10) + w01 * p01) + w00 * p00);
    }
  }
}

}  // namespace

// img (B, H, W, C) and out (B, oh, ow, C) of float32 or, with is_u8, uint8;
// table (oh, ow, 2) float32 of source (x, y).
extern "C" int vt_bilinear_remap(const void* img, const float* table,
                                 void* out, int B, int H, int W, int C,
                                 int oh, int ow, int is_u8, void* stream) {
  const dim3 block(BLOCK_W, BLOCK_H);
  const dim3 grid((ow + BLOCK_W - 1) / BLOCK_W, (oh + BLOCK_H - 1) / BLOCK_H);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    bilinear_remap_kernel<uint8_t><<<grid, block, 0, s>>>(
        (const uint8_t*)img, table, (uint8_t*)out, B, H, W, C, oh, ow);
  } else {
    bilinear_remap_kernel<float><<<grid, block, 0, s>>>(
        (const float*)img, table, (float*)out, B, H, W, C, oh, ow);
  }
  return (int)cudaGetLastError();
}
