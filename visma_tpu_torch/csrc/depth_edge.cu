// Depth-edge stencil of the renderer, batched over depth images.
//
// Replaces the TPU kernel visma_tpu/image/edges.py::_edge_kernel (called by
// depth_edge_pallas). It computes what the plain PyTorch twin
// (visma_tpu_torch/image/edges.py::depth_edge_plain) computes:
//   background (depth <= 0 or not finite) -> -1; outside the frame -> 0;
//   delta = 0.25 * (|W - E| + |S - N| + |NW - SE| + |SW - NE|), the four
//   terms added in this order; soft threshold clamp((delta - lo) / range,
//   0, 1); 0 on background pixels and within `border` px of the frame edge.
// The TPU kernel holds a whole image in fast memory and shifts it; here each
// thread computes one output pixel from its eight neighbours (the centre
// only decides background), read through the cache.
//
// What bounds it on an H100: device-memory traffic, 4 bytes in and 4 out
// per pixel (each input pixel is read once from device memory and eight more
// times from cache); the arithmetic is ~15 operations per pixel. The
// library is built with -fmad=false and the sum is taken in the plain
// version's order, so the kernel rounds as the plain version does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_W = 32;
constexpr int BLOCK_H = 8;

__device__ __forceinline__ float linear_depth(const float* __restrict__ img,
                                              int y, int x, int H, int W) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.0f;
  const float d = __ldg(img + (size_t)y * W + x);
  return (isfinite(d) && d > 0.0f) ? d : -1.0f;
}

__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
depth_edge_kernel(const float* __restrict__ depth, float* __restrict__ out,
                  int B, int H, int W, float lo, float range, int border) {
  const int x = blockIdx.x * BLOCK_W + threadIdx.x;
  const int y = blockIdx.y * BLOCK_H + threadIdx.y;
  if (x >= W || y >= H) return;
  const bool inside = x >= border && x <= W - 1 - border && y >= border &&
                      y <= H - 1 - border;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* img = depth + (size_t)b * H * W;
    float res = 0.0f;
    if (inside && linear_depth(img, y, x, H, W) > 0.0f) {
      const float we = fabsf(linear_depth(img, y, x - 1, H, W) -
                             linear_depth(img, y, x + 1, H, W));
      const float sn = fabsf(linear_depth(img, y + 1, x, H, W) -
                             linear_depth(img, y - 1, x, H, W));
      const float d1 = fabsf(linear_depth(img, y - 1, x - 1, H, W) -
                             linear_depth(img, y + 1, x + 1, H, W));
      const float d2 = fabsf(linear_depth(img, y + 1, x - 1, H, W) -
                             linear_depth(img, y - 1, x + 1, H, W));
      const float delta = 0.25f * (((we + sn) + d1) + d2);
      res = fminf(fmaxf((delta - lo) / range, 0.0f), 1.0f);
    }
    out[((size_t)b * H + y) * W + x] = res;
  }
}

}  // namespace

extern "C" int vt_depth_edge(const float* depth, float* out, int B, int H,
                             int W, float lo, float range, int border,
                             void* stream) {
  const dim3 block(BLOCK_W, BLOCK_H);
  const dim3 grid((W + BLOCK_W - 1) / BLOCK_W, (H + BLOCK_H - 1) / BLOCK_H,
                  B < 65535 ? B : 65535);
  depth_edge_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      depth, out, B, H, W, lo, range, border);
  return (int)cudaGetLastError();
}
