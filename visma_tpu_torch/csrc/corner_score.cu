// Fused Shi-Tomasi corner score with 3x3 non-maximum suppression.
//
// Replaces the TPU kernel visma_tpu/frontend/detect.py::_score_kernel
// (called by corner_score_pallas). It computes what the plain PyTorch twin
// (visma_tpu_torch/frontend/detect.py::corner_score_plain, which follows
// the reference's _corner_score_xla) computes, everywhere in the frame:
//   Sobel/8 gradients of the zero-padded image -> structure tensor products
//   -> zero-padded 5x5 box sums (rows first) -> lambda_min =
//   0.5 (A + C - sqrt((A - C)^2 + 4 B^2)) -> 3x3 NMS with -inf outside the
//   frame -> border mask and response threshold.
// The TPU kernel takes its gradients from the zero-padded image even outside
// the frame, so it differs from this at the frame edge; the border mask
// (border >= 4) hides that difference in both.
//
// Design: one thread block per TILE_H x TILE_W output tile, one thread per
// output pixel (each thread loops over its share of every stage). The image
// tile and every intermediate stage live in shared memory with the halo the
// next stage needs (4 px for the image, 3 for the gradient products, 1 for
// the response), so device memory is read about once and written once.
// What bounds it on an H100: device-memory traffic (4 bytes in and 4 out
// per pixel, ~3.8 MB for a 500x960 frame) and, at this size, launch latency;
// the arithmetic is ~60 flops per pixel. The library is built with
// -fmad=false and every sum is taken in the plain version's order, so the
// kernel reproduces the plain version's rounding and its NMS decisions.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int THREADS = 256;
constexpr int R = 2;  // box radius (5x5 window)

// Stage extents (rows x cols), each centred on the output tile.
constexpr int IMG_H = TILE_H + 8, IMG_W = TILE_W + 8;  // image, halo 4
constexpr int PRD_H = TILE_H + 6, PRD_W = TILE_W + 6;  // gx^2, gxgy, gy^2, halo 3
constexpr int VRT_H = TILE_H + 2, VRT_W = TILE_W + 6;  // row-summed products
constexpr int RSP_H = TILE_H + 2, RSP_W = TILE_W + 2;  // response, halo 1

__global__ void __launch_bounds__(THREADS)
corner_score_kernel(const float* __restrict__ img, float* __restrict__ out,
                    int H, int W, int border, float min_response) {
  __shared__ float s_img[IMG_H][IMG_W];
  __shared__ float s_prd[3][PRD_H][PRD_W];
  __shared__ float s_vrt[3][VRT_H][VRT_W];
  __shared__ float s_rsp[RSP_H][RSP_W];

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;

  // 1. image tile, zero outside the frame
  for (int i = tid; i < IMG_H * IMG_W; i += THREADS) {
    const int r = i / IMG_W, c = i % IMG_W;
    const int y = y0 - 4 + r, x = x0 - 4 + c;
    s_img[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                      ? img[(size_t)y * W + x] : 0.0f;
  }
  __syncthreads();

  // 2. gradient products; zero outside the frame (the plain version
  //    zero-pads the products before the box sums)
  for (int i = tid; i < PRD_H * PRD_W; i += THREADS) {
    const int r = i / PRD_W, c = i % PRD_W;
    const int y = y0 - 3 + r, x = x0 - 3 + c;
    float a = 0.0f, b = 0.0f, cc = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int u = r + 1, v = c + 1;  // position in s_img
#define S(dy, dx) s_img[u + (dy)][v + (dx)]
      const float east_west = S(0, 1) - S(0, -1);
      const float ne_nw = S(-1, 1) - S(-1, -1);
      const float se_sw = S(1, 1) - S(1, -1);
      const float gx = ((ne_nw + 2.0f * east_west) + se_sw) / 8.0f;
      const float south_north = S(1, 0) - S(-1, 0);
      const float gy = (((S(1, -1) - S(-1, -1)) + 2.0f * south_north)
                        + (S(1, 1) - S(-1, 1))) / 8.0f;
#undef S
      a = gx * gx;
      b = gx * gy;
      cc = gy * gy;
    }
    s_prd[0][r][c] = a;
    s_prd[1][r][c] = b;
    s_prd[2][r][c] = cc;
  }
  __syncthreads();

  // 3. box sum along rows (taps in order -2..2)
  for (int i = tid; i < VRT_H * VRT_W; i += THREADS) {
    const int r = i / VRT_W, c = i % VRT_W;
    for (int k = 0; k < 3; ++k) {
      float acc = s_prd[k][r][c];
      for (int t = 1; t <= 2 * R; ++t) acc = acc + s_prd[k][r + t][c];
      s_vrt[k][r][c] = acc;
    }
  }
  __syncthreads();

  // 4. box sum along columns, then the minimum eigenvalue; -inf outside
  //    the frame for the NMS
  for (int i = tid; i < RSP_H * RSP_W; i += THREADS) {
    const int r = i / RSP_W, c = i % RSP_W;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float resp = -INFINITY;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      float S3[3];
      for (int k = 0; k < 3; ++k) {
        float acc = s_vrt[k][r][c];
        for (int t = 1; t <= 2 * R; ++t) acc = acc + s_vrt[k][r][c + t];
        S3[k] = acc;
      }
      const float A = S3[0], B = S3[1], C = S3[2];
      const float d = A - C;
      const float disc = sqrtf(fmaxf(d * d + (4.0f * B) * B, 0.0f));
      resp = 0.5f * ((A + C) - disc);
    }
    s_rsp[r][c] = resp;
  }
  __syncthreads();

  // 5. 3x3 NMS, border mask and threshold
  for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, c = i % TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const float v = s_rsp[r + 1][c + 1];
    float neigh = v;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) neigh = fmaxf(neigh, s_rsp[r + dy][c + dx]);
    const bool inside = y >= border && y < H - border && x >= border &&
                        x < W - border;
    out[(size_t)y * W + x] =
        (v >= neigh && inside && v > min_response) ? v : 0.0f;
  }
}

}  // namespace

extern "C" int vt_corner_score(const float* img, float* out, int H, int W,
                               int border, float min_response,
                               void* stream) {
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  corner_score_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, out, H, W, border, min_response);
  return (int)cudaGetLastError();
}
