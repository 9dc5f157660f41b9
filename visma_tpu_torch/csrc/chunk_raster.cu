// Chunked plane-equation rasterizer: depth images from per-chunk triangle
// plane tables and per-subtile lists of hitting chunks.
//
// Replaces two TPU kernels of visma_tpu/render/raster.py:
//   _chunk_raster_kernel          one pose, 32-px subtiles (full frames)
//                                 -> vt_chunk_raster_frame
//   _chunk_raster_kernel_batched  G poses, 16-px subtiles (ROI windows)
//                                 -> vt_chunk_raster_batched
// Both are the same code here, instantiated for the subtile edge. They
// compute what the plain PyTorch twin
// (visma_tpu_torch/render/raster.py::chunk_raster_plain) computes: for each
// pixel, over the triangles of the chunks listed for its subtile, each
// plane as px*a + py*b + c in that order; the pixel is inside a triangle
// iff its three edge planes are >= 0 and 1/far < 1/z < 1/near; the maximum
// 1/z wins; the output is metric depth 1/max, +inf where nothing covers
// the pixel (the reference converts and crops in a separate pass).
//
// Inputs, as the Python setup packs them:
//   planes (B, nc, 12, 128) f32  rows a0 b0 c0 a1 b1 c1 a2 b2 c2 az bz cz
//   ids    (B, nsub, nc)   i32   per subtile, the hitting chunk ids first
//   counts (B, nsub)       i32   how many of them hit
//   out    (B, H, W)       f32
// over the row-major (ceil(H/SUB), ceil(W/SUB)) subtile grid.
//
// Design. The TPU kernel walks its tiles in order on one core, prefetches
// every list as scalars (which caps the poses per call) and keeps a pose's
// whole plane table in fast memory. Here one block of 256 threads owns one
// (pose, subtile): it reads its own count and list, and for each hitting
// chunk stages the chunk's 12 x 128 plane table (6 KB) into shared memory,
// transposed so that a triangle's 12 coefficients are three 16-byte reads
// that every thread of a warp shares. A thread keeps the running maximum of
// its pixels in registers: one pixel for the 16-px subtile, four (rows 8
// apart) for the 32-px subtile, which reuse the triangle's coefficients and
// the px*a products. The grid takes all poses of a call at once; blocks of
// empty subtiles return after one read. A maximum does not depend on the
// order of the list, so the result is the same from run to run.
//
// What bounds it on an H100: operations. Each (pixel, triangle) pair of a
// hitting chunk costs 8 multiplies and 8 adds plus 5 compares and the
// maximum; the bytes (plane tables read once, 4 bytes a pixel written) are
// orders of magnitude below that. The library is built with -fmad=false so
// that every plane rounds as in the plain version and the inside test flips
// on the same pixels.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 128;
constexpr int ROWS_PL = 12;
constexpr int THREADS = 256;

template <int SUB>
__global__ void __launch_bounds__(THREADS)
chunk_raster_kernel(const float* __restrict__ planes,
                    const int* __restrict__ ids,
                    const int* __restrict__ counts, float* __restrict__ out,
                    int nc, int H, int W, int nsx, int nsub, float inv_near,
                    float inv_far) {
  constexpr int ROWS = THREADS / SUB;  // pixel rows covered by one pass
  constexpr int PIX = SUB / ROWS;      // pixels per thread
  __shared__ __align__(16) float s_pl[CHUNK * ROWS_PL];

  const int b = blockIdx.z;
  const int st = blockIdx.y * nsx + blockIdx.x;
  const int tid = threadIdx.x;
  const int x = blockIdx.x * SUB + tid % SUB;
  const int y0 = blockIdx.y * SUB + tid / SUB;
  const float px = (float)x;
  float py[PIX], best[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    py[k] = (float)(y0 + k * ROWS);
    best[k] = 0.0f;
  }

  const int n = counts[(size_t)b * nsub + st];
  const int* my_ids = ids + ((size_t)b * nsub + st) * nc;
  const float* my_planes = planes + (size_t)b * nc * ROWS_PL * CHUNK;
  const float4* s4 = reinterpret_cast<const float4*>(s_pl);

  for (int i = 0; i < n; ++i) {
    const float* src = my_planes + (size_t)my_ids[i] * ROWS_PL * CHUNK;
    __syncthreads();  // the previous chunk has been consumed
    for (int e = tid; e < ROWS_PL * CHUNK; e += THREADS)
      s_pl[(e % CHUNK) * ROWS_PL + e / CHUNK] = src[e];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < CHUNK; ++j) {
      const float4 q0 = s4[3 * j];      // a0 b0 c0 a1
      const float4 q1 = s4[3 * j + 1];  // b1 c1 a2 b2
      const float4 q2 = s4[3 * j + 2];  // c2 az bz cz
      const float xa0 = px * q0.x, xa1 = px * q0.w;
      const float xa2 = px * q1.z, xaz = px * q2.y;
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        const float e0 = (xa0 + py[k] * q0.y) + q0.z;
        const float e1 = (xa1 + py[k] * q1.x) + q1.y;
        const float e2 = (xa2 + py[k] * q1.w) + q2.x;
        const float iz = (xaz + py[k] * q2.z) + q2.w;
        const bool in = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                        iz > inv_far && iz < inv_near;
        best[k] = fmaxf(best[k], in ? iz : 0.0f);
      }
    }
  }

  if (x >= W) return;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int y = y0 + k * ROWS;
    if (y < H)
      out[((size_t)b * H + y) * W + x] =
          best[k] > 0.0f ? 1.0f / fmaxf(best[k], 1e-12f) : INFINITY;
  }
}

template <int SUB>
int launch(const float* planes, const int* ids, const int* counts, float* out,
           int B, int nc, int H, int W, float inv_near, float inv_far,
           void* stream) {
  const int nsx = (W + SUB - 1) / SUB, nsy = (H + SUB - 1) / SUB;
  const dim3 grid(nsx, nsy, B);
  chunk_raster_kernel<SUB><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      planes, ids, counts, out, nc, H, W, nsx, nsx * nsy, inv_near, inv_far);
  return (int)cudaGetLastError();
}

}  // namespace

// One pose, 32-px subtiles: planes (nc,12,128), ids (nsub,nc), counts
// (nsub) -> out (H,W).
extern "C" int vt_chunk_raster_frame(const float* planes, const int* ids,
                                     const int* counts, float* out, int nc,
                                     int H, int W, float inv_near,
                                     float inv_far, void* stream) {
  return launch<32>(planes, ids, counts, out, 1, nc, H, W, inv_near, inv_far,
                    stream);
}

// B poses (B <= 65535), 16-px subtiles: planes (B,nc,12,128), ids
// (B,nsub,nc), counts (B,nsub) -> out (B,H,W).
extern "C" int vt_chunk_raster_batched(const float* planes, const int* ids,
                                       const int* counts, float* out, int B,
                                       int nc, int H, int W, float inv_near,
                                       float inv_far, void* stream) {
  return launch<16>(planes, ids, counts, out, B, nc, H, W, inv_near, inv_far,
                    stream);
}
