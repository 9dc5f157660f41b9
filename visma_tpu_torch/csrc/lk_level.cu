// One pyramid level of inverse-compositional Lucas-Kanade for K features.
//
// Replaces the TPU kernel visma_tpu/frontend/klt_fused.py::_lk_level_kernel
// (called by lk_level_fused). Per feature, as the reference computes it:
//   * the template T (m x m, m = 2r+1) and its central-difference gradients
//     come from one (m+2) x (m+2) bilinear patch of the template image,
//     started at the template start clamped to [1, win-m-1] inside the
//     feature's win x win template window;
//   * the 2x2 normal matrix G gives ok = det(G) > 1e-6;
//   * `iters` Gauss-Newton steps sample the search image at the search start
//     plus the running displacement, clamped to [0, win-m-1e-4] inside the
//     search window, and update u by G^-1 b;
//   * the RMS residual of the final sample.
// The reference samples with "hat taps" over windows it extracted by one-hot
// matmuls (a TPU gather workaround). Hat taps inside the window are two-tap
// bilinear, so this kernel reads the level images directly with bilinear
// taps at window origin + start: the weights come from the start as in the
// reference, max(0, 1 - |s - n|) and max(0, 1 - |s - n - 1|) with
// n = floor(s), and a tap whose weight is 0 is clamped to the window's last
// row or column so no read leaves the window.
//
// Design: one thread block per feature, one thread per template pixel
// (121 of 128 threads at r = 5). The (m+2)^2 template patch is staged in
// shared memory; G, the b-vector and the residual are block reductions
// (warp shuffles, then the per-warp partials summed in a fixed order, so
// every thread holds the same value and results do not vary run to run).
// What bounds it on an H100: latency. K = 96 blocks fill 96 of 132 SMs with
// one 4-warp block each; every iteration is a dependent chain of two scattered
// bilinear reads (L2 hits) and two block reductions, with ~1 KB of data per
// feature. The launch (~5 per frame) and the reduction barriers dominate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_WARPS = 32;

struct Taps {
  int n;       // first tap, window-local
  float w0;    // weight of tap n
  float w1;    // weight of tap n + 1
};

__device__ __forceinline__ Taps make_taps(float s) {
  const float n = floorf(s);
  Taps t;
  t.n = (int)n;
  t.w0 = fmaxf(0.0f, 1.0f - fabsf(s - n));
  t.w1 = fmaxf(0.0f, 1.0f - fabsf(s - (n + 1.0f)));
  return t;
}

// Bilinear sample at patch pixel (i, j) of a patch starting at taps (ty, tx)
// inside the win x win window at (ox, oy) of an H x W image: rows first,
// then columns, as the reference's hat taps. Reads are clamped into the
// image as well, so an origin that puts a window outside it (which
// window_origin never produces) cannot read out of bounds.
__device__ __forceinline__ int tap(int origin, int k, int win, int dim) {
  return min(max(origin + min(k, win - 1), 0), dim - 1);
}

__device__ __forceinline__ float sample(const float* __restrict__ img, int H,
                                        int W, int ox, int oy, int win,
                                        const Taps& ty, const Taps& tx,
                                        int i, int j) {
  const int r0 = tap(oy, ty.n + i, win, H);
  const int r1 = tap(oy, ty.n + i + 1, win, H);
  const int c0 = tap(ox, tx.n + j, win, W);
  const int c1 = tap(ox, tx.n + j + 1, win, W);
  const float* row0 = img + (size_t)r0 * W;
  const float* row1 = img + (size_t)r1 * W;
  const float v0 = ty.w0 * row0[c0] + ty.w1 * row1[c0];
  const float v1 = ty.w0 * row0[c1] + ty.w1 * row1[c1];
  return tx.w0 * v0 + tx.w1 * v1;
}

// Sum of N per-thread values over the block; every thread gets the sums.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * MAX_WARPS + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += scratch[k * MAX_WARPS + w];
    v[k] = s;
  }
  __syncthreads();  // scratch is reused by the next reduction
}

__global__ void lk_level_kernel(const float* __restrict__ imgT,
                                const float* __restrict__ imgI, int H,
                                int W,
                                const int* __restrict__ orgT,
                                const int* __restrict__ orgI,
                                const float* __restrict__ stT,
                                const float* __restrict__ sI0,
                                float* __restrict__ u_out,
                                float* __restrict__ stat_out, int K, int win,
                                int radius, int iters) {
  extern __shared__ float smem[];
  float* scratch = smem;                   // 3 * MAX_WARPS
  float* patch = smem + 3 * MAX_WARPS;     // (m+2)^2 template patch

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = 2 * radius + 1;
  const int Mp = m + 2;

  const int oxT = orgT[2 * k], oyT = orgT[2 * k + 1];
  const int oxI = orgI[2 * k], oyI = orgI[2 * k + 1];

  // template start, clamped so the +-1 px gradient taps stay in the window
  const float hiT = (float)(win - m) - 1.0f;
  const float ty = fminf(fmaxf(stT[k], 1.0f), hiT);
  const float tx = fminf(fmaxf(stT[K + k], 1.0f), hiT);
  const Taps tapY = make_taps(ty - 1.0f), tapX = make_taps(tx - 1.0f);
  for (int idx = tid; idx < Mp * Mp; idx += blockDim.x)
    patch[idx] = sample(imgT, H, W, oxT, oyT, win, tapY, tapX, idx / Mp,
                        idx % Mp);
  __syncthreads();

  const bool active = tid < m * m;
  const int i = active ? tid / m : 0, j = active ? tid % m : 0;
  float T = 0.0f, Tx = 0.0f, Ty = 0.0f;
  if (active) {
    const float* p = patch + (i + 1) * Mp + (j + 1);
    T = p[0];
    Tx = 0.5f * (p[1] - p[-1]);
    Ty = 0.5f * (p[Mp] - p[-Mp]);
  }

  float g[3] = {Tx * Tx, Tx * Ty, Ty * Ty};
  block_sum<3>(g, scratch);
  const float Gxx = g[0], Gxy = g[1], Gyy = g[2];
  const float det = Gxx * Gyy - Gxy * Gxy;
  const bool ok = det > 1e-6f;
  const float inv_det = ok ? 1.0f / fmaxf(det, 1e-12f) : 0.0f;

  // rounded once from double, as the float32 cast of the reference's
  // Python constant win - m - 1e-4
  const float lim = (float)((double)(win - m) - 1e-4);
  const float s0y = sI0[k], s0x = sI0[K + k];
  float uy = 0.0f, ux = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const Taps ry = make_taps(fminf(fmaxf(s0y + uy, 0.0f), lim));
    const Taps rx = make_taps(fminf(fmaxf(s0x + ux, 0.0f), lim));
    const float e =
        active ? sample(imgI, H, W, oxI, oyI, win, ry, rx, i, j) - T : 0.0f;
    float b[2] = {Tx * e, Ty * e};
    block_sum<2>(b, scratch);
    const float dx = inv_det * (Gyy * b[0] - Gxy * b[1]);
    const float dy = inv_det * (-Gxy * b[0] + Gxx * b[1]);
    uy = uy - dy;
    ux = ux - dx;
  }

  const Taps ry = make_taps(fminf(fmaxf(s0y + uy, 0.0f), lim));
  const Taps rx = make_taps(fminf(fmaxf(s0x + ux, 0.0f), lim));
  const float e =
      active ? sample(imgI, H, W, oxI, oyI, win, ry, rx, i, j) - T : 0.0f;
  float sq[1] = {e * e};
  block_sum<1>(sq, scratch);
  if (tid == 0) {
    u_out[k] = uy;
    u_out[K + k] = ux;
    stat_out[k] = sqrtf(sq[0] / (float)(m * m));
    stat_out[K + k] = ok ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int vt_lk_level(const float* imgT, const float* imgI, int H,
                           int W,
                           const int* orgT, const int* orgI, const float* stT,
                           const float* sI0, float* u, float* stat, int K,
                           int win, int radius, int iters, void* stream) {
  const int m = 2 * radius + 1;
  const int threads = (m * m + 31) / 32 * 32;
  const size_t smem = (3 * MAX_WARPS + (m + 2) * (m + 2)) * sizeof(float);
  lk_level_kernel<<<K, threads, smem, (cudaStream_t)stream>>>(
        imgT, imgI, H, W, orgT, orgI, stT, sI0, u, stat, K, win, radius,
        iters);
  return (int)cudaGetLastError();
}
