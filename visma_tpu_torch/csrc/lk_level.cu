// Pyramidal inverse-compositional Lucas-Kanade for K features: one launch a
// tracked frame (vt_lk_track), and one pyramid level alone (vt_lk_level).
//
// Replaces the TPU kernel visma_tpu/frontend/klt_fused.py::_lk_level_kernel
// (called by lk_level_fused) and, in vt_lk_track, the XLA glue that
// track_features_fused runs between its calls. Per feature and level, as the
// reference computes it:
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
// bilinear, so this kernel reads the level images with bilinear taps at
// window origin + start: the weights come from the start as in the
// reference, max(0, 1 - |s - n|) and max(0, 1 - |s - n - 1|) with
// n = floor(s), and a tap whose weight is 0 is clamped to the window's last
// row or column so no read leaves the window.
//
// What bounds it on an H100: latency, not bytes or operations. A frame is
// 96 features x 5 solves (four levels and the forward-backward pass) of 8
// dependent Gauss-Newton steps on 121 pixels; the data is 2.3 KB a window.
// As five launches with some 40 small PyTorch ops between each pair, the
// frame cost 5 launch latencies, 5 x 8 x 2 scattered L2 reads on the
// critical path and near 200 host dispatches.
//
// Design. One thread block a feature, one thread a template pixel (121 of
// 128 threads at r = 5). lk_solve is one level's solve as a device function:
//   * the search window (win x win, coalesced rows) is staged into shared
//     memory once a level beside the (m+2)^2 template patch: every tap of
//     the 8 steps is clamped into that window, so after the first read
//     nothing leaves the SM;
//   * G, the b-vector and the residual are block reductions (warp shuffles,
//     then the per-warp partials summed in a fixed order, so every thread
//     holds the same value and results do not vary run to run). Successive
//     reductions alternate between two scratch buffers, which saves the
//     second barrier: a buffer is rewritten only after every thread has
//     passed the barrier of the reduction in between.
// lk_track_kernel walks the levels coarse to fine in the block, then the
// forward-backward pass and the gates. Every thread holds the same sums, so
// every thread carries the feature's scalars (level point, estimate, window
// origins, starts, displacement) in registers, in float32 and in the order
// of operations of track_features_fused's plain version; nothing is
// broadcast and nothing goes through global memory between levels. The
// pyramids arrive as a by-value table of per-level pointers and sizes.
// lk_level_kernel is the thin per-level entry over the same lk_solve, kept
// so that a disagreement can be pinned to a level.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_WARPS = 32;
constexpr int SCRATCH = 3 * MAX_WARPS;   // one reduction buffer
constexpr int MAX_LEVELS = 8;

// Per-level pointers and sizes of the two pyramids; wl is the level's
// window, 0 for a level too small to host the patch (skipped).
struct LkLevels {
  const float* prev[MAX_LEVELS];
  const float* cur[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int wl[MAX_LEVELS];
  int n;
};

struct Taps {
  int n;       // first tap, window-local
  float w0;    // weight of tap n
  float w1;    // weight of tap n + 1
};

struct Solve {
  float uy, ux, res;
  bool ok;
};

__device__ __forceinline__ Taps make_taps(float s) {
  const float n = floorf(s);
  Taps t;
  t.n = (int)n;
  t.w0 = fmaxf(0.0f, 1.0f - fabsf(s - n));
  t.w1 = fmaxf(0.0f, 1.0f - fabsf(s - (n + 1.0f)));
  return t;
}

// Image coordinate of window-local tap k of a window at `origin`: clamped
// into the window, and into the image as well, so an origin that puts a
// window outside it (which window_origin never produces) cannot read out
// of bounds.
__device__ __forceinline__ int tap(int origin, int k, int win, int dim) {
  return min(max(origin + min(k, win - 1), 0), dim - 1);
}

// Bilinear sample at patch pixel (i, j) of a patch starting at taps (ty, tx)
// inside the win x win window at (ox, oy) of an H x W image: rows first,
// then columns, as the reference's hat taps.
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

// The same sample from a window staged in shared memory (swin[r * win + c]
// holds the image at tap(oy, r), tap(ox, c)).
__device__ __forceinline__ float sample_staged(const float* swin, int win,
                                               const Taps& ty, const Taps& tx,
                                               int i, int j) {
  const int r0 = min(max(ty.n + i, 0), win - 1) * win;
  const int r1 = min(max(ty.n + i + 1, 0), win - 1) * win;
  const int c0 = min(max(tx.n + j, 0), win - 1);
  const int c1 = min(max(tx.n + j + 1, 0), win - 1);
  const float v0 = ty.w0 * swin[r0 + c0] + ty.w1 * swin[r1 + c0];
  const float v1 = ty.w0 * swin[r0 + c1] + ty.w1 * swin[r1 + c1];
  return tx.w0 * v0 + tx.w1 * v1;
}

// Sum of N per-thread values over the block; every thread gets the sums.
// `phase` counts the block's reductions; odd and even ones use different
// halves of `scratch` (2 * SCRATCH floats), so one barrier is enough.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch,
                                          int& phase) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* buf = scratch + (phase & 1) * SCRATCH;
  ++phase;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) buf[k * MAX_WARPS + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += buf[k * MAX_WARPS + w];
    v[k] = s;
  }
}

// One level's solve for the block's feature. Templates from imgT inside
// the window at (oxT, oyT), samples from imgI inside the window at
// (oxI, oyI); stT* the template start, s0* the sample start for u = 0, in
// window coordinates (row, col). Every thread returns the same values.
// The last use of `patch` and `swin` lies before the final reduction's
// barrier, so the next call may overwrite them at once.
__device__ Solve lk_solve(const float* __restrict__ imgT,
                          const float* __restrict__ imgI, int H, int W,
                          int oxT, int oyT, int oxI, int oyI, float stTy,
                          float stTx, float s0y, float s0x, int win,
                          int radius, int iters, float* scratch, float* patch,
                          float* swin, int& phase) {
  const int tid = threadIdx.x;
  const int m = 2 * radius + 1;
  const int Mp = m + 2;

  // template start, clamped so the +-1 px gradient taps stay in the window
  const float hiT = (float)(win - m) - 1.0f;
  const float ty = fminf(fmaxf(stTy, 1.0f), hiT);
  const float tx = fminf(fmaxf(stTx, 1.0f), hiT);
  const Taps tapY = make_taps(ty - 1.0f), tapX = make_taps(tx - 1.0f);
  for (int idx = tid; idx < Mp * Mp; idx += blockDim.x)
    patch[idx] = sample(imgT, H, W, oxT, oyT, win, tapY, tapX, idx / Mp,
                        idx % Mp);
  for (int idx = tid; idx < win * win; idx += blockDim.x)
    swin[idx] = imgI[(size_t)tap(oyI, idx / win, win, H) * W
                     + tap(oxI, idx % win, win, W)];
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
  block_sum<3>(g, scratch, phase);
  const float Gxx = g[0], Gxy = g[1], Gyy = g[2];
  const float det = Gxx * Gyy - Gxy * Gxy;
  Solve out;
  out.ok = det > 1e-6f;
  const float inv_det = out.ok ? 1.0f / fmaxf(det, 1e-12f) : 0.0f;

  // rounded once from double, as the float32 cast of the reference's
  // Python constant win - m - 1e-4
  const float lim = (float)((double)(win - m) - 1e-4);
  float uy = 0.0f, ux = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const Taps ry = make_taps(fminf(fmaxf(s0y + uy, 0.0f), lim));
    const Taps rx = make_taps(fminf(fmaxf(s0x + ux, 0.0f), lim));
    const float e = active ? sample_staged(swin, win, ry, rx, i, j) - T : 0.0f;
    float b[2] = {Tx * e, Ty * e};
    block_sum<2>(b, scratch, phase);
    const float dx = inv_det * (Gyy * b[0] - Gxy * b[1]);
    const float dy = inv_det * (-Gxy * b[0] + Gxx * b[1]);
    uy = uy - dy;
    ux = ux - dx;
  }

  const Taps ry = make_taps(fminf(fmaxf(s0y + uy, 0.0f), lim));
  const Taps rx = make_taps(fminf(fmaxf(s0x + ux, 0.0f), lim));
  const float e = active ? sample_staged(swin, win, ry, rx, i, j) - T : 0.0f;
  float sq[1] = {e * e};
  block_sum<1>(sq, scratch, phase);
  out.uy = uy;
  out.ux = ux;
  out.res = sqrtf(sq[0] / (float)(m * m));
  return out;
}

// Shared memory of a block: two reduction buffers, the template patch, the
// staged search window.
size_t smem_floats(int m, int win) {
  return 2 * SCRATCH + (size_t)(m + 2) * (m + 2) + (size_t)win * win;
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
  const int Mp = 2 * radius + 3;
  float* scratch = smem;
  float* patch = smem + 2 * SCRATCH;
  float* swin = patch + Mp * Mp;

  const int k = blockIdx.x;
  int phase = 0;
  const Solve s = lk_solve(imgT, imgI, H, W, orgT[2 * k], orgT[2 * k + 1],
                           orgI[2 * k], orgI[2 * k + 1], stT[k], stT[K + k],
                           sI0[k], sI0[K + k], win, radius, iters, scratch,
                           patch, swin, phase);
  if (threadIdx.x == 0) {
    u_out[k] = s.uy;
    u_out[K + k] = s.ux;
    stat_out[k] = s.res;
    stat_out[K + k] = s.ok ? 1.0f : 0.0f;
  }
}

// Origin of a win-wide window around centre c along an axis of `dim`
// pixels: clip(floor(c) - win/2, 0, dim - win).
__device__ __forceinline__ int window_origin(float c, int win, int dim) {
  return min(max((int)floorf(c) - win / 2, 0), dim - win);
}

__global__ void lk_track_kernel(const LkLevels lv,
                                const float* __restrict__ pts,
                                const unsigned char* __restrict__ valid,
                                float* __restrict__ new_pts,
                                unsigned char* __restrict__ ok_out,
                                int radius, int iters, float max_residual,
                                float fb_thresh) {
  extern __shared__ float smem[];
  const int Mp = 2 * radius + 3;
  float* scratch = smem;
  float* patch = smem + 2 * SCRATCH;
  float* swin = patch + Mp * Mp;

  const int k = blockIdx.x;
  const float px = pts[2 * k], py = pts[2 * k + 1];
  if (!valid[k]) {  // the gates would give the same: pts, not ok
    if (threadIdx.x == 0) {
      new_pts[2 * k] = px;
      new_pts[2 * k + 1] = py;
      ok_out[k] = 0;
    }
    return;
  }

  const float rf = (float)radius;
  float dx = 0.0f, dy = 0.0f, res0 = 0.0f;
  int oxP0 = 0, oyP0 = 0, oxC0 = 0, oyC0 = 0;
  bool ok = true;
  int phase = 0;
  for (int l = lv.n - 1; l >= 0; --l) {
    const int wl = lv.wl[l];
    if (wl == 0) continue;  // level too small to host the patch
    const int H = lv.H[l], W = lv.W[l];
    const float scale = (float)(1 << l);
    const float plx = px / scale, ply = py / scale;
    const float ex = plx + dx / scale, ey = ply + dy / scale;
    const int oxP = window_origin(plx, wl, W), oyP = window_origin(ply, wl, H);
    const int oxC = window_origin(ex, wl, W), oyC = window_origin(ey, wl, H);
    const Solve s = lk_solve(
        lv.prev[l], lv.cur[l], H, W, oxP, oyP, oxC, oyC,
        (ply - rf) - (float)oyP, (plx - rf) - (float)oxP,
        (ey - rf) - (float)oyC, (ex - rf) - (float)oxC, wl, radius, iters,
        scratch, patch, swin, phase);
    dx = ((ex + s.ux) - plx) * scale;
    dy = ((ey + s.uy) - ply) * scale;
    ok = ok && s.ok;
    if (l == 0) {
      oxP0 = oxP, oyP0 = oyP, oxC0 = oxC, oyC0 = oyC;
      res0 = s.res;
    }
  }
  const float nx = px + dx, ny = py + dy;

  // forward-backward: template from cur at the new point, samples from prev
  const int H0 = lv.H[0], W0 = lv.W[0];
  const Solve f = lk_solve(
      lv.cur[0], lv.prev[0], H0, W0, oxC0, oyC0, oxP0, oyP0,
      (ny - rf) - (float)oyC0, (nx - rf) - (float)oxC0,
      (py - rf) - (float)oyP0, (px - rf) - (float)oxP0, lv.wl[0], radius,
      iters, scratch, patch, swin, phase);
  const float fb_err = sqrtf(f.uy * f.uy + f.ux * f.ux);

  const bool inb = nx >= (float)(radius + 1) && nx < (float)(W0 - radius - 1)
                   && ny >= (float)(radius + 1)
                   && ny < (float)(H0 - radius - 1);
  ok = ok && inb && res0 < max_residual && fb_err < fb_thresh
       && isfinite(nx) && isfinite(ny);
  if (threadIdx.x == 0) {
    new_pts[2 * k] = ok ? nx : px;
    new_pts[2 * k + 1] = ok ? ny : py;
    ok_out[k] = ok ? 1 : 0;
  }
}

int block_threads(int radius) {
  const int m = 2 * radius + 1;
  return (m * m + 31) / 32 * 32;
}

}  // namespace

// One level: imgT/imgI (H,W), orgT/orgI (K,2) i32 (x0,y0), stT/sI0 (2,K)
// (row,col) -> u (2,K) = (uy,ux), stat (2,K) = (residual, ok as 0/1).
extern "C" int vt_lk_level(const float* imgT, const float* imgI, int H,
                           int W,
                           const int* orgT, const int* orgI, const float* stT,
                           const float* sI0, float* u, float* stat, int K,
                           int win, int radius, int iters, void* stream) {
  const size_t smem = smem_floats(2 * radius + 1, win) * sizeof(float);
  lk_level_kernel<<<K, block_threads(radius), smem, (cudaStream_t)stream>>>(
        imgT, imgI, H, W, orgT, orgI, stT, sI0, u, stat, K, win, radius,
        iters);
  return (int)cudaGetLastError();
}

// A whole tracked frame: `level_table` points at an LkLevels table in host
// memory (copied into the launch by value; void* because the type is
// local to this file); pts (K,2) f32 (x,y), valid (K,)
// bytes -> new_pts (K,2), ok (K,) bytes. Level 0 must not be skipped.
extern "C" int vt_lk_track(const void* level_table, const float* pts,
                           const unsigned char* valid, float* new_pts,
                           unsigned char* ok, int K, int radius, int iters,
                           float max_residual, float fb_thresh,
                           void* stream) {
  const LkLevels* levels = static_cast<const LkLevels*>(level_table);
  int win = 0;
  for (int l = 0; l < levels->n; ++l)
    if (levels->wl[l] > win) win = levels->wl[l];
  const size_t smem = smem_floats(2 * radius + 1, win) * sizeof(float);
  lk_track_kernel<<<K, block_threads(radius), smem, (cudaStream_t)stream>>>(
      *levels, pts, valid, new_pts, ok, radius, iters, max_residual,
      fb_thresh);
  return (int)cudaGetLastError();
}
