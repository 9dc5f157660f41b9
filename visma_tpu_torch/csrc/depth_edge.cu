// Depth-edge stencil of the renderer, and the occlusion-aware edge score of
// the CEM built on it.
//
// vt_depth_edge replaces the TPU kernel visma_tpu/image/edges.py::_edge_kernel
// (called by depth_edge_pallas). It computes what the plain PyTorch twin
// (visma_tpu_torch/image/edges.py::depth_edge_plain) computes:
//   background (depth <= 0 or not finite) -> -1; outside the frame -> 0;
//   delta = 0.25 * (|W - E| + |S - N| + |NW - SE| + |SW - NE|), the four
//   terms added in this order; soft threshold clamp((delta - lo) / range,
//   0, 1); 0 on background pixels and within `border` px of the frame edge.
//
// vt_edge_score computes, in one pass over the inputs, the whole
// occlusion-aware score of a batch of hypothesis windows that
// visma_tpu_torch/render/likelihood.py::edge_score_plain composes from two
// stencil passes, a 5x5 max-pool and six reductions: per window b of object
// i = b / S,
//   joint = min(depth[b], occ[i]) (NaN-propagating, as torch.minimum);
//   a     = max(edge(joint) - edge(occ[i]), 0)   (a = edge(depth) with no
//           occluder);
//   num   = sum a * min(dt[i], tau),  den = sum a,
//   cov   = sum min(maxpool_(2r+1)^2(a), 1) * obs[i];
//   score = (den > 0 ? num / max(den, 1e-6) : tau)
//           + cw * (1 - cov / max(obs_mass, 1e-6)).
// The TPU package has no kernel for this: it fuses in XLA.
//
// Design for the H100. Both kernels work on 64 x 32 output tiles with 256
// threads and share one __device__ stencil on linear depths. Staging reads
// each row of the tile and its halo as float4 (the column halo is one
// float4, 4 px) when the width allows it. The score kernel stages depth and
// occluder with a 3-px row halo (1 for the stencil, 2 for the dilation) in
// shared memory, all of a thread's loads in flight at once. It computes `a`
// on the tile plus a 2-px ring by column walks (a 3x3 window in registers,
// one new row a step), and the occluder's edge only where the joint has
// one: elsewhere a = max(0 - e_occ, 0) = 0. The max-pool runs separably,
// rows then columns, in a second column walk over a ring of row maxima,
// which also takes the sums; dt and obs are read once a tile, fetched
// before the stencil. The occluder window is re-read by each of the S
// windows' tiles: they run in neighbouring blocks, so it comes from L2, and
// no separate launch or edge map in device memory is needed. The three sums
// are reduced in a fixed order (warp butterflies, then warps in order) into
// one partial per tile; a second kernel of the same call adds each window's
// tiles in a fixed order and forms the score. No float atomics: the scores
// are bitwise repeatable, which the CEM's stable argsort relies on to pick
// its elites.
//
// What bounds them: device-memory traffic. depth_edge moves 4 bytes in and
// 4 out a pixel; edge_score reads each depth window once and each object's
// occluder, dt and evidence windows once (42.5 MB at 96 windows of
// 256 x 384) and writes one float a window; the arithmetic is ~50
// operations a pixel. The library is built with -fmad=false and the stencil
// sums in the plain version's order, so edge maps round as the plain
// version's; the score's sums are taken in another order than torch.sum.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 64;            // output tile width: 16 float4 columns
constexpr int TH = 32;            // output tile height
constexpr int THREADS = 256;
constexpr int XH = 4;             // staged column halo: one float4
constexpr int SW = TW + 2 * XH;   // staged row width, 72
constexpr int SQ = SW / 4;        // float4s a staged row, 18
constexpr int AH = TH + 4;        // rows of `a`: the tile and a 2-px ring
constexpr int AW = TW + 4;        // columns of `a`

__device__ __forceinline__ float linear_depth(float d) {
  return (isfinite(d) && d > 0.0f) ? d : -1.0f;
}

// torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

// Four raw values of row y at columns x..x+3 (x a multiple of 4) and
// whether each lies in the frame. VEC: W % 4 == 0 and the rows 16-byte
// aligned, so the four are all in the frame or all outside it.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ img, int y,
                                      int x, int H, int W, float v[4],
                                      bool in[4]) {
  const bool row_in = y >= 0 && y < H;
  if (VEC) {
    const bool ok = row_in && x >= 0 && x < W;
    const float4 q =
        ok ? __ldg(reinterpret_cast<const float4*>(img + (size_t)y * W + x))
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) in[k] = ok;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      in[k] = row_in && x + k >= 0 && x + k < W;
      v[k] = in[k] ? __ldg(img + (size_t)y * W + x + k) : 0.0f;
    }
  }
}

// K5's stencil on the 3x3 linear depths around a pixel: t, m, b are the
// rows above, at and below it, each (west, centre, east); `inside`: the
// pixel lies `border` px or more inside the frame.
__device__ __forceinline__ float edge3x3(const float t[3], const float m[3],
                                         const float b[3], bool inside,
                                         float lo, float range) {
  if (!inside || !(m[1] > 0.0f)) return 0.0f;
  const float we = fabsf(m[0] - m[2]);
  const float sn = fabsf(b[1] - t[1]);
  const float d1 = fabsf(t[0] - b[2]);
  const float d2 = fabsf(b[0] - t[2]);
  const float delta = 0.25f * (((we + sn) + d1) + d2);
  return fminf(fmaxf((delta - lo) / range, 0.0f), 1.0f);
}

// The same on linear depths in shared memory: `s` points at the centre, P
// is the row pitch.
__device__ __forceinline__ float edge_at(const float* s, int P, bool inside,
                                         float lo, float range) {
  const float t[3] = {s[-P - 1], s[-P], s[-P + 1]};
  const float m[3] = {s[-1], s[0], s[1]};
  const float b[3] = {s[P - 1], s[P], s[P + 1]};
  return edge3x3(t, m, b, inside, lo, range);
}

__device__ __forceinline__ bool inside_border(int y, int x, int H, int W,
                                              int border) {
  return x >= border && x <= W - 1 - border && y >= border &&
         y <= H - 1 - border;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
depth_edge_kernel(const float* __restrict__ depth, float* __restrict__ out,
                  int B, int H, int W, float lo, float range, int border) {
  __shared__ __align__(16) float s[(TH + 2) * SW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int c0 = 4 * (tid & 15), r0 = 2 * (tid >> 4);
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* img = depth + (size_t)b * H * W;
    for (int q = tid; q < (TH + 2) * SQ; q += THREADS) {
      const int r = q / SQ, cq = q - r * SQ;
      float v[4];
      bool in[4];
      load4<VEC>(img, y0 - 1 + r, x0 - XH + 4 * cq, H, W, v, in);
      *reinterpret_cast<float4*>(s + r * SW + 4 * cq) = make_float4(
          in[0] ? linear_depth(v[0]) : 0.0f, in[1] ? linear_depth(v[1]) : 0.0f,
          in[2] ? linear_depth(v[2]) : 0.0f, in[3] ? linear_depth(v[3]) : 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int y = y0 + r0 + rr;
      if (y >= H) continue;
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        e[k] = edge_at(s + (r0 + rr + 1) * SW + XH + c0 + k, SW,
                       inside_border(y, x0 + c0 + k, H, W, border), lo, range);
      float* o = out + ((size_t)b * H + y) * W + x0 + c0;
      if (VEC) {
        if (x0 + c0 < W)
          *reinterpret_cast<float4*>(o) = make_float4(e[0], e[1], e[2], e[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (x0 + c0 + k < W) o[k] = e[k];
      }
    }
    __syncthreads();  // the next window overwrites the staged tile
  }
}

// One block per (tile, window): the tile's three partial sums.
template <bool VEC, bool OCC>
__global__ void __launch_bounds__(THREADS, 5)
edge_score_tiles(const float* __restrict__ depth, const float* __restrict__ occ,
                 int occ_stride, const float* __restrict__ dt, int dt_stride,
                 const float* __restrict__ obs, int obs_stride,
                 float* __restrict__ partial, int S, int H, int W,
                 int tiles_x, int radius, float lo, float range, int border,
                 float tau) {
  __shared__ __align__(16) float s_j[(TH + 6) * SW];  // joint, linear
  __shared__ __align__(16) float s_o[OCC ? (TH + 6) * SW : 1];
  __shared__ float s_a[AH * AW];
  __shared__ float s_red[THREADS / 32][3];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x, b = blockIdx.y, i = b / S;
  const int ty = tile / tiles_x;
  const int x0 = (tile - ty * tiles_x) * TW, y0 = ty * TH;
  const float* d_img = depth + (size_t)b * H * W;
  const float* o_img = OCC ? occ + (size_t)i * occ_stride : nullptr;

  // this thread's outputs: column x0 + ox, rows y0 + oy .. y0 + oy + 7;
  // their dt and evidence are fetched first, to land during the stencil
  const int ox = tid & 63, oy = 8 * (tid >> 6);
  const float* dt_img = dt + (size_t)i * dt_stride;
  const float* ob_img = obs + (size_t)i * obs_stride;
  float dv[8], ov[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int y = y0 + oy + k, x = x0 + ox;
    const bool in = y < H && x < W;
    dv[k] = in ? __ldg(dt_img + (size_t)y * W + x) : 0.0f;
    ov[k] = in ? __ldg(ob_img + (size_t)y * W + x) : 0.0f;
  }

  // 1. depth (and occluder) with a 3-px row halo, as linear depths; a
  //    thread's loads are all issued before the first is used
  constexpr int NQ = ((TH + 6) * SQ + THREADS - 1) / THREADS;
  float v[NQ][4], u[NQ][4];
  bool in[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int q = tid + n * THREADS, r = q / SQ, cq = q - r * SQ;
    if (q < (TH + 6) * SQ) {
      load4<VEC>(d_img, y0 - 3 + r, x0 - XH + 4 * cq, H, W, v[n], in[n]);
      if (OCC) load4<VEC>(o_img, y0 - 3 + r, x0 - XH + 4 * cq, H, W, u[n],
                          in[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int q = tid + n * THREADS, r = q / SQ, cq = q - r * SQ;
    if (q >= (TH + 6) * SQ) break;
    float j[4], o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      j[k] = in[n][k]
                 ? linear_depth(OCC ? min_nan(v[n][k], u[n][k]) : v[n][k])
                 : 0.0f;
      o[k] = (OCC && in[n][k]) ? linear_depth(u[n][k]) : 0.0f;
    }
    *reinterpret_cast<float4*>(s_j + r * SW + 4 * cq) =
        make_float4(j[0], j[1], j[2], j[3]);
    if (OCC)
      *reinterpret_cast<float4*>(s_o + r * SW + 4 * cq) =
          make_float4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();

  // 2. a = max(edge(joint) - edge(occ), 0) on the tile and a 2-px ring,
  //    one column walk of 12 rows a thread: a 3x3 window in registers, one
  //    new row a step. The occluder's edge matters only where the joint has
  //    one (a = max(0 - e_occ, 0) = 0 elsewhere).
  constexpr int WALK = AH / 3;
  if (tid < 3 * AW) {
    const int c = tid % AW, r_begin = (tid / AW) * WALK;
    const int x = x0 - 2 + c;
    const float* col = s_j + c + 1;  // staged column west of the pixel
    float t[3], m[3], bt[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t[k] = col[r_begin * SW + k];
      m[k] = col[(r_begin + 1) * SW + k];
    }
#pragma unroll
    for (int s = 0; s < WALK; ++s) {
      const int r = r_begin + s;
#pragma unroll
      for (int k = 0; k < 3; ++k) bt[k] = col[(r + 2) * SW + k];
      const bool inside = inside_border(y0 - 2 + r, x, H, W, border);
      float a = edge3x3(t, m, bt, inside, lo, range);
      if (OCC && a > 0.0f)
        a = fmaxf(a - edge_at(s_o + (r + 1) * SW + c + 2, SW, true, lo, range),
                  0.0f);
      s_a[r * AW + c] = a;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        t[k] = m[k];
        m[k] = bt[k];
      }
    }
  }
  __syncthreads();

  // 3. the dilation and the sums, one column walk of 8 outputs a thread:
  //    the max along each row of `a` (a >= 0 on the frame and 0 off it, and
  //    every window holds its in-frame centre, so the 0 stands for the
  //    -inf padding), then along the column from a ring of 5 row maxima
  float num = 0.0f, den = 0.0f, cov = 0.0f;
  float ring[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ctr[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    const float* p = s_a + (oy + s) * AW + ox + 2;
    float rm = p[0];
    for (int t = 1; t <= radius; ++t) rm = fmaxf(rm, fmaxf(p[-t], p[t]));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ring[k] = ring[k + 1];
      ctr[k] = ctr[k + 1];
    }
    ring[4] = rm;
    ctr[4] = p[0];
    if (s >= 4) {
      const int k = s - 4;  // output row oy + k: `a` rows oy + k .. + 4
      if (y0 + oy + k < H && x0 + ox < W) {
        float pool = ring[2];
        if (radius >= 1) pool = fmaxf(pool, fmaxf(ring[1], ring[3]));
        if (radius >= 2) pool = fmaxf(pool, fmaxf(ring[0], ring[4]));
        const float a = ctr[2];
        const float d = isnan(dv[k]) ? dv[k] : fminf(dv[k], tau);
        num += a * d;
        den += a;
        cov += fminf(pool, 1.0f) * ov[k];
      }
    }
  }

  // 4. the block's sums in a fixed order
  num = warp_sum(num);
  den = warp_sum(den);
  cov = warp_sum(cov);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    s_red[warp][0] = num;
    s_red[warp][1] = den;
    s_red[warp][2] = cov;
  }
  __syncthreads();
  if (tid < 3) {
    float acc = s_red[0][tid];
    for (int w = 1; w < THREADS / 32; ++w) acc += s_red[w][tid];
    partial[((size_t)b * gridDim.x + tile) * 3 + tid] = acc;
  }
}

// One warp per window: its tiles' partials in a fixed order, then the score.
__global__ void edge_score_finish(const float* __restrict__ partial, int B,
                                  int S, int ntiles,
                                  const float* __restrict__ mass,
                                  int mass_stride, float mass_value, float tau,
                                  float cw, float* __restrict__ scores) {
  const int b = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  float num = 0.0f, den = 0.0f, cov = 0.0f;
  for (int t = lane; t < ntiles; t += 32) {
    const float* p = partial + ((size_t)b * ntiles + t) * 3;
    num += p[0];
    den += p[1];
    cov += p[2];
  }
  num = warp_sum(num);
  den = warp_sum(den);
  cov = warp_sum(cov);
  if (lane == 0) {
    const float base = den > 0.0f ? num / fmaxf(den, 1e-6f) : tau;
    const float m = mass ? mass[(size_t)(b / S) * mass_stride] : mass_value;
    scores[b] = base + cw * (1.0f - cov / fmaxf(m, 1e-6f));
  }
}

template <bool VEC, bool OCC>
void launch_tiles(dim3 grid, cudaStream_t st, const float* depth,
                  const float* occ, int occ_stride, const float* dt,
                  int dt_stride, const float* obs, int obs_stride,
                  float* partial, int S, int H, int W, int tiles_x, int radius,
                  float lo, float range, int border, float tau) {
  edge_score_tiles<VEC, OCC><<<grid, THREADS, 0, st>>>(
      depth, occ, occ_stride, dt, dt_stride, obs, obs_stride, partial, S, H,
      W, tiles_x, radius, lo, range, border, tau);
}

}  // namespace

extern "C" int vt_depth_edge(const float* depth, float* out, int B, int H,
                             int W, float lo, float range, int border, int vec,
                             void* stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH,
                  B < 65535 ? B : 65535);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    depth_edge_kernel<true><<<grid, THREADS, 0, st>>>(depth, out, B, H, W, lo,
                                                      range, border);
  else
    depth_edge_kernel<false><<<grid, THREADS, 0, st>>>(depth, out, B, H, W,
                                                       lo, range, border);
  return (int)cudaGetLastError();
}

// depth (n*S, H, W); occ: object i's window at occ + i * occ_stride, or null
// for no occluders; dt and obs likewise (stride 0: one window for all);
// mass: the evidence mass of object i at mass[i * mass_stride], or null to
// take mass_value; partial: (n*S, tiles, 3) scratch; scores (n*S).
extern "C" int vt_edge_score(const float* depth, const float* occ,
                             int occ_stride, const float* dt, int dt_stride,
                             const float* obs, int obs_stride,
                             const float* mass, int mass_stride,
                             float mass_value, float* partial, float* scores,
                             int n, int S, int H, int W, int radius, float lo,
                             float range, int border, float tau, float cw,
                             int vec, void* stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int B = n * S, ntiles = tiles_x * tiles_y;
  const dim3 grid(ntiles, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec && occ)
    launch_tiles<true, true>(grid, st, depth, occ, occ_stride, dt, dt_stride,
                             obs, obs_stride, partial, S, H, W, tiles_x,
                             radius, lo, range, border, tau);
  else if (vec)
    launch_tiles<true, false>(grid, st, depth, occ, occ_stride, dt, dt_stride,
                              obs, obs_stride, partial, S, H, W, tiles_x,
                              radius, lo, range, border, tau);
  else if (occ)
    launch_tiles<false, true>(grid, st, depth, occ, occ_stride, dt, dt_stride,
                              obs, obs_stride, partial, S, H, W, tiles_x,
                              radius, lo, range, border, tau);
  else
    launch_tiles<false, false>(grid, st, depth, occ, occ_stride, dt,
                               dt_stride, obs, obs_stride, partial, S, H, W,
                               tiles_x, radius, lo, range, border, tau);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  edge_score_finish<<<(B + 3) / 4, 128, 0, st>>>(partial, B, S, ntiles, mass,
                                                 mass_stride, mass_value, tau,
                                                 cw, scores);
  return (int)cudaGetLastError();
}
