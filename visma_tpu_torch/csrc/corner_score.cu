// Fused Shi-Tomasi corner score with 3x3 non-maximum suppression, and the
// best corner of each detection cell in the same launch.
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
// With a cell buffer it also picks, per `cell` x `cell` square of
// [:Hc, :Wc], what detect.py::cell_best_plain picks (the reference's
// reduce_window at visma_tpu/frontend/detect.py:166-180): the best score
// and the LAST maximal linear index row * Wc + col among pixels > 0.
//
// Design: one block of 256 threads per 64 x 32 output tile. The image tile
// and a 4-px halo are staged in shared memory with float4 loads. Each of
// 210 threads then walks down one column of a third of the tile's rows,
// computing the gradient products from a 3x3 register window (one new
// image row a step) and the 5-row vertical sums from a ring of 5 products
// in registers, taps added in the plain version's order (a running sum that
// subtracts would round differently, and the NMS flips on one ulp). The
// horizontal sums, the response and the NMS read shared memory; no stage
// divides or takes a modulo per element. The NMS writes its map with float4
// stores. The cell pick: each positive pixel takes a 64-bit atomicMax on
// (float bits of the score) << 32 | (index + 1) in a shared table of the
// tile's cells, one global atomicMax per (tile, cell) follows, and the last
// block to finish decodes every cell into (score, index, x, y). A maximum is
// order-free, so the pick is deterministic; the caller's buffer is zeroed
// on the same stream before the launch.
// What bounds it on an H100: at 500x960, launch latency; its bytes (4 in
// and 4 out a pixel) take 1.15 us. The library is built with -fmad=false
// and every sum keeps the plain version's order, so the map equals the
// plain version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 64;                     // output tile width
constexpr int TH = 32;                     // output tile height
constexpr int THREADS = 256;
constexpr int IMG_H = TH + 8, IMG_W = TW + 8;  // image, 4-px halo: 40 x 72
constexpr int IQ = IMG_W / 4;                  // float4s an image row
constexpr int V_H = TH + 2, V_W = TW + 6;      // vertical sums: 34 x 70
constexpr int R_H = TH + 2, R_W = TW + 2;      // responses, 1-px halo: 34 x 66
constexpr int SEG = 12;                        // vertical-sum rows a walk
constexpr int NSEG = (V_H + SEG - 1) / SEG;    // walks a column: 3
constexpr int CELL_CAP = 128;                  // shared cell table entries

typedef unsigned long long u64;

// Gradient products at the centre of a 3x3 window: t, m, b are the rows
// above, at and below it, each (west, centre, east).
__device__ __forceinline__ void products(const float t[3], const float m[3],
                                         const float b[3], float& a,
                                         float& ab, float& c) {
  const float east_west = m[2] - m[0];
  const float ne_nw = t[2] - t[0];
  const float se_sw = b[2] - b[0];
  const float gx = ((ne_nw + 2.0f * east_west) + se_sw) / 8.0f;
  const float south_north = b[1] - t[1];
  const float gy = (((b[0] - t[0]) + 2.0f * south_north) + (b[2] - t[2]))
                   / 8.0f;
  a = gx * gx;
  ab = gx * gy;
  c = gy * gy;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
corner_score_kernel(const float* __restrict__ img, float* __restrict__ out,
                    int H, int W, int border, float min_response,
                    u64* __restrict__ cells, int cell, int gw, int Hc, int Wc,
                    float* __restrict__ cell_score, int* __restrict__ cell_idx,
                    float* __restrict__ cell_xy) {
  __shared__ __align__(16) float s_img[IMG_H * IMG_W];  // later: responses
  __shared__ float s_v[3][V_H * V_W];
  __shared__ u64 s_cell[CELL_CAP];
  __shared__ int s_last;
  float* s_r = s_img;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;

  // the cells this tile overlaps, in a shared table when they fit
  const bool pick = cells != nullptr;
  int cy_lo = 0, cx_lo = 0, ncx = 0, n_local = 0;
  if (pick && y0 < Hc && x0 < Wc) {
    cy_lo = y0 / cell;
    cx_lo = x0 / cell;
    ncx = (min(x0 + TW, Wc) - 1) / cell - cx_lo + 1;
    n_local = ((min(y0 + TH, Hc) - 1) / cell - cy_lo + 1) * ncx;
    if (n_local > CELL_CAP) n_local = 0;
    for (int k = tid; k < n_local; k += THREADS) s_cell[k] = 0ull;
  }
  const bool local = n_local > 0;

  // A. image tile, zero outside the frame
  for (int q = tid; q < IMG_H * IQ; q += THREADS) {
    const int r = q / IQ, cq = q - r * IQ;
    const int y = y0 - 4 + r, x = x0 - 4 + 4 * cq;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (y >= 0 && y < H) {
      const float* row = img + (size_t)y * W;
      if (VEC) {
        if (x >= 0 && x < W) v = __ldg(reinterpret_cast<const float4*>(row + x));
      } else {
        v.x = (x >= 0 && x < W) ? __ldg(row + x) : 0.0f;
        v.y = (x + 1 >= 0 && x + 1 < W) ? __ldg(row + x + 1) : 0.0f;
        v.z = (x + 2 >= 0 && x + 2 < W) ? __ldg(row + x + 2) : 0.0f;
        v.w = (x + 3 >= 0 && x + 3 < W) ? __ldg(row + x + 3) : 0.0f;
      }
    }
    *reinterpret_cast<float4*>(s_img + r * IMG_W + 4 * cq) = v;
  }
  __syncthreads();

  // B. gradient products and vertical sums, one column walk a thread.
  //    Product row p is y0 - 3 + p (image rows p..p+2 around it); vertical
  //    sum row r is y0 - 1 + r, the sum of product rows r..r+4 in order.
  //    Products outside the frame are 0 (the plain version pads them).
  if (tid < NSEG * V_W) {
    const int c = tid % V_W, seg = tid / V_W;
    const int r_begin = seg * SEG;
    const int n_rows = min(SEG, V_H - r_begin);
    const int x = x0 - 3 + c;
    const bool col_in = x >= 0 && x < W;
    const float* col = s_img + c;
    float t[3], m[3], b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t[k] = col[r_begin * IMG_W + k];
      m[k] = col[(r_begin + 1) * IMG_W + k];
    }
    float pa[5] = {}, pb[5] = {}, pc[5] = {};
#pragma unroll
    for (int s = 0; s < SEG + 4; ++s) {
      if (s >= n_rows + 4) break;
      const int p = r_begin + s;
#pragma unroll
      for (int k = 0; k < 3; ++k) b[k] = col[(p + 2) * IMG_W + k];
      const int y = y0 - 3 + p;
      float a = 0.0f, ab = 0.0f, cc = 0.0f;
      if (col_in && y >= 0 && y < H) products(t, m, b, a, ab, cc);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        t[k] = m[k];
        m[k] = b[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pa[k] = pa[k + 1];
        pb[k] = pb[k + 1];
        pc[k] = pc[k + 1];
      }
      pa[4] = a;
      pb[4] = ab;
      pc[4] = cc;
      if (s >= 4) {
        const int r = r_begin + s - 4;
        s_v[0][r * V_W + c] = (((pa[0] + pa[1]) + pa[2]) + pa[3]) + pa[4];
        s_v[1][r * V_W + c] = (((pb[0] + pb[1]) + pb[2]) + pb[3]) + pb[4];
        s_v[2][r * V_W + c] = (((pc[0] + pc[1]) + pc[2]) + pc[3]) + pc[4];
      }
    }
  }
  __syncthreads();

  // C. horizontal sums and the minimum eigenvalue; -inf outside the frame
  //    for the NMS. Response (r, c) is pixel (y0 - 1 + r, x0 - 1 + c).
  {
    const int tx = tid & 63, ty = tid >> 6;
    for (int r = ty; r < R_H; r += THREADS / 64) {
      const int y = y0 - 1 + r;
      for (int c = tx; c < R_W; c += 64) {
        const int x = x0 - 1 + c;
        float resp = -INFINITY;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          float S3[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float* v = s_v[k] + r * V_W + c;
            S3[k] = (((v[0] + v[1]) + v[2]) + v[3]) + v[4];
          }
          const float A = S3[0], B = S3[1], C = S3[2];
          const float d = A - C;
          const float disc = sqrtf(fmaxf(d * d + (4.0f * B) * B, 0.0f));
          resp = 0.5f * ((A + C) - disc);
        }
        s_r[r * R_W + c] = resp;
      }
    }
  }
  __syncthreads();

  // D. 3x3 NMS, border mask and threshold on 2 rows x 4 columns a thread,
  //    from a 4 x 6 window of responses in registers; then the cell pick
  const int c0 = 4 * (tid & 15), r0 = 2 * (tid >> 4);
  float w[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) w[i][j] = s_r[(r0 + i) * R_W + c0 + j];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int y = y0 + r0 + rr;
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = x0 + c0 + k;
      const float v = w[rr + 1][k + 1];
      float neigh = v;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) neigh = fmaxf(neigh, w[rr + dy][k + dx]);
      const bool inside = y >= border && y < H - border && x >= border &&
                          x < W - border;
      o[k] = (v >= neigh && inside && v > min_response) ? v : 0.0f;
    }
    if (y < H) {
      float* dst = out + (size_t)y * W + x0 + c0;
      if (VEC) {
        if (x0 + c0 < W)
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (x0 + c0 + k < W) dst[k] = o[k];
      }
    }
    if (pick && y < Hc) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = x0 + c0 + k;
        if (!(o[k] > 0.0f) || x >= Wc) continue;  // corners are sparse
        const u64 key = ((u64)__float_as_uint(o[k]) << 32) |
                        (u64)(unsigned)(y * Wc + x + 1);
        const int cy = y / cell, cx = x / cell;
        if (local)
          atomicMax(&s_cell[(cy - cy_lo) * ncx + cx - cx_lo], key);
        else
          atomicMax(&cells[(size_t)cy * gw + cx], key);
      }
    }
  }
  if (!pick) return;

  // E. the tile's cells to the global table; the last block decodes them
  __syncthreads();
  for (int k = tid; k < n_local; k += THREADS) {
    const u64 key = s_cell[k];
    if (key) {
      const int cy = k / ncx;
      atomicMax(&cells[(size_t)(cy_lo + cy) * gw + cx_lo + k - cy * ncx], key);
    }
  }
  __threadfence();
  __syncthreads();
  const int ncells = (Hc / cell) * gw;
  if (tid == 0) {
    unsigned* done = reinterpret_cast<unsigned*>(cells + ncells);
    s_last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = tid; k < ncells; k += THREADS) {
    const u64 key = *reinterpret_cast<volatile u64*>(cells + k);
    const int idx = key ? (int)(unsigned)(key & 0xffffffffull) - 1 : -1;
    const int cy = idx >= 0 ? idx / Wc : 0;
    const int cx = idx >= 0 ? idx - cy * Wc : 0;
    cell_score[k] = key ? __uint_as_float((unsigned)(key >> 32)) : 0.0f;
    cell_idx[k] = idx;
    cell_xy[2 * k] = (float)cx;
    cell_xy[2 * k + 1] = (float)cy;
  }
}

}  // namespace

// img, out (H, W). cells: null for the map alone, else (ncells + 1) u64
// scratch (the last word counts finished blocks), zeroed here on the
// stream; cell_score, cell_idx, cell_xy: (ncells,), (ncells,), (ncells, 2)
// with ncells = (H / cell) * (W / cell) > 0.
extern "C" int vt_corner_score(const float* img, float* out, int H, int W,
                               int border, float min_response, void* cells,
                               int cell, float* cell_score, int* cell_idx,
                               float* cell_xy, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int gh = cells ? H / cell : 0, gw = cells ? W / cell : 0;
  if (cells) {
    const cudaError_t e = cudaMemsetAsync(
        cells, 0, sizeof(u64) * ((size_t)gh * gw + 1), st);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  u64* c = static_cast<u64*>(cells);
  if (vec)
    corner_score_kernel<true><<<grid, THREADS, 0, st>>>(
        img, out, H, W, border, min_response, c, cell, gw, gh * cell,
        gw * cell, cell_score, cell_idx, cell_xy);
  else
    corner_score_kernel<false><<<grid, THREADS, 0, st>>>(
        img, out, H, W, border, min_response, c, cell, gw, gh * cell,
        gw * cell, cell_score, cell_idx, cell_xy);
  return (int)cudaGetLastError();
}
