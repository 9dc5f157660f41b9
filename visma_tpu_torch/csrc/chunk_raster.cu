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
// plane as (px*a + py*b) + c in that order; the pixel is inside a triangle
// iff its three edge planes are >= 0 and 1/far < 1/z < 1/near; the maximum
// 1/z wins; the output is metric depth 1/max, +inf where nothing covers
// the pixel (the reference converts and crops in a separate pass).
//
// Inputs, as the Python setup packs them:
//   planes (B, nc, 128, 12) f32  a triangle is 12 contiguous floats
//                                a0 b0 c0 a1 b1 c1 a2 b2 c2 az bz cz
//   ids    (B, nsub, nc)   i32   per subtile, the hitting chunk ids first
//   counts (B, nsub)       i32   how many of them hit
//   out    (B, H, W)       f32
// over the row-major (ceil(H/SUB), ceil(W/SUB)) subtile grid. The table is
// triangle-major, as the triangle setup produces it: the TPU kernel wanted
// the 128 triangles of a chunk in the lane dimension, (B, nc, 12, 128),
// which cost a transposing copy in the setup and a transpose back in here.
//
// What bounds it on an H100: operations, at the rate an SM's schedulers
// dispatch them. A (pixel, triangle) evaluation is 8 multiplies and 8 adds (kept
// apart by -fmad=false, so that every plane rounds as in the plain version
// and the inside test flips on the same pixels), 5 compares, a select and a
// maximum. Testing every pixel of a subtile against all 128 triangles of
// every hitting chunk ran at nine tenths of that rate already; but a chunk's
// bbox is ~30 px and a triangle a few, so most of those triangles cannot
// touch the subtile. The only way down is to evaluate fewer pairs.
//
// Design. One block of 256 threads owns one (pose, subtile), in two stages.
//   1. Cull. A thread takes one triangle of a hitting chunk (two chunks a
//      pass), reads its 12 coefficients straight from the table (three
//      16-byte loads; the tables of a call stay in L2) and evaluates each
//      edge plane at the subtile corner that maximises it, and the 1/z
//      plane at its maximising and minimising corners, with the pixel
//      loop's own expression. The triangle survives iff the three maxima
//      are >= 0, max 1/z > 1/far and min 1/z < 1/near. Survivors are
//      compacted (ballot, popcount, per-warp counts) into a list of
//      coefficient rows in shared memory; the list is filled over several
//      passes and flushed through stage 2 only when the next pass might
//      overflow it, so the pixel loop stays long and the barriers few.
//   2. Pixel loop. A warp owns a compact footprint of the subtile (8x4
//      pixels of the 16-px subtile, one a thread; 16x8 of the 32-px
//      subtile, four a thread in rows 2 apart, which reuse the triangle's
//      coefficients and the px*a products). It takes the list 32 rows at a
//      time: each lane puts one row through the same corner test against
//      the warp's own footprint, a ballot gives the rows that can touch it,
//      and the warp evaluates its pixels on those rows only (a row is three
//      16-byte shared loads that all lanes share). No list is written and
//      no barrier is needed: the ballot is the list. A thread keeps the
//      running maximum of its pixels in registers.
// The cull is exact, at both levels. Rounded multiplication and addition
// are monotone, so (px*a + py*b) + c, rounded as written, is largest over a
// rectangle of pixels at the corner picked by the signs of a and b: the
// corner value IS the maximum of what the pixel loop would compute there.
// A culled triangle is one that no pixel of the rectangle accepts, and the
// image is the same bit for bit. A NaN fails every comparison in both
// stages (a corner value can be NaN only where every pixel's value is NaN
// or infinite of the failing sign); the dead-triangle plane a = b = 0,
// c0 = -1 is culled.
// The grid takes all poses of a call at once; a block of an empty subtile
// writes +inf and returns after one read. A maximum does not depend on the
// order of the list, so the result is the same from run to run.
//
// What the card offers beyond that, and why it is not used here:
//   * shared memory holds the survivor list (24 KB for 512 rows) and no
//     longer a staged 6 KB chunk; 8 blocks of 256 threads still fit an SM.
//   * asynchronous copies (cp.async, cp.async.bulk on an mbarrier) would
//     prefetch the next chunk for stage 1. Stage 1 reads each coefficient
//     once, into registers, and 8 resident blocks an SM overlap one block's
//     L2 latency with the others' pixel loops; a staged copy would add a
//     shared-memory round trip to data used once.
//   * tensor cores: the four planes are a depth-3 product (px, py, 1), far
//     below an MMA tile's depth, and TF32 would round pixel coordinates up
//     to 960 and the coefficients to 10 mantissa bits, which moves the
//     inside test; float32 exactness against the plain version is the
//     contract.
//   * a list of the non-empty (pose, subtile) items in place of the full
//     grid: the full grid with every list empty takes a tenth of the call
//     (chip_smoke.py times it), so compacting it could save no more.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 128;          // triangles to a chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CAP = 512;            // rows of the survivor list
constexpr unsigned FULL = 0xffffffffu;

// The plane (px*a + py*b) + c at the corner of [x_lo, x_hi] x [y_lo, y_hi]
// that maximises it (want_max) or minimises it.
__device__ __forceinline__ float corner_value(float a, float b, float c,
                                              float x_lo, float x_hi,
                                              float y_lo, float y_hi,
                                              bool want_max) {
  const float px = ((a < 0.0f) == want_max) ? x_lo : x_hi;
  const float py = ((b < 0.0f) == want_max) ? y_lo : y_hi;
  return (px * a + py * b) + c;
}

template <int SUB>
__global__ void __launch_bounds__(THREADS)
chunk_raster_kernel(const float* __restrict__ planes,
                    const int* __restrict__ ids,
                    const int* __restrict__ counts, float* __restrict__ out,
                    int nc, int H, int W, int nsx, int nsub, float inv_near,
                    float inv_far) {
  // a warp's footprint: FW x FH pixels, 2 x 4 footprints to a subtile
  constexpr int FW = SUB / 2, FH = SUB / 4;
  constexpr int STEP = 32 / FW;        // rows one pass of a warp covers
  constexpr int PIX = FH / STEP;       // pixels per thread
  __shared__ float4 s_list[CAP * 3];   // surviving triangles' rows
  __shared__ int s_wcnt[WARPS];        // survivors per warp of one pass

  const int b = blockIdx.z;
  const int st = blockIdx.y * nsx + blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int fx0 = blockIdx.x * SUB + (warp % 2) * FW;
  const int fy0 = blockIdx.y * SUB + (warp / 2) * FH;
  const int x = fx0 + lane % FW;
  const int y0 = fy0 + lane / FW;
  const float px = (float)x;
  float py[PIX], best[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    py[k] = (float)(y0 + k * STEP);
    best[k] = 0.0f;
  }
  // the pixels the warp's footprint really has
  const float wx_lo = (float)fx0, wx_hi = (float)min(fx0 + FW - 1, W - 1);
  const float wy_lo = (float)fy0, wy_hi = (float)min(fy0 + FH - 1, H - 1);

  // the pixels the subtile really has
  const float x_lo = (float)(blockIdx.x * SUB);
  const float x_hi = (float)min(blockIdx.x * SUB + SUB - 1, W - 1);
  const float y_lo = (float)(blockIdx.y * SUB);
  const float y_hi = (float)min(blockIdx.y * SUB + SUB - 1, H - 1);

  const int n = counts[(size_t)b * nsub + st];
  const int* my_ids = ids + ((size_t)b * nsub + st) * nc;
  const float4* my_planes =
      reinterpret_cast<const float4*>(planes) + (size_t)b * nc * CHUNK * 3;

  // the coarse test of one triangle against a pixel rectangle
  auto may_touch = [&](const float4& q0, const float4& q1, const float4& q2,
                       float xl, float xh, float yl, float yh) {
    return corner_value(q0.x, q0.y, q0.z, xl, xh, yl, yh, true) >= 0.0f
           && corner_value(q0.w, q1.x, q1.y, xl, xh, yl, yh, true) >= 0.0f
           && corner_value(q1.z, q1.w, q2.x, xl, xh, yl, yh, true) >= 0.0f
           && corner_value(q2.y, q2.z, q2.w, xl, xh, yl, yh, true) > inv_far
           && corner_value(q2.y, q2.z, q2.w, xl, xh, yl, yh, false)
                  < inv_near;
  };

  // stage 2: the warp's pixels against those of the first `cnt` list rows
  // that can touch its footprint
  auto pixel_loop = [&](int cnt) {
    for (int base = 0; base < cnt; base += 32) {
      const int mine = base + lane;
      bool hit = false;
      if (mine < cnt)
        hit = may_touch(s_list[3 * mine], s_list[3 * mine + 1],
                        s_list[3 * mine + 2], wx_lo, wx_hi, wy_lo, wy_hi);
      unsigned rows = __ballot_sync(FULL, hit);
      while (rows) {
        const int j = base + __ffs(rows) - 1;
        rows &= rows - 1;
        const float4 q0 = s_list[3 * j];      // a0 b0 c0 a1
        const float4 q1 = s_list[3 * j + 1];  // b1 c1 a2 b2
        const float4 q2 = s_list[3 * j + 2];  // c2 az bz cz
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
  };

  int cur = 0;  // rows in the list; the same in every thread
  for (int i0 = 0; i0 < n; i0 += THREADS / CHUNK) {
    if (cur + THREADS > CAP) {  // the next pass might not fit: flush
      pixel_loop(cur);
      __syncthreads();          // the list has been consumed
      cur = 0;
    }
    // stage 1: one triangle a thread, THREADS / CHUNK chunks a pass
    const int i = i0 + tid / CHUNK;
    bool keep = false;
    float4 q0, q1, q2;
    if (i < n) {
      const float4* src =
          my_planes + ((size_t)my_ids[i] * CHUNK + tid % CHUNK) * 3;
      q0 = __ldg(src);
      q1 = __ldg(src + 1);
      q2 = __ldg(src + 2);
      keep = may_touch(q0, q1, q2, x_lo, x_hi, y_lo, y_hi);
    }
    const unsigned ballot = __ballot_sync(FULL, keep);
    if (lane == 0) s_wcnt[warp] = __popc(ballot);
    __syncthreads();
    int slot = cur, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_wcnt[w];
      if (w < warp) slot += c;
      total += c;
    }
    if (keep) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      s_list[3 * slot] = q0;
      s_list[3 * slot + 1] = q1;
      s_list[3 * slot + 2] = q2;
    }
    cur += total;
    __syncthreads();  // the list is complete; s_wcnt may be rewritten
  }
  pixel_loop(cur);

  if (x >= W) return;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int y = y0 + k * STEP;
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

// One pose, 32-px subtiles: planes (nc,128,12), ids (nsub,nc), counts
// (nsub) -> out (H,W).
extern "C" int vt_chunk_raster_frame(const float* planes, const int* ids,
                                     const int* counts, float* out, int nc,
                                     int H, int W, float inv_near,
                                     float inv_far, void* stream) {
  return launch<32>(planes, ids, counts, out, 1, nc, H, W, inv_near, inv_far,
                    stream);
}

// B poses (B <= 65535), 16-px subtiles: planes (B,nc,128,12), ids
// (B,nsub,nc), counts (B,nsub) -> out (B,H,W).
extern "C" int vt_chunk_raster_batched(const float* planes, const int* ids,
                                       const int* counts, float* out, int B,
                                       int nc, int H, int W, float inv_near,
                                       float inv_far, void* stream) {
  return launch<16>(planes, ids, counts, out, B, nc, H, W, inv_near, inv_far,
                    stream);
}
