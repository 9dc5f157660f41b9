// Triangle set-up of the chunked rasterizer: the plane table and the
// per-subtile chunk lists that K3/K4 (csrc/chunk_raster.cu) read, made from
// the mesh stack and the poses in two launches.
//
// Replaces no TPU kernel: the reference builds these tables with XLA ops
// (visma_tpu/render/raster.py::_prep_chunks_all). The port first built them
// with a chain of PyTorch ops (render/raster.py::_prep_chunks_all, kept as
// this kernel's plain twin, which CPU tensors take): about 150 launches a
// call, the gathered corner copy, a stack of twelve plane columns and a
// stable radix sort of every subtile's chunk scores. It computes exactly
// what that chain computes, in the same layouts:
//   planes (B, nc, 128, 12) f32  a triangle's row a0 b0 c0 a1 b1 c1 a2 b2
//                                c2 az bz cz; a triangle past the mesh's
//                                last (the chunk's padding) the always-fail
//                                row (-0 everywhere, c0 = -1)
//   ids    (B, nsub, nc)   i32   per subtile the chunks whose screen bbox
//                                hits it in ascending order, then the rest
//                                in ascending order (the stable descending
//                                sort's output)
//   counts (B, nsub)       i32   how many hit
// over the row-major (ceil(H/SUB), ceil(W/SUB)) subtile grid.
//
// Every value is rounded as the chain rounds it. The camera-frame corner is
// cuBLAS's K = 3 product, an FMA chain from 0 over j = 0, 1, 2, then + t; the
// rest is one rounding an operation in the chain's order (the library is
// built with -fmad=false, so nothing is contracted), comparisons in float32
// against the float32 value of each constant, and minima and maxima that
// let a NaN through as torch.minimum and amin do.
//
// What bounds it on an H100: bytes. A call reads the mesh stack (~190 KB a
// mesh, L2-resident) and writes the table and the lists: 24.2 MB and 6.0 MB
// for the settled CEM's 96 windows of 256x384, 7 us at 3.35 TB/s.
//
// Design.
//   1. tri_setup_planes: one block of 128 threads a (pose, chunk), one
//      thread a triangle. The thread reads its 9 corner floats straight
//      from the stack by the pose's mesh index (no gathered copy), projects
//      them, writes its row as three 16-byte stores, and the block reduces
//      the chunk's screen bbox (warp shuffles, then 4 partials in shared
//      memory) into a (B, nc) float4 scratch table.
//   2. tri_setup_bins<SUB>: one warp a (pose, subtile). It tests the nc
//      chunk bboxes 32 at a time with the chain's comparisons; ballots and
//      popcounts give every chunk its slot (hits first, then misses, each
//      ascending), so no score tensor and no sort exist.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 128;            // triangles to a chunk
constexpr int BIN_WARPS = 8;          // subtiles a block of the binning
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;           // a dead triangle's bbox lies beyond

// torch.minimum / amin and torch.maximum / amax: a NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// edge(xa, ya, xb, yb) of _planes_from_screen, before the scaling by
// 1/area: w(p) = (xb-xa)*(py-ya) - (yb-ya)*(px-xa)
struct Edge {
  float a, b, c;
};
__device__ __forceinline__ Edge edge(float xa, float ya, float xb, float yb,
                                     float inv_area) {
  const float dy = yb - ya, dx = xb - xa;
  const float c = dy * xa - dx * ya;
  return {-dy * inv_area, dx * inv_area, c * inv_area};
}

__global__ void __launch_bounds__(CHUNK)
tri_setup_planes(const float* __restrict__ Cs, const void* __restrict__ mesh,
                 int mesh64, int M, int T, const float* __restrict__ poses,
                 const float* __restrict__ origins, float* __restrict__ planes,
                 float4* __restrict__ bbox, int nc, float fx, float fy,
                 float cx, float cy, float z_near, float z_far) {
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int tri = c * CHUNK + t;
  long long m = 0;
  if (mesh != nullptr)
    m = mesh64 ? static_cast<const long long*>(mesh)[b]
               : static_cast<const int*>(mesh)[b];
  if (m < 0) m += M;                  // indexing's negative indices

  // the padding row: -(arange(12) == 2), so -0 everywhere but c0
  float row[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) row[k] = -0.0f;
  row[2] = -1.0f;
  float bx0 = BIG, bx1 = -BIG, by0 = BIG, by1 = -BIG;

  if (tri < T && m >= 0 && m < M) {
    const float* P = poses + (size_t)b * 12;       // (3,4): R | t
    const float* V = Cs + ((size_t)m * T + tri) * 9;
    float u[3], v[3], z[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float c0 = V[3 * k], c1 = V[3 * k + 1], c2 = V[3 * k + 2];
      float Vc[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Vc[i] = __fmaf_rn(P[4 * i + 2], c2,
                          __fmaf_rn(P[4 * i + 1], c1,
                                    __fmaf_rn(P[4 * i], c0, 0.0f)))
                + P[4 * i + 3];
      z[k] = Vc[2];
      const float sz = fabsf(Vc[2]) < 1e-9f ? 1e-9f : Vc[2];
      u[k] = (fx * Vc[0]) / sz + cx;
      v[k] = (fy * Vc[1]) / sz + cy;
      if (origins != nullptr) {
        u[k] = u[k] - origins[2 * b];
        v[k] = v[k] - origins[2 * b + 1];
      }
    }
    const float area = (u[1] - u[0]) * (v[2] - v[0])
                       - (v[1] - v[0]) * (u[2] - u[0]);
    const float zmin = nan_min(nan_min(z[0], z[1]), z[2]);
    const bool big_enough = fabsf(area) > 1e-12f;
    const bool ok = zmin > z_near && zmin < z_far && big_enough;
    const float inv_area = ok ? 1.0f / (big_enough ? area : 1.0f) : 0.0f;
    const Edge e0 = edge(u[1], v[1], u[2], v[2], inv_area);
    const Edge e1 = edge(u[2], v[2], u[0], v[0], inv_area);
    const Edge e2 = edge(u[0], v[0], u[1], v[1], inv_area);
    // when ok no corner is NaN and each z lies above z_near
    const float iz0 = ok ? 1.0f / fmaxf(z[0], 1e-9f) : 0.0f;
    const float iz1 = ok ? 1.0f / fmaxf(z[1], 1e-9f) : 0.0f;
    const float iz2 = ok ? 1.0f / fmaxf(z[2], 1e-9f) : 0.0f;
    row[0] = e0.a; row[1] = e0.b; row[2] = ok ? e0.c : -1.0f;
    row[3] = e1.a; row[4] = e1.b; row[5] = e1.c;
    row[6] = e2.a; row[7] = e2.b; row[8] = e2.c;
    row[9] = (e0.a * iz0 + e1.a * iz1) + e2.a * iz2;
    row[10] = (e0.b * iz0 + e1.b * iz1) + e2.b * iz2;
    row[11] = (e0.c * iz0 + e1.c * iz1) + e2.c * iz2;
    if (ok) {
      bx0 = nan_min(nan_min(u[0], u[1]), u[2]);
      bx1 = nan_max(nan_max(u[0], u[1]), u[2]);
      by0 = nan_min(nan_min(v[0], v[1]), v[2]);
      by1 = nan_max(nan_max(v[0], v[1]), v[2]);
    }
  }

  float4* dst = reinterpret_cast<float4*>(planes)
                + (((size_t)b * nc + c) * CHUNK + t) * 3;
  dst[0] = make_float4(row[0], row[1], row[2], row[3]);
  dst[1] = make_float4(row[4], row[5], row[6], row[7]);
  dst[2] = make_float4(row[8], row[9], row[10], row[11]);

  // the chunk's bbox: the minima and maxima over its 128 triangles
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    bx0 = nan_min(bx0, __shfl_xor_sync(FULL, bx0, off));
    bx1 = nan_max(bx1, __shfl_xor_sync(FULL, bx1, off));
    by0 = nan_min(by0, __shfl_xor_sync(FULL, by0, off));
    by1 = nan_max(by1, __shfl_xor_sync(FULL, by1, off));
  }
  __shared__ float4 s_box[CHUNK / 32];
  if ((t & 31) == 0) s_box[t >> 5] = make_float4(bx0, bx1, by0, by1);
  __syncthreads();
  if (t == 0) {
    float4 r = s_box[0];
#pragma unroll
    for (int w = 1; w < CHUNK / 32; ++w) {
      r.x = nan_min(r.x, s_box[w].x);
      r.y = nan_max(r.y, s_box[w].y);
      r.z = nan_min(r.z, s_box[w].z);
      r.w = nan_max(r.w, s_box[w].w);
    }
    bbox[(size_t)b * nc + c] = r;
  }
}

template <int SUB>
__global__ void __launch_bounds__(BIN_WARPS * 32)
tri_setup_bins(const float4* __restrict__ bbox, int* __restrict__ ids,
               int* __restrict__ counts, int nc, int nsx, int nsub) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * BIN_WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (s >= nsub) return;              // the whole warp
  const float tx0 = (float)((s % nsx) * SUB), ty0 = (float)((s / nsx) * SUB);
  const float tx1 = tx0 + (float)(SUB - 1), ty1 = ty0 + (float)(SUB - 1);
  const float4* box = bbox + (size_t)b * nc;
  auto hits = [&](int c) {
    const float4 q = __ldg(box + c);  // cx0 cx1 cy0 cy1
    return q.x <= tx1 && q.y >= tx0 && q.z <= ty1 && q.w >= ty0;
  };
  int total = 0;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int c = c0 + lane;
    total += __popc(__ballot_sync(FULL, c < nc && hits(c)));
  }
  int* out = ids + ((size_t)b * nsub + s) * nc;
  const unsigned below = (1u << lane) - 1u;
  int hit_slot = 0, miss_slot = total;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int c = c0 + lane;
    const bool valid = c < nc, hit = valid && hits(c);
    const unsigned h = __ballot_sync(FULL, hit);
    const unsigned miss = __ballot_sync(FULL, valid) & ~h;
    if (valid)
      out[hit ? hit_slot + __popc(h & below)
              : miss_slot + __popc(miss & below)] = c;
    hit_slot += __popc(h);
    miss_slot += __popc(miss);
  }
  if (lane == 0) counts[(size_t)b * nsub + s] = total;
}

}  // namespace

// B poses (1 <= B <= 65535) of a padded mesh stack Cs (M, T, 3, 3): pose b
// renders mesh mesh[b] (int64 where mesh64, else int32; NULL: mesh 0 for
// every pose) at poses[b] (3,4) into the window whose top-left is
// origins[b] (NULL: the frame). bbox is (B, nc, 4) f32 scratch; sub is the
// subtile edge, 16 or 32. A mesh index outside [-M, M) gives dead rows.
extern "C" int vt_tri_setup(const float* Cs, const void* mesh, int mesh64,
                            int M, int T, const float* poses,
                            const float* origins, float* planes, float* bbox,
                            int* ids, int* counts, int B, int nc, int H,
                            int W, int sub, float fx, float fy, float cx,
                            float cy, float z_near, float z_far,
                            void* stream) {
  if (sub != 16 && sub != 32) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  tri_setup_planes<<<dim3(nc, B), CHUNK, 0, st>>>(
      Cs, mesh, mesh64, M, T, poses, origins, planes,
      reinterpret_cast<float4*>(bbox), nc, fx, fy, cx, cy, z_near, z_far);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nsx = (W + sub - 1) / sub, nsub = nsx * ((H + sub - 1) / sub);
  const dim3 grid((nsub + BIN_WARPS - 1) / BIN_WARPS, B);
  const float4* box = reinterpret_cast<const float4*>(bbox);
  if (sub == 16)
    tri_setup_bins<16><<<grid, BIN_WARPS * 32, 0, st>>>(box, ids, counts, nc,
                                                        nsx, nsub);
  else
    tri_setup_bins<32><<<grid, BIN_WARPS * 32, 0, st>>>(box, ids, counts, nc,
                                                        nsx, nsub);
  return (int)cudaGetLastError();
}
