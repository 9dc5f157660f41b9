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
//
// What bounds it on an H100: device-memory traffic (each frame read once and
// written once, the table once; ~12 operations a value). The TPU kernel keeps
// the whole frame in fast memory; the counterpart here stages, per output
// tile, only the source rectangle the tile reads.
//
// Design. A block of 256 threads owns a 32 x 64 output tile and a group of
// frames (gridDim.z splits the batch: `split_frames`). A warp owns 4 rows of
// the tile; lane l owns pixel l of each 32-pixel segment of them: 8 pixels a
// thread. A single frame has no batch to share the table's cost over and no
// frame to overlap a copy with, so it takes the same kernel instantiated
// with one pixel a thread (an 8 x 32 tile a block, registers capped for 8
// blocks an SM) and the direct branch only: 8 pixels a thread there chain
// 24 gathers of a colour frame at 3 blocks an SM. Once per launch a thread
// reads its table entries, derives its taps and the four weights as the
// plain version does, and keeps them in registers for every frame. One
// block reduction gives the box of the tile's taps over its valid entries.
// Then one of two branches, chosen per block from the box and the same for
// every frame:
//   staged: the box fits a stage (4x the tile's output bytes for uint8, 3x
//     for float32) and the call has two frames or more a group: the box's
//     16-byte pieces are copied with cp.async into a ring of up to 4 stages
//     in shared memory, frames f + 1 .. f + 3 in flight while frame f is
//     blended from shared memory (loads at a register address plus the
//     stage's immediate);
//   direct: the taps are gathered from device memory, as a table that is
//     no smooth warp (random, or with far-apart taps) or a single frame
//     needs (a single frame has nothing to overlap its copy with).
// A call whose row pitch or base is not 16-byte aligned takes the direct
// branch in every tile. The optional `branch` output records each tile's
// branch (0 staged, 1 direct); remap.py::remap_footprint_plain is its plain
// twin.
//
// Why lane = pixel and byte stores, and not a run of 16 pixels a thread with
// one 16-byte store: a run puts a warp's 32 lanes 16 bytes apart, so each of
// the four tap loads hits 8 of the 32 shared-memory banks. Counted on the
// Corvis table's rows 50-113 (the distinct 4-byte words a warp's load asks
// of each bank, at 32 x 128 tiles), that is 2.2-3.3 wavefronts a load;
// lane = pixel reads 32 neighbouring bytes, and a staged row pitch of 64 mod
// 128 bytes puts the second source row a warp may touch 16 banks away: 1.0
// wavefront a load. A warp's byte store is one full 32-byte sector.
//
// Exactness: the library is built with -fmad=false and the blend keeps the
// plain version's order, so the kernel rounds as the plain version does. A
// staged value is the global value. uint8 -> float is exact by the
// 2^23 trick (bits 0x4B000000 | b, minus 2^23), and round half to even of a
// value in (-0.5, 255.5) is the low byte of (value + 2^23) in
// round-to-nearest-even, equal to rintf then the clip to [0, 255]; neither
// takes the conversion unit.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 200 * 1024;

// A thread's pixels: pixel k is in row k / SEGS of the ROWS rows its warp
// owns, in 32-pixel segment k % SEGS. A batch: 8 pixels, a 32 x 64 tile a
// block; a single frame: 1 pixel, an 8 x 32 tile.
template <bool BATCH>
struct Geo {
  static constexpr int ROWS = BATCH ? 4 : 1;
  static constexpr int SEGS = BATCH ? 2 : 1;
  static constexpr int NP = ROWS * SEGS;
  static constexpr int TILE_H = WARPS * ROWS;
  static constexpr int TILE_W = 32 * SEGS;
};
// the staged tile, and the tile of the `branch` output for every call
constexpr int TILE_H = Geo<true>::TILE_H;   // 32
constexpr int TILE_W = Geo<true>::TILE_W;   // 64

template <typename T, int C>
struct Cfg {
  static constexpr bool U8 = sizeof(T) == 1;
  static constexpr int CS = C * (int)sizeof(T);     // bytes a pixel
  // a stage holds 4x (uint8) or 3x (float32) the tile's output bytes
  static constexpr int STAGE = (U8 ? 4 : 3) * TILE_H * TILE_W * CS;
  static constexpr int NST = SMEM_LIMIT / STAGE < MAX_STAGES
                                 ? SMEM_LIMIT / STAGE : MAX_STAGES;
  // staged row pitch, mod 128 bytes: see the bank note above
  static constexpr int PITCH_MOD = (U8 && C == 1) ? 64 : 0;
  // 16-byte pieces of a full stage a thread copies
  static constexpr int PIECES = (STAGE / 16 + THREADS - 1) / THREADS;
  static_assert(NST >= 2, "stage budget too large for the ring");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float as_float(uint8_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | (uint32_t)b), 8388608.0f);
}
__device__ __forceinline__ float as_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ float ldg(const uint8_t* p) {
  return as_float(__ldg((const T*)p));
}

// f(std::integral_constant<int, 0>) ... f(... N - 1>): an index that is a
// constant expression, for the immediates of the shared loads below
template <typename F, int... I>
__device__ __forceinline__ void static_for(F&& f,
                                           std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for(f, std::make_integer_sequence<int, N>{});
}

// a shared-memory load at a register address plus an immediate; volatile,
// so that the same address in two frames is read twice
template <typename T, int IMM>
__device__ __forceinline__ float lds(uint32_t a) {
  if constexpr (sizeof(T) == 1) {
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1+%2];\n" : "=r"(v) : "r"(a), "n"(IMM));
    return as_float((uint8_t)v);
  } else {
    float v;
    asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(v) : "r"(a), "n"(IMM));
    return v;
  }
}

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }

// v is a blend of bytes with weights in [0, 1] that sum to 1 within a few
// ulps, so v lies in (-0.5, 255.5): rint(v) needs no clip above, and the
// clip below only keeps a NaN (not reachable) at 0
__device__ __forceinline__ void store_value(uint8_t* p, float v) {
  *p = (uint8_t)__float_as_uint(__fadd_rn(fmaxf(v, 0.0f), 8388608.0f));
}

// Blend one frame from device memory (the direct branch): off / off1 are
// the byte offsets of each pixel's top and bottom tap rows in the frame,
// `orow` the thread's first pixel in the frame's output (pixel k: Geo).
template <typename T, int C, bool BATCH, int NP = Geo<BATCH>::NP>
__device__ __forceinline__ void blend_direct(
    const uint8_t* frame, T* orow, int ow, const int (&off)[NP],
    const int (&off1)[NP], const float (&w)[4][NP], uint32_t valid,
    uint32_t inside) {
  using G = Geo<BATCH>;
  constexpr int CS = Cfg<T, C>::CS;
#pragma unroll
  for (int r = 0; r < G::ROWS; ++r, orow += (size_t)ow * C) {
#pragma unroll
    for (int g = 0; g < G::SEGS; ++g) {
      const int k = r * G::SEGS + g;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int b = c * (int)sizeof(T);
        const float p00 = ldg<T>(frame + off[k] + b);
        const float p01 = ldg<T>(frame + off[k] + b + CS);
        const float p10 = ldg<T>(frame + off1[k] + b);
        const float p11 = ldg<T>(frame + off1[k] + b + CS);
        const float v = ((w[0][k] * p11 + w[1][k] * p10) + w[2][k] * p01)
                        + w[3][k] * p00;
        if ((inside >> k) & 1)
          store_value(orow + g * 32 * C + c,
                      (Cfg<T, C>::U8 || ((valid >> k) & 1)) ? v : 0.0f);
      }
    }
  }
}

// Blend one frame from stage S (the staged branch): a / a1 are the shared
// addresses of each pixel's top and bottom tap rows in stage 0; the stage
// and the channel are immediates of the loads. Every load lies in the box
// (a pixel outside the frame or invalid reads the box's first bytes); only
// the store is predicated.
template <typename T, int C, int S, int NP = Geo<true>::NP>
__device__ __forceinline__ void blend_staged(
    const uint32_t (&a)[NP], const uint32_t (&a1)[NP], T* orow, int ow,
    const float (&w)[4][NP], uint32_t valid, uint32_t inside) {
  using G = Geo<true>;
  using K = Cfg<T, C>;
#pragma unroll
  for (int r = 0; r < G::ROWS; ++r, orow += (size_t)ow * C) {
#pragma unroll
    for (int g = 0; g < G::SEGS; ++g) {
      const int k = r * G::SEGS + g;
      static_for<C>([&](auto ci) {
        constexpr int B = S * K::STAGE + decltype(ci)::value * sizeof(T);
        const float p00 = lds<T, B>(a[k]);
        const float p01 = lds<T, B + K::CS>(a[k]);
        const float p10 = lds<T, B>(a1[k]);
        const float p11 = lds<T, B + K::CS>(a1[k]);
        const float v = ((w[0][k] * p11 + w[1][k] * p10) + w[2][k] * p01)
                        + w[3][k] * p00;
        // uint8: an invalid entry has zero weights and finite taps, so v
        // is 0 already; a float image may hold a NaN or an infinity
        if ((inside >> k) & 1)
          store_value(orow + g * 32 * C + decltype(ci)::value,
                      (K::U8 || ((valid >> k) & 1)) ? v : 0.0f);
      });
    }
  }
}

// registers are capped for 3 blocks (24 warps) an SM for a batch, 85 a
// thread, and for 8 blocks for a single frame, 32 a thread
template <typename T, int C, bool BATCH>
__global__ void __launch_bounds__(THREADS, BATCH ? 3 : 8)
bilinear_remap_kernel(const uint8_t* __restrict__ img,
                      const float* __restrict__ table, T* __restrict__ out,
                      int* __restrict__ branch, int B, int H, int W, int oh,
                      int ow, int stage_ok) {
  using G = Geo<BATCH>;
  using K = Cfg<T, C>;
  constexpr int NP = G::NP;
  constexpr int CS = K::CS;
  extern __shared__ __align__(128) uint8_t ring[];  // the batch's stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int oy0 = blockIdx.y * G::TILE_H + warp * G::ROWS;
  const int ox0 = blockIdx.x * G::TILE_W + lane;

  // the thread's taps and weights, once for every frame
  int x0[NP], y0[NP];
  float w[4][NP];
  uint32_t valid = 0, inside = 0;
  int xmin = INT_MAX, xmax = -1, ymin = INT_MAX, ymax = -1;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int oy = oy0 + k / G::SEGS, ox = ox0 + (k % G::SEGS) * 32;
    const bool in = oy < oh && ox < ow;
    const size_t e = 2 * ((size_t)oy * ow + ox);
    const float sx = in ? __ldg(table + e) : -1.0f;
    const float sy = in ? __ldg(table + e + 1) : 0.0f;
    // fmaxf / fminf return the other operand for a NaN, so a NaN or huge
    // entry is clamped into the frame before the cast to int
    const float x0f = fminf(fmaxf(floorf(sx), 0.0f), (float)(W - 2));
    const float y0f = fminf(fmaxf(floorf(sy), 0.0f), (float)(H - 2));
    const float fx = fminf(fmaxf(sx - x0f, 0.0f), 1.0f);
    const float fy = fminf(fmaxf(sy - y0f, 0.0f), 1.0f);
    const float fxy = fx * fy;
    const bool ok = in && sx >= 0.0f;
    // uint8 folds the invalid mark into zero weights (see blend_staged)
    const bool keep = ok || !K::U8;
    w[0][k] = keep ? fxy : 0.0f;
    w[1][k] = keep ? fy - fxy : 0.0f;
    w[2][k] = keep ? fx - fxy : 0.0f;
    w[3][k] = keep ? ((1.0f - fx) - fy) + fxy : 0.0f;
    x0[k] = (int)x0f;
    y0[k] = (int)y0f;
    inside |= (uint32_t)in << k;
    if (ok) {
      valid |= 1u << k;
      xmin = min(xmin, x0[k]);
      xmax = max(xmax, x0[k]);
      ymin = min(ymin, y0[k]);
      ymax = max(ymax, y0[k]);
    }
  }

  const int pitch = W * CS;
  const size_t in_frame = (size_t)H * pitch;
  const size_t out_frame = (size_t)oh * ow * C;
  // the block's frames (a single frame's kernel spares the divisions)
  const int f_begin =
      BATCH ? (int)((long long)B * blockIdx.z / gridDim.z) : 0;
  const int nf =
      BATCH ? (int)((long long)B * (blockIdx.z + 1) / gridDim.z) - f_begin
            : 1;
  T* o = out + ((size_t)f_begin * oh * ow + (size_t)oy0 * ow + ox0) * C;
  // one int a 32 x 64 tile: a single frame's 8 x 32 blocks record it from
  // the tile's first block
  auto record = [&](int b) {
    constexpr int SY = TILE_H / G::TILE_H, SX = TILE_W / G::TILE_W;
    if (branch != nullptr && blockIdx.z == 0 && tid == 0
        && blockIdx.y % SY == 0 && blockIdx.x % SX == 0)
      branch[blockIdx.y / SY * ((ow + TILE_W - 1) / TILE_W)
             + blockIdx.x / SX] = b;
  };
  // the direct branch: every frame of the group from device memory
  auto gather = [&]() {
    int off[NP], off1[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      off[k] = y0[k] * pitch + x0[k] * CS;
      off1[k] = off[k] + pitch;
    }
    const uint8_t* frame = img + (size_t)f_begin * in_frame;
    for (int i = 0; i < nf; ++i, frame += in_frame, o += out_frame)
      blend_direct<T, C, BATCH>(frame, o, ow, off, off1, w, valid, inside);
  };
  // a single frame, or no tile of the call can stage: no box needed
  if (!BATCH || !stage_ok) {
    record(1);
    gather();
    return;
  }
  if constexpr (BATCH) {
    constexpr int NST = K::NST;
    __shared__ int red[WARPS][4];

    // the box of the tile's taps: (xmin, ymin) to (xmax + 1, ymax + 1)
    xmin = __reduce_min_sync(0xffffffffu, xmin);
    ymin = __reduce_min_sync(0xffffffffu, ymin);
    xmax = __reduce_max_sync(0xffffffffu, xmax);
    ymax = __reduce_max_sync(0xffffffffu, ymax);
    if (lane == 0) {
      red[warp][0] = xmin;
      red[warp][1] = ymin;
      red[warp][2] = xmax;
      red[warp][3] = ymax;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      xmin = min(xmin, red[i][0]);
      ymin = min(ymin, red[i][1]);
      xmax = max(xmax, red[i][2]);
      ymax = max(ymax, red[i][3]);
    }
    const bool any = ymax >= 0;
    const int rows = any ? ymax + 2 - ymin : 0;
    const int xb0 = any ? (xmin * CS) & ~15 : 0;
    const int rowbytes = any ? (((xmax + 2) * CS + 15) & ~15) - xb0 : 0;
    const int rs = rowbytes + ((K::PITCH_MOD - rowbytes) & 127);
    const bool staged = rows * rs <= K::STAGE;
    record(staged ? 0 : 1);
    if (!staged) {
      gather();
      return;
    }

    // shared addresses in stage 0; an invalid entry reads the box's first
    // bytes (zero weights, or the value replaced by 0)
    const uint32_t ring0 = (uint32_t)__cvta_generic_to_shared(ring);
    uint32_t a[NP], a1[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      a[k] = ring0 + (((valid >> k) & 1)
                          ? (y0[k] - ymin) * rs + x0[k] * CS - xb0 : 0);
      a1[k] = a[k] + rs;
    }

    // the ring: frame i lands in stage i % NST, frames i + 1 .. i + NST - 1
    // are in flight while frame i is blended. The box's 16-byte pieces are
    // dealt to the threads in turn; a thread's pieces sit at the same places
    // in every frame, so it keeps their offsets (-1: none).
    const int cpr = rowbytes >> 4;
    int soff[K::PIECES], goff[K::PIECES];
#pragma unroll
    for (int j = 0; j < K::PIECES; ++j) {
      const int q = tid + j * THREADS, r = cpr ? q / cpr : 0;
      const bool has = r < rows;
      soff[j] = has ? r * rs + (q - r * cpr) * 16 : -1;
      goff[j] = has ? r * pitch + (q - r * cpr) * 16 : 0;
    }
    const uint8_t* box = img + (size_t)f_begin * in_frame
                         + (size_t)(any ? ymin : 0) * pitch + xb0;
    auto issue = [&](int i, int s) {
      if (i < nf) {
        const uint8_t* src = box + (size_t)i * in_frame;
#pragma unroll
        for (int j = 0; j < K::PIECES; ++j)
          if (soff[j] >= 0)
            cp_async16(ring0 + s * K::STAGE + soff[j], src + goff[j]);
      }
      cp_async_commit();  // an empty group keeps the count uniform
    };

#pragma unroll
    for (int s = 0; s < NST - 1; ++s) issue(s, s);
    for (int i0 = 0; i0 < nf; i0 += NST) {
      static_for<NST>([&](auto si) {
        constexpr int s = decltype(si)::value;
        const int i = i0 + s;
        if (i >= nf) return;
        cp_async_wait<NST - 2>();  // this thread's pieces of frame i landed
        __syncthreads();  // ... every thread's; stage s - 1 is free: refill it
        issue(i + NST - 1, (s + NST - 1) % NST);
        blend_staged<T, C, s>(a, a1, o + (size_t)i * out_frame, ow, w, valid,
                              inside);
      });
    }
    cp_async_wait<0>();
  }
}

// How many groups the batch is split into over gridDim.z. The kernel is
// bound by an SM's issue rate, so the time follows the busiest SM's work:
// ceil(tiles * g / SMs) blocks of ceil(B / g) frames, each block costing
// about one frame more (its table prologue and the ring's fill). The g of
// 1 .. gmax with the least such work, the fewest on a tie.
inline int split_frames(int tiles, int B, int gmax) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  int best = 1;
  long long best_work = LLONG_MAX;
  for (int g = 1; g <= gmax; ++g) {
    const long long blocks = ((long long)tiles * g + sms - 1) / sms;
    const long long work = blocks * ((B + g - 1) / g + 1);
    if (work < best_work) {
      best = g;
      best_work = work;
    }
  }
  return best;
}

template <typename T, int C>
int launch(const void* img, const float* table, void* out, int* branch,
           int B, int H, int W, int oh, int ow, cudaStream_t s) {
  using K = Cfg<T, C>;
  if (B == 1) {
    using G = Geo<false>;
    const dim3 grid((ow + G::TILE_W - 1) / G::TILE_W,
                    (oh + G::TILE_H - 1) / G::TILE_H);
    bilinear_remap_kernel<T, C, false><<<grid, THREADS, 0, s>>>(
        (const uint8_t*)img, table, (T*)out, branch, B, H, W, oh, ow, 0);
    return (int)cudaGetLastError();
  }
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(bilinear_remap_kernel<T, C, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         K::NST * K::STAGE);
    attr = true;
  }
  // staging needs 16-byte aligned rows (and two frames a group: gmax)
  const int stage_ok = (uintptr_t)img % 16 == 0 && (W * K::CS) % 16 == 0;
  const int tx = (ow + TILE_W - 1) / TILE_W, ty = (oh + TILE_H - 1) / TILE_H;
  const int g = split_frames(tx * ty, B, B / 2 < 64 ? B / 2 : 64);
  const int per = (B + g - 1) / g;
  const int smem = stage_ok ? (per < K::NST ? per : K::NST) * K::STAGE : 0;
  bilinear_remap_kernel<T, C, true><<<dim3(tx, ty, g), THREADS, smem, s>>>(
      (const uint8_t*)img, table, (T*)out, branch, B, H, W, oh, ow,
      stage_ok);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const void* img, const float* table, void* out, int* branch,
             int B, int H, int W, int C, int oh, int ow, cudaStream_t s) {
  switch (C) {
    case 1: return launch<T, 1>(img, table, out, branch, B, H, W, oh, ow, s);
    case 2: return launch<T, 2>(img, table, out, branch, B, H, W, oh, ow, s);
    case 3: return launch<T, 3>(img, table, out, branch, B, H, W, oh, ow, s);
    case 4: return launch<T, 4>(img, table, out, branch, B, H, W, oh, ow, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// img (B, H, W, C) and out (B, oh, ow, C) of float32 or, with is_u8, uint8;
// table (oh, ow, 2) float32 of source (x, y); branch NULL or one int a
// 32 x 64 output tile (row-major over the tile grid).
extern "C" int vt_bilinear_remap(const void* img, const float* table,
                                 void* out, int* branch, int B, int H, int W,
                                 int C, int oh, int ow, int is_u8,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_u8 ? launch_c<uint8_t>(img, table, out, branch, B, H, W, C, oh,
                                   ow, s)
               : launch_c<float>(img, table, out, branch, B, H, W, C, oh, ow,
                                 s);
}
