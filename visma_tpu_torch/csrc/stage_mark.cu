// Stage marks: do-nothing kernels that bracket a stage of the port's work
// on the device, so that a device trace can split its operations by stage
// (visma_tpu_torch/utils/trace.py::stage). The mark's id is a template
// argument, so it is in the device function's name (`stage_mark<7>`) and a
// trace reads it without any argument of the launch; the program keeps the
// table of id to (stage, begin or end). One block of one thread, no memory
// touched: a mark costs a launch, about 2 us of device time, and nothing
// else. Launched inside a CUDA graph capture it becomes a kernel node, so a
// replay runs its marks as its other operations.

#include <cuda_runtime.h>

template <int ID>
__global__ void stage_mark() {}

#define VT_MARKS8(b)                                                      \
  stage_mark<b + 0>, stage_mark<b + 1>, stage_mark<b + 2>,                \
      stage_mark<b + 3>, stage_mark<b + 4>, stage_mark<b + 5>,            \
      stage_mark<b + 6>, stage_mark<b + 7>

static void (*const MARKS[])() = {VT_MARKS8(0),  VT_MARKS8(8),
                                  VT_MARKS8(16), VT_MARKS8(24),
                                  VT_MARKS8(32), VT_MARKS8(40),
                                  VT_MARKS8(48), VT_MARKS8(56)};
static const int N_MARKS = sizeof(MARKS) / sizeof(MARKS[0]);

extern "C" int vt_stage_marks() { return N_MARKS; }

// Loads every mark's function (cudaFuncGetAttributes does, under lazy
// module loading), so that no mark is first loaded inside a capture.
extern "C" int vt_stage_mark_load() {
  cudaFuncAttributes attr;
  for (int i = 0; i < N_MARKS; ++i) {
    cudaError_t rc = cudaFuncGetAttributes(&attr, (const void*)MARKS[i]);
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

extern "C" int vt_stage_mark(int id, void* stream) {
  if (id < 0 || id >= N_MARKS) return (int)cudaErrorInvalidValue;
  MARKS[id]<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
