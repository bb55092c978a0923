// Device phase markers: one empty kernel per phase boundary of a train
// step or a forward (leaf_tpu_torch/tracing.py launches them).
//
// Replaces no TPU kernel. On the TPU the phases of a step show as named
// regions of one XLA program; inside a CUDA graph replay the kernels have
// only their own names, and a forward elementwise kernel cannot be told
// from an optimizer one. A marker is a kernel launched in the stream's
// order between two phases, so the device trace shows where each phase
// starts and ends on the device's own clock, replays included.
//
// Bound: launch only. One block of one thread that returns at once (an
// EXIT in SASS); its cost is the launch's slot in the stream, about a
// microsecond of device time. Each marker is its own __global__ so that
// the trace prints its name (leaf_tpu_torch::mark_<phase>()); none of the
// names holds a substring that the benchmark's kernel categories match.

#include <cuda_runtime.h>

namespace leaf_tpu_torch {

__global__ void mark_step() {}
__global__ void mark_forward() {}
__global__ void mark_frontend() {}
__global__ void mark_backbone() {}
__global__ void mark_backbone_grad() {}
__global__ void mark_backward() {}
__global__ void mark_update() {}
// tracing.ATTENTION_MARKS: around an attention core (AST's blocks)
__global__ void mark_attention() {}
__global__ void mark_attention_end() {}
__global__ void mark_attention_grad() {}
__global__ void mark_attention_grad_end() {}

}  // namespace leaf_tpu_torch

// Load the eleven kernels now. CUDA loads a module's kernels lazily, at
// their first launch, and a marker's first launch is usually inside a CUDA
// graph capture. On the H100, after such a first load while CUPTI traced
// the process, every later profiler window of the process read one device
// row short in two of three probe runs; loaded here first, three runs
// showed no loss. tracing._load_marks calls this once per device, and
// TrainMultistep calls that before its capture.
extern "C" int leaf_phase_marks_load() {
  using namespace leaf_tpu_torch;
  const void* kernels[] = {
      (const void*)mark_step, (const void*)mark_forward,
      (const void*)mark_frontend, (const void*)mark_backbone,
      (const void*)mark_backbone_grad, (const void*)mark_backward,
      (const void*)mark_update, (const void*)mark_attention,
      (const void*)mark_attention_end, (const void*)mark_attention_grad,
      (const void*)mark_attention_grad_end};
  cudaFuncAttributes attr;
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launch marker `which` (its index in tracing.MARKS + ATTENTION_MARKS) on
// `stream`; returns the launch's CUDA error code.
extern "C" int leaf_phase_mark(int which, void* stream) {
  using namespace leaf_tpu_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: mark_step<<<1, 1, 0, s>>>(); break;
    case 1: mark_forward<<<1, 1, 0, s>>>(); break;
    case 2: mark_frontend<<<1, 1, 0, s>>>(); break;
    case 3: mark_backbone<<<1, 1, 0, s>>>(); break;
    case 4: mark_backbone_grad<<<1, 1, 0, s>>>(); break;
    case 5: mark_backward<<<1, 1, 0, s>>>(); break;
    case 6: mark_update<<<1, 1, 0, s>>>(); break;
    case 7: mark_attention<<<1, 1, 0, s>>>(); break;
    case 8: mark_attention_end<<<1, 1, 0, s>>>(); break;
    case 9: mark_attention_grad<<<1, 1, 0, s>>>(); break;
    case 10: mark_attention_grad_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
