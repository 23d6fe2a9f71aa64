// span_stamp: the markers of the device spans inside a CUDA graph
// (utils/profiling.py:GraphSpans).
//
// Replaces no TPU kernel. JAX names a region of a jitted program by its
// profiler's scopes; a CUDA graph replays ~10,000 launches with no host code
// between them, so a span inside it is timed by the device itself: a marker
// is one launch of one thread that writes the device's ns timer
// (%globaltimer, common.cuh) into a ring of slots in device memory.
//
// Layout: ring[slots][stride] of uint64, counter a uint64 in device memory.
// Marker `index` of a replay writes ring[counter % slots][index]; the graph's
// last marker also bumps the counter, so the next replay writes the next
// slot. Nothing is read back during the replays: the host copies the ring
// once, when it reports.
//
// What bounds it: the launch, about a microsecond of a graph's kernel node;
// the stores are 8 or 16 bytes.
//
// At capture, the C entry point also counts the kernel nodes of the graph
// being captured on the stream (cudaStreamGetCaptureInfo, cudaGraphGetNodes,
// cudaGraphNodeGetType), the marker among them: the difference between two
// markers' counts, less one, is the kernels of the span between them.

#include <vector>

#include "common.cuh"

namespace {

__global__ void adm_span_stamp(unsigned long long* __restrict__ ring, unsigned long long* __restrict__ counter,
                               int slots, int stride, int index, int last) {
  const unsigned long long n = *counter;
  ring[(n % (unsigned long long)slots) * stride + index] = adm::globaltimer();
  if (last) *counter = n + 1;
}

// Kernel nodes of the graph being captured on `stream`, or -1 if none is.
cudaError_t capture_kernel_nodes(cudaStream_t stream, long long* out) {
  *out = -1;
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph);
  if (err != cudaSuccess || status != cudaStreamCaptureStatusActive || graph == nullptr) return err;
  size_t n = 0;
  if ((err = cudaGraphGetNodes(graph, nullptr, &n)) != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (err = cudaGraphGetNodes(graph, nodes.data(), &n)) != cudaSuccess) return err;
  long long kernels = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess) return err;
    kernels += type == cudaGraphNodeTypeKernel;
  }
  *out = kernels;
  return cudaSuccess;
}

}  // namespace

// One marker on `stream`. `kernel_nodes`: null, or where the count of the
// kernel nodes captured so far (this marker's included; -1 outside a
// capture) goes. Returns a CUDA error code, 0 on success.
extern "C" int adm_span_mark(void* ring, void* counter, int slots, int stride, int index, int last,
                             long long* kernel_nodes, void* stream) {
  if (slots <= 0 || stride <= 0 || index < 0 || index >= stride) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  adm_span_stamp<<<1, 1, 0, s>>>((unsigned long long*)ring, (unsigned long long*)counter, slots, stride, index,
                                 last);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && kernel_nodes != nullptr) err = capture_kernel_nodes(s, kernel_nodes);
  return (int)err;
}
