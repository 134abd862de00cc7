// Conditional IF nodes of the step's CUDA graph: comd_tpu's lax.cond
// (comd_tpu/sim.py:319-320, :373-375; parallel/sharded.py:416, :478) on
// the device.
//
// PyTorch's CUDA graph capture has no conditional node that Python can
// reach on every version the port runs on, so a body is captured through
// here, inside a capture PyTorch began:
//
//   comd_if_handle(stream, out):
//     `stream` is capturing a graph.  Make a conditional handle in that
//     graph.  A kernel captured into the same graph sets its value at
//     every replay (csrc/step.cu's kick_drift_trigger, from the skin
//     trigger): no kernel of this file does;
//   comd_if_begin(stream, handle, body):
//     add an IF node on `handle` after `stream`'s current nodes (its body
//     an empty graph of its own), make the IF node `stream`'s only
//     dependency, and begin capturing `body` (a stream that is not
//     capturing) into the IF node's body graph;
//   comd_if_end(body): end that capture.
//
// At each replay the IF node runs its body when the handle is nonzero;
// nothing returns to the host.  A body may hold kernel, memcpy, memset,
// child-graph and conditional nodes (the CUDA programming guide's list):
// no event, host or allocation node.
//
// The plain version (ops/cuda/graph_if.py) evaluates the predicate on the
// host and runs the body or not.  Errors are cudaError_t values, plus
// COMD_IF_NOT_CAPTURING when `stream` is not capturing; comd_if_begin's
// carry the step that failed (COMD_IF_STEP below).
#include <cuda_runtime.h>

#define COMD_IF_NOT_CAPTURING 10001

// The capture's graph and the nodes the stream's next node depends on.
static cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, n);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    return (cudaError_t)COMD_IF_NOT_CAPTURING;
  return err;
}

// An error of comd_if_begin's step k (1..4) returns k * COMD_IF_STEP + the
// cudaError_t value.
#define COMD_IF_STEP 100000
#define RETURN_IF(k, e)                                   \
  do {                                                    \
    cudaError_t e_ = (e);                                 \
    if (e_ != cudaSuccess) return (k) * COMD_IF_STEP + e_; \
  } while (0)

extern "C" int comd_if_handle(cudaStream_t stream, unsigned long long* out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaGetLastError();  // clear an error of an earlier call of this runtime
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err == cudaSuccess) *out = handle;
  return err;
}

extern "C" int comd_if_begin(cudaStream_t stream, unsigned long long handle,
                             cudaStream_t body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaGetLastError();
  RETURN_IF(1, capture_info(stream, &graph, &deps, &n_deps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  RETURN_IF(2, cudaGraphAddNode(&node, graph, deps, nullptr, n_deps,
                                &params));
  RETURN_IF(3, cudaStreamUpdateCaptureDependencies(
                   stream, &node, nullptr, 1,
                   cudaStreamSetCaptureDependencies));
#else
  RETURN_IF(2, cudaGraphAddNode(&node, graph, deps, n_deps, &params));
  RETURN_IF(3, cudaStreamUpdateCaptureDependencies(
                   stream, &node, 1, cudaStreamSetCaptureDependencies));
#endif
  RETURN_IF(4, cudaStreamBeginCaptureToGraph(
                   body, params.conditional.phGraph_out[0], nullptr,
                   nullptr, 0, cudaStreamCaptureModeThreadLocal));
  return 0;
}

// A stream of its own for the bodies: PyTorch hands its streams out
// round robin from a small pool, so one of them could be the very stream
// whose capture a body joins.
extern "C" int comd_if_stream_create(int device, cudaStream_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}

extern "C" int comd_if_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}

extern "C" const char* comd_if_error_string(int err) {
  err %= COMD_IF_STEP;
  if (err == COMD_IF_NOT_CAPTURING)
    return "the stream is not capturing a graph";
  return cudaGetErrorString((cudaError_t)err);
}
