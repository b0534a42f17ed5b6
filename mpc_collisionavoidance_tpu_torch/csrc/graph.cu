// Joins the segments of a captured lane tick into one CUDA graph, with the
// stall escalation's steps as conditional IF nodes (the counterpart of the
// reference's `lax.while_loop` inside its jitted tick,
// mpc_collisionavoidance_tpu/ops/ipm_lanes.py:476-492).
//
// The segments are graphs that torch captured one after another in one
// memory pool (solver/capture.py): the tick before the escalation, one
// segment per escalation step, and the tick after it.  Each step's segment
// becomes the body of an IF node whose condition a one-thread kernel sets
// from a device bool just before it; the segment before a step writes that
// bool (the loop's predicate).  Once it is false no later step runs, since
// a step that does not run leaves the bool as it was.  The joined graph is
// instantiated here and launched with one call: nothing in it reads the
// host.  torch 2.11 has no Python binding for conditional nodes, so they
// are built here with the CUDA runtime (12.4 or later; the driver too).
//
// Every function returns a cudaError_t (0 = cudaSuccess).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t add_if_node(cudaGraph_t graph, const cudaGraphNode_t* deps,
                        size_t n_deps, cudaGraph_t body_src,
                        const bool* pred, cudaGraphNode_t* node) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  void* args[] = {&handle, &pred};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t setter;
  err = cudaGraphAddKernelNode(&setter, graph, deps, n_deps, &kp);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(node, graph, &setter, nullptr, 1, &cp);
#else
  err = cudaGraphAddNode(node, graph, &setter, 1, &cp);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  return cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                    nullptr, 0, body_src);
}

}  // namespace

extern "C" {

// The CUDA runtime this library was built with, and the driver's version.
int nmpc_cuda_versions(int* runtime, int* driver) {
  const cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDriverGetVersion(driver));
}

const char* nmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// segments[i]: a cudaGraph_t, run in order; conditional[i] != 0 makes it
// the body of an IF node on *pred.  Writes the joined graph's executable
// and its node count (every segment's nodes, plus a setter and an IF node
// per conditional segment).  The segments are copied, not kept.
int nmpc_graph_compose(int n, void* const* segments, const int* conditional,
                       const void* pred, void** exec_out,
                       long long* nodes_out) {
  cudaGraph_t graph;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t prev = nullptr;
  long long nodes = 0;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    const auto seg = static_cast<cudaGraph_t>(segments[i]);
    size_t seg_nodes = 0;
    err = cudaGraphGetNodes(seg, nullptr, &seg_nodes);
    if (err != cudaSuccess) break;
    nodes += static_cast<long long>(seg_nodes);
    cudaGraphNode_t node;
    if (conditional[i]) {
      err = add_if_node(graph, prev ? &prev : nullptr, prev ? 1 : 0, seg,
                        static_cast<const bool*>(pred), &node);
      nodes += 2;
    } else {
      err = cudaGraphAddChildGraphNode(&node, graph, prev ? &prev : nullptr,
                                       prev ? 1 : 0, seg);
    }
    prev = node;
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  *exec_out = exec;
  *nodes_out = nodes;
  return 0;
}

int nmpc_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

int nmpc_graph_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

}  // extern "C"
