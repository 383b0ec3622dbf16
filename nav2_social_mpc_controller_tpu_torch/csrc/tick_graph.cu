// The compiled tick as one CUDA graph launch, with the LM solve as a loop on
// the device: lm_continue and the parent graph around the stage graphs.
//
// Replaces no Pallas kernel. It is the port's counterpart of the JAX
// package's LM `lax.while_loop` (solver/lm.py: lm_solve, cond
// `(~done) & (iters < max_iterations)`), which XLA runs on the device inside
// the jitted step. controller/graph.py captures the tick's stages (head, one
// chunk of `n` LM iterations per distinct chunk length, tail) as CUDA graphs
// and hands them here; the parent graph built here is, in order,
//
//   child graph: head
//   for each chunk length n (check_every, then the remainder of
//   max_iterations, if any):
//     kernel lm_continue (sets loop k's handle)
//     conditional WHILE on that handle, whose body is
//       child graph: the chunk of n iterations
//       kernel lm_continue (counts the iterations, sets the handle again)
//   child graph: tail
//
// instantiated once and launched on the caller's stream: a tick is one
// launch, and the host reads nothing of the device in between.
//
// lm_continue is one block. It reduces the B `done` flags to "is a lane
// still active", keeps the tick's LM iteration count in stats[0] and sets
// the loop's condition to
//     (no check or any lane active) && it + n <= max_iterations,
// which are the eager loop's checks (solver/lm.py: lm_solve asks every
// check_every iterations from iteration 0 and stops at max_iterations).
// stats[1] counts its launches and stats[2 + k] the runs of loop k's body,
// from which the host tallies the stage kernels' launches when it is asked.
// Its work is a read of B bytes: bound by the launch, not by bytes or
// operations, so it is as simple as one block can be.
//
// Built with the runtime API of nvcc's static cudart, as every other source
// of the package: graph, node and stream handles are the CUDA driver's objects,
// so graphs captured by PyTorch's own runtime are children here, and the
// parent launches on PyTorch's stream. Conditional nodes need CUDA 12.4
// (memset and memcpy nodes in their bodies); an older runtime or driver
// fails here and the caller raises.

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLoops = 4;
constexpr int kTypeSlots = 32;

__global__ void lm_continue_kernel(cudaGraphConditionalHandle handle, int set_handle,
                                   const unsigned char* __restrict__ done, int n,
                                   long long* __restrict__ stats, int* __restrict__ out,
                                   int reset, int add, int need, int max_iterations,
                                   int check_done, int slot) {
  int active = 0;
  if (check_done) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) active |= done[i] == 0;
  }
  active = __syncthreads_or(active);
  if (threadIdx.x == 0) {
    long long it = reset ? 0 : stats[0] + add;
    stats[0] = it;
    stats[1] += 1;
    if (slot >= 2) stats[slot] += 1;
    unsigned int go = (!check_done || active) && need > 0 && it + need <= max_iterations;
    *out = static_cast<int>(go);
    if (set_handle) cudaGraphSetConditional(handle, go);
  }
}

struct ContinueArgs {
  cudaGraphConditionalHandle handle;
  int set_handle;
  const unsigned char* done;
  int n;
  long long* stats;
  int* out;
  int reset, add, need, max_iterations, check_done, slot;
};

cudaError_t add_continue(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                         size_t n_dep, ContinueArgs a) {
  void* args[] = {&a.handle, &a.set_handle, &a.done, &a.n, &a.stats, &a.out, &a.reset,
                  &a.add, &a.need, &a.max_iterations, &a.check_done, &a.slot};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(lm_continue_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(kThreads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, n_dep, &p);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                     size_t n_dep, cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, dep, nullptr, n_dep, params);
#else
  return cudaGraphAddNode(node, graph, dep, n_dep, params);
#endif
}

#define TRY(expr)                         \
  do {                                    \
    cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

cudaError_t build(cudaGraph_t g, cudaGraph_t head, cudaGraph_t tail, int n_loops,
                  cudaGraph_t const* chunks, const int* lengths, ContinueArgs base,
                  cudaGraph_t* bodies_out) {
  cudaGraphNode_t prev;
  TRY(cudaGraphAddChildGraphNode(&prev, g, nullptr, 0, head));
  for (int k = 0; k < n_loops; ++k) {
    cudaGraphConditionalHandle handle;
    TRY(cudaGraphConditionalHandleCreate(&handle, g, 0, cudaGraphCondAssignDefault));
    ContinueArgs a = base;
    a.handle = handle;
    a.set_handle = 1;
    a.reset = k == 0;
    a.add = 0;
    a.need = lengths[k];
    a.slot = -1;
    cudaGraphNode_t check;
    TRY(add_continue(&check, g, &prev, 1, a));

    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    cudaGraphNode_t loop;
    TRY(add_node(&loop, g, &check, 1, &cp));
    cudaGraph_t body = cp.conditional.phGraph_out[0];
    bodies_out[k] = body;

    cudaGraphNode_t chunk;
    TRY(cudaGraphAddChildGraphNode(&chunk, body, nullptr, 0, chunks[k]));
    a.reset = 0;
    a.add = lengths[k];
    a.slot = 2 + k;
    cudaGraphNode_t again;
    TRY(add_continue(&again, body, &chunk, 1, a));
    prev = loop;
  }
  cudaGraphNode_t last;
  TRY(cudaGraphAddChildGraphNode(&last, g, &prev, 1, tail));
  return cudaSuccess;
}

void count_types(cudaGraph_t g, long long* counts, cudaError_t* err) {
  size_t n = 0;
  if ((*err = cudaGraphGetNodes(g, nullptr, &n)) != cudaSuccess) return;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n && (*err = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) return;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType t;
    if ((*err = cudaGraphNodeGetType(node, &t)) != cudaSuccess) return;
    int slot = static_cast<int>(t);
    counts[slot < kTypeSlots ? slot : kTypeSlots - 1] += 1;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      if ((*err = cudaGraphChildGraphNodeGetGraph(node, &child)) != cudaSuccess) return;
      count_types(child, counts, err);
      if (*err != cudaSuccess) return;
    }
  }
}

}  // namespace

extern "C" {

// The parent graph of one program. head, tail and chunks[k] are cudaGraph_t
// (PyTorch's CUDAGraph.raw_cuda_graph(), kept alive by the caller), cloned
// here into child-graph nodes; lengths[k] each chunk's LM iterations; done
// the (n,) bool flags of the head's LM state, which the chunks update in
// place; stats (2 + n_loops) int64 and out one int32, both on the device.
// Writes the parent graph, its instantiation and each loop's body graph.
int social_mpc_tick_graph_build(void* head, void* tail, int n_loops, void* const* chunks,
                                const int* lengths, const void* done, int n, void* stats,
                                void* out, int max_iterations, int check_done,
                                void** graph_out, void** exec_out, void** bodies_out) {
  if (n_loops < 0 || n_loops > kMaxLoops) return cudaErrorInvalidValue;
  int runtime = 0, driver = 0;
  TRY(cudaRuntimeGetVersion(&runtime));
  TRY(cudaDriverGetVersion(&driver));
  if (runtime < 12040 || driver < 12040) return cudaErrorNotSupported;
  cudaGraph_t g;
  cudaError_t created = cudaGraphCreate(&g, 0);
  if (created != cudaSuccess) {
    cudaGetLastError();
    return created;
  }
  ContinueArgs base = {};
  base.done = static_cast<const unsigned char*>(done);
  base.n = n;
  base.stats = static_cast<long long*>(stats);
  base.out = static_cast<int*>(out);
  base.max_iterations = max_iterations;
  base.check_done = check_done;
  cudaGraph_t bodies[kMaxLoops] = {};
  cudaError_t err = build(g, static_cast<cudaGraph_t>(head), static_cast<cudaGraph_t>(tail),
                          n_loops, reinterpret_cast<cudaGraph_t const*>(chunks), lengths,
                          base, bodies);
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(g);
    cudaGetLastError();
    return err;
  }
  *graph_out = g;
  *exec_out = exec;
  for (int k = 0; k < n_loops; ++k) bodies_out[k] = bodies[k];
  return cudaSuccess;
}

int social_mpc_tick_graph_launch(void* exec, void* stream) {
  cudaError_t err =
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Any error is also cleared from the runtime's last error, which the
// kernels' launch checks read (a program collected during another stream's
// capture gets cudaErrorStreamCaptureUnsupported here).
int social_mpc_tick_graph_destroy(void* graph, void* exec) {
  cudaError_t a = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t b = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  if (a != cudaSuccess || b != cudaSuccess) cudaGetLastError();
  return a != cudaSuccess ? a : b;
}

// counts[t] += the nodes of type t (cudaGraphNodeType; >= 31 in slot 31) in
// graph and, recursively, in its child graphs. A graph that holds
// conditional nodes is not asked (on the H100's CUDA 12.9 runtime and
// 580 driver, cudaGraphGetNodes on the parent failed with
// cudaErrorUnknown): the caller counts a parent from its parts. An error
// is cleared from the runtime's last error, which the kernels' launch
// checks read.
int social_mpc_graph_node_types(void* graph, long long* counts) {
  cudaError_t err = cudaSuccess;
  count_types(static_cast<cudaGraph_t>(graph), counts, &err);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// lm_continue outside any graph (no handle is set): for the comparison
// with its plain version. done (n,) bool, stats int64, out one int32.
int social_mpc_lm_continue(const void* done, int n, void* stats, void* out, int reset, int add,
                           int need, int max_iterations, int check_done, int slot,
                           void* stream) {
  lm_continue_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      0, 0, static_cast<const unsigned char*>(done), n, static_cast<long long*>(stats),
      static_cast<int*>(out), reset, add, need, max_iterations, check_done, slot);
  return cudaGetLastError();
}

}  // extern "C"
