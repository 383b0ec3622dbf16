// The device's loops around the captured stages: the condition kernels
// lm_continue and compact_continue, and the graph primitives from which
// controller/tick_graph.py assembles a parent graph that runs as one launch.
//
// Replaces no Pallas kernel. It is the port's counterpart of the JAX
// package's `lax.while_loop`s and `lax.scan` that XLA runs on the device
// inside a jitted program: the LM loop (solver/lm.py: lm_solve, cond
// `(~done) & (iters < max_iterations)`), the compacted solver's loops over
// its width ladder (solver/batched.py, cond `any(active) & (sum(active) >
// cap)`) and the simulator's scan over ticks (runtime/simulator.py). The
// stages (head, LM chunks, transitions, tail, the simulator's world update)
// are captured by PyTorch as CUDA graphs; the primitives below put them into
// one graph, as child-graph nodes, beside the condition kernels and the
// conditional nodes (WHILE, IF) those kernels steer. The parent graph is
// instantiated once and launched on the caller's stream: between the
// launch and the outputs the host reads nothing of the device.
//
// lm_continue is one block. It reduces the B `done` flags to "is a lane
// still active", keeps a loop's count in stats[0] and sets its condition to
//     (no check or any lane active) && it + need <= max_iterations,
// the eager loop's checks (solver/lm.py: lm_solve asks every check_every
// iterations from iteration 0 and stops at max_iterations). stats[1] counts
// its launches and stats[slot] the runs of a loop's body, from which the
// host tallies the stage kernels' launches when it is asked. With
// check_done = 0, need = 1 and max_iterations = T it counts T runs: the
// campaign's loop over ticks.
//
// compact_continue is one block too: the compacted solver's schedule
// (solver/batched.py: lm_solve_batch_compacted). At a rung's check it counts
// the rung's active lanes (__syncthreads_count over its W done bytes) and
// decides, as the eager loop does before each chunk of check_every
// iterations: stop at zero or at the cap; descend to the next rung if the
// count fits it (the transition's IF); else run a chunk of check_every
// iterations at this rung (the rung's WHILE) or, at the last check, the
// remainder of max_iterations (the remainder's IF). Its `finish` role picks
// the scatter of the rung reached. Its stats (int64, 4 + 5 * rungs):
//     [0] LM iterations of the tick, [1] its launches, [2] the rung reached,
//     [3] 1 once the schedule has stopped, [4 + k] iterations at rung k,
//     [4 + L + k] full chunks, [4 + 2L + k] remainder chunks,
//     [4 + 3L + k] transitions from rung k and [4 + 4L + k] scatters of
//     rung k since the host last read them.
// Both kernels are bound by their launch (a read of B bytes), so each is as
// simple as one block can be.
//
// Built with the runtime API of nvcc's static cudart, as every other source
// of the package: graph, node and stream handles are the CUDA driver's
// objects, so graphs captured by PyTorch's own runtime are children here,
// and the parent launches on PyTorch's stream. Conditional nodes (WHILE and
// IF, nested one in another's body) need CUDA 12.4; an older runtime or
// driver fails here and the caller raises.

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHandles = 32;  // a compact_continue sets up to this many conditions
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

struct CompactArgs {
  cudaGraphConditionalHandle handles[kMaxHandles];
  int handle_mask;  // bit j: set handles[j] (0 outside a graph)
  const unsigned char* done;
  int width;       // lanes of this rung
  int next_width;  // lanes of the next rung, 0 at the last
  long long* stats;
  int* out;  // check: [while, remainder, transition]; finish: [scatter of rung k]
  int rung, n_rungs, reset, check_every, max_iterations, finish;
};

__global__ void compact_continue_kernel(CompactArgs a) {
  __shared__ int s_count;
  const int L = a.n_rungs;
  long long* s = a.stats;
  if (threadIdx.x == 0) {
    if (a.reset) {
      s[0] = 0;
      s[2] = 0;
      s[3] = 0;
      for (int k = 0; k < L; ++k) s[4 + k] = 0;
    }
    s[1] += 1;
    long long left = a.max_iterations - s[0];
    s_count = !a.finish && !s[3] && s[2] == a.rung && left > 0;
  }
  __syncthreads();
  int count = 0;
  if (s_count) {  // the same for every thread
    for (int base = 0; base < a.width; base += blockDim.x) {
      int i = base + threadIdx.x;
      count += __syncthreads_count(i < a.width && a.done[i] == 0);
    }
  }
  if (threadIdx.x != 0) return;
  int go[kMaxHandles] = {};
  int n_out = 3;
  if (a.finish) {
    n_out = L;
    for (int k = 1; k < L; ++k) {
      go[k] = s[2] == k;
      s[4 + 4 * L + k] += go[k];
    }
  } else if (s_count) {
    const int r = a.rung;
    long long left = a.max_iterations - s[0];
    long long n = left < a.check_every ? left : a.check_every;
    if (count == 0) {
      s[3] = 1;
    } else if (a.next_width > 0 && count <= a.next_width) {
      go[2] = 1;
      s[2] = r + 1;
      s[4 + 3 * L + r] += 1;
    } else {
      go[n == a.check_every ? 0 : 1] = 1;
      s[0] += n;
      s[4 + r] += n;
      if (n == a.check_every) {
        s[4 + L + r] += 1;
      } else {
        s[4 + 2 * L + r] += 1;
        s[3] = 1;  // the remainder is the last chunk
      }
    }
  } else if (!a.finish && s[2] == a.rung && a.max_iterations - s[0] <= 0) {
    s[3] = 1;  // the cap: no check after the last chunk
  }
  for (int j = 0; j < n_out; ++j) {
    a.out[j] = go[j];
    if (a.handle_mask >> j & 1) cudaGraphSetConditional(a.handles[j], go[j]);
  }
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                     size_t n_dep, cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, dep, nullptr, n_dep, params);
#else
  return cudaGraphAddNode(node, graph, dep, n_dep, params);
#endif
}

cudaError_t add_kernel(void** node_out, void* graph, void* dep, void* func, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1);
  p.blockDim = dim3(kThreads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(&node, static_cast<cudaGraph_t>(graph), d ? &d : nullptr,
                                           d ? 1 : 0, &p);
  if (err == cudaSuccess) *node_out = node;
  return err;
}

// Every entry clears a failure from the runtime's last error: the kernels'
// launch checks read cudaGetLastError(), and a stale error there fails the
// next kernel.
int cleared(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
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

// A new empty graph; fails with cudaErrorNotSupported where the runtime or
// the driver is older than 12.4 (no conditional nodes).
int social_mpc_graph_create(void** graph_out) {
  int runtime = 0, driver = 0;
  cudaError_t err = cudaRuntimeGetVersion(&runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(&driver);
  if (err != cudaSuccess) return cleared(err);
  if (runtime < 12040 || driver < 12040) return cudaErrorNotSupported;
  cudaGraph_t g;
  err = cudaGraphCreate(&g, 0);
  if (err == cudaSuccess) *graph_out = g;
  return cleared(err);
}

// A conditional handle of `graph` (the graph that will hold its node),
// reset to 0 at every launch.
int social_mpc_graph_handle(void* graph, unsigned long long* handle_out) {
  cudaGraphConditionalHandle h;
  cudaError_t err =
      cudaGraphConditionalHandleCreate(&h, static_cast<cudaGraph_t>(graph), 0,
                                       cudaGraphCondAssignDefault);
  if (err == cudaSuccess) *handle_out = h;
  return cleared(err);
}

// A child-graph node of `graph` (a clone of `child`, PyTorch's
// CUDAGraph.raw_cuda_graph()) after `dep` (NULL: no dependency).
int social_mpc_graph_add_child(void* graph, void* dep, void* child, void** node_out) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(graph),
                                               d ? &d : nullptr, d ? 1 : 0,
                                               static_cast<cudaGraph_t>(child));
  if (err == cudaSuccess) *node_out = node;
  return cleared(err);
}

// A conditional node of `graph` after `dep` on `handle`: a WHILE (is_while)
// or an IF; writes the node and its body graph, which the node owns.
int social_mpc_graph_add_conditional(void* graph, void* dep, unsigned long long handle,
                                     int is_while, void** node_out, void** body_out) {
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t node;
  cudaError_t err = add_node(&node, static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
                             &cp);
  if (err == cudaSuccess) {
    *node_out = node;
    *body_out = cp.conditional.phGraph_out[0];
  }
  return cleared(err);
}

// An lm_continue node of `graph` after `dep` that sets `handle`.
int social_mpc_graph_add_lm_continue(void* graph, void* dep, unsigned long long handle,
                                     const void* done, int n, void* stats, void* out, int reset,
                                     int add, int need, int max_iterations, int check_done,
                                     int slot, void** node_out) {
  cudaGraphConditionalHandle h = handle;
  int set_handle = 1;
  void* args[] = {&h, &set_handle, &done, &n, &stats, &out, &reset,
                  &add, &need, &max_iterations, &check_done, &slot};
  return cleared(add_kernel(node_out, graph, dep, reinterpret_cast<void*>(lm_continue_kernel),
                            args));
}

// A compact_continue node of `graph` after `dep` that sets handles[j] for
// each bit j of handle_mask (n_handles <= 32).
int social_mpc_graph_add_compact_continue(void* graph, void* dep,
                                          const unsigned long long* handles, int n_handles,
                                          int handle_mask, const void* done, int width,
                                          int next_width, void* stats, void* out, int rung,
                                          int n_rungs, int reset, int check_every,
                                          int max_iterations, int finish, void** node_out) {
  if (n_handles < 0 || n_handles > kMaxHandles || n_rungs > kMaxHandles) {
    return cudaErrorInvalidValue;
  }
  CompactArgs a = {};
  for (int j = 0; j < n_handles; ++j) a.handles[j] = handles[j];
  a.handle_mask = handle_mask;
  a.done = static_cast<const unsigned char*>(done);
  a.width = width;
  a.next_width = next_width;
  a.stats = static_cast<long long*>(stats);
  a.out = static_cast<int*>(out);
  a.rung = rung;
  a.n_rungs = n_rungs;
  a.reset = reset;
  a.check_every = check_every;
  a.max_iterations = max_iterations;
  a.finish = finish;
  void* args[] = {&a};
  return cleared(add_kernel(node_out, graph, dep,
                            reinterpret_cast<void*>(compact_continue_kernel), args));
}

int social_mpc_graph_instantiate(void* graph, void** exec_out) {
  cudaGraphExec_t exec;
  cudaError_t err = cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
  if (err == cudaSuccess) *exec_out = exec;
  return cleared(err);
}

int social_mpc_graph_launch(void* exec, void* stream) {
  return cleared(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                 static_cast<cudaStream_t>(stream)));
}

// exec may be NULL (a graph never instantiated). A program collected during
// another stream's capture gets cudaErrorStreamCaptureUnsupported here.
int social_mpc_graph_destroy(void* graph, void* exec) {
  cudaError_t a = exec ? cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)) : cudaSuccess;
  cudaError_t b = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  cleared(a != cudaSuccess ? a : b);
  return a != cudaSuccess ? a : b;
}

// counts[t] += the nodes of type t (cudaGraphNodeType; >= 31 in slot 31) in
// graph and, recursively, in its child graphs. A graph that holds
// conditional nodes is not asked (on the H100's CUDA 12.9 runtime and
// 580 driver, cudaGraphGetNodes on such a graph failed with
// cudaErrorUnknown): the caller counts a parent from its parts.
int social_mpc_graph_node_types(void* graph, long long* counts) {
  cudaError_t err = cudaSuccess;
  count_types(static_cast<cudaGraph_t>(graph), counts, &err);
  return cleared(err);
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

// compact_continue outside any graph (no handle is set): done (width,)
// bool, stats (4 + 5 * n_rungs) int64, out (3, or n_rungs in the finish
// role) int32.
int social_mpc_compact_continue(const void* done, int width, int next_width, void* stats,
                                void* out, int rung, int n_rungs, int reset, int check_every,
                                int max_iterations, int finish, void* stream) {
  if (n_rungs > kMaxHandles) return cudaErrorInvalidValue;
  CompactArgs a = {};
  a.done = static_cast<const unsigned char*>(done);
  a.width = width;
  a.next_width = next_width;
  a.stats = static_cast<long long*>(stats);
  a.out = static_cast<int*>(out);
  a.rung = rung;
  a.n_rungs = n_rungs;
  a.reset = reset;
  a.check_every = check_every;
  a.max_iterations = max_iterations;
  a.finish = finish;
  compact_continue_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
