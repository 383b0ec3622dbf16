"""The LM loop on the device: ``lm_continue`` (wrapper, plain version, launch
count) and ``ParentGraph``, the tick as one CUDA graph launch, for
``csrc/tick_graph.cu``.

The port's counterpart of the JAX package's LM ``lax.while_loop``
(``solver/lm.py: lm_solve``) inside its jitted step; it replaces no Pallas
kernel. controller/graph.py captures a tick's stages (head, a chunk of n LM
iterations for each loop, tail); ``ParentGraph`` puts them into one graph

    head -> for each loop k: lm_continue, WHILE { chunk_k, lm_continue } -> tail

whose WHILE nodes run as long as ``lm_continue`` says, on the device. The
loops are those of ``loop_lengths``: ``check_every`` iterations per body and
a second loop for the remainder of ``max_iterations``, so the iterations
run, and the bits, are the eager loop's (``lm_solve`` asks every
``check_every`` iterations from iteration 0 and stops at the cap).

``stats`` (int64, 2 + loops) is the loop's record on the device: [0] the
LM iterations of the last tick, [1] lm_continue's launches and [2 + k] the
runs of loop k's body since the host last read them. On the CPU the same
loops run in Python, each condition computed by lm_continue's plain
version on the same tensors.
"""

import ctypes
import weakref

import torch

from nav2_social_mpc_controller_tpu_torch import _build

# cudaGraphNodeType values a conditional node's body may hold: kernel,
# memcpy, memset, child graph, empty, conditional.
BODY_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 4: "graph", 5: "empty",
                   13: "conditional"}
NODE_TYPE_NAMES = {**BODY_NODE_TYPES, 3: "host", 6: "wait_event", 7: "event_record",
                   8: "ext_semaphore_signal", 9: "ext_semaphore_wait", 10: "mem_alloc",
                   11: "mem_free", 12: "batch_mem_op"}


def loop_lengths(max_iterations: int, check_every: int):
    """The iterations of each loop's body, in order: check_every, then the
    remainder of max_iterations if check_every does not divide it
    (check_every = 0: one body of every iteration, run once)."""
    if max_iterations <= 0:
        return []
    if check_every <= 0:
        return [max_iterations]
    full = [check_every] if max_iterations >= check_every else []
    rest = max_iterations % check_every
    return full + ([rest] if rest else [])


def new_stats(n_loops: int, device) -> torch.Tensor:
    return torch.zeros(2 + n_loops, dtype=torch.int64, device=device)


def lm_continue_plain(done, stats, out, reset: bool, add: int, need: int,
                      max_iterations: int, check_done: bool, slot: int) -> None:
    """Plain version of lm_continue: the tick's iteration count stats[0]
    becomes 0 (reset) or grows by `add`, stats[1] and (slot >= 2)
    stats[slot] grow by one, and out[0] = 1 if the loop goes on:
    (no check or any lane not done) and stats[0] + need <= max_iterations."""
    it = stats[0] * 0 if reset else stats[0] + add
    stats[0] = it
    stats[1] += 1
    if slot >= 2:
        stats[slot] += 1
    go = (it + need <= max_iterations) & (need > 0)
    if check_done:
        go = go & (~done).any()
    out[0] = go.to(out.dtype)


def lm_continue(done, stats, out, reset: bool, add: int, need: int, max_iterations: int,
                check_done: bool, slot: int = -1) -> None:
    """lm_continue outside a graph (it sets no loop's condition), in place on
    stats (int64) and out (one int32): the kernel on CUDA tensors, the
    plain version on CPU tensors. done (B,) bool."""
    if not done.is_cuda:
        lm_continue_plain(done, stats, out, reset, add, need, max_iterations, check_done, slot)
        return
    dev = done.device
    _build.check_tensor("lm_continue", "done", done, torch.bool, done.shape, dev)
    _build.check_tensor("lm_continue", "stats", stats, torch.int64, stats.shape, dev)
    _build.check_tensor("lm_continue", "out", out, torch.int32, (1,), dev)
    if done.dim() != 1 or slot >= stats.shape[0]:
        raise ValueError("lm_continue: done must be (B,) and slot an index of stats")
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.social_mpc_lm_continue(
            done.data_ptr(), done.shape[0], stats.data_ptr(), out.data_ptr(), int(reset),
            add, need, max_iterations, int(check_done), slot,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "lm_continue")
    _build.launch_counts["lm_continue"] += 1


def node_types(raw_graph: int) -> dict:
    """{type name: nodes} of a cudaGraph_t and, recursively, its child
    graphs."""
    counts = (ctypes.c_longlong * 32)()
    err = _build.load().social_mpc_graph_node_types(raw_graph, counts)
    if err != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed: cudaError {err}")
    return {NODE_TYPE_NAMES.get(t, f"type{t}"): n for t, n in enumerate(counts) if n}


def check_body(raw_graph: int, what: str) -> dict:
    """node_types of a graph that goes into a conditional node's body;
    raises on a node type a body may not hold."""
    types = node_types(raw_graph)
    bad = sorted(set(types) - set(BODY_NODE_TYPES.values()))
    if bad:
        raise RuntimeError(f"{what}: a conditional body cannot hold {bad} nodes ({types})")
    return types


def _destroy(lib, graph, exec_):
    lib.social_mpc_tick_graph_destroy(graph, exec_)


class ParentGraph:
    """A tick as one instantiated CUDA graph: head, the loops, tail, from
    the stages' torch.cuda.CUDAGraph(keep_graph=True) objects, which the
    caller keeps alive (their pool holds the memory the nodes use) and never
    resets. ``done`` is the head's LM state's flags, which every chunk
    updates in place. Raises if the runtime or driver lacks conditional
    nodes (CUDA < 12.4) or the build or instantiation fails."""

    def __init__(self, head, chunks, tail, lengths, done, stats, out, max_iterations: int,
                 check_done: bool):
        lib = _build.load()
        n = len(lengths)
        raws = [g.raw_cuda_graph() for g in chunks]
        for k, raw in enumerate(raws):
            check_body(raw, f"the chunk of {lengths[k]} LM iterations")
        graph, exec_ = ctypes.c_void_p(), ctypes.c_void_p()
        bodies = (ctypes.c_void_p * max(n, 1))()
        err = lib.social_mpc_tick_graph_build(
            head.raw_cuda_graph(), tail.raw_cuda_graph(), n, (ctypes.c_void_p * max(n, 1))(*raws),
            (ctypes.c_int * max(n, 1))(*lengths), done.data_ptr(), done.shape[0],
            stats.data_ptr(), out.data_ptr(), max_iterations, int(check_done),
            ctypes.byref(graph), ctypes.byref(exec_), bodies)
        if err != 0:
            raise RuntimeError(
                "building the tick's parent graph (conditional WHILE nodes, CUDA >= 12.4) "
                f"failed: cudaError {err}")
        self.graph, self.exec = graph.value, exec_.value
        self.parts = [head.raw_cuda_graph(), tail.raw_cuda_graph()] + [bodies[k] for k in range(n)]
        self.n_loops = n
        self._finalizer = weakref.finalize(self, _destroy, lib, self.graph, self.exec)

    def launch(self) -> None:
        err = _build.load().social_mpc_tick_graph_launch(
            self.exec, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launching the tick's graph failed: cudaError {err}")

    def node_types(self) -> dict:
        """{type name: nodes} of the whole parent graph: its own nodes (the
        head's and the tail's child-graph nodes, each loop's lm_continue
        and conditional node), the head's and the tail's, and each loop
        body's (its chunk's child-graph node and nodes, its lm_continue)."""
        total = {"graph": 2, "kernel": self.n_loops, "conditional": self.n_loops}
        for raw in self.parts:
            for k, n in node_types(raw).items():
                total[k] = total.get(k, 0) + n
        return total
