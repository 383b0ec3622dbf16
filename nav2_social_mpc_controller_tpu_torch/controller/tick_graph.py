"""The device's loops: the condition kernels ``lm_continue`` and
``compact_continue`` (wrappers, plain versions, launch counts) and
``ParentGraph``, a CUDA graph assembled from captured stages and those
kernels and launched as one, for ``csrc/tick_graph.cu``.

The port's counterpart of the JAX package's ``lax.while_loop``s and
``lax.scan`` inside its jitted programs; it replaces no Pallas kernel.
controller/graph.py captures a tick's stages (head, a chunk of n LM
iterations for each loop, tail); ``add_tick`` puts them into a graph

    head -> for each loop k: lm_continue, WHILE { chunk_k, lm_continue } -> tail

whose WHILE nodes run as long as ``lm_continue`` says, on the device. The
loops are those of ``loop_lengths``: ``check_every`` iterations per body and
a second loop for the remainder of ``max_iterations``, so the iterations
run, and the bits, are the eager loop's (``lm_solve`` asks every
``check_every`` iterations from iteration 0 and stops at the cap). A tick's
nodes go into a graph of their own (make_step_batch's tick) or into the
body of the simulator's loop over ticks (runtime/simulator.py), nested
there: a graph that holds conditional nodes cannot be a child graph, so a
tick is added node by node. controller/graph_compacted.py assembles the
compacted tick from the same primitives, on ``compact_continue``.

``stats`` (int64, 2 + loops) is the loops' record on the device: [0] the
LM iterations of the last tick, [1] lm_continue's launches and [2 + k] the
runs of loop k's body since the host last read them (``compact_stats``
gives compact_continue's layout). On the CPU the same loops run in Python,
each condition computed by the kernel's plain version on the same tensors.
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
MAX_HANDLES = 32  # conditions one compact_continue sets; also the most rungs


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


def compact_stats(n_rungs: int, device) -> torch.Tensor:
    """compact_continue's record for a ladder of n_rungs (csrc/tick_graph.cu):
    [0] LM iterations of the tick, [1] launches, [2] rung reached, [3]
    stopped, then per rung k: [4 + k] iterations at rung k in the tick,
    [4 + L + k] full chunks, [4 + 2L + k] remainder chunks, [4 + 3L + k]
    transitions from k, [4 + 4L + k] scatters of k since the last read."""
    return torch.zeros(4 + 5 * n_rungs, dtype=torch.int64, device=device)


def compact_continue_plain(done, stats, out, rung: int, n_rungs: int, next_width: int,
                           reset: bool, check_every: int, max_iterations: int,
                           finish: bool = False) -> None:
    """Plain version of compact_continue, in place on stats and out. At the
    check of `rung` (the rung reached, schedule not stopped): with
    max_iterations - stats[0] = 0 left, or no lane of `done` (the rung's
    (W,) flags) active, the schedule stops; if the active lanes fit the
    next rung (next_width > 0) out[2] = 1 (descend); else n = min(
    check_every, left) iterations run at this rung: out[0] = 1 for a full
    chunk, out[1] = 1 for the remainder, the last. With `finish`, out[k] = 1
    for the scatter of the rung reached (k >= 1). reset starts a tick."""
    s = stats.tolist()
    L = n_rungs
    if reset:
        s[0] = s[2] = s[3] = 0
        s[4:4 + L] = [0] * L
    s[1] += 1
    left = max_iterations - s[0]
    if finish:
        go = [0] * L
        for k in range(1, L):
            go[k] = int(s[2] == k)
            s[4 + 4 * L + k] += go[k]
    else:
        go = [0, 0, 0]
        if not s[3] and s[2] == rung:
            count = int((~done).sum()) if left > 0 else 0
            n = min(check_every, left)
            if left <= 0 or count == 0:
                s[3] = 1
            elif next_width > 0 and count <= next_width:
                go[2] = 1
                s[2] = rung + 1
                s[4 + 3 * L + rung] += 1
            else:
                full = n == check_every
                go[0 if full else 1] = 1
                s[0] += n
                s[4 + rung] += n
                s[4 + (1 if full else 2) * L + rung] += 1
                s[3] = int(not full)
    stats.copy_(torch.tensor(s, dtype=stats.dtype))
    out[:len(go)] = torch.tensor(go, dtype=out.dtype)


def compact_continue(done, stats, out, rung: int, n_rungs: int, next_width: int, reset: bool,
                     check_every: int, max_iterations: int, finish: bool = False) -> None:
    """compact_continue outside a graph (it sets no condition): the kernel
    on CUDA tensors, the plain version on CPU tensors. done (W,) bool,
    stats compact_stats(n_rungs), out (>= max(3, n_rungs),) int32."""
    if not stats.is_cuda:
        compact_continue_plain(done, stats, out, rung, n_rungs, next_width, reset, check_every,
                               max_iterations, finish)
        return
    dev = stats.device
    _check_compact_args(done, stats, out, n_rungs, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.social_mpc_compact_continue(
            done.data_ptr(), done.shape[0], next_width, stats.data_ptr(), out.data_ptr(), rung,
            n_rungs, int(reset), check_every, max_iterations, int(finish),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "compact_continue")
    _build.launch_counts["compact_continue"] += 1


def _check_compact_args(done, stats, out, n_rungs, dev):
    _build.check_tensor("compact_continue", "done", done, torch.bool, done.shape, dev)
    _build.check_tensor("compact_continue", "stats", stats, torch.int64,
                        (4 + 5 * n_rungs,), dev)
    _build.check_tensor("compact_continue", "out", out, torch.int32, out.shape, dev)
    if done.dim() != 1 or not 0 < n_rungs <= MAX_HANDLES or out.shape[0] < max(3, n_rungs):
        raise ValueError("compact_continue: done must be (W,), 0 < n_rungs <= 32 and out hold "
                         "max(3, n_rungs) flags")


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


def _destroy(lib, handles):
    graph, exec_ = handles
    lib.social_mpc_graph_destroy(graph, exec_)


def _ptr(node):
    return ctypes.c_void_p(node)


class ParentGraph:
    """One CUDA graph assembled node by node, then instantiated and
    launched as one: child-graph nodes cloned from stages captured with
    torch.cuda.CUDAGraph(keep_graph=True), which the caller keeps alive
    (their pool holds the memory the nodes use) and never resets, the
    condition kernels, and conditional WHILE / IF nodes whose bodies are
    graphs of this one (``root`` or a body: where a node goes). Every method
    that adds a node takes the node it depends on (None: none) and returns
    the new one. Raises if the runtime or driver lacks conditional nodes
    (CUDA < 12.4) or a node, the instantiation or a launch fails."""

    def __init__(self):
        self._lib = _build.load()
        graph = ctypes.c_void_p()
        self._check(self._lib.social_mpc_graph_create(ctypes.byref(graph)),
                    "creating a graph (conditional nodes need CUDA >= 12.4)")
        self.root = graph.value
        self._handles = [self.root, None]
        self._finalizer = weakref.finalize(self, _destroy, self._lib, self._handles)
        self.own = {}  # the nodes added here, by type
        self.parts = []  # the child graphs cloned in

    @staticmethod
    def _check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: cudaError {err}")

    def _added(self, kind, node):
        self.own[kind] = self.own.get(kind, 0) + 1
        return node.value

    def handle(self, graph) -> int:
        """A condition of `graph`, the graph that will hold its node."""
        h = ctypes.c_ulonglong()
        self._check(self._lib.social_mpc_graph_handle(_ptr(graph), ctypes.byref(h)),
                    "creating a conditional handle")
        return h.value

    def child(self, graph, dep, stage, what: str):
        """A child-graph node: a clone of `stage`'s (a CUDAGraph) graph."""
        raw = stage.raw_cuda_graph()
        check_body(raw, what)
        node = ctypes.c_void_p()
        self._check(self._lib.social_mpc_graph_add_child(
            _ptr(graph), _ptr(dep), _ptr(raw), ctypes.byref(node)), f"adding {what}")
        self.parts.append(raw)
        return self._added("graph", node)

    def conditional(self, graph, dep, handle: int, loop: bool):
        """A WHILE (loop) or IF node on `handle`: (node, its body graph)."""
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        self._check(self._lib.social_mpc_graph_add_conditional(
            _ptr(graph), _ptr(dep), handle, int(loop), ctypes.byref(node), ctypes.byref(body)),
            "adding a conditional node (CUDA >= 12.4)")
        return self._added("conditional", node), body.value

    def lm_continue(self, graph, dep, handle: int, done, stats, out, reset: bool, add: int,
                    need: int, max_iterations: int, check_done: bool, slot: int = -1):
        """An lm_continue node that sets `handle` (see lm_continue)."""
        node = ctypes.c_void_p()
        self._check(self._lib.social_mpc_graph_add_lm_continue(
            _ptr(graph), _ptr(dep), handle, done.data_ptr(), done.shape[0], stats.data_ptr(),
            out.data_ptr(), int(reset), add, need, max_iterations, int(check_done), slot,
            ctypes.byref(node)), "adding lm_continue")
        return self._added("kernel", node)

    def compact_continue(self, graph, dep, handles, done, stats, out, rung: int, n_rungs: int,
                         next_width: int, reset: bool, check_every: int, max_iterations: int,
                         finish: bool = False):
        """A compact_continue node (see compact_continue) that sets
        handles[j] to out[j] for each handle that is not None."""
        _check_compact_args(done, stats, out, n_rungs, stats.device)
        if len(handles) > MAX_HANDLES:
            raise ValueError("compact_continue sets at most 32 conditions")
        mask = sum(1 << j for j, h in enumerate(handles) if h is not None)
        values = (ctypes.c_ulonglong * MAX_HANDLES)(*[h or 0 for h in handles])
        node = ctypes.c_void_p()
        self._check(self._lib.social_mpc_graph_add_compact_continue(
            _ptr(graph), _ptr(dep), values, len(handles), mask, done.data_ptr(), done.shape[0],
            next_width, stats.data_ptr(), out.data_ptr(), rung, n_rungs, int(reset), check_every,
            max_iterations, int(finish), ctypes.byref(node)), "adding compact_continue")
        return self._added("kernel", node)

    def instantiate(self) -> "ParentGraph":
        exec_ = ctypes.c_void_p()
        self._check(self._lib.social_mpc_graph_instantiate(_ptr(self.root), ctypes.byref(exec_)),
                    "instantiating the parent graph")
        self.exec = self._handles[1] = exec_.value
        return self

    def launch(self) -> None:
        self._check(self._lib.social_mpc_graph_launch(
            _ptr(self.exec), _ptr(torch.cuda.current_stream().cuda_stream)),
            "launching the parent graph")

    def node_types(self) -> dict:
        """{type name: nodes} of the whole graph: the nodes added here (child
        graphs, condition kernels, conditional nodes) and those of every
        child graph, counted from the parts (cudaGraphGetNodes fails on a
        graph that holds conditional nodes)."""
        total = dict(self.own)
        for raw in self.parts:
            for k, n in node_types(raw).items():
                total[k] = total.get(k, 0) + n
        return total


def add_tick(parent: ParentGraph, graph, dep, head, chunks, tail, lengths, done, stats, out,
             max_iterations: int, check_done: bool):
    """A tick's nodes into `graph` of `parent` after `dep`: head, for each
    loop k (chunks[k] of lengths[k] iterations) lm_continue and a WHILE
    node whose body is chunks[k] and lm_continue, then tail (the stages'
    CUDAGraphs); returns the tail's node. done: the head's LM state's
    flags, which every chunk updates in place; stats new_stats(loops)."""
    prev = parent.child(graph, dep, head, "the tick's head")
    for k, (n, chunk) in enumerate(zip(lengths, chunks)):
        handle = parent.handle(graph)
        args = dict(done=done, stats=stats, out=out, need=n, max_iterations=max_iterations,
                    check_done=check_done)
        check = parent.lm_continue(graph, prev, handle, reset=k == 0, add=0, slot=-1, **args)
        prev, body = parent.conditional(graph, check, handle, loop=True)
        node = parent.child(body, None, chunk, f"the chunk of {n} LM iterations")
        parent.lm_continue(body, node, handle, reset=False, add=n, slot=2 + k, **args)
    return parent.child(graph, prev, tail, "the tick's tail")
