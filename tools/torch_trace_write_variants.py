#!/usr/bin/env python3
"""Device ms of ways to write one LM iteration's debug-trace row on the card.

    python3 tools/torch_trace_write_variants.py

At B = 4096 lanes and T = 40 columns, each variant is captured as a CUDA
graph and replayed back to back behind a spin kernel (as chip_smoke.py's
time_cuda times a kernel), twice in turns: ``positional`` (solver/lm.py:
record_trace at a Python column, what a graph per column position runs),
``by_lane_mask`` (lm.record_trace_by_lane: each lane's column from its own
iteration count, one masked torch.where a leaf), ``scatter`` (the same
column by gather and scatter_), ``index_put`` (by advanced indexing),
``stacked_mask`` (the six float leaves as one (6, B, T) tensor, one
torch.where), and an empty graph (the floor). The inputs are random: the
write's cost does not depend on the values. Prints one JSON dict of ms
lists.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter, lm  # noqa: E402

B, T = 4096, 40
SPIN_CYCLES = 100_000_000


def graph_ms(fn, reps=200):
    """Device ms of fn() as a CUDA graph, replayed reps times back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_trace_write_variants: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    active = rnd(B) < 0.7
    cost, change, step_norm, rho, radius = (rnd(B) for _ in range(5))
    st = lm.LMState(u=None, cost=cost, g=rnd(B, 6), jtj=None, radius=radius,
                    decrease_factor=None,
                    iters=torch.randint(0, T + 1, (B,), generator=gen).to(dev).int(),
                    done=~active, term=None, failed=None)
    aux = cuda_iter.CommitAux(rho=rho, actual_change=change, step_norm=step_norm,
                              accept=rnd(B) < 0.5, active=active)

    def rows():
        grad_max = st.g.abs().max(dim=1).values
        return (st.cost, aux.actual_change, grad_max, aux.step_norm, aux.rho, st.radius,
                aux.accept)

    def scatter(trace):
        col = st.iters.clamp(max=T - 1).long()[:, None]
        for buf, v in zip(trace, rows()):
            held = buf.gather(1, col)[:, 0]
            buf.scatter_(1, col, torch.where(aux.active, v, held)[:, None])

    def index_put(trace):
        col = st.iters.clamp(max=T - 1).long()
        lanes = torch.arange(B, device=dev)
        for buf, v in zip(trace, rows()):
            buf.index_put_((lanes, col), torch.where(aux.active, v, buf[lanes, col]))

    floats = torch.zeros(6, B, T, device=dev)
    flags = torch.zeros(B, T, dtype=torch.bool, device=dev)

    def stacked(_):
        col = st.iters.clamp(max=T - 1)[:, None]
        hit = (torch.arange(T, device=dev)[None, :] == col) & aux.active[:, None]
        *v, accept = rows()
        torch.where(hit, torch.stack(v)[:, :, None], floats, out=floats)
        torch.where(hit, accept[:, None], flags, out=flags)

    variants = {
        "positional": lambda trace: lm.record_trace(trace, 17, st, aux),
        "by_lane_mask": lambda trace: lm.record_trace_by_lane(trace, st, aux),
        "scatter": scatter, "index_put": index_put, "stacked_mask": stacked,
        "empty_graph_floor": lambda _: torch.cuda._sleep(0),
    }
    res = {name: [] for name in variants}
    for _ in range(2):
        for name, fn in variants.items():
            trace = lm.new_trace(torch.zeros(B, 6, device=dev), T)
            res[name].append(graph_ms(lambda: fn(trace)))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "B": B, "T": T, "ms": res}))


if __name__ == "__main__":
    main()
