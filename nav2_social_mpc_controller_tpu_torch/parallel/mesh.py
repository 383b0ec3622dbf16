"""Scale-out over several devices: the "mesh", scenario sharding, and the
distributed batched step.

Counterpart of the JAX package's ``parallel/mesh.py``. There is no reference
equivalent — the reference is single-problem, single-thread CPU (SURVEY.md
section 2.3). The JAX package splits a 1-D ``batch`` device mesh with
``shard_map`` inside one program; PyTorch has no virtual devices, so here a
"mesh" is a ``torch.distributed`` process group with one rank per device:

  * each rank holds its own rows of the global scenario batch
    (``shard_batch``) and runs the batched step on them;
  * scenario solves are independent, so the only collective of a tick is
    one ``all_reduce`` of the five ``FleetMetrics`` (the JAX package's
    ``psum``/``pmean``); nothing crosses ranks inside the LM loop;
  * ``gather_batch`` concatenates every rank's rows in rank order, which is
    what reading a JAX global array gives.

Initialise the process group first (``parallel.multihost.initialize``).
NCCL reduces CUDA tensors, one rank per card; gloo reduces host tensors, so
under gloo what crosses ranks goes through host copies (gloo is what several
ranks on one card, or CPU ranks, take).
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from nav2_social_mpc_controller_tpu_torch.controller.controller import make_step_batch
from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.core.types import resolve_device, tree_map


class Mesh(NamedTuple):
    """This rank's view of the data-parallel world: the process group (None:
    the default group, which the mesh then does not keep alive past
    destroy_process_group), this rank's index in it, the number of ranks,
    and this rank's device."""

    group: object
    rank: int
    world_size: int
    device: torch.device


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of `group` (default: the default process group). A bare
    ``"cuda"`` puts rank r on ``cuda:{local_rank % device_count}``, the local
    rank being what torchrun's launcher gives the process, else the global
    rank (the ranks of a local cluster share one host); an indexed device
    or ``"cpu"`` is taken as given. Raises where
    torch.distributed is not initialised, where the card is asked for and
    there is none, and for an NCCL group on the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "parallel.multihost.initialize first (a world of one included)"
        )
    rank = dist.get_rank(group)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local_rank = dist.get_node_local_rank(fallback_rank=rank)
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dist.get_backend(group) == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group reduces CUDA tensors: CPU ranks take backend='gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=group, rank=rank, world_size=dist.get_world_size(group), device=dev)


def _on_host(mesh: Mesh) -> bool:
    """Whether collectives of this mesh take host copies (gloo)."""
    return dist.get_backend(mesh.group) == "gloo"


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a global batch (tensor or NumPy leaves whose
    leading axis is divisible by the world size), as tensors on
    ``mesh.device``: rank r takes the r-th of world_size equal blocks."""

    def rows(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        n = t.shape[0]
        if n % mesh.world_size:
            raise ValueError(
                f"a batch of {n} rows does not split over {mesh.world_size} ranks"
            )
        k = n // mesh.world_size
        return t[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device).contiguous()

    return tree_map(rows, tree)


def gather_batch(mesh: Mesh, tree):
    """Every rank's rows of each leaf, concatenated in rank order, on every
    rank (``all_gather``; every rank must hold the same number of rows).
    Each leaf comes back on the device it was given on."""
    host = _on_host(mesh)

    def gather(x):
        wire = x.cpu() if host else x
        is_bool = wire.dtype == torch.bool
        if is_bool:  # bool travels as uint8 on both backends
            wire = wire.to(torch.uint8)
        wire = wire.contiguous()
        parts = [torch.empty_like(wire) for _ in range(mesh.world_size)]
        dist.all_gather(parts, wire, group=mesh.group)
        out = torch.cat(parts)
        return (out.bool() if is_bool else out).to(x.device)

    return tree_map(gather, tree)


class FleetMetrics(NamedTuple):
    """Cross-rank reduced telemetry (the only traffic between ranks — the
    scenarios are independent). Counts are int32; ``mean_final_cost`` has
    the step's float dtype. On an NCCL mesh they lie on the rank's card,
    on a gloo mesh on the host."""

    n_scenarios: torch.Tensor
    n_usable: torch.Tensor
    n_status_ok: torch.Tensor
    total_iterations: torch.Tensor
    mean_final_cost: torch.Tensor


def reduce_metrics(mesh: Mesh, aux, dtype) -> FleetMetrics:
    """The five FleetMetrics of this tick over every rank, in one
    ``all_reduce`` of a float64 vector (counts of int32 size are exact in
    it): sums of the scenarios, usable solves, STATUS_OK and LM iterations,
    and the mean over ranks of each rank's own mean final cost — the JAX
    package's ``pmean`` of ``jnp.mean``, not the mean over all scenarios."""
    solve = aux.solve
    local = torch.stack([
        torch.full((), aux.status.shape[0], dtype=torch.float64, device=aux.status.device),
        solve.usable.sum().to(torch.float64),
        (aux.status == 0).sum().to(torch.float64),
        solve.iterations.sum().to(torch.float64),
        solve.final_cost.mean().to(torch.float64),
    ])
    if _on_host(mesh):
        local = local.cpu()
    dist.all_reduce(local, op=dist.ReduceOp.SUM, group=mesh.group)
    counts = local[:4].to(torch.int32)
    return FleetMetrics(
        n_scenarios=counts[0],
        n_usable=counts[1],
        n_status_ok=counts[2],
        total_iterations=counts[3],
        mean_final_cost=(local[4] / mesh.world_size).to(dtype),
    )


def make_distributed_step(cfg: SocialMPCConfig, mesh: Mesh, dtype=torch.float32):
    """The distributed batched step: step(scenario_local, carry_local) ->
    (cmd, aux, carry', FleetMetrics).

    The scenario and carry are this rank's rows (``shard_batch`` or
    ``multihost.host_local_to_global``) on ``mesh.device``; the command, aux
    and carry come back as this rank's rows, the metrics reduced over every
    rank (``reduce_metrics``). The rows run through ``make_step_batch``, the
    same kernels as one process; every rank must call the step each tick."""
    local_step = make_step_batch(cfg, device=mesh.device, dtype=dtype)

    def step(scenario, carry):
        cmd, aux, new_carry = local_step(scenario, carry)
        return cmd, aux, new_carry, reduce_metrics(mesh, aux, dtype)

    return step
