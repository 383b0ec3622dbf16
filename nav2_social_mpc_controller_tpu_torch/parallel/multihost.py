"""Multi-process scale-out: process-group initialisation, the global mesh,
and host-local scenario feeding.

Counterpart of the JAX package's ``parallel/multihost.py``. Each process is
one rank with one device; it generates or ingests its local scenario shard,
puts it on its device and runs the distributed step, whose only traffic is
the reduction of the fleet metrics (``parallel/mesh.py``). In torch no
global array exists: a rank's batch IS its rows of the global batch, in
rank order.

Rendezvous arguments are explicit: a coordinator address, the number of
processes and this process's index (what ``runtime/campaign.py`` hands the
workers it spawns), or, with none of them, torch's ``env://`` rendezvous,
which is what ``torchrun`` sets up on real hosts. The backend is an
argument too: NCCL for CUDA ranks with a card each, gloo for CPU ranks and
for several ranks that share one card (NCCL refuses two ranks on one
card). A wrong choice raises; nothing switches backend or device by itself.
"""

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from nav2_social_mpc_controller_tpu_torch.core.types import (
    carry_from_numpy,
    resolve_device,
    scenario_from_numpy,
)
from nav2_social_mpc_controller_tpu_torch.parallel.mesh import Mesh, make_mesh

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched_by_torchrun() -> bool:
    """Whether torchrun (torch.distributed.elastic) started this process,
    and so set up the env:// rendezvous."""
    return dist.is_torchelastic_launched()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> str:
    """Initialise the default process group; returns its backend.

    With ``coordinator_address`` ("host:port" of rank 0), ``num_processes``
    and ``process_id`` this joins a TCP rendezvous there; with none of them,
    torch's env:// rendezvous (torchrun). ``backend`` defaults to NCCL for
    CUDA ranks and gloo for CPU ranks. Collectives and the rendezvous give
    up after ``timeout_s`` seconds. Raises for the card where there is none,
    for NCCL on the CPU, and for half the rendezvous arguments."""
    dev = resolve_device(device)
    backend = default_backend(dev) if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL reduces CUDA tensors: CPU ranks take backend='gloo'")
    timeout = datetime.timedelta(seconds=timeout_s)
    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit):
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    elif any(a is None for a in explicit):
        raise ValueError(
            "pass coordinator_address, num_processes and process_id together "
            "(or none of them, for torchrun's env:// rendezvous)"
        )
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    return backend


def make_global_mesh(device="cuda") -> Mesh:
    """The mesh over every rank of the default group, this rank on `device`
    (a bare "cuda": the card of its local rank)."""
    return make_mesh(device)


def host_local_to_global(mesh: Mesh, host_local_batch, dtype=torch.float32):
    """This process's local batch (a Scenario or a ControllerCarry with
    NumPy leaves; the leading axis is the local batch) as this rank's rows
    of the global batch: tensors on ``mesh.device``. The global batch is
    the concatenation of every rank's rows in rank order."""
    if hasattr(host_local_batch, "robot"):
        return scenario_from_numpy(host_local_batch, device=mesh.device, dtype=dtype)
    if hasattr(host_local_batch, "prev_path"):
        return carry_from_numpy(host_local_batch, device=mesh.device, dtype=dtype)
    raise TypeError(f"a Scenario or a ControllerCarry was expected, got {type(host_local_batch)}")


def global_batch_size(mesh: Mesh, per_device: int) -> int:
    """Scenarios over every rank: one device per rank."""
    return per_device * mesh.world_size
