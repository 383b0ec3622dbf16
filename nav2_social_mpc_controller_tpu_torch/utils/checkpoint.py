"""Checkpoint/resume for long batch campaigns.

Counterpart of the JAX package's ``utils/checkpoint.py``. The reference's
only cross-tick persistence is the in-memory TrajectoryMemory warm start
(trajectory_memory.hpp:32-49), with no disk persistence. For large scenario
campaigns this module snapshots the batched ControllerCarry (or any other
NamedTuple of tensors) with ``torch.save``.

A snapshot holds the leaves positionally, ``leaf_i`` in the NamedTuple's
field order (``core.types.tree_leaves``: the order ``jax.tree.flatten``
gives), so ``restore_carry`` rebuilds any tree whose structure the caller
can give (``like``). It also reads the JAX package's NumPy snapshots
(``save_carry(..., use_orbax=False)``, ``<path>.npz``, the same layout), so
a carry saved by the JAX package resumes here. Orbax directories are not
read: the port does not import orbax.
"""

import os
from typing import Any

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.core.types import tree_leaves, tree_map


def save_carry(path: str, state: Any) -> str:
    """Snapshot a NamedTuple of tensors to ``<path>.pt`` (its directory made
    if missing); returns the path written. The file is written beside it,
    flushed to disk and renamed into place, so a reader never sees half a
    snapshot."""
    path = os.path.abspath(path) + ".pt"
    payload = {f"leaf_{i}": x.detach().cpu() for i, x in enumerate(tree_leaves(state))}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _snapshot_file(path: str) -> str:
    """The file a snapshot `path` names: the path itself when it ends in
    .pt or .npz, else ``<path>.pt`` (this package's), else ``<path>.npz``
    (the JAX package's)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?): the port reads .pt snapshots and "
            "the JAX package's .npz ones (save_carry(..., use_orbax=False)), not orbax"
        )
    if path.endswith((".pt", ".npz")):
        return path
    for cand in (path + ".pt", path + ".npz"):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no snapshot {path}.pt or {path}.npz")


def restore_carry(path: str, like: Any) -> Any:
    """Restore a snapshot into the structure of `like`: every leaf on the
    device and with the dtype of `like`'s leaf at its position. Raises when
    the snapshot's leaves do not match `like`'s in number or shape."""
    file = _snapshot_file(os.path.abspath(path))
    if file.endswith(".npz"):
        with np.load(file) as z:
            data = {k: torch.as_tensor(z[k]) for k in z.files}
    else:
        data = torch.load(file, map_location="cpu", weights_only=True)
    leaves_like = tree_leaves(like)
    if sorted(data) != sorted(f"leaf_{i}" for i in range(len(leaves_like))):
        raise ValueError(f"{file} holds {len(data)} leaves, the tree {len(leaves_like)}")
    leaves = []
    for i, ref in enumerate(leaves_like):
        x = data[f"leaf_{i}"]
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(
                f"{file}: leaf {i} has shape {tuple(x.shape)}, the tree's {tuple(ref.shape)}"
            )
        leaves.append(x.to(device=ref.device, dtype=ref.dtype))
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
