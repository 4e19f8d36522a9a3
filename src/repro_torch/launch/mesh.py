"""The process group of the sharded engine (counterpart of
``repro/launch/mesh.py``).

``init_shards`` joins this process to the group that core/distributed.py
shards over:

- under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
  ``MASTER_ADDR`` set), through torchrun's rendezvous (``env://``);
- with ``init_file``, through a ``FileStore`` at that path, the ranks and
  size taken from ``RANK`` / ``WORLD_SIZE`` (processes that a test or a
  script starts itself);
- otherwise as a one-rank group on a ``FileStore`` in a fresh temporary
  directory, so parallel processes never contend for a TCP port.

CUDA (the default) makes an NCCL group on device ``LOCAL_RANK``; gloo
serves only a caller that asks for the CPU.  With ``mesh_shape`` the ranks
also form that mesh in row-major order, and every rank builds one subgroup
per mesh axis (core/distributed.mesh_groups), which the axis-wise exchange
(``DistConfig(topology="axiswise")``) runs over.  ``close_shards`` destroys
the group and its subgroups and removes the temporary store.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.distributed import forget_mesh_groups, mesh_groups
from repro_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class Shards:
    """This process's place in the engine's process group (the default
    group, which every ``group=None`` of core/distributed.py means)."""
    rank: int
    size: int
    device: torch.device
    store_dir: Optional[str] = None  # temporary FileStore directory
    mesh_shape: Optional[tuple] = None
    axis_groups: tuple = ()          # this rank's group on each mesh axis


def init_shards(device=None, init_file: Optional[str] = None,
                mesh_shape: Optional[Sequence[int]] = None) -> Shards:
    """Initialize the default process group for ``device`` (CUDA unless
    the caller asks for the CPU) and return this rank's ``Shards``; with
    ``mesh_shape`` (its product the world size) also the mesh's axis
    subgroups."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists: call "
                           "close_shards first")
    env = os.environ
    rank = int(env.get("RANK", "0"))
    size = int(env.get("WORLD_SIZE", "1"))
    local = int(env.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        backend = "nccl"
    else:
        backend = "gloo"
    if mesh_shape is not None and math.prod(mesh_shape) != size:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not cover "
                         f"the {size} ranks")
    store_dir = None
    if init_file is not None:
        method = f"file://{os.path.abspath(init_file)}"
    elif size > 1 or "MASTER_ADDR" in env:
        method = "env://"
    else:
        store_dir = tempfile.mkdtemp(prefix="repro_torch_shards_")
        method = f"file://{os.path.join(store_dir, 'store')}"
        rank, size = 0, 1
    dist.init_process_group(backend=backend, init_method=method, rank=rank,
                            world_size=size)
    if mesh_shape is None:
        return Shards(rank=rank, size=size, device=dev, store_dir=store_dir)
    return Shards(rank=rank, size=size, device=dev, store_dir=store_dir,
                  mesh_shape=tuple(mesh_shape),
                  axis_groups=mesh_groups(mesh_shape))


def close_shards(shards: Shards) -> None:
    """Destroy the default process group, its mesh subgroups and its
    temporary store."""
    forget_mesh_groups()
    if dist.is_initialized():
        dist.destroy_process_group()
    if shards.store_dir is not None:
        shutil.rmtree(shards.store_dir, ignore_errors=True)
