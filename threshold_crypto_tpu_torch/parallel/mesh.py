"""The share axis over a group of processes, one device each.

The counterpart of ``threshold_crypto_tpu/parallel/mesh.py``. The JAX
package lays a 1-D mesh of chips over the share batch inside one program;
here each rank of a ``torch.distributed`` process group holds one device
and one contiguous block of the batch, the PyTorch idiom. A ``Mesh`` names
the group, this process's rank, the world size and the device; world size
1 needs no process group at all.

``shard_batch`` keeps this rank's block of a global batch, ``replicate``
moves a tree to the mesh's device, and ``gather_batch`` (the one name the
JAX module has no need of: a sharded ``jax.Array`` reads whole) puts the
blocks of every rank back together, in rank order. Trees are nested tuples
and lists of tensors.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

SHARE_AXIS = "shares"


class Mesh:
    """One rank's view of the share axis.

    group: the process group (None at world size 1 without one); rank and
    world: this process's rank and the group's size; device: this rank's
    torch device; backend: the group's backend ("nccl", "gloo") or None.
    ``devices`` holds one entry per rank, so ``mesh.devices.size`` is the
    world size, as the JAX tests read a mesh."""

    def __init__(self, group, rank: int, world: int, device,
                 axis: str = SHARE_AXIS, backend: str | None = None):
        self.group = group
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.axis_names = (axis,)
        self.backend = backend
        self.devices = np.arange(world)

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend})")


def default_device(rank: int | None = None) -> torch.device:
    """``cuda:{local rank % device count}``: the local rank from
    ``LOCAL_RANK`` (torchrun sets it), else the global rank."""
    local = int(os.environ.get("LOCAL_RANK", rank or 0))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, axis: str = SHARE_AXIS,
              device=None) -> Mesh:
    """The mesh of the current process group (world size 1 without one).
    ``n_devices``, when given, must equal the world size; ``device`` is this
    rank's device, by default ``default_device``."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        rank, world, group, backend = 0, 1, None, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} devices, have {world} "
                         f"(one per process)")
    dev = default_device(rank) if device is None else torch.device(device)
    return Mesh(group, rank, world, dev, axis, backend)


def tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def shard_block(mesh: Mesh, n: int) -> slice:
    """This rank's lanes of a global batch of n: the contiguous block
    [rank·n/world, (rank+1)·n/world)."""
    if n % mesh.world:
        raise ValueError(f"batch ({n}) must divide the mesh ({mesh.world} "
                         f"ranks)")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: Mesh, tree, axis: str = SHARE_AXIS):
    """This rank's block of every leaf's leading dim, on the mesh's
    device."""
    return tree_map(
        lambda a: a[shard_block(mesh, a.shape[0])].to(mesh.device), tree)


def replicate(mesh: Mesh, tree):
    """Every leaf whole, on the mesh's device."""
    return tree_map(lambda a: a.to(mesh.device), tree)


def batch_spec(tree, axis: str = SHARE_AXIS):
    """Per leaf, the axis its leading dim is split over: ``(axis,)``."""
    return tree_map(lambda _: (axis,), tree)


def repl_spec(tree):
    """Per leaf, no split axis: ``()``."""
    return tree_map(lambda _: (), tree)


def _all_gather(mesh: Mesh, a):
    """[world, *a.shape]: every rank's a, in rank order. Over gloo a CUDA
    tensor goes through the host (gloo gathers CPU tensors); a bool tensor
    goes as uint8."""
    if mesh.group is None:
        return a[None]
    via_host = mesh.backend == "gloo" and a.device.type != "cpu"
    src = (a.cpu() if via_host else a).contiguous()
    if a.dtype == torch.bool:
        src = src.to(torch.uint8)
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src, group=mesh.group)
    out = torch.stack(out).to(a.device)
    return out.bool() if a.dtype == torch.bool else out


def gather_batch(mesh: Mesh, tree):
    """The global batch from every rank's block of every leaf (the blocks
    of ``shard_batch``, equal in size), in rank order, on each rank."""
    def one(a):
        g = _all_gather(mesh, a)
        return g.reshape((-1,) + tuple(a.shape[1:]))

    return tree_map(one, tree)
