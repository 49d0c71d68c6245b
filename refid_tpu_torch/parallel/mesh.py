"""Process groups of a ``(data, spatial)`` mesh (mirrors
``refid_tpu/parallel/mesh.py``).

The JAX package puts every chip of every host into one
``jax.sharding.Mesh`` and lets GSPMD insert the collectives.  Here each
process drives one device and the mesh is a layout of the
``torch.distributed`` ranks:

  * axis ``data``    — batch (data parallelism).  Rank ``r`` has data index
    ``r // S``; the ranks of one data group hold the same spatial index.
    Gradients are summed over the whole world after the backward pass
    (``train/trainer.py``).
  * axis ``spatial`` — image height.  Rank ``r`` has spatial index ``r % S``,
    so the S ranks that split one frame are neighbours on a node.  The
    convs exchange halos over the spatial group (``parallel/spatial.py``).

:func:`init_distributed` joins the process group (the JAX CLI's
``--coordinator / --num-processes / --process-id``, or torchrun's
environment); :func:`make_mesh` lays the ranks out; :func:`replicate`
broadcasts state from rank 0; :func:`shard_batch` gives a rank its rows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from refid_tpu_torch.parallel.spatial import row_split

__all__ = ["Mesh", "init_distributed", "make_mesh", "mesh_layout", "replicate",
           "all_reduce_mean", "shard_batch", "local_rank", "rank", "world_size"]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """The device index of this process on its node: torchrun's
    ``LOCAL_RANK``, else the global rank (``--num-processes`` on one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the default process group.

    ``num_processes > 1`` with ``coordinator`` (``host:port``) and
    ``process_id`` initialises from those, as ``jax.distributed.initialize``
    does; otherwise, under torchrun (``WORLD_SIZE`` in the environment, with
    ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) it initialises from the
    environment, a world of one included.  With neither, or when the group
    already exists, it does nothing.  ``backend`` defaults to NCCL where
    CUDA is present and gloo on the CPU."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if num_processes and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("--num-processes > 1 needs --coordinator host:port "
                             "and --process-id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")


def mesh_layout(world: int, data: int = -1, spatial: int = 1):
    """``(data, spatial)`` for ``world`` ranks (``data=-1``: all that remain),
    and the ranks of each spatial group and of each data group."""
    if spatial < 1 or world % spatial:
        raise ValueError(f"spatial={spatial} does not divide the world of {world} ranks")
    if data == -1:
        data = world // spatial
    if data * spatial != world:
        raise ValueError(f"data={data} x spatial={spatial} != world size {world}")
    spatial_groups = [list(range(d * spatial, (d + 1) * spatial)) for d in range(data)]
    data_groups = [list(range(s, world, spatial)) for s in range(spatial)]
    return data, spatial, spatial_groups, data_groups


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, spatial)`` mesh.  A group is None
    where its axis has one rank (nothing to exchange)."""
    data: int
    spatial: int
    data_index: int
    spatial_index: int
    data_group: Optional[object] = None
    spatial_group: Optional[object] = None


def make_mesh(data: int = -1, spatial: int = 1) -> Mesh:
    """Lay the world's ranks out as ``(data, spatial)``.  Every rank must
    call it, in the same order as any other group it creates."""
    world = world_size()
    data, spatial, sgroups, dgroups = mesh_layout(world, data, spatial)
    r = rank()
    groups = {}
    for axis, layout in (("spatial", sgroups), ("data", dgroups)):
        if len(layout[0]) > 1:
            for ranks in layout:           # new_group is collective: every rank, every group
                g = dist.new_group(ranks)
                if r in ranks:
                    groups[axis] = g
    return Mesh(data, spatial, r // spatial, r % spatial,
                groups.get("data"), groups.get("spatial"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _flat_collective(tensors, collective) -> None:
    """Run ``collective`` on one flat buffer per device and dtype of
    ``tensors`` (in an order every rank shares) and copy the result back
    into them."""
    buckets = {}
    for t in tensors:
        if t.numel():
            buckets.setdefault((t.device, t.dtype), []).append(t)
    for (device, _), ts in sorted(buckets.items(), key=lambda kv: str(kv[0])):
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if device.type == "cpu" and dist.get_backend() == "nccl":   # e.g. Adam's step counts
            flat = flat.cuda()
        collective(flat)
        offset = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def replicate(tree):
    """Broadcast every tensor of ``tree`` (a tensor, a module's state, or
    dicts / lists of them, such as an optimiser's state) from global rank 0,
    in place, whenever a process group exists (a world of one included).
    Every rank passes the same structure.  Returns ``tree``."""
    if dist.is_initialized():
        _flat_collective(list(_tensors(tree)), lambda flat: dist.broadcast(flat, src=0))
    return tree


def all_reduce_mean(tensors, divisor: int) -> None:
    """Sum ``tensors`` over the world in place and divide by ``divisor``
    (the data axis: a sum over the spatial ranks, a mean over the data
    ranks)."""
    def collective(flat):
        dist.all_reduce(flat)
        flat /= divisor
    _flat_collective(tensors, collective)


def shard_batch(batch: dict, mesh: Mesh, spatial_axes: Optional[dict] = None,
                block: int = 1) -> dict:
    """This rank's part of its data group's batch: each array's height axis
    (``spatial_axes`` maps an array's ndim to it, e.g. ``{4: 1, 5: 2}`` for
    NHWC and NTHWC, as in the JAX package) cut to the rows of the rank's
    spatial index (``spatial.row_split`` in whole blocks of ``block`` rows).
    The batch axis is already the data group's: its loader draws only that
    group's items.  Other fields pass through."""
    spatial_axes = spatial_axes or {}
    if mesh.spatial == 1 or not spatial_axes:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        axis = spatial_axes.get(getattr(v, "ndim", None))
        if axis is None:
            out[k] = v
            continue
        start, stop = row_split(v.shape[axis], mesh.spatial, block)[mesh.spatial_index]
        index = [slice(None)] * v.ndim
        index[axis] = slice(start, stop)
        out[k] = v[tuple(index)]
    return out
