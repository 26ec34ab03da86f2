"""The device mesh of the port (the counterpart of
unet_studio_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ``Mesh`` of devices with the
axes ``data`` (the batch) and ``space`` (the volume's z axis).  The port
runs one process per rank, each with its own device, joined by
``torch.distributed``: rank ``r`` of ``n_data * n_space`` ranks sits at
``(data r // n_space, space r % n_space)``, the place of device ``r`` in
the JAX package's ``reshape(n_data, n_space)``.  A mesh of one rank needs
no process group, so the single-card path does not change.

* data axis: each rank takes ``batch / n_data`` rows (``shard_batch``);
  the train step sums the gradients with one all-reduce per dtype
  (``all_reduce_sum``), the ``psum`` of the JAX step.
* space axis: ``parallel/spatial.py`` splits D into slabs and exchanges
  halos explicitly.

Backend: NCCL where every rank has a card of its own, gloo on the CPU and
where ranks share a card; the caller names it (``utils/device.py``
``init_multihost``), nothing here switches it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``(n_data, n_space)`` mesh, its device and
    the process groups of its two axes (``None`` where the axis has one
    member and needs no communication)."""

    n_data: int
    n_space: int
    rank: int
    device: torch.device
    data_group: object = None
    space_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "space": self.n_space}

    @property
    def size(self) -> int:
        return self.n_data * self.n_space

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space


def rank_device(device=None) -> torch.device:
    """This rank's device.  ``"cuda"`` without an index, in a process
    group, is the card ``LOCAL_RANK`` (torchrun's name; the rank where it
    is unset); a card that is not there raises.  Any other device is
    taken as given (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {dist.get_rank()} needs card {local}, this host has "
                               f"{torch.cuda.device_count()}")
        dev = torch.device("cuda", local)
    return dev


def make_mesh(n_data: int | None = None, n_space: int = 1, device=None) -> Mesh:
    """The ``(n_data, n_space)`` mesh over the ranks of the process group
    (one rank without one).  ``n_data`` defaults to the ranks over
    ``n_space``.  Every rank of the group takes part: a mesh of more or
    fewer ranks raises ``ValueError``.  ``device`` as ``rank_device``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_space
    n = n_data * n_space
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    if n < world:
        raise ValueError(f"a mesh of {n} devices leaves ranks of the {world} without work")
    dev = rank_device(device)
    if dev.type == "cuda" and dist.is_initialized():
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current card
    data_group = space_group = None
    if n_data > 1 and n_space == 1:
        data_group = dist.group.WORLD
    elif n_space > 1 and n_data == 1:
        space_group = dist.group.WORLD
    elif n > 1:
        # every rank creates every group, in one order
        for i in range(n_data):
            g = dist.new_group(list(range(i * n_space, (i + 1) * n_space)))
            if i == rank // n_space:
                space_group = g
        for j in range(n_space):
            g = dist.new_group(list(range(j, n, n_space)))
            if j == rank % n_space:
                data_group = g
    return Mesh(n_data, n_space, rank, dev, data_group, space_group)


def local_rows(mesh: Mesh, batch: int) -> slice:
    """The rows of a ``batch``-row global batch that this rank loads: the
    data index's contiguous share (the JAX engine's ``_local_batch_rows``)."""
    if batch % mesh.n_data:
        raise ValueError(f"a batch of {batch} does not split over {mesh.n_data} data ranks")
    per = batch // mesh.n_data
    lo = mesh.data_index * per
    return slice(lo, lo + per)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each host array (leading batch axis)."""
    out = tuple(a[local_rows(mesh, len(a))] for a in arrays)
    return out if len(out) > 1 else out[0]


def _flat_apply(tensors, collective) -> None:
    """Run ``collective`` on one flat buffer per (dtype, device) holding
    ``tensors``, then copy the result back into them."""
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in by_kind.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            collective(flat)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def all_reduce_sum(tensors, group) -> None:
    """Sum ``tensors`` in place over the ranks of ``group``: one
    all-reduce per dtype, not one per tensor."""
    _flat_apply(tensors, lambda flat: dist.all_reduce(flat, group=group))


def replicate(mesh: Mesh, params: dict, opt_state: dict | None = None):
    """Broadcast ``params`` and the optimizer state's momentum and step
    from rank 0 to every rank, in place; returns the state (the step is
    a host int).  A mesh of one rank has nothing to do."""
    if mesh.size == 1:
        return opt_state
    tensors = list(params.values())
    if opt_state is not None:
        tensors += list(opt_state["momentum"].values())
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, src=0))
    if opt_state is None:
        return None
    step = torch.tensor([int(opt_state["step"])], dtype=torch.int64, device=mesh.device)
    dist.broadcast(step, src=0)
    return {**opt_state, "step": int(step.item())}
