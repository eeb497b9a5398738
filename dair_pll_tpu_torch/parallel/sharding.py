r"""Data-parallel training steps and rollouts over ``torch.distributed``.

Counterpart of ``dair_pll_tpu/parallel/sharding.py``, whose SPMD
``shard_map`` over a device mesh, with ``pmean`` of the gradients, becomes
one process per card (as ``torchrun`` starts them) joined in the default
process group: a :class:`Mesh` is the group's first ``size`` ranks, the
parameters are broadcast from rank 0 (:func:`replicate`), each rank takes
its equal share of a batch's rows (:func:`shard_batch`), and the
gradients are summed over the ranks with ``all_reduce`` and divided by the
mesh's size. Contact problems are small and batch-parallel, so data
parallelism is the whole decomposition, as in the JAX package.

Every collective runs over the whole default group: a rank outside the
mesh (a rank past the largest count that divides the batch) joins each
one with zeros, so every rank keeps the same parameters. Gathers are an
``all_reduce`` of a zero-filled buffer into which each rank writes its own
rows, so that the same code runs on NCCL and on gloo with CUDA tensors
(gloo has no gather of CUDA tensors). Without a process group, or with
one rank, a mesh has one member and every function here is the plain
single-process computation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import Tensor

def initialized() -> bool:
    """Whether this process is in a default process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if initialized() else 0


def barrier() -> None:
    """Waits for every rank of the default process group (nothing
    without one)."""
    if world_size() > 1:
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel mesh: ranks ``0 .. size - 1`` of the default
    process group take part, this process being ``rank``; ``world`` is
    the group's size (ranks from ``size`` on join the collectives with
    zeros)."""
    size: int
    rank: int
    world: int

    @property
    def participates(self) -> bool:
        return self.rank < self.size

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` (``n`` a multiple of
        ``size``); an empty slice outside the mesh."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.size} ranks")
        share = n // self.size
        if not self.participates:
            return slice(n, n)
        return slice(self.rank * share, (self.rank + 1) * share)


def make_mesh(size: Optional[int] = None) -> Mesh:
    """The mesh of the default process group's first ``size`` ranks (all
    by default); one rank without a process group."""
    world = world_size()
    size = world if size is None else int(size)
    if not 1 <= size <= world:
        raise ValueError(f"a mesh of {size} ranks in a group of {world}")
    return Mesh(size, rank(), world)


def all_reduce_sum(t: Tensor, mesh: Mesh) -> Tensor:
    """Sums ``t`` over every rank, in place; returns it."""
    if mesh.world > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def _leaves(tree: Any) -> List[Tensor]:
    if isinstance(tree, Tensor):
        return [tree]
    if hasattr(tree, "parameters"):
        return list(tree.parameters())
    return list(tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Broadcasts every tensor of ``tree`` (a tensor, parameters with
    ``.parameters()`` or a sequence of tensors) from rank 0, in place;
    returns ``tree``."""
    if mesh.world > 1:
        with torch.no_grad():
            for leaf in _leaves(tree):
                dist.broadcast(leaf.data, src=0)
    return tree


def shard_batch(tree: Any, mesh: Mesh, axis: int = 0) -> Any:
    """This rank's rows of a batch (a tensor or a sequence of tensors,
    split along ``axis`` into ``mesh.size`` equal parts); no rows outside
    the mesh."""
    if isinstance(tree, Tensor):
        part = mesh.rows(tree.shape[axis])
        return tree.narrow(axis, part.start, part.stop - part.start)
    return type(tree)(shard_batch(t, mesh, axis) for t in tree)


def gather_rows(local: Tensor, mesh: Mesh, n: int, axis: int = 0
                ) -> Tensor:
    """The whole batch of ``n`` rows on every rank from each rank's own
    rows (:func:`shard_batch`): an ``all_reduce`` of a zero-filled buffer
    into which each rank writes its rows."""
    shape = list(local.shape)
    shape[axis] = n
    full = local.new_zeros(shape)
    part = mesh.rows(n)
    full.narrow(axis, part.start, part.stop - part.start).copy_(local)
    return all_reduce_sum(full, mesh)


def mean_gradients(leaves: Sequence[Tensor], mesh: Mesh) -> None:
    """Sets each leaf's ``.grad`` to the mean over the mesh of the ranks'
    gradients (a rank's missing ``.grad`` counts as zeros): one
    ``all_reduce`` of the flattened gradients, divided by the mesh's
    size."""
    leaves = list(leaves)
    if mesh.world == 1:
        return
    grads = [leaf.grad if leaf.grad is not None and mesh.participates
             else torch.zeros_like(leaf) for leaf in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum(flat, mesh)
    flat = flat / mesh.size
    offset = 0
    for leaf in leaves:
        n = leaf.numel()
        leaf.grad = flat[offset:offset + n].view_as(leaf).clone()
        offset += n


def mean_over_mesh(value: Tensor, mesh: Mesh) -> Tensor:
    """The mean over the mesh's ranks of a per-rank value (zero outside
    the mesh)."""
    if mesh.world == 1:
        return value
    value = value.detach().clone() if mesh.participates else \
        torch.zeros_like(value)
    return all_reduce_sum(value, mesh) / mesh.size


def make_data_parallel_step(
        loss_fn: Callable[[Any, Tensor, Tensor], Tensor],
        optimizer, mesh: Mesh) -> Callable:
    """A data-parallel training step.

    Args:
        loss_fn: ``(params, x_past, x_future) -> (local_batch,)``
          per-sample loss.
        optimizer: a ``torch.optim`` optimizer over ``params``' leaves.
        mesh: the data-parallel mesh.

    Returns:
        ``step(params, x_past, x_future) -> loss``: each rank takes the
        mean loss of its share of the batch (the whole batch on every
        rank, split on its leading axis), runs ``backward``, the gradients
        are averaged over the mesh and the optimizer steps; the loss is
        the mean over the mesh. The parameters and the optimizer's state
        stay equal on every rank (start them equal with
        :func:`replicate`).
    """

    def step(params, x_past: Tensor, x_future: Tensor) -> Tensor:
        leaves = _leaves(params)
        optimizer.zero_grad(set_to_none=True)
        if mesh.participates:
            loss = torch.mean(loss_fn(params, shard_batch(x_past, mesh),
                                      shard_batch(x_future, mesh)))
            loss.backward()
        else:
            loss = x_past.new_zeros(())
        mean_gradients(leaves, mesh)
        loss = mean_over_mesh(loss.detach(), mesh)
        optimizer.step()
        return loss

    return step


def make_data_parallel_rollout(simulate_fn: Callable,
                               mesh: Mesh) -> Callable:
    """A data-parallel batched rollout.

    Args:
        simulate_fn: ``(params, x_0_batch) -> (batch, T, n_x)`` local
          batched rollout.
        mesh: the data-parallel mesh, of every rank of the group.

    Returns:
        ``rollout(params, x_0)``: ``x_0`` (the whole batch, on every rank)
        is padded with copies of its last row to a multiple of the mesh's
        size, each rank rolls out its own rows, and the rows are gathered
        (:func:`gather_rows`) and trimmed back; the whole result on every
        rank.
    """
    if mesh.size != mesh.world:
        raise ValueError("a rollout's mesh spans the whole group")

    def rollout(params, x_0: Tensor) -> Tensor:
        n = x_0.shape[0]
        pad = (-n) % mesh.size
        if pad:
            x_0 = torch.cat([x_0, x_0[-1:].expand(pad, *x_0.shape[1:])])
        local = simulate_fn(params, shard_batch(x_0, mesh))
        return gather_rows(local, mesh, n + pad)[:n]

    return rollout
