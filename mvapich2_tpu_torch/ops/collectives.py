"""Collectives over the ranks of a ``MeshComm`` in the stacked layout
(counterpart of ``mvapich2_tpu/ops/collectives.py``, the part the
sequence-parallel attention path needs).

In the JAX package these run inside ``shard_map``, one shard a device,
and lower to stock XLA collectives (``lax.ppermute``,
``lax.all_to_all``, ``lax.psum``). Here the ``p`` virtual ranks of a
mesh live on one device, so a value of every rank is one *stacked*
tensor whose dim 0 is the rank: ``x[i]`` is rank i's shard, of the
shape the JAX function sees on that rank. Each function takes the
stacked tensor and the ``MeshComm`` where the JAX one takes the axis
name. They are stock torch (a roll, a reshape and a permute, a sum in
rank order), as the JAX package leaves them to XLA, and move exactly
the values the ``lax`` lowering moves.
"""

from __future__ import annotations

import torch


def axis_size(comm) -> int:
    """Number of ranks on the comm's axis (MPI_Comm_size analog)."""
    return comm.size


def axis_rank(comm) -> torch.Tensor:
    """Every rank's index along the axis, stacked: ``[p]`` int64 on the
    mesh's device (``lax.axis_index`` of each shard)."""
    return torch.arange(comm.size, device=comm.device)


def _check_stacked(x: torch.Tensor, comm, what: str) -> None:
    if x.dim() < 1 or x.shape[0] != comm.size:
        raise ValueError(f"{what}: expected a stacked tensor of "
                         f"{comm.size} ranks on dim 0, got shape "
                         f"{tuple(x.shape)}")


def allreduce(x: torch.Tensor, comm, op: str = "sum") -> torch.Tensor:
    """MPI_Allreduce over the axis (``lax.psum``, ``pmax``, ``pmin``):
    every rank gets the reduction of all ranks' shards. Sums fold in
    rank order 0, 1, ..., p-1, as XLA's CPU all-reduce does."""
    _check_stacked(x, comm, "allreduce")
    if op == "sum":
        acc = x[0].clone()
        for i in range(1, comm.size):
            acc += x[i]
    elif op == "max":
        acc = torch.amax(x, dim=0)
    elif op == "min":
        acc = torch.amin(x, dim=0)
    else:
        raise ValueError(f"unsupported device op {op!r}")
    return acc.unsqueeze(0).expand_as(x).clone()


def ring_shift(x: torch.Tensor, comm, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the axis ring by ``shift`` (+ = to higher
    ranks): rank i's shard lands on rank (i + shift) mod p
    (``lax.ppermute`` with the perm ``[(i, (i + shift) % p)]``). On one
    card this is a copy of the whole stacked tensor."""
    _check_stacked(x, comm, "ring_shift")
    return torch.roll(x, shifts=shift, dims=0)


def all_to_all(x: torch.Tensor, comm, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """MPI_Alltoall over the axis (``lax.all_to_all``, tiled): each rank
    cuts its shard into ``p`` blocks along ``split_axis`` and sends
    block j to rank j; rank j concatenates the blocks it receives along
    ``concat_axis`` in the order of their source ranks. Axes are those
    of one rank's shard (the stacked tensor's dim 0 is the rank)."""
    _check_stacked(x, comm, "all_to_all")
    p = comm.size
    shape = tuple(x.shape[1:])
    nd = len(shape)
    if not (0 <= split_axis < nd and 0 <= concat_axis < nd):
        raise ValueError(f"all_to_all: axes {split_axis}, {concat_axis} "
                         f"outside a shard of rank {nd}")
    n = shape[split_axis]
    if n % p:
        raise ValueError(f"all_to_all: split axis of size {n} is not a "
                         f"multiple of the {p} ranks")
    # [src, ..., dst, n/p, ...]: block j of source i at [i, ..., j, ...]
    a = split_axis + 1
    y = x.reshape(x.shape[:a] + (p, n // p) + x.shape[a + 1:])
    y = y.movedim(a, 0)                  # [dst, src, shard with n/p]
    # the source rank goes just before the concat axis and merges with
    # it, source-major: the blocks land in source order
    y = y.movedim(1, 1 + concat_axis)
    out = list(shape)
    out[split_axis] = n // p
    out[concat_axis] *= p
    return y.reshape((p, *out))
