"""Collectives over the ranks of a ``MeshComm`` in the stacked layout
(counterpart of ``mvapich2_tpu/ops/collectives.py``).

In the JAX package these run inside ``shard_map``, one shard a device,
and lower to stock XLA collectives (``lax.psum``, ``lax.ppermute``,
``lax.all_to_all``, ``lax.all_gather``, ``lax.psum_scatter``). Here the
virtual ranks of a mesh live on one device, so a value of every rank is
one *stacked* tensor whose dim 0 is the mesh rank: ``x[i]`` is rank i's
shard, of the shape the JAX function sees on that rank. Each function
takes the stacked tensor and a ``MeshComm`` where the JAX one takes the
axis name; a comm over a tuple of axes stands for the tuple, and a comm
over some of the mesh's axes acts on each group of ranks that share
their other coordinates (``MeshComm.group``). Axes named in arguments
(``split_axis``, ``dim``, ...) are those of one rank's shard.

They are stock torch (a sum in rank order, an index, a reshape and a
permute), as the JAX package leaves them to XLA, and move exactly the
values the ``lax`` lowering moves. Every one keeps autograd: none runs
under ``no_grad`` or writes in place into a tensor autograd needs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def axis_size(comm) -> int:
    """Number of ranks in the comm (MPI_Comm_size analog)."""
    return comm.size


def axis_rank(comm) -> torch.Tensor:
    """Every mesh rank's index in the comm, stacked: ``[mesh.size]``
    int64 on the mesh's device (``lax.axis_index`` of each shard)."""
    return comm.rank()


def _ranks_like(comm, x: torch.Tensor) -> torch.Tensor:
    """``axis_rank`` shaped to broadcast against the stacked ``x``."""
    return comm.rank().reshape((-1,) + (1,) * (x.dim() - 1))


def _group_sum(g: torch.Tensor) -> torch.Tensor:
    """``[G, P, ...]`` -> ``[G, ...]``: the sum over dim 1 folded in rank
    order 0, 1, ..., P-1, as XLA's CPU all-reduce does."""
    acc = g[:, 0] if g.shape[1] > 1 else g[:, 0].clone()
    for i in range(1, g.shape[1]):
        acc = acc + g[:, i]
    return acc


def _to_all(comm, y: torch.Tensor) -> torch.Tensor:
    """One value a group ``[G, ...]`` -> every member's own copy,
    stacked."""
    return comm.ungroup(y.unsqueeze(1).expand(
        (y.shape[0], comm.size) + tuple(y.shape[1:]))).contiguous()


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, comm, op: str = "sum") -> torch.Tensor:
    """MPI_Allreduce over the comm (``lax.psum``, ``pmax``, ``pmin``,
    ``prod`` of the gathered axis, ``pmean``): every rank gets the
    reduction of its group's shards. Sums fold in rank order; ``mean``
    is that sum over the group size."""
    g = comm.group(x)
    if op in ("sum", "mean"):
        y = _group_sum(g)
        if op == "mean":
            y = y / comm.size
    elif op == "max":
        y = torch.amax(g, dim=1)
    elif op == "min":
        y = torch.amin(g, dim=1)
    elif op == "prod":
        y = torch.prod(g, dim=1, dtype=g.dtype)
    else:
        raise ValueError(f"unsupported device op {op!r}")
    return _to_all(comm, y)


def reduce_scatter(x: torch.Tensor, comm, scatter_dimension: int = 0,
                   op: str = "sum", tiled: bool = True) -> torch.Tensor:
    """MPI_Reduce_scatter_block (``lax.psum_scatter``): the group's sum,
    cut along ``scatter_dimension`` into one block a rank (``tiled``: the
    dim shrinks by the group size; untiled: the dim must equal it and
    goes away)."""
    if op != "sum":
        raise ValueError("reduce_scatter lowers natively for sum")
    p = comm.size
    g = comm.group(x)
    d = scatter_dimension + 1              # the dim in one group's value
    y = _group_sum(g)                      # [G, *shard]
    n = y.shape[d]
    if tiled:
        if n % p:
            raise ValueError(f"reduce_scatter: dim of size {n} does not "
                             f"split over {p} ranks")
        y = y.reshape(y.shape[:d] + (p, n // p) + y.shape[d + 1:])
    elif n != p:
        raise ValueError(f"reduce_scatter(tiled=False): dim of size {n} "
                         f"is not the {p} ranks")
    return comm.ungroup(y.movedim(d, 1))


def scan_axis(x: torch.Tensor, comm) -> torch.Tensor:
    """Inclusive prefix sum over the comm in rank order (MPI_Scan for
    MPI_SUM). The JAX package takes a masked product with the gathered
    axis, whose f32 sum order is XLA's: equal on integer-valued data,
    within rounding otherwise."""
    g = comm.group(x)
    return comm.ungroup(torch.cumsum(g, dim=1, dtype=g.dtype))


# ---------------------------------------------------------------------------
# data movement
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, comm, tiled: bool = False,
               gather_axis: int = 0) -> torch.Tensor:
    """MPI_Allgather (``lax.all_gather``): every rank gets its group's
    shards in rank order, on a new dim at ``gather_axis`` (or joined
    along it, ``tiled``)."""
    g = comm.group(x)                      # [G, P, *shard]
    y = g.movedim(1, 1 + gather_axis)      # [G, ..., P, ...]
    if tiled:
        a = 1 + gather_axis
        y = y.reshape(y.shape[:a] + (-1,) + y.shape[a + 2:])
    return _to_all(comm, y)


def bcast(x: torch.Tensor, comm, root: int = 0) -> torch.Tensor:
    """MPI_Bcast: the root's shard everywhere, as the JAX package's
    one-hot psum computes it (so the root's -0.0 arrives as 0.0)."""
    idx = _ranks_like(comm, x)
    contrib = torch.where(idx == root, x, torch.zeros_like(x))
    return allreduce(contrib, comm)


def _tiled_all_to_all(x, comm, split_axis, concat_axis):
    p = comm.size
    g = comm.group(x)                      # [G, src, *shard]
    shape = tuple(g.shape[2:])
    nd = len(shape)
    if not (0 <= split_axis < nd and 0 <= concat_axis < nd):
        raise ValueError(f"all_to_all: axes {split_axis}, {concat_axis} "
                         f"outside a shard of rank {nd}")
    n = shape[split_axis]
    if n % p:
        raise ValueError(f"all_to_all: split axis of size {n} is not a "
                         f"multiple of the {p} ranks")
    # [G, src, ..., dst, n/p, ...]: block j of source i at [:, i, ..., j]
    a = split_axis + 2
    y = g.reshape(g.shape[:a] + (p, n // p) + g.shape[a + 1:])
    y = y.movedim(a, 1)                    # [G, dst, src, shard with n/p]
    # the source rank goes just before the concat axis and merges with
    # it, source-major: the blocks land in source order
    y = y.movedim(2, 2 + concat_axis)
    out = list(shape)
    out[split_axis] = n // p
    out[concat_axis] *= p
    return comm.ungroup(y.reshape((g.shape[0], p, *out)))


def all_to_all(x: torch.Tensor, comm, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """MPI_Alltoall over the comm (``lax.all_to_all``): each rank cuts
    its shard into ``p`` blocks along ``split_axis`` and sends block j to
    rank j; rank j joins the blocks it receives along ``concat_axis`` in
    the order of their source ranks. Untiled, ``split_axis`` must have
    the group size and goes away, and the sources stack on a new dim at
    ``concat_axis``, as ``lax.all_to_all(tiled=False)`` does."""
    if tiled:
        return _tiled_all_to_all(x, comm, split_axis, concat_axis)
    n = x.shape[1 + split_axis] if x.dim() > 1 + split_axis else None
    if n != comm.size:
        raise ValueError(f"all_to_all(tiled=False): split axis of size {n} "
                         f"is not the {comm.size} ranks")
    if split_axis < concat_axis:
        concat_axis += 1
        x = x.unsqueeze(1 + concat_axis)
    elif concat_axis < split_axis:
        x = x.unsqueeze(1 + concat_axis)
        split_axis += 1
    y = _tiled_all_to_all(x, comm, split_axis, concat_axis)
    return y.squeeze(1 + split_axis) if split_axis != concat_axis else y


def _mesh_ordered(comm):
    """The comm with its axes in the mesh's order: ``lax.ppermute``
    numbers the ranks of an axis tuple row-major in the mesh's axis
    order, not the tuple's (``lax.axis_index`` and ``lax.all_gather``
    take the tuple's)."""
    names = comm.mesh.axis_names
    axes = tuple(sorted(comm.axes, key=names.index))
    return comm if axes == comm.axes else comm.sub(axes)


def ppermute(x: torch.Tensor, comm,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """MPI_Sendrecv with an arbitrary (src, dst) pattern
    (``lax.ppermute``): rank dst of each group gets rank src's shard;
    a rank no pair names gets zeros."""
    comm = _mesh_ordered(comm)
    p = comm.size
    src_of = list(range(p))
    got = [False] * p
    for src, dst in perm:
        if not (0 <= src < p and 0 <= dst < p) or got[dst]:
            raise ValueError(f"ppermute: bad permutation {perm} over "
                             f"{p} ranks")
        src_of[dst], got[dst] = int(src), True
    g = comm.group(x)
    y = g[:, torch.tensor(src_of, device=x.device)]
    if not all(got):
        keep = torch.tensor(got, device=x.device).reshape(
            (1, p) + (1,) * (g.dim() - 2))
        y = torch.where(keep, y, torch.zeros_like(y))
    return comm.ungroup(y)


def ring_shift(x: torch.Tensor, comm, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the comm's ring by ``shift`` (+ = to higher
    ranks): rank i's shard lands on rank (i + shift) mod p
    (``lax.ppermute`` with the perm ``[(i, (i + shift) % p)]``). On one
    card this is a copy of the whole stacked tensor."""
    comm = _mesh_ordered(comm)
    return comm.ungroup(torch.roll(comm.group(x), shifts=shift, dims=1))


def sendrecv_shift(x: torch.Tensor, comm, shift: int = 1):
    """Bidirectional neighbour exchange: (from the left, from the right)
    for the 1-D halo pattern."""
    return ring_shift(x, comm, shift), ring_shift(x, comm, -shift)


def halo_exchange(x: torch.Tensor, comm, halo: int, dim: int = 0,
                  periodic: bool = True) -> torch.Tensor:
    """Halo exchange (the 3-D stencil's): each rank sends its boundary
    slabs of width ``halo`` along ``dim`` to both neighbours and gets its
    shard back padded with the slabs it received; without ``periodic``
    the ends of the line get zeros."""
    d = dim + 1
    n = x.shape[d]
    lo = x.narrow(d, 0, halo)
    hi = x.narrow(d, n - halo, halo)
    from_left = ring_shift(hi, comm, 1)    # the left neighbour's high slab
    from_right = ring_shift(lo, comm, -1)  # the right neighbour's low slab
    if not periodic:
        idx = _ranks_like(comm, from_left)
        from_left = torch.where(idx == 0, torch.zeros_like(from_left),
                                from_left)
        from_right = torch.where(idx == comm.size - 1,
                                 torch.zeros_like(from_right), from_right)
    return torch.cat([from_left, x, from_right], dim=d)


def barrier(comm) -> torch.Tensor:
    """MPI_Barrier: the 1-element psum of the JAX package, one ``0.0`` a
    rank, stacked."""
    return allreduce(torch.zeros(comm.mesh.size, dtype=torch.float32,
                                 device=comm.device), comm)


def moe_shuffle(tokens: torch.Tensor, comm) -> torch.Tensor:
    """The MoE / Ulysses reshard: a tiled all_to_all on dim 0 of each
    rank's shard, so each rank holds its experts' tokens."""
    return all_to_all(tokens, comm, split_axis=0, concat_axis=0, tiled=True)
