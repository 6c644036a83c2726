"""Process topologies: Cartesian, graph and distributed graph, and the
neighborhood collectives (a copy of the JAX package's ``core/topo.py``,
MPI-3.1 §7).

The constructors derive the new comm by ``split`` (``cart_create``,
``graph_create``, ``cart_sub``) or ``dup`` (the dist-graph ones), so on
a run bound to the card it binds the device channel its members'
geometry gives (``coll/device.py`` ``bind_derived``): a tensor allreduce
over a ``cart_sub`` row runs that channel's kernel. A rank that a
``cart_create`` or ``graph_create`` leaves out gets None, and its
context id is released as by ``split`` with UNDEFINED.

The neighborhood collectives run on numpy over the comm's point-to-point
(a PROC_NULL neighbor leaves its block untouched, duplicate neighbors
match in post order, a strided ``recvbuf`` is written back). A CPU
tensor is read and written in place as numpy; a tensor on the card
raises ``NotImplementedError`` before any data moves (``_on_host``),
and is never staged to the host: no device channel runs a neighborhood
exchange.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import on_card
from .comm import to_host
from .errors import (MPIException, MPI_ERR_ARG, MPI_ERR_DIMS, MPI_ERR_RANK,
                     MPI_ERR_TOPOLOGY, mpi_assert)
from .status import PROC_NULL, UNDEFINED


class CartTopology:
    kind = "cart"

    def __init__(self, dims: Sequence[int], periods: Sequence[bool]):
        self.dims = list(dims)
        self.periods = [bool(p) for p in periods]
        self.ndims = len(self.dims)

    def coords_of(self, rank: int) -> List[int]:
        """Row-major (C order) coordinates — matches MPI_Cart_coords."""
        mpi_assert(0 <= rank < self.nnodes(), MPI_ERR_RANK,
                   f"rank {rank} outside cart of {self.nnodes()}")
        coords = []
        for i in range(self.ndims - 1, -1, -1):
            coords.append(rank % self.dims[i])
            rank //= self.dims[i]
        return coords[::-1]

    def rank_of(self, coords: Sequence[int]) -> int:
        rank = 0
        for i, c in enumerate(coords):
            d = self.dims[i]
            if self.periods[i]:
                c = c % d
            elif not (0 <= c < d):
                return PROC_NULL
            rank = rank * d + c
        return rank

    def nnodes(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def neighbors_of(self, rank: int) -> List[int]:
        """Neighbor order for cart neighborhood collectives (MPI 7.6):
        for each dimension, (source_-1, dest_+1) i.e. [-1, +1] per dim."""
        out = []
        coords = self.coords_of(rank)
        for dim in range(self.ndims):
            for disp in (-1, +1):
                c = list(coords)
                c[dim] += disp
                out.append(self.rank_of(c))
        return out


class GraphTopology:
    kind = "graph"

    def __init__(self, index: Sequence[int], edges: Sequence[int]):
        self.index = list(index)
        self.edges = list(edges)

    def neighbors_of(self, rank: int) -> List[int]:
        mpi_assert(0 <= rank < len(self.index), MPI_ERR_RANK,
                   f"rank {rank} outside graph of {len(self.index)}")
        lo = self.index[rank - 1] if rank > 0 else 0
        return self.edges[lo:self.index[rank]]


class DistGraphTopology:
    kind = "dist_graph"

    def __init__(self, sources: Sequence[int], destinations: Sequence[int],
                 sweights=None, dweights=None, weighted=None):
        self.sources = list(sources)          # ranks that send to me
        self.destinations = list(destinations)  # ranks I send to
        self.sweights = list(sweights) if sweights is not None else None
        self.dweights = list(dweights) if dweights is not None else None
        # MPI_Dist_graph_neighbors_count's weighted flag: set iff the
        # constructor was NOT given MPI_UNWEIGHTED (an empty weight
        # array still counts as weighted — MPI-3.1 §7.5.4)
        self.weighted = bool(weighted) if weighted is not None else (
            sweights is not None or dweights is not None)

    def neighbors_of(self, rank: int) -> List[int]:
        # for neighborhood collectives: recv from sources, send to dests
        return list(self.destinations)


# ---------------------------------------------------------------------------
# constructors (collective)
# ---------------------------------------------------------------------------

def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> List[int]:
    """MPI_Dims_create: balanced factorization, honoring fixed entries."""
    out = list(dims) if dims is not None else [0] * ndims
    mpi_assert(len(out) == ndims, MPI_ERR_DIMS, "dims length mismatch")
    fixed = 1
    free_idx = [i for i, d in enumerate(out) if d == 0]
    for d in out:
        if d:
            mpi_assert(d > 0, MPI_ERR_DIMS, f"negative dim {d}")
            fixed *= d
    mpi_assert(nnodes % max(fixed, 1) == 0, MPI_ERR_DIMS,
               f"nnodes {nnodes} not divisible by fixed dims {fixed}")
    rem = nnodes // max(fixed, 1)
    if not free_idx:
        mpi_assert(rem == 1, MPI_ERR_DIMS, "dims don't cover nnodes")
        return out
    # factor rem into len(free_idx) balanced factors, largest first
    nfree = len(free_idx)
    factors = [1] * nfree
    # prime factorization, assign largest primes to smallest buckets
    n = rem
    primes = []
    p = 2
    while p * p <= n:
        while n % p == 0:
            primes.append(p)
            n //= p
        p += 1
    if n > 1:
        primes.append(n)
    for prime in sorted(primes, reverse=True):
        k = factors.index(min(factors))
        factors[k] *= prime
    factors.sort(reverse=True)
    for i, f in zip(free_idx, factors):
        out[i] = f
    return out


def cart_create(comm, dims: Sequence[int], periods: Sequence[bool],
                reorder: bool = False):
    """MPI_Cart_create: returns a new comm with cartesian topology (None on
    ranks left out)."""
    for d in dims:
        mpi_assert(d > 0, MPI_ERR_DIMS, f"non-positive cart dim {d}")
    nnodes = int(np.prod(dims)) if len(dims) else 1
    mpi_assert(nnodes <= comm.size, MPI_ERR_DIMS,
               f"cart of {nnodes} > comm size {comm.size}")
    sub = comm.split(0 if comm.rank < nnodes else None, comm.rank)
    if sub is None:
        return None
    sub.topo = CartTopology(dims, periods)
    sub.set_name(f"{comm.get_name()}_cart")
    return sub


def graph_create(comm, index: Sequence[int], edges: Sequence[int],
                 reorder: bool = False):
    nnodes = len(index)
    mpi_assert(nnodes <= comm.size, MPI_ERR_TOPOLOGY,
               f"graph of {nnodes} > comm size {comm.size}")
    sub = comm.split(0 if comm.rank < nnodes else None, comm.rank)
    if sub is None:
        return None
    sub.topo = GraphTopology(index, edges)
    return sub


def dist_graph_create_adjacent(comm, sources: Sequence[int],
                               destinations: Sequence[int],
                               sweights=None, dweights=None,
                               reorder: bool = False, weighted=None):
    sub = comm.dup()
    sub.topo = DistGraphTopology(sources, destinations, sweights,
                                 dweights, weighted)
    return sub


def dist_graph_create(comm, sources: Sequence[int],
                      degrees: Sequence[int], destinations: Sequence[int],
                      weights=None, reorder: bool = False,
                      weighted=None):
    """General constructor: each rank contributes edges (sources[i] ->
    destinations chunk, with optional per-edge weights); assemble the
    full adjacency by allgatherv-style exchange, then each rank extracts
    its in/out neighbor lists (and their weights)."""
    # flatten my contributed edges as (src, dst, w) triples
    triples = []
    off = 0
    for s, deg in zip(sources, degrees):
        for k in range(deg):
            w = int(weights[off + k]) if weights is not None else 1
            triples.append((int(s), int(destinations[off + k]), w))
        off += deg
    mine = np.array(triples, dtype=np.int64).reshape(-1) if triples \
        else np.empty(0, dtype=np.int64)
    counts = np.zeros(comm.size, dtype=np.int64)
    comm.allgather(np.array([mine.size], dtype=np.int64), counts, count=1)
    total = int(counts.sum())
    allpairs = np.zeros(total, dtype=np.int64)
    comm.allgatherv(mine, allpairs, [int(c) for c in counts])
    edges = allpairs.reshape(-1, 3)
    me = comm.rank
    in_n = [(int(s), int(w)) for s, d, w in edges if d == me]
    out_n = [(int(d), int(w)) for s, d, w in edges if s == me]
    sub = comm.dup()
    sub.topo = DistGraphTopology(
        [s for s, _ in in_n], [d for d, _ in out_n],
        [w for _, w in in_n], [w for _, w in out_n], weighted)
    return sub


# ---------------------------------------------------------------------------
# accessors (operate on a comm carrying .topo)
# ---------------------------------------------------------------------------

def _cart(comm) -> CartTopology:
    t = comm.topo
    if not isinstance(t, CartTopology):
        raise MPIException(MPI_ERR_TOPOLOGY, "no cartesian topology")
    return t


def topo_test(comm) -> str:
    """MPI_Topo_test: 'cart' | 'graph' | 'dist_graph' | 'undefined'."""
    return comm.topo.kind if comm.topo is not None else "undefined"


def cart_shift(comm, direction: int, disp: int = 1) -> Tuple[int, int]:
    """(rank_source, rank_dest) for a shift along ``direction``."""
    t = _cart(comm)
    mpi_assert(0 <= direction < t.ndims, MPI_ERR_ARG,
               f"bad direction {direction}")
    coords = t.coords_of(comm.rank)
    up = list(coords)
    up[direction] += disp
    down = list(coords)
    down[direction] -= disp
    return t.rank_of(down), t.rank_of(up)


def cart_sub(comm, remain_dims: Sequence[bool]):
    """MPI_Cart_sub: slice the grid into sub-grids keeping remain dims.
    All-false remain_dims matches the reference implementation's
    behavior (test/mpi/topo/cartsuball.c): rank 0 gets a zero-dim comm
    congruent to SELF, everyone else MPI_COMM_NULL."""
    t = _cart(comm)
    if not any(remain_dims):
        sub = comm.split(0 if comm.rank == 0 else None, 0)
        if sub is not None:
            sub.topo = CartTopology([], [])
        return sub
    coords = t.coords_of(comm.rank)
    color = 0
    for i, keep in enumerate(remain_dims):
        if not keep:
            color = color * t.dims[i] + coords[i]
    key = 0
    for i, keep in enumerate(remain_dims):
        if keep:
            key = key * t.dims[i] + coords[i]
    sub = comm.split(color, key)
    sub.topo = CartTopology([d for d, k in zip(t.dims, remain_dims) if k],
                            [p for p, k in zip(t.periods, remain_dims) if k])
    return sub


def cart_map(comm, dims: Sequence[int], periods: Sequence[bool]) -> int:
    """MPI_Cart_map: suggested rank (identity placement here)."""
    nnodes = int(np.prod(dims))
    return comm.rank if comm.rank < nnodes else UNDEFINED


# ---------------------------------------------------------------------------
# neighborhood collectives (MPI 7.6)
# ---------------------------------------------------------------------------

def _flat_recv(recvbuf) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Contiguous flat view of recvbuf, or a scratch copy + writeback
    target when the buffer is strided (reshape(-1) would silently copy
    and drop the received data)."""
    arr = np.asarray(recvbuf)
    if arr.flags["C_CONTIGUOUS"]:
        return arr.reshape(-1), None
    return arr.flatten(), arr   # flatten preserves untouched slots


def _writeback(flat: np.ndarray, orig: Optional[np.ndarray]) -> None:
    if orig is not None:
        orig.flat[:] = flat


def _on_host(name: str, comm, *bufs):
    """``bufs`` as numpy: a CPU tensor as its numpy view (reads and writes
    land in the tensor), a tensor on the card refused."""
    out = []
    for b in bufs:
        if on_card(b):
            raise NotImplementedError(
                f"{name} on communicator {comm.name or comm.context_id}: "
                f"a neighborhood collective has no device path; a tensor "
                f"on {b.device} is not moved to the host")
        if isinstance(b, torch.Tensor):
            b = to_host(b)
        out.append(b)
    return out


def _neighbor_lists(comm) -> Tuple[List[int], List[int]]:
    """(recv_from, send_to) in standard neighbor order."""
    t = comm.topo
    if t is None:
        raise MPIException(MPI_ERR_TOPOLOGY, "no topology on comm")
    if isinstance(t, DistGraphTopology):
        return list(t.sources), list(t.destinations)
    n = t.neighbors_of(comm.rank)
    return list(n), list(n)


def neighbor_allgather(comm, sendbuf, recvbuf, count: Optional[int] = None,
                       datatype=None) -> None:
    """Each rank sends its buffer to every out-neighbor; receives one block
    per in-neighbor into recvbuf (block i at element offset i*count).

    Duplicate neighbors (e.g. a 2-rank periodic cart where left == right)
    match in post order — recv slot k gets the peer's k-th send — the same
    FIFO discipline MPICH's isend/irecv schedules produce."""
    from . import datatype as dtmod
    sendbuf, recvbuf = _on_host("neighbor_allgather", comm, sendbuf,
                                recvbuf)
    srcs, dsts = _neighbor_lists(comm)
    if not srcs and not dsts:
        return
    arr = np.asarray(sendbuf)
    if count is None:
        count = arr.size
    dt = datatype or dtmod.from_numpy_dtype(arr.dtype)
    rflat, orig = _flat_recv(recvbuf)
    mpi_assert(rflat.size >= len(srcs) * count, MPI_ERR_ARG,
               f"recvbuf too small: {rflat.size} < {len(srcs) * count}")
    reqs = []
    tag = comm.next_coll_tag()
    for i, s in enumerate(srcs):
        if s == PROC_NULL:
            continue   # MPI: PROC_NULL neighbor leaves recvbuf unchanged
        seg = rflat[i * count:(i + 1) * count]
        reqs.append(comm.irecv(seg, s, tag, count=count, datatype=dt))
    for d in dsts:
        if d == PROC_NULL:
            continue
        reqs.append(comm.isend(sendbuf, d, tag, count=count, datatype=dt))
    for r in reqs:
        r.wait()
    _writeback(rflat, orig)


def neighbor_alltoall(comm, sendbuf, recvbuf, count: Optional[int] = None,
                      datatype=None) -> None:
    """Distinct block per neighbor in both directions (block j of sendbuf
    to out-neighbor j; block i of recvbuf from in-neighbor i). Duplicate
    neighbors match in post order (see neighbor_allgather)."""
    from . import datatype as dtmod
    sendbuf, recvbuf = _on_host("neighbor_alltoall", comm, sendbuf,
                                recvbuf)
    srcs, dsts = _neighbor_lists(comm)
    if not srcs and not dsts:
        return
    sflat = np.ascontiguousarray(np.asarray(sendbuf)).reshape(-1)
    rflat, orig = _flat_recv(recvbuf)
    if count is None:
        mpi_assert(dsts and sflat.size % len(dsts) == 0, MPI_ERR_ARG,
                   "cannot infer block count")
        count = sflat.size // len(dsts)
    mpi_assert(sflat.size >= len(dsts) * count, MPI_ERR_ARG,
               f"sendbuf too small: {sflat.size} < {len(dsts) * count}")
    mpi_assert(rflat.size >= len(srcs) * count, MPI_ERR_ARG,
               f"recvbuf too small: {rflat.size} < {len(srcs) * count}")
    dt = datatype or dtmod.from_numpy_dtype(sflat.dtype)
    tag = comm.next_coll_tag()
    reqs = []
    for i, s in enumerate(srcs):
        if s == PROC_NULL:
            continue   # MPI: PROC_NULL neighbor leaves recvbuf unchanged
        seg = rflat[i * count:(i + 1) * count]
        reqs.append(comm.irecv(seg, s, tag, count=count, datatype=dt))
    for j, d in enumerate(dsts):
        if d == PROC_NULL:
            continue
        seg = sflat[j * count:(j + 1) * count]
        reqs.append(comm.isend(seg, d, tag, count=count, datatype=dt))
    for r in reqs:
        r.wait()
    _writeback(rflat, orig)


def neighbor_alltoallv(comm, sendbuf, sendcounts, sdispls, recvbuf,
                       recvcounts, rdispls, datatype=None) -> None:
    from . import datatype as dtmod
    sendbuf, recvbuf = _on_host("neighbor_alltoallv", comm, sendbuf,
                                recvbuf)
    srcs, dsts = _neighbor_lists(comm)
    sarr = np.ascontiguousarray(np.asarray(sendbuf)).reshape(-1)
    rarr, orig = _flat_recv(recvbuf)
    dt = datatype or dtmod.from_numpy_dtype(sarr.dtype)
    tag = comm.next_coll_tag()
    reqs = []
    for i, s in enumerate(srcs):
        if s == PROC_NULL or recvcounts[i] == 0:
            continue
        seg = rarr[rdispls[i]:rdispls[i] + recvcounts[i]]
        reqs.append(comm.irecv(seg, s, tag, count=recvcounts[i],
                               datatype=dt))
    for i, d in enumerate(dsts):
        if d == PROC_NULL or sendcounts[i] == 0:
            continue
        seg = sarr[sdispls[i]:sdispls[i] + sendcounts[i]]
        reqs.append(comm.isend(seg, d, tag, count=sendcounts[i],
                               datatype=dt))
    for r in reqs:
        r.wait()
    _writeback(rarr, orig)
