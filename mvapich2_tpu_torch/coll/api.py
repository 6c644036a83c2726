"""The host collective entry points (a trimmed copy of the JAX package's
``coll/api.py``, the MPIR_<Coll>_impl analog).

Each packs the datatype (and resolves MPI_IN_PLACE), picks the algorithm
through the comm's table (``coll/tuning.py``), runs it on contiguous
numpy arrays (``coll/algorithms.py``) and unpacks. ``_select`` wraps the
chosen algorithm in the ``coll_<coll>_<algo>_calls`` counter and
``coll_<coll>_<algo>_time`` timer pvars. The JAX package's native-plane
routes (``_plane_*``, ``flatcoll``, ``netcoll``) belong to its
process-mode transports and are not ported.
"""

from __future__ import annotations

import time as _time
from typing import List, Optional, Sequence

import numpy as np

from .. import metrics as _metrics
from ..core.comm import IN_PLACE
from ..core.datatype import Datatype, as_bytes_view, from_numpy_dtype
from ..core.errors import MPI_ERR_ROOT, mpi_assert
from ..core.op import Op
from . import algorithms as alg


def _packed(buf, count: int, datatype: Optional[Datatype]) -> np.ndarray:
    """Pack into the basic dtype (reductions) or bytes (movement)."""
    if datatype is None:
        datatype = from_numpy_dtype(np.asarray(buf).dtype)
    if datatype.basic is not None:
        return datatype.to_numpy(buf, count)
    return datatype.pack(buf, count)


def _packed_ro(buf, count: int, datatype: Datatype) -> np.ndarray:
    """Read-only packed VIEW for reduction sources: a contiguous basic
    dtype needs no staging copy — every reduction algorithm copies
    before it mutates, and the blocking call keeps the user buffer
    stable. On an oversubscribed host the skipped 1 MiB memcpy is paid
    by every co-located rank in turn, so it is pure serial latency."""
    if datatype.basic is not None and datatype.is_contiguous \
            and datatype.basic.itemsize == datatype.size:
        try:
            mv = as_bytes_view(buf)
            n = datatype.size * count
            if len(mv) >= n:
                return np.frombuffer(mv, dtype=np.uint8,
                                     count=n).view(datatype.basic)
        except (ValueError, TypeError):
            pass
    return _packed(buf, count, datatype)


def _unpack(arr: np.ndarray, buf, count: int,
            datatype: Optional[Datatype]) -> None:
    if datatype is None:
        datatype = from_numpy_dtype(np.asarray(buf).dtype)
    datatype.unpack(np.ascontiguousarray(arr).view(np.uint8), buf, count)


def _dt(buf, datatype):
    return datatype if datatype is not None \
        else from_numpy_dtype(np.asarray(buf).dtype)


def _displs_from_counts(counts: Sequence[int]) -> List[int]:
    displs = [0] * len(counts)
    for i in range(1, len(counts)):
        displs[i] = displs[i - 1] + counts[i - 1]
    return displs


# ---------------------------------------------------------------------------
# blocking collectives — each takes the algorithm fn from the tuning table
# ---------------------------------------------------------------------------

def barrier(comm) -> None:
    tag = comm.next_coll_tag()
    fn = _select(comm, "barrier", 0)
    fn(comm, tag)


def bcast(comm, buf, count: int, datatype: Optional[Datatype],
          root: int) -> None:
    mpi_assert(0 <= root < comm.size, MPI_ERR_ROOT, f"bad root {root}")
    datatype = _dt(buf, datatype)
    nbytes = datatype.size * count
    if comm.size == 1:
        return
    data = datatype.pack(buf, count) if comm.rank == root \
        else np.empty(nbytes, dtype=np.uint8)
    data = np.ascontiguousarray(data)
    tag = comm.next_coll_tag()
    fn = _select(comm, "bcast", nbytes)
    mx = _metrics.LIVE
    t0 = _time.perf_counter() if mx is not None else 0.0
    fn(comm, data, root, tag)
    if mx is not None:
        mx.rec_since("lat_coll_sched", t0)
    if comm.rank != root or not datatype.is_contiguous:
        datatype.unpack(data, buf, count)


def reduce(comm, sendbuf, recvbuf, count: int, datatype: Optional[Datatype],
           op: Op, root: int) -> None:
    datatype = _dt(recvbuf if sendbuf is IN_PLACE else sendbuf, datatype)
    src = recvbuf if sendbuf is IN_PLACE else sendbuf
    arr = _packed(src, count, datatype)
    tag = comm.next_coll_tag()
    fn = _select(comm, "reduce", arr.nbytes, op=op)
    out = fn(comm, arr, op, root, tag)
    if comm.rank == root:
        _unpack(out, recvbuf, count, datatype)


def allreduce(comm, sendbuf, recvbuf, count: int,
              datatype: Optional[Datatype], op: Op) -> None:
    datatype = _dt(recvbuf if sendbuf is IN_PLACE else sendbuf, datatype)
    src = recvbuf if sendbuf is IN_PLACE else sendbuf
    arr = _packed_ro(src, count, datatype)
    tag = comm.next_coll_tag()
    fn = _select(comm, "allreduce", arr.nbytes, op=op)
    mx = _metrics.LIVE
    t0 = _time.perf_counter() if mx is not None else 0.0
    out = fn(comm, arr, op, tag)
    if mx is not None:
        mx.rec_since("lat_coll_sched", t0)
    _unpack(out, recvbuf, count, datatype)


def allgather(comm, sendbuf, recvbuf, count: int,
              datatype: Optional[Datatype]) -> None:
    datatype = _dt(recvbuf, datatype)
    tag = comm.next_coll_tag()
    nbytes = datatype.size * count
    if sendbuf is IN_PLACE:
        rb = datatype.pack(recvbuf, count * comm.size)
        mine = rb[comm.rank * nbytes:(comm.rank + 1) * nbytes].copy()
    else:
        mine = datatype.pack(sendbuf, count)
        rb = np.empty(comm.size * nbytes, dtype=np.uint8)
    fn = _select(comm, "allgather", nbytes)
    fn(comm, np.ascontiguousarray(mine), rb, tag)
    datatype.unpack(rb, recvbuf, count * comm.size)


def allgatherv(comm, sendbuf, recvbuf, counts: Sequence[int],
               displs: Optional[Sequence[int]],
               datatype: Optional[Datatype]) -> None:
    datatype = _dt(recvbuf, datatype)
    esz = datatype.size
    if displs is None:
        displs = _displs_from_counts(counts)
    total = max(displs[i] + counts[i] for i in range(comm.size))
    tag = comm.next_coll_tag()
    rb = datatype.pack(recvbuf, total) if sendbuf is IN_PLACE else \
        np.empty(total * esz, dtype=np.uint8)
    if sendbuf is IN_PLACE:
        mine = rb[displs[comm.rank] * esz:
                  (displs[comm.rank] + counts[comm.rank]) * esz].copy()
    else:
        mine = datatype.pack(sendbuf, counts[comm.rank])
    bcounts = [c * esz for c in counts]
    bdispls = [d * esz for d in displs]
    alg.allgatherv_ring(comm, np.ascontiguousarray(mine), rb, bcounts,
                        bdispls, tag)
    datatype.unpack(rb, recvbuf, total)


def gather(comm, sendbuf, recvbuf, count: int, datatype: Optional[Datatype],
           root: int) -> None:
    datatype = _dt(sendbuf if sendbuf is not IN_PLACE else recvbuf, datatype)
    tag = comm.next_coll_tag()
    nbytes = datatype.size * count
    if sendbuf is IN_PLACE and comm.rank == root:
        full = datatype.pack(recvbuf, count * comm.size)
        mine = full[comm.rank * nbytes:(comm.rank + 1) * nbytes].copy()
    else:
        mine = datatype.pack(sendbuf, count)
    out = None
    if comm.rank == root:
        out = np.empty(comm.size * nbytes, dtype=np.uint8)
    alg.gather_binomial(comm, np.ascontiguousarray(mine), out, root, tag)
    if comm.rank == root:
        datatype.unpack(out, recvbuf, count * comm.size)


def gatherv(comm, sendbuf, recvbuf, counts, displs, datatype, root) -> None:
    datatype = _dt(sendbuf if sendbuf is not IN_PLACE else recvbuf, datatype)
    esz = datatype.size
    tag = comm.next_coll_tag()
    if displs is None:
        displs = _displs_from_counts(counts)
    # linear gatherv (the reference's default for v-collectives)
    if comm.rank == root:
        total = max(displs[i] + counts[i] for i in range(comm.size))
        rb = np.asarray(datatype.pack(recvbuf, total))
        reqs = []
        for r in range(comm.size):
            if r == root:
                if sendbuf is not IN_PLACE:
                    seg = datatype.pack(sendbuf, counts[r])
                    rb[displs[r] * esz:(displs[r] + counts[r]) * esz] = seg
                continue
            seg = rb[displs[r] * esz:(displs[r] + counts[r]) * esz]
            reqs.append(alg.crecv(comm, seg, r, tag))
        from ..core.request import waitall
        waitall(reqs)
        datatype.unpack(rb, recvbuf, total)
    else:
        mine = datatype.pack(sendbuf, counts[comm.rank])
        alg.csend(comm, np.ascontiguousarray(mine), root, tag).wait()


def scatter(comm, sendbuf, recvbuf, count: int, datatype: Optional[Datatype],
            root: int) -> None:
    datatype = _dt(recvbuf if recvbuf is not IN_PLACE else sendbuf, datatype)
    tag = comm.next_coll_tag()
    nbytes = datatype.size * count
    full = None
    if comm.rank == root:
        full = np.asarray(datatype.pack(sendbuf, count * comm.size))
    mine = np.empty(nbytes, dtype=np.uint8)
    alg.scatter_binomial(comm, full, mine, root, tag)
    if recvbuf is IN_PLACE:
        return
    datatype.unpack(mine, recvbuf, count)


def scatterv(comm, sendbuf, counts, displs, recvbuf, datatype, root) -> None:
    datatype = _dt(recvbuf, datatype)
    esz = datatype.size
    tag = comm.next_coll_tag()
    from ..core.request import waitall
    if comm.rank == root:
        if displs is None:
            displs = _displs_from_counts(counts)
        total = max(displs[i] + counts[i] for i in range(comm.size))
        sb = np.asarray(datatype.pack(sendbuf, total))
        reqs = []
        for r in range(comm.size):
            seg = sb[displs[r] * esz:(displs[r] + counts[r]) * esz]
            if r == root:
                if recvbuf is not IN_PLACE:   # root's slice stays put
                    datatype.unpack(seg, recvbuf, counts[r])
                continue
            reqs.append(alg.csend(comm, seg.copy(), r, tag))
        waitall(reqs)
    else:
        n = counts[comm.rank] if counts is not None else \
            np.asarray(recvbuf).size
        mine = np.empty(n * esz, dtype=np.uint8)
        alg.crecv(comm, mine, root, tag).wait()
        datatype.unpack(mine, recvbuf, n)


def alltoall(comm, sendbuf, recvbuf, count: int,
             datatype: Optional[Datatype]) -> None:
    datatype = _dt(recvbuf, datatype)
    tag = comm.next_coll_tag()
    nbytes = datatype.size * count
    if sendbuf is IN_PLACE:
        sb = datatype.pack(recvbuf, count * comm.size)
    else:
        sb = datatype.pack(sendbuf, count * comm.size)
    rb = np.empty(comm.size * nbytes, dtype=np.uint8)
    fn = _select(comm, "alltoall", nbytes)
    fn(comm, np.ascontiguousarray(sb), rb, tag)
    datatype.unpack(rb, recvbuf, count * comm.size)


def alltoallv(comm, sendbuf, scounts, sdispls, recvbuf, rcounts, rdispls,
              datatype: Optional[Datatype]) -> None:
    datatype = _dt(recvbuf, datatype)
    esz = datatype.size
    tag = comm.next_coll_tag()
    stotal = max(sdispls[i] + scounts[i] for i in range(comm.size))
    rtotal = max(rdispls[i] + rcounts[i] for i in range(comm.size))
    sb = np.asarray(datatype.pack(sendbuf, stotal))
    rb = np.empty(rtotal * esz, dtype=np.uint8)
    alg.alltoallv_scattered(comm, sb, [c * esz for c in scounts],
                            [d * esz for d in sdispls], rb,
                            [c * esz for c in rcounts],
                            [d * esz for d in rdispls], tag)
    datatype.unpack(rb, recvbuf, rtotal)


def reduce_scatter_block(comm, sendbuf, recvbuf, count: int,
                         datatype: Optional[Datatype], op: Op) -> None:
    datatype = _dt(recvbuf, datatype)
    tag = comm.next_coll_tag()
    src = recvbuf if sendbuf is IN_PLACE else sendbuf
    arr = _packed(src, count * comm.size, datatype)
    nelem = count * (datatype.size // datatype.basic_size)
    out = np.empty(nelem, dtype=arr.dtype)
    if op.commutative:
        alg.reduce_scatter_ring(comm, arr, out, op, tag)
    else:
        # order-preserving fallback: ordered reduce at 0, scatter blocks
        red = alg.reduce_gather_local(comm, arr, op, 0, tag)
        alg.scatter_binomial(comm, red, out, 0, tag)
    _unpack(out, recvbuf, count, datatype)


def reduce_scatter(comm, sendbuf, recvbuf, counts: Sequence[int],
                   datatype: Optional[Datatype], op: Op) -> None:
    """General reduce_scatter: reduce + scatterv (reference fallback algo)."""
    datatype = _dt(recvbuf, datatype)
    total = sum(counts)
    tag = comm.next_coll_tag()
    src = recvbuf if sendbuf is IN_PLACE else sendbuf
    arr = _packed(src, total, datatype)
    reduce_fn = _select(comm, "reduce", arr.nbytes, op=op)
    out = reduce_fn(comm, arr, op, 0, tag)
    displs = _displs_from_counts(counts)
    scatterv(comm, out if comm.rank == 0 else None, counts, displs, recvbuf,
             datatype, 0)


def scan(comm, sendbuf, recvbuf, count: int, datatype: Optional[Datatype],
         op: Op) -> None:
    datatype = _dt(recvbuf, datatype)
    tag = comm.next_coll_tag()
    src = recvbuf if sendbuf is IN_PLACE else sendbuf
    arr = _packed(src, count, datatype)
    out = alg.scan_linear(comm, arr, op, tag, exclusive=False)
    _unpack(out, recvbuf, count, datatype)


def exscan(comm, sendbuf, recvbuf, count: int, datatype: Optional[Datatype],
           op: Op) -> None:
    datatype = _dt(recvbuf, datatype)
    tag = comm.next_coll_tag()
    src = recvbuf if sendbuf is IN_PLACE else sendbuf
    arr = _packed(src, count, datatype)
    out = alg.scan_linear(comm, arr, op, tag, exclusive=True)
    if comm.rank > 0:
        _unpack(out, recvbuf, count, datatype)


def _select(comm, name: str, nbytes: int, op: Optional[Op] = None):
    """Dispatch through the comm's table (``coll/tuning.py``), wrapping
    the chosen algorithm in its timer and counter pvars."""
    if not comm.coll_fns:
        from .tuning import install_coll_ops
        install_coll_ops(comm)
    fn = comm.coll_fns["_select"](name, nbytes, op)
    cached = _timed_cache.get((name, fn))
    if cached is None:
        from .. import mpit
        algo = getattr(fn, "__name__", "unknown")
        timer = mpit.pvar(f"coll_{name}_{algo}_time", mpit.PVAR_CLASS_TIMER,
                          f"cumulative seconds in {name}/{algo}")
        counter = mpit.pvar(f"coll_{name}_{algo}_calls",
                            mpit.PVAR_CLASS_COUNTER,
                            f"invocations of {name}/{algo}")

        def cached(*a, _fn=fn, _t=timer, _c=counter, **kw):
            _c.inc()
            with _t.timing():
                return _fn(*a, **kw)

        cached.__name__ = algo
        _timed_cache[(name, fn)] = cached
    return cached


# (coll name, algorithm fn) -> timed wrapper; bounded by the algorithm zoo
_timed_cache: dict = {}
