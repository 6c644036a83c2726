"""Intercommunicator collectives (a copy of the JAX package's
``coll/inter.py``): MPICH's generic intercomm algorithms behind
``Intercomm._coll`` (``core/intercomm.py``).

Data moves between the two disjoint groups with MPI-2 root semantics
(``ROOT`` on the origin, the origin's remote rank on the receiving
side, ``PROC_NULL`` elsewhere). Every algorithm is a local phase on the
intercomm's private intracomm ``comm.local_comm`` plus a leader bridge
(local rank 0 <-> remote rank 0) on the intercomm's collective context;
both sides call collectives in the same order, so ``next_coll_tag``
stays in lockstep. Buffers are numpy: ``on_host`` refuses a tensor on
the card (``NotImplementedError`` naming the intercomm; it is never
moved to the host) and reads a CPU tensor in place as numpy. The
nonblocking schedules are in ``coll/nbc/inter.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.comm import to_host
from ..core.status import PROC_NULL, ROOT
from ..utils import on_card
from .algorithms import crecv, csend, csendrecv


def on_host(name: str, fn):
    """``fn`` (an algorithm of this module or a schedule of
    ``coll/nbc/inter.py``) over numpy buffers: a tensor on the card
    raises ``NotImplementedError`` naming the intercomm and why it has
    no device path; a CPU tensor is handed on as its numpy view (reads
    and writes land in the tensor)."""
    def run(comm, *args):
        for a in args:
            if on_card(a):
                raise NotImplementedError(
                    f"{name} on intercommunicator "
                    f"{comm.name or comm.context_id}: {comm.unbound_why}; "
                    f"a tensor on {a.device} has no device path here and "
                    f"is not moved to the host")
        return fn(comm, *(to_host(a) if isinstance(a, torch.Tensor) else a
                          for a in args))
    return run


def _packed(datatype, buf, count) -> np.ndarray:
    return np.asarray(datatype.pack(buf, count))


def barrier(comm) -> None:
    tag = comm.next_coll_tag()
    comm.local_comm.barrier()
    if comm.rank == 0:
        tok = np.zeros(1, dtype=np.uint8)
        rtok = np.zeros(1, dtype=np.uint8)
        csendrecv(comm, tok, 0, rtok, 0, tag)
    comm.local_comm.barrier()


def bcast(comm, buf, count, datatype, root) -> None:
    tag = comm.next_coll_tag()
    if root == PROC_NULL:
        return
    if root == ROOT:
        # origin side: this rank holds the data; ship to remote local-0
        csend(comm, _packed(datatype, buf, count), 0, tag).wait()
        return
    # receiving side: remote rank ``root`` sends to our local rank 0
    nbytes = datatype.size * count
    stage = np.empty(nbytes, dtype=np.uint8)
    if comm.local_comm.rank == 0:
        crecv(comm, stage, root, tag).wait()
    comm.local_comm.bcast(stage, root=0)
    datatype.unpack(stage, buf, count)


def reduce(comm, sendbuf, recvbuf, count, datatype, op, root) -> None:
    tag = comm.next_coll_tag()
    if root == PROC_NULL:
        return
    if root == ROOT:
        # origin of the *result*: receive remote side's reduction
        nbytes = datatype.size * count
        stage = np.empty(nbytes, dtype=np.uint8)
        crecv(comm, stage, 0, tag).wait()
        datatype.unpack(stage, recvbuf, count)
        return
    # contributing side: reduce locally to local rank 0, forward to root
    part = comm.local_comm.reduce(np.asarray(sendbuf), root=0,
                                  op=op, count=count, datatype=datatype)
    if comm.local_comm.rank == 0:
        csend(comm, _packed(datatype, part, count), root, tag).wait()


def allreduce(comm, sendbuf, recvbuf, count, datatype, op) -> None:
    """Each side receives the reduction of the *remote* group's data
    (MPI-3.1 §5.2.3 intercomm semantics)."""
    tag = comm.next_coll_tag()
    lc = comm.local_comm
    part = lc.reduce(np.asarray(sendbuf), root=0, op=op,
                     count=count, datatype=datatype)
    nbytes = datatype.size * count
    stage = np.empty(nbytes, dtype=np.uint8)
    if lc.rank == 0:
        csendrecv(comm, _packed(datatype, part, count), 0, stage, 0, tag)
    lc.bcast(stage, root=0)
    datatype.unpack(stage, recvbuf, count)


def allgather(comm, sendbuf, recvbuf, count, datatype) -> None:
    """recvbuf gathers the remote group's contributions. ``count`` is
    the per-REMOTE-rank recvcount; the send count comes from sendbuf
    (the two groups may pass different counts — MPI-3.1 §5.7)."""
    tag = comm.next_coll_tag()
    lc = comm.local_comm
    myc = _elem_count(sendbuf, datatype) if sendbuf is not None else 0
    mine = _packed(datatype, sendbuf, myc)
    local_all = np.empty(mine.size * lc.size, dtype=np.uint8)
    lc.gather(mine, local_all, root=0, count=mine.size)
    nbytes = datatype.size * count
    remote_all = np.empty(nbytes * comm.remote_size, dtype=np.uint8)
    if lc.rank == 0:
        csendrecv(comm, local_all, 0, remote_all, 0, tag)
    lc.bcast(remote_all, root=0)
    datatype.unpack(remote_all, recvbuf, count * comm.remote_size)


def gather(comm, sendbuf, recvbuf, count, datatype, root) -> None:
    tag = comm.next_coll_tag()
    if root == PROC_NULL:
        return
    nbytes = datatype.size * count
    if root == ROOT:
        stage = np.empty(nbytes * comm.remote_size, dtype=np.uint8)
        crecv(comm, stage, 0, tag).wait()
        datatype.unpack(stage, recvbuf, count * comm.remote_size)
        return
    lc = comm.local_comm
    mine = _packed(datatype, sendbuf, count)
    local_all = np.empty(nbytes * lc.size, dtype=np.uint8) \
        if lc.rank == 0 else None
    lc.gather(mine, local_all, root=0, count=nbytes)
    if lc.rank == 0:
        csend(comm, local_all, root, tag).wait()


def scatter(comm, sendbuf, recvbuf, count, datatype, root) -> None:
    tag = comm.next_coll_tag()
    if root == PROC_NULL:
        return
    nbytes = datatype.size * count
    if root == ROOT:
        csend(comm, _packed(datatype, sendbuf, count * comm.remote_size),
              0, tag).wait()
        return
    lc = comm.local_comm
    local_all = np.empty(nbytes * lc.size, dtype=np.uint8)
    if lc.rank == 0:
        crecv(comm, local_all, root, tag).wait()
    mine = np.empty(nbytes, dtype=np.uint8)
    lc.scatter(local_all, mine, root=0, count=nbytes)
    datatype.unpack(mine, recvbuf, count)


def alltoall(comm, sendbuf, recvbuf, count, datatype) -> None:
    """Direct pairwise exchange: block j of sendbuf goes to remote rank
    j; block i of recvbuf comes from remote rank i. ``count`` is the
    per-remote-rank RECV count; send block size derives from sendbuf
    (the groups may pass different counts)."""
    tag = comm.next_coll_tag()
    nbytes = datatype.size * count
    myc = _elem_count(sendbuf, datatype) if sendbuf is not None else 0
    packed = _packed(datatype, sendbuf, myc)
    sblk = packed.size // comm.remote_size if comm.remote_size else 0
    stage = np.empty(nbytes * comm.remote_size, dtype=np.uint8)
    reqs = []
    for j in range(comm.remote_size):
        reqs.append(crecv(comm, stage[j * nbytes:(j + 1) * nbytes], j, tag))
    for j in range(comm.remote_size):
        reqs.append(csend(comm, packed[j * sblk:(j + 1) * sblk], j, tag))
    for r in reqs:
        r.wait()
    datatype.unpack(stage, recvbuf, count * comm.remote_size)



from .api import _displs_from_counts as _displs_from  # noqa: E402


def _elem_count(buf, datatype) -> int:
    """Element count of a typed/byte buffer under ``datatype``."""
    b = np.asarray(buf)
    return (b.size * b.itemsize) // max(datatype.size, 1)


def _own_count(counts, lc):
    """A contributor's own count: root-significant args mean non-root
    callers may pass a 1-entry list (the C shim) or the full list."""
    if counts is None:
        return None
    counts = list(counts)
    if len(counts) == lc.size:
        return counts[lc.rank]
    return counts[0] if counts else 0


def gatherv(comm, sendbuf, recvbuf, counts, displs, datatype,
            root) -> None:
    """counts/displs are remote-group-sized at the ROOT; contributors
    need only their own count (MPI-3.1 §5.5 intercomm semantics)."""
    tag = comm.next_coll_tag()
    if root == PROC_NULL:
        return
    esz = datatype.size
    lc = comm.local_comm
    if root == ROOT:
        counts = list(counts)
        if displs is None:
            displs = _displs_from(counts)
        blob = np.empty(sum(counts) * esz, np.uint8)
        crecv(comm, blob, 0, tag).wait()
        total = max((displs[i] + counts[i]
                     for i in range(comm.remote_size)), default=0)
        rb = np.asarray(datatype.pack(recvbuf, total))
        off = 0
        for i in range(comm.remote_size):
            n = counts[i] * esz
            rb[displs[i] * esz: displs[i] * esz + n] = blob[off:off + n]
            off += n
        datatype.unpack(rb, recvbuf, total)
        return
    myc = _own_count(counts, lc)
    if myc is None:
        myc = _elem_count(sendbuf, datatype)
    mine = np.asarray(datatype.pack(sendbuf, myc)).view(np.uint8)
    sizes = np.zeros(lc.size, np.int64)
    lc.gather(np.array([mine.size], np.int64), sizes, root=0, count=1)
    if lc.rank == 0:
        blob = np.empty(int(sizes.sum()), np.uint8)
        lc.gatherv(mine, blob, [int(x) for x in sizes], root=0)
        csend(comm, blob, root, tag).wait()
    else:
        lc.gatherv(mine, None, [int(mine.size)] * lc.size, root=0)


def scatterv(comm, sendbuf, counts, displs, recvbuf, datatype,
             root) -> None:
    tag = comm.next_coll_tag()
    if root == PROC_NULL:
        return
    esz = datatype.size
    lc = comm.local_comm
    if root == ROOT:
        counts = list(counts)
        if displs is None:
            displs = _displs_from(counts)
        total = max((displs[i] + counts[i]
                     for i in range(comm.remote_size)), default=0)
        sb = np.asarray(datatype.pack(sendbuf, total))
        blob = np.empty(sum(counts) * esz, np.uint8)
        off = 0
        for i in range(comm.remote_size):
            n = counts[i] * esz
            blob[off:off + n] = sb[displs[i] * esz: displs[i] * esz + n]
            off += n
        csend(comm, blob, 0, tag).wait()
        return
    myc = _own_count(counts, lc)
    if myc is None:
        myc = _elem_count(recvbuf, datatype)
    my_bytes = myc * esz
    sizes = np.zeros(lc.size, np.int64)
    lc.gather(np.array([my_bytes], np.int64), sizes, root=0, count=1)
    mine = np.empty(my_bytes, np.uint8)
    if lc.rank == 0:
        blob = np.empty(int(sizes.sum()), np.uint8)
        crecv(comm, blob, root, tag).wait()
        lc.scatterv(blob, [int(x) for x in sizes], None, mine, root=0)
    else:
        lc.scatterv(None, [my_bytes] * lc.size, None, mine, root=0)
    datatype.unpack(mine, recvbuf, myc)


def allgatherv(comm, sendbuf, recvbuf, counts, displs, datatype) -> None:
    """recvbuf gathers the REMOTE group's contributions; counts are
    remote-group-sized on every rank (MPI-3.1 §5.7)."""
    tag = comm.next_coll_tag()
    esz = datatype.size
    lc = comm.local_comm
    counts = list(counts)
    if displs is None:
        displs = _displs_from(counts)
    myc = _elem_count(sendbuf, datatype)
    mine = np.asarray(datatype.pack(sendbuf, myc)).view(np.uint8)
    sizes = np.zeros(lc.size, np.int64)
    lc.gather(np.array([mine.size], np.int64), sizes, root=0, count=1)
    if lc.rank == 0:
        blob = np.empty(int(sizes.sum()), np.uint8)
        lc.gatherv(mine, blob, [int(x) for x in sizes], root=0)
    else:
        blob = None
        lc.gatherv(mine, None, [int(mine.size)] * lc.size, root=0)
    stage = np.empty(sum(counts) * esz, np.uint8)
    if lc.rank == 0:
        csendrecv(comm, blob, 0, stage, 0, tag)
    lc.bcast(stage, root=0)
    total = max((displs[i] + counts[i]
                 for i in range(comm.remote_size)), default=0)
    rb = np.asarray(datatype.pack(recvbuf, total))
    off = 0
    for i in range(comm.remote_size):
        n = counts[i] * esz
        rb[displs[i] * esz: displs[i] * esz + n] = stage[off:off + n]
        off += n
    datatype.unpack(rb, recvbuf, total)


def alltoallv(comm, sendbuf, sendcounts, sdispls, recvbuf, recvcounts,
              rdispls, datatype) -> None:
    """Pairwise exchange with per-remote-rank counts."""
    tag = comm.next_coll_tag()
    esz = datatype.size
    sendcounts, recvcounts = list(sendcounts), list(recvcounts)
    if sdispls is None:
        sdispls = _displs_from(sendcounts)
    if rdispls is None:
        rdispls = _displs_from(recvcounts)
    stotal = max((sdispls[i] + sendcounts[i]
                  for i in range(comm.remote_size)), default=0)
    sb = np.asarray(datatype.pack(sendbuf, stotal))
    reqs, stages = [], []
    for j in range(comm.remote_size):
        st = np.empty(recvcounts[j] * esz, np.uint8)
        stages.append(st)
        reqs.append(crecv(comm, st, j, tag))
    for j in range(comm.remote_size):
        seg = sb[sdispls[j] * esz:(sdispls[j] + sendcounts[j]) * esz]
        reqs.append(csend(comm, np.ascontiguousarray(seg), j, tag))
    for r in reqs:
        r.wait()
    rtotal = max((rdispls[i] + recvcounts[i]
                  for i in range(comm.remote_size)), default=0)
    rb = np.asarray(datatype.pack(recvbuf, rtotal))
    for j in range(comm.remote_size):
        n = recvcounts[j] * esz
        rb[rdispls[j] * esz: rdispls[j] * esz + n] = stages[j]
    datatype.unpack(rb, recvbuf, rtotal)


def reduce_scatter_block(comm, sendbuf, recvbuf, count, datatype,
                         op) -> None:
    """Each side receives count-per-rank slices of the reduction of the
    REMOTE group's data (MPI-3.1 §5.10 intercomm semantics): a rank's
    sendbuf holds count*remote_size elements."""
    tag = comm.next_coll_tag()
    lc = comm.local_comm
    esz = datatype.size
    send_elems = _elem_count(sendbuf, datatype)
    part = lc.reduce(np.asarray(sendbuf), root=0, op=op,
                     count=send_elems, datatype=datatype)
    theirs = np.empty(count * lc.size * esz, np.uint8)
    if lc.rank == 0:
        csendrecv(comm, np.asarray(datatype.pack(part, send_elems)),
                  0, theirs, 0, tag)
    mine = np.empty(count * esz, np.uint8)
    lc.scatter(theirs if lc.rank == 0 else None, mine, root=0,
               count=count * esz)
    datatype.unpack(mine, recvbuf, count)


def reduce_scatter(comm, sendbuf, recvbuf, counts, datatype, op) -> None:
    """Irregular-counts variant: counts are LOCAL-group-sized (my
    side's slices of the remote reduction)."""
    tag = comm.next_coll_tag()
    lc = comm.local_comm
    esz = datatype.size
    counts = list(counts)
    send_elems = _elem_count(sendbuf, datatype)
    part = lc.reduce(np.asarray(sendbuf), root=0, op=op,
                     count=send_elems, datatype=datatype)
    theirs = np.empty(sum(counts) * esz, np.uint8)
    if lc.rank == 0:
        csendrecv(comm, np.asarray(datatype.pack(part, send_elems)),
                  0, theirs, 0, tag)
    mine = np.empty(counts[lc.rank] * esz, np.uint8)
    if lc.rank == 0:
        lc.scatterv(theirs, [n * esz for n in counts], None, mine,
                    root=0)
    else:
        lc.scatterv(None, [counts[lc.rank] * esz] * lc.size, None,
                    mine, root=0)
    datatype.unpack(mine, recvbuf, counts[lc.rank])


COLL_FNS: Dict[str, callable] = {
    "barrier": barrier,
    "bcast": bcast,
    "reduce": reduce,
    "allreduce": allreduce,
    "allgather": allgather,
    "gather": gather,
    "scatter": scatter,
    "alltoall": alltoall,
    "gatherv": gatherv,
    "scatterv": scatterv,
    "allgatherv": allgatherv,
    "alltoallv": alltoallv,
    "reduce_scatter": reduce_scatter,
    "reduce_scatter_block": reduce_scatter_block,
}
