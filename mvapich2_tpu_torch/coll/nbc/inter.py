"""Intercommunicator nonblocking-collective schedules (a copy of the JAX
package's ``coll/nbc/inter.py``).

Each operation is one rank's DAG on the completion-driven engine
(``coll/nbc/engine.py``): a local fan-in to the local leader over the
intercomm's private intracomm, the leader bridge over the intercomm's
collective context, and a binomial release or broadcast back.
``coll/nonblocking.py`` ``_inter_fn`` dispatches an intercomm's
i-collective here (through ``coll/inter.py`` ``on_host``: numpy
buffers, a tensor on the card refused).

Tags: every schedule takes ONE tag from the intercomm's collective
counter when it is built (the caller's thread, so the call order, which
MPI requires to be the same on every rank, pairs the sides), offset
into its own namespace (``NBC_TAG_BASE``) so the traffic it puts on the
private intracomm never meets that comm's own collective tags. A
PROC_NULL rank of ``ibcast`` and ``ireduce`` takes its tag too (the JAX
package's returns before taking it, which leaves its counter one behind
the origin's, so the next schedule on the intercomm never pairs). Root
semantics are the blocking algorithms' (``coll/inter.py``).
"""

from __future__ import annotations

import numpy as np

from ...core.request import CompletedRequest, Request
from ...core.status import PROC_NULL, ROOT
from .dag import SchedDAG
from .engine import start

# high, disjoint from the 0..32767 window next_coll_tag cycles through
NBC_TAG_BASE = 1 << 20


def _nbc_tag(comm) -> int:
    return NBC_TAG_BASE + comm.next_coll_tag()


def _elem_count(buf, datatype) -> int:
    b = np.asarray(buf)
    return (b.size * b.itemsize) // max(datatype.size, 1)


def _packed_bytes(datatype, buf, count) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(datatype.pack(buf, count))).view(np.uint8).reshape(-1)


def _local_bcast(dag: SchedDAG, lc, buf: np.ndarray, tag: int,
                 after_root) -> list:
    """Binomial broadcast of ``buf`` from local rank 0 over ``lc``.
    ``after_root`` gates rank 0's sends (the data-ready vertices).
    Returns the vids whose completion means THIS rank holds the data."""
    size, rank = lc.size, lc.rank
    if size == 1:
        return list(after_root)
    got = list(after_root)
    mask = 1
    while mask < size:
        if rank & mask:
            got = [dag.recv(lc, buf, rank - mask, tag)]
            break
        mask <<= 1
    mask >>= 1
    while mask > 0:
        if rank + mask < size:
            dag.send(lc, buf, rank + mask, tag, after=got)
        mask >>= 1
    return got


def _local_fold(dag: SchedDAG, lc, acc: np.ndarray, op, tag: int) -> list:
    """Fan local contributions in to rank 0 and fold them into ``acc``
    in ascending local-rank order (order-preserving, so non-commutative
    ops match the blocking path). Rank 0 returns the vid list gating
    consumers of the folded value; other ranks return [] after posting
    their contribution send."""
    if lc.size == 1:
        return []
    if lc.rank != 0:
        dag.send(lc, acc, 0, tag)
        return []
    parts = {}
    fanin = []
    for r in range(1, lc.size):
        parts[r] = np.empty_like(acc)
        fanin.append(dag.recv(lc, parts[r], r, tag))

    def fold():
        for r in range(1, lc.size):
            acc[:] = op(acc, parts[r])
    return [dag.call(fold, after=fanin)]


# ---------------------------------------------------------------------------
# the schedule builders (MPIR_I<coll>_inter analogs)
# ---------------------------------------------------------------------------

def ibarrier(comm) -> Request:
    tag = _nbc_tag(comm)
    lc = comm.local_comm
    dag = SchedDAG()
    tok = np.zeros(1, np.uint8)
    if lc.rank == 0:
        fanin = [dag.recv(lc, np.zeros(1, np.uint8), r, tag)
                 for r in range(1, lc.size)]
        dag.send(comm, tok, 0, tag, after=fanin)
        release = [dag.recv(comm, np.zeros(1, np.uint8), 0, tag)]
    else:
        dag.send(lc, tok, 0, tag)
        release = []
    _local_bcast(dag, lc, np.zeros(1, np.uint8), tag, release)
    return start(comm, dag, "inter-ibarrier")


def ibcast(comm, buf, count: int, datatype, root: int) -> Request:
    # the tag is taken on every rank, PROC_NULL ones too, as the blocking
    # bcast takes it: the schedules after this one pair by the counter
    tag = _nbc_tag(comm)
    if root == PROC_NULL:
        return CompletedRequest()
    dag = SchedDAG()
    if root == ROOT:
        dag.send(comm, _packed_bytes(datatype, buf, count), 0, tag)
        return start(comm, dag, "inter-ibcast")
    lc = comm.local_comm
    stage = np.empty(datatype.size * count, np.uint8)
    got = [dag.recv(comm, stage, root, tag)] if lc.rank == 0 else []
    got = _local_bcast(dag, lc, stage, tag, got)
    dag.call(lambda: datatype.unpack(stage, buf, count), after=got)
    return start(comm, dag, "inter-ibcast")


def ireduce(comm, sendbuf, recvbuf, count: int, datatype, op,
            root: int) -> Request:
    tag = _nbc_tag(comm)              # on every rank: see ibcast
    if root == PROC_NULL:
        return CompletedRequest()
    dag = SchedDAG()
    if root == ROOT:
        stage = np.empty(datatype.size * count, np.uint8)
        r = dag.recv(comm, stage, 0, tag)
        dag.call(lambda: datatype.unpack(stage, recvbuf, count),
                 after=[r])
        return start(comm, dag, "inter-ireduce")
    lc = comm.local_comm
    acc = datatype.to_numpy(sendbuf, count).copy()
    folded = _local_fold(dag, lc, acc, op, tag)
    if lc.rank == 0:
        dag.send(comm, acc, root, tag, after=folded)
    return start(comm, dag, "inter-ireduce")


def iallreduce(comm, sendbuf, recvbuf, count: int, datatype,
               op) -> Request:
    """Each side receives the reduction of the REMOTE group's data
    (MPI-3.1 §5.2.3)."""
    tag = _nbc_tag(comm)
    lc = comm.local_comm
    dag = SchedDAG()
    acc = datatype.to_numpy(sendbuf, count).copy()
    stage = np.empty(datatype.size * count, np.uint8)
    folded = _local_fold(dag, lc, acc, op, tag)
    got = []
    if lc.rank == 0:
        dag.send(comm, acc, 0, tag, after=folded)
        got = [dag.recv(comm, stage, 0, tag)]
    got = _local_bcast(dag, lc, stage, tag, got)
    dag.call(lambda: datatype.unpack(stage, recvbuf, count), after=got)
    return start(comm, dag, "inter-iallreduce")


def iallgather(comm, sendbuf, recvbuf, count: int, datatype) -> Request:
    """``count`` is the per-REMOTE-rank recvcount; the send count comes
    from sendbuf (the two sides may pass different counts, §5.7)."""
    tag = _nbc_tag(comm)
    lc = comm.local_comm
    dag = SchedDAG()
    myc = _elem_count(sendbuf, datatype) if sendbuf is not None else 0
    mine = _packed_bytes(datatype, sendbuf, myc)
    nbytes = datatype.size * count
    remote_all = np.empty(nbytes * comm.remote_size, np.uint8)
    got = []
    if lc.rank == 0:
        local_all = np.empty(mine.size * lc.size, np.uint8)
        local_all[:mine.size] = mine
        fanin = [dag.recv(lc, local_all[r * mine.size:
                                        (r + 1) * mine.size], r, tag)
                 for r in range(1, lc.size)]
        dag.send(comm, local_all, 0, tag, after=fanin)
        got = [dag.recv(comm, remote_all, 0, tag)]
    else:
        dag.send(lc, mine, 0, tag)
    got = _local_bcast(dag, lc, remote_all, tag, got)
    dag.call(lambda: datatype.unpack(remote_all, recvbuf,
                                     count * comm.remote_size), after=got)
    return start(comm, dag, "inter-iallgather")


def ialltoall(comm, sendbuf, recvbuf, count: int, datatype) -> Request:
    """Direct pairwise exchange (no leader bridge — every rank talks to
    every remote rank, like the blocking inter.alltoall)."""
    tag = _nbc_tag(comm)
    dag = SchedDAG()
    nbytes = datatype.size * count
    myc = _elem_count(sendbuf, datatype) if sendbuf is not None else 0
    packed = _packed_bytes(datatype, sendbuf, myc)
    n = comm.remote_size
    sblk = packed.size // n if n else 0
    stage = np.empty(nbytes * n, np.uint8)
    recvs = [dag.recv(comm, stage[j * nbytes:(j + 1) * nbytes], j, tag)
             for j in range(n)]
    for j in range(n):
        dag.send(comm, packed[j * sblk:(j + 1) * sblk], j, tag)
    dag.call(lambda: datatype.unpack(stage, recvbuf, count * n),
             after=recvs)
    return start(comm, dag, "inter-ialltoall")


# the nonblocking intercomm dispatch table (the icoll seam mirroring
# coll/inter.py's COLL_FNS for the blocking algorithms)
ICOLL_FNS = {
    "ibarrier": ibarrier,
    "ibcast": ibcast,
    "ireduce": ireduce,
    "iallreduce": iallreduce,
    "iallgather": iallgather,
    "ialltoall": ialltoall,
}
