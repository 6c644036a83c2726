"""Nonblocking collectives (a copy of the JAX package's
``coll/nonblocking.py``): the device-tier routing and the host schedule
builders.

On a comm bound to the 1:1 mesh channel, ``ibcast``, ``iallreduce``,
``iallgather``, ``ialltoall`` and ``ialltoallv`` ride the device NBC tier
(``coll/device.py`` ``build_nonblocking_request``) where the JAX package
routes them there. Every other call builds this rank's host schedule:
``Sched`` expresses an algorithm as barrier-separated phases of sends,
receives and local calls over the comm's collective context, and
``start()`` lowers the phases to a dependency DAG (each phase-k vertex
depends on every phase-(k-1) vertex) run by the completion-driven
scheduler of ``coll/nbc``. A call on a device-capable comm that the
device tier refuses (the slot and fold channels, ``MPI_IN_PLACE``, a
missing or tensor ``recvbuf``, a dtype or op that does not lower, a
host-tier size) counts ``dev_coll_fallback_nbc``. A bfloat16 tensor
takes the device tier as its blocking call does (``coll/device.py``
``_recv_dtype_ok``), and a numpy bfloat16 one the host schedule. A
reduction's result reaches ``recvbuf`` through ``Datatype.from_numpy``,
so the MINLOC/MAXLOC pair types scatter their items' signature bytes. Intercommunicators'
leader-bridge schedules wait with the intercomms.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..core.op import Op
from ..core.request import Request


class Sched:
    """Phase-list schedule over the DAG engine: local calls run when
    their phase starts, receives are posted before the phase's sends go
    out, and a barrier() orders everything before it ahead of everything
    after."""

    def __init__(self, comm, tag: int):
        self.comm = comm
        self.tag = tag
        self.phases: List[List[tuple]] = [[]]

    # -- entry constructors ----------------------------------------------
    def send(self, buf: np.ndarray, dest: int) -> None:
        self.phases[-1].append(("send", buf, dest))

    def recv(self, buf: np.ndarray, src: int) -> None:
        self.phases[-1].append(("recv", buf, src))

    def call(self, fn: Callable[[], None]) -> None:
        """Local compute (reduce/copy) run when its phase starts."""
        self.phases[-1].append(("call", fn))

    def barrier(self) -> None:
        """Close the current phase (MPID_Sched_barrier)."""
        if self.phases[-1]:
            self.phases.append([])

    # -- execution --------------------------------------------------------
    def start(self) -> Request:
        from .nbc import engine as nbc
        from .nbc.dag import SchedDAG
        dag = SchedDAG()
        prev: List[int] = []
        for phase in self.phases:
            if not phase:
                continue
            cur: List[int] = []
            for e in phase:
                if e[0] == "call":
                    cur.append(dag.call(e[1], after=prev))
                elif e[0] == "recv":
                    cur.append(dag.recv(self.comm, e[1], e[2], self.tag,
                                        after=prev))
                else:
                    cur.append(dag.send(self.comm, e[1], e[2], self.tag,
                                        after=prev))
            prev = cur
        return nbc.start(self.comm, dag, "sched-coll")


# ---------------------------------------------------------------------------
# schedule builders
# ---------------------------------------------------------------------------

def ibarrier(comm) -> Request:
    tag = comm.next_coll_tag()
    s = Sched(comm, tag)
    size, rank = comm.size, comm.rank
    tok = np.zeros(1, np.uint8)
    mask = 1
    while mask < size:
        rtok = np.zeros(1, np.uint8)
        s.send(tok, (rank + mask) % size)
        s.recv(rtok, (rank - mask) % size)
        s.barrier()
        mask <<= 1
    return s.start()


def _device_nbc(comm, name: str, *a) -> Optional[Request]:
    """Device-tier routing (coll/device.py): i-collectives on a
    mesh-bound comm become NBC DAGs whose poll vertices launch and read
    device segments; every call on a device-capable comm that the tier
    refuses counts dev_coll_fallback_nbc and builds the host schedule."""
    if comm.device_channel is None:
        return None
    from . import device as _dev
    return _dev.build_nonblocking_request(comm, name, *a)


def ibcast(comm, buf, count: int, datatype, root: int) -> Request:
    req = _device_nbc(comm, "bcast", buf, count, datatype, root)
    if req is not None:
        return req
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    data = datatype.pack(buf, count) if rank == root else \
        np.empty(datatype.size * count, dtype=np.uint8)
    data = np.ascontiguousarray(data)
    vrank = (rank - root) % size
    mask = 1
    while mask < size:
        if vrank & mask:
            s.recv(data, ((vrank - mask) + root) % size)
            s.barrier()
            break
        mask <<= 1
    mask >>= 1
    while mask > 0:
        if vrank + mask < size:
            s.send(data, ((vrank + mask) + root) % size)
        mask >>= 1
    if rank != root:
        s.barrier()
        s.call(lambda: datatype.unpack(data, buf, count))
    return s.start()


def iallreduce(comm, sendbuf, recvbuf, count: int, datatype, op: Op
               ) -> Request:
    req = _device_nbc(comm, "allreduce", sendbuf, recvbuf, count,
                      datatype, op)
    if req is not None:
        return req
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    acc = datatype.to_numpy(sendbuf, count).copy()
    if not op.commutative:
        # order-preserving fallback (mirrors the blocking path's guard):
        # linear pipeline fold 0->1->...->p-1, then binomial bcast back
        if rank > 0:
            prev = np.empty_like(acc)
            s.recv(prev, rank - 1)
            s.barrier()
            s.call(lambda: acc.__setitem__(slice(None), op.fn(prev, acc)))
            s.barrier()
        if rank < size - 1:
            s.send(acc, rank + 1)
            s.barrier()
        root = size - 1
        vrank = (rank - root) % size
        mask = 1
        while mask < size:
            if vrank & mask:
                s.recv(acc, ((vrank - mask) + root) % size)
                s.barrier()
                break
            mask <<= 1
        mask >>= 1
        while mask > 0:
            if vrank + mask < size:
                s.send(acc, ((vrank + mask) + root) % size)
            mask >>= 1
        s.barrier()
        s.call(lambda: datatype.unpack(
            datatype.from_numpy(acc), recvbuf, count))
        return s.start()
    # recursive doubling (power-of-2 only; remainder folded like blocking rd)
    pof2 = 1 << (size.bit_length() - 1)
    rem = size - pof2
    tmp = np.empty_like(acc)
    newrank = rank
    if rank < 2 * rem:
        if rank % 2 == 0:
            s.send(acc, rank + 1)
            newrank = -1
        else:
            s.recv(tmp, rank - 1)
            s.barrier()
            s.call(lambda: acc.__setitem__(slice(None), op(tmp, acc)))
            newrank = rank // 2
    elif rem:
        newrank = rank - rem
    if newrank != -1:
        mask = 1
        while mask < pof2:
            peer_new = newrank ^ mask
            peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
            rbuf = np.empty_like(acc)
            s.barrier()
            # acc is sent live: the phase engine issues this send only after
            # the previous phase's reduce ran, and won't mutate acc again
            # until this phase's requests (incl. the send) complete.
            s.send(acc, peer)
            s.recv(rbuf, peer)
            s.barrier()
            s.call(lambda rb=rbuf: acc.__setitem__(slice(None), op(rb, acc)))
            mask <<= 1
    if rank < 2 * rem:
        s.barrier()
        if rank % 2:
            s.send(acc, rank - 1)
        else:
            s.recv(acc, rank + 1)
    s.barrier()
    s.call(lambda: datatype.unpack(
        datatype.from_numpy(acc), recvbuf, count))
    return s.start()


def iallgather(comm, sendbuf, recvbuf, count: int, datatype) -> Request:
    req = _device_nbc(comm, "allgather", sendbuf, recvbuf, count,
                      datatype)
    if req is not None:
        return req
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    nb = datatype.size * count
    stage = np.empty(size * nb, dtype=np.uint8)
    mine = np.ascontiguousarray(datatype.pack(sendbuf, count))
    stage[rank * nb:(rank + 1) * nb] = mine
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        sblk = (rank - step) % size
        rblk = (rank - step - 1) % size
        s.send(stage[sblk * nb:(sblk + 1) * nb], right)
        s.recv(stage[rblk * nb:(rblk + 1) * nb], left)
        s.barrier()
    s.call(lambda: datatype.unpack(stage, recvbuf, count * size))
    return s.start()


def ialltoall(comm, sendbuf, recvbuf, count: int, datatype) -> Request:
    req = _device_nbc(comm, "alltoall", sendbuf, recvbuf, count,
                      datatype)
    if req is not None:
        return req
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    nb = datatype.size * count
    sb = np.ascontiguousarray(datatype.pack(sendbuf, count * size))
    rb = np.empty(size * nb, dtype=np.uint8)
    rb[rank * nb:(rank + 1) * nb] = sb[rank * nb:(rank + 1) * nb]
    for i in range(1, size):
        src = (rank + i) % size
        dst = (rank - i) % size
        s.recv(rb[src * nb:(src + 1) * nb], src)
        s.send(sb[dst * nb:(dst + 1) * nb], dst)
    s.barrier()
    s.call(lambda: datatype.unpack(rb, recvbuf, count * size))
    return s.start()


def ireduce(comm, sendbuf, recvbuf, count: int, datatype, op: Op,
            root: int) -> Request:
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    acc = datatype.to_numpy(sendbuf, count).copy()
    vrank = (rank - root) % size
    mask = 1
    sent = False
    while mask < size and not sent:
        if vrank & mask:
            s.barrier()
            s.send(acc, ((vrank - mask) + root) % size)
            sent = True
        else:
            peer_v = vrank + mask
            if peer_v < size:
                tmp = np.empty_like(acc)
                s.recv(tmp, (peer_v + root) % size)
                s.barrier()
                s.call(lambda t=tmp: acc.__setitem__(slice(None),
                                                     op(t, acc)))
            mask <<= 1
    if rank == root:
        s.barrier()
        s.call(lambda: datatype.unpack(
            datatype.from_numpy(acc), recvbuf, count))
    return s.start()


def iscan(comm, sendbuf, recvbuf, count: int, datatype, op: Op) -> Request:
    """Linear pipelined scan: recv prefix from rank-1, fold own
    contribution, forward to rank+1 (MPIR_Iscan sched shape)."""
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    acc = datatype.to_numpy(sendbuf, count).copy()
    if rank > 0:
        prev = np.empty_like(acc)
        s.recv(prev, rank - 1)
        s.barrier()
        s.call(lambda: acc.__setitem__(slice(None), op(prev, acc)))
        s.barrier()
    if rank + 1 < size:
        s.send(acc, rank + 1)
    s.barrier()
    s.call(lambda: datatype.unpack(
        datatype.from_numpy(acc), recvbuf, count))
    return s.start()


def iexscan(comm, sendbuf, recvbuf, count: int, datatype, op: Op) -> Request:
    """Linear exclusive scan: forward the inclusive prefix, deliver the
    exclusive one (rank 0's recvbuf is untouched, MPI-3.1 §5.11.2)."""
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    acc = datatype.to_numpy(sendbuf, count).copy()
    if rank > 0:
        prev = np.empty_like(acc)
        s.recv(prev, rank - 1)
        s.barrier()
        s.call(lambda: datatype.unpack(
            datatype.from_numpy(prev), recvbuf, count))
        s.call(lambda: acc.__setitem__(slice(None), op(prev, acc)))
        s.barrier()
    if rank + 1 < size:
        s.send(acc, rank + 1)
    return s.start()


def igather(comm, sendbuf, recvbuf, count: int, datatype,
            root: int) -> Request:
    """Linear gather into root (sched form)."""
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    nb = datatype.size * count
    if rank == root:
        rb = np.empty(size * nb, dtype=np.uint8)
        rb[root * nb:(root + 1) * nb] = \
            np.ascontiguousarray(datatype.pack(sendbuf, count))
        for src in range(size):
            if src != root:
                s.recv(rb[src * nb:(src + 1) * nb], src)
        s.barrier()
        s.call(lambda: datatype.unpack(rb, recvbuf, count * size))
    else:
        sb = np.ascontiguousarray(datatype.pack(sendbuf, count))
        s.send(sb, root)
    return s.start()


def iscatter(comm, sendbuf, recvbuf, count: int, datatype,
             root: int) -> Request:
    """Linear scatter from root (sched form)."""
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    nb = datatype.size * count
    if rank == root:
        sb = np.ascontiguousarray(datatype.pack(sendbuf, count * size))
        for dst in range(size):
            if dst != root:
                s.send(sb[dst * nb:(dst + 1) * nb], dst)
        s.call(lambda: datatype.unpack(
            sb[root * nb:(root + 1) * nb], recvbuf, count))
    else:
        rb = np.empty(nb, dtype=np.uint8)
        s.recv(rb, root)
        s.barrier()
        s.call(lambda: datatype.unpack(rb, recvbuf, count))
    return s.start()


from .api import _displs_from_counts as _pfx  # noqa: E402


def igatherv(comm, sendbuf, sendcount: int, recvbuf, counts, displs,
             datatype, root: int) -> Request:
    """Linear gatherv (sched form); counts/displs root-significant."""
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    esz = datatype.size
    if rank == root:
        counts = list(counts)
        displs = list(displs) if displs is not None else _pfx(counts)
        total = max((displs[i] + counts[i] for i in range(size)),
                    default=0)
        rb = np.asarray(datatype.pack(recvbuf, total))
        seg = rb[displs[rank] * esz:(displs[rank] + counts[rank]) * esz]
        seg[:] = np.ascontiguousarray(
            datatype.pack(sendbuf, counts[rank])).view(np.uint8)
        for src in range(size):
            if src != root:
                s.recv(rb[displs[src] * esz:
                          (displs[src] + counts[src]) * esz], src)
        s.barrier()
        s.call(lambda: datatype.unpack(rb, recvbuf, total))
    else:
        sb = np.ascontiguousarray(datatype.pack(sendbuf, sendcount))
        s.send(sb.view(np.uint8), root)
    return s.start()


def iscatterv(comm, sendbuf, counts, displs, recvbuf, recvcount: int,
              datatype, root: int) -> Request:
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    esz = datatype.size
    if rank == root:
        counts = list(counts)
        displs = list(displs) if displs is not None else _pfx(counts)
        total = max((displs[i] + counts[i] for i in range(size)),
                    default=0)
        sb = np.asarray(datatype.pack(sendbuf, total))
        rb_cap = 0 if recvbuf is None else \
            int(getattr(np.asarray(recvbuf), "size", 0))
        for dst in range(size):
            seg = sb[displs[dst] * esz:(displs[dst] + counts[dst]) * esz]
            if dst == root:
                if rb_cap:      # NULL/zero recvbuf: root keeps nothing
                    s.call(lambda sg=seg, n=counts[dst]:
                           datatype.unpack(sg, recvbuf, n))
            else:
                s.send(np.ascontiguousarray(seg), dst)
    else:
        rb = np.empty(recvcount * esz, np.uint8)
        s.recv(rb, root)
        s.barrier()
        s.call(lambda: datatype.unpack(rb, recvbuf, recvcount))
    return s.start()


def iallgatherv(comm, sendbuf, sendcount: int, recvbuf, counts, displs,
                datatype) -> Request:
    """Ring allgatherv (sched form): linear send-to-all keeps it simple
    at conformance sizes."""
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    esz = datatype.size
    counts = list(counts)
    displs = list(displs) if displs is not None else _pfx(counts)
    total = max((displs[i] + counts[i] for i in range(size)), default=0)
    rb = np.asarray(datatype.pack(recvbuf, total))
    mine = np.ascontiguousarray(
        datatype.pack(sendbuf, sendcount)).view(np.uint8)
    rb[displs[rank] * esz: displs[rank] * esz + mine.size] = mine
    for peer in range(size):
        if peer == rank:
            continue
        s.send(mine, peer)
        s.recv(rb[displs[peer] * esz:
                  (displs[peer] + counts[peer]) * esz], peer)
    s.barrier()
    s.call(lambda: datatype.unpack(rb, recvbuf, total))
    return s.start()


def ialltoallv(comm, sendbuf, scounts, sdispls, recvbuf, rcounts,
               rdispls, datatype) -> Request:
    req = _device_nbc(comm, "alltoallv", sendbuf, scounts, sdispls,
                      recvbuf, rcounts, rdispls, datatype)
    if req is not None:
        return req
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    esz = datatype.size
    scounts, rcounts = list(scounts), list(rcounts)
    sdispls = list(sdispls) if sdispls is not None else _pfx(scounts)
    rdispls = list(rdispls) if rdispls is not None else _pfx(rcounts)
    stotal = max((sdispls[i] + scounts[i] for i in range(size)),
                 default=0)
    rtotal = max((rdispls[i] + rcounts[i] for i in range(size)),
                 default=0)
    sb = np.asarray(datatype.pack(sendbuf, stotal))
    rb = np.asarray(datatype.pack(recvbuf, rtotal))
    rb[rdispls[rank] * esz:(rdispls[rank] + rcounts[rank]) * esz] = \
        sb[sdispls[rank] * esz:(sdispls[rank] + scounts[rank]) * esz]
    for peer in range(size):
        if peer == rank:
            continue
        s.send(np.ascontiguousarray(
            sb[sdispls[peer] * esz:
               (sdispls[peer] + scounts[peer]) * esz]), peer)
        s.recv(rb[rdispls[peer] * esz:
                  (rdispls[peer] + rcounts[peer]) * esz], peer)
    s.barrier()
    s.call(lambda: datatype.unpack(rb, recvbuf, rtotal))
    return s.start()


def _ired_scatter_common(comm, sendbuf, recvbuf, counts, datatype, op):
    """Shared engine for ireduce_scatter[_block]: every rank exchanges
    full contributions, folds in ascending-rank order (non-commutative
    safe), and keeps its own slice."""
    tag = comm.next_coll_tag()
    size, rank = comm.size, comm.rank
    s = Sched(comm, tag)
    counts = list(counts)
    total = sum(counts)
    acc = datatype.to_numpy(sendbuf, total).copy()
    parts = {rank: acc}
    for peer in range(size):
        if peer == rank:
            continue
        buf = np.empty_like(acc)
        parts[peer] = buf
        s.send(acc, peer)
        s.recv(buf, peer)
    s.barrier()

    def fold():
        out = parts[0].copy()
        for r in range(1, size):
            out[:] = op(out, parts[r])
        epb = out.size // total if total else 1
        off = sum(counts[:rank]) * epb
        mine = out[off: off + counts[rank] * epb]
        datatype.unpack(datatype.from_numpy(mine),
                        recvbuf, counts[rank])
    s.call(fold)
    return s.start()


def ireduce_scatter(comm, sendbuf, recvbuf, counts, datatype,
                    op) -> Request:
    return _ired_scatter_common(comm, sendbuf, recvbuf, counts, datatype,
                                op)


def ireduce_scatter_block(comm, sendbuf, recvbuf, count: int, datatype,
                          op) -> Request:
    return _ired_scatter_common(comm, sendbuf, recvbuf,
                                [count] * comm.size, datatype, op)
