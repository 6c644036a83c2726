"""Communicators (counterpart of the JAX package's ``core/comm.py``), with
the JAX package's signatures.

A Comm is a Group bound to a context id pair (point-to-point on
``context_id``, collectives on ``context_id + 1``) and a collective
table, ``coll_fns``: the host entries of ``coll/api.py``
(``coll/tuning.py`` ``install_coll_ops``), of which a device channel
overwrites the ones it runs (``coll/device.py`` ``install_device_coll``;
COMM_WORLD of ``run_ranks`` is bound to one). Its surface:

* point-to-point over the rank's protocol (``pt2pt/protocol.py``): send
  in its four modes, isend/issend/irecv/recv, sendrecv(_replace),
  probe/iprobe/improbe/mrecv, send_init/recv_init;
* the collectives: barrier, bcast, reduce, allreduce, allgather(v),
  gather(v), scatter(v), alltoall(v), reduce_scatter(_block), scan and
  exscan; their nonblocking twins (``coll/nonblocking.py``: the device
  NBC tier where the JAX package routes a call there, else the host
  schedule); the persistent collectives (``*_init``, MPI-4), whose
  request re-posts the ``i*`` twin on every ``start()``;
* dup, create, create_group, split, split_type_shared, build_2level,
  compare, free, set_name/get_name. A comm made by dup, create,
  create_group or split of a bound comm gets a device channel by its
  members' geometry (``coll/device.py`` ``bind_derived``): it runs a
  tensor's collectives on the card, and a numpy call on the host tier,
  as a comm with no channel;
* attribute caching (``attrs``, ``core/attr.py``): ``dup`` runs the
  keyvals' ``copy_fn`` and carries the topology over, ``free`` runs
  every ``delete_fn`` before it releases the device channel and the
  context id, so a ``delete_fn`` may still call a collective on the
  comm. ``split``, ``create`` and ``create_group`` copy no attributes
  (MPI-3.1 §6.7.2 names only MPI_Comm_dup and MPI_Comm_idup), as in the
  JAX package;
* process topologies and neighbor collectives (``core/topo.py``): the
  Cartesian, graph and distributed-graph constructors (made by split or
  dup, so they bind the channel their geometry gives) and accessors,
  and ``neighbor_allgather``/``_alltoall``/``_alltoallv`` on numpy (a
  CPU tensor in place; a tensor on the card raises
  ``NotImplementedError``, never staged to the host).

Counts and datatypes come from the buffer where not given
(``core/datatype.py``: a numpy array's or a tensor's dtype); derived
datatypes pass through ``datatype=``. A numpy ``recvbuf`` is filled in
place and returned. On a device channel a tensor ``sendbuf`` returns the
result tensor (for allreduce/reduce/bcast every rank is handed the same
shared tensor, which must not be written in place); a tensor on the
host tier is read as numpy if it lies on the CPU, as the JAX package
stages a device array (``_stage_if_unbound`` here, the device wrappers
on a bound comm); one on the card raises ``NotImplementedError`` there
instead of moving to the host. A point-to-point call refuses any tensor
with MPI_ERR_ARG (``as_bytes_view``).

Intercommunicators (``core/intercomm.py`` ``Intercomm``) subclass Comm
and override its seams: ``world_of`` and ``_check_rank`` (point-to-point
ranks name the remote group), ``_check_root`` (MPI_ROOT and
MPI_PROC_NULL) and ``_coll`` (the intercomm algorithms of
``coll/inter.py``); ``is_inter`` tells the two apart. The one-sided
host windows' constructors (``win_create``, ``win_allocate``,
``win_allocate_shared``, ``win_create_dynamic``) are ``rma/win.py``'s;
a window buffer follows the rule above (a CPU tensor in place, a tensor
on the card refused). The ULFM calls wait with their tier.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import datatype as dtmod
from . import op as opmod
from .attr import AttrCache
from .datatype import Datatype
from .errors import (MPI_ERR_COMM, MPI_ERR_COUNT, MPI_ERR_GROUP,
                     MPI_ERR_RANK, MPI_ERR_ROOT, MPI_ERR_TOPOLOGY,
                     MPIException, mpi_assert)
from .group import Group
from .request import Request
from .status import ANY_SOURCE, ANY_TAG, PROC_NULL, UNDEFINED, Status
from ..utils import on_card

class _InPlace:
    """The MPI_IN_PLACE sentinel."""

    def __repr__(self):
        return "MPI_IN_PLACE"


IN_PLACE = _InPlace()


def _is_in_place(buf) -> bool:
    return isinstance(buf, _InPlace)


def _is_device(buf) -> bool:
    return isinstance(buf, torch.Tensor)


def _numel(buf) -> int:
    return buf.numel() if _is_device(buf) else int(np.asarray(buf).size)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host (a bfloat16 tensor
    needs ml_dtypes' numpy bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        basic = dtmod.BFLOAT16.basic
        if basic is None:
            raise NotImplementedError(
                "a bfloat16 tensor on the host tier needs ml_dtypes' "
                "numpy bfloat16, which is not installed")
        return t.view(torch.int16).cpu().numpy().view(basic)
    return t.cpu().numpy()


def from_host(h: np.ndarray, device) -> torch.Tensor:
    """The inverse of :func:`to_host`: a numpy array as a tensor on
    ``device``."""
    h = np.ascontiguousarray(h)
    basic = dtmod.BFLOAT16.basic
    if basic is not None and h.dtype == basic:
        return torch.from_numpy(h.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(h).to(device)


def _result_like(like, n: Optional[int] = None) -> np.ndarray:
    """The result buffer a reduction allocates: ``like``'s dtype, its
    shape or ``n`` items. A MINLOC/MAXLOC pair dtype's trailing padding
    is zeroed, as :func:`core.datatype.packed_to_basic` restages items,
    so every byte of the result is defined."""
    a = np.asarray(like)
    shape = a.shape if n is None else (n,)
    alloc = np.zeros if dtmod.has_padding(a.dtype) else np.empty
    return alloc(shape, dtype=a.dtype)


def _resolve(buf, count: Optional[int], datatype: Optional[Datatype],
             alt=None) -> Tuple[int, Datatype]:
    """(count, datatype) of a numpy array, tensor or bytes buffer where
    not given; ``alt`` stands in for MPI_IN_PLACE."""
    if _is_in_place(buf):
        buf = alt
    if datatype is None:
        if isinstance(buf, np.ndarray) or _is_device(buf):
            datatype = dtmod.from_numpy_dtype(buf.dtype)
        elif isinstance(buf, (bytes, bytearray, memoryview)) or buf is None:
            datatype = dtmod.BYTE
        else:
            raise MPIException(MPI_ERR_COMM, f"cannot infer datatype "
                               f"for {type(buf)}")
    if count is None:
        if isinstance(buf, np.ndarray) or _is_device(buf):
            count = _numel(buf)
        elif buf is None:
            count = 0
        else:
            count = len(buf) // max(datatype.size, 1)
    return count, datatype


class Comm:
    is_inter = False      # an Intercomm (core/intercomm.py) says True

    def __init__(self, universe, group: Group, context_id: int,
                 name: str = ""):
        self.u = universe
        self.group = group
        self.context_id = context_id
        self.name = name
        self.rank = group.rank_of_world(universe.world_rank)
        self.size = group.size
        self.freed = False
        self.attrs = AttrCache()
        self.topo = None            # set by core/topo.py
        self._coll_seq = 0          # collective tag sequencing
        self.coll_fns: Dict[str, Callable] = {}
        self._shmem_comm: Optional["Comm"] = None
        self._leader_comm: Optional["Comm"] = None
        self._twolevel_ready = False
        # the device collective channel (coll/device.py
        # install_device_coll, bind_derived); None on a host-only comm
        self.device_channel = None
        # why a comm made from a bound one has no channel (its geometry)
        self.unbound_why = ""
        universe.comms_by_ctx[context_id] = self

    # ------------------------------------------------------------------
    @property
    def ctx_pt2pt(self) -> int:
        return self.context_id

    @property
    def ctx_coll(self) -> int:
        return self.context_id + 1

    def world_of(self, rank: int) -> int:
        if rank in (PROC_NULL, ANY_SOURCE):
            return rank
        return self.group.world_of_rank(rank)

    def next_coll_tag(self) -> int:
        self._coll_seq = (self._coll_seq + 1) % 32768
        return self._coll_seq

    def _check(self) -> None:
        if self.freed:
            raise MPIException(MPI_ERR_COMM, "communicator is freed")

    def _check_rank(self, r: int, allow_any: bool = False) -> None:
        if r == PROC_NULL or (allow_any and r == ANY_SOURCE):
            return
        mpi_assert(0 <= r < self.size, MPI_ERR_RANK,
                   f"rank {r} invalid for comm of size {self.size}")

    def _check_root(self, root: int) -> None:
        if not 0 <= root < self.size:
            raise MPIException(MPI_ERR_ROOT, f"bad root {root} for a "
                               f"communicator of size {self.size}")

    # ------------------------------------------------------------------
    # point-to-point
    # ------------------------------------------------------------------
    def isend(self, buf, dest: int, tag: int = 0, count: Optional[int] = None,
              datatype: Optional[Datatype] = None,
              mode: str = "standard") -> Request:
        self._check()
        self._check_rank(dest)
        count, datatype = _resolve(buf, count, datatype)
        return self.u.protocol.isend(buf, count, datatype,
                                     self.world_of(dest), self.rank,
                                     self.ctx_pt2pt, tag, mode)

    def irecv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              count: Optional[int] = None,
              datatype: Optional[Datatype] = None) -> Request:
        self._check()
        self._check_rank(source, allow_any=True)
        count, datatype = _resolve(buf, count, datatype)
        return self.u.protocol.irecv(buf, count, datatype, source,
                                     self.ctx_pt2pt, tag)

    def send(self, buf, dest: int, tag: int = 0, **kw) -> None:
        self.isend(buf, dest, tag, **kw).wait()

    def ssend(self, buf, dest: int, tag: int = 0, **kw) -> None:
        self.isend(buf, dest, tag, mode="sync", **kw).wait()

    def bsend(self, buf, dest: int, tag: int = 0, **kw) -> None:
        self.isend(buf, dest, tag, mode="buffered", **kw).wait()

    def rsend(self, buf, dest: int, tag: int = 0, **kw) -> None:
        # ready mode is standard mode (an implementation may do so,
        # MPI-3.1 §3.4), as in the JAX package
        self.isend(buf, dest, tag, mode="standard", **kw).wait()

    def issend(self, buf, dest: int, tag: int = 0, **kw) -> Request:
        return self.isend(buf, dest, tag, mode="sync", **kw)

    def recv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             **kw) -> Status:
        return self.irecv(buf, source, tag, **kw).wait()

    def sendrecv(self, sendbuf, dest: int, sendtag: int,
                 recvbuf, source: int, recvtag: int,
                 send_count: Optional[int] = None,
                 send_datatype: Optional[Datatype] = None,
                 recv_count: Optional[int] = None,
                 recv_datatype: Optional[Datatype] = None) -> Status:
        rreq = self.irecv(recvbuf, source, recvtag, recv_count, recv_datatype)
        sreq = self.isend(sendbuf, dest, sendtag, send_count, send_datatype)
        st = rreq.wait()
        sreq.wait()
        return st

    def sendrecv_replace(self, buf, dest: int, sendtag: int, source: int,
                         recvtag: int) -> Status:
        tmp = np.array(buf, copy=True)
        return self.sendrecv(tmp, dest, sendtag, buf, source, recvtag)

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
        self._check()
        return self.u.protocol.probe(source, self.ctx_pt2pt, tag)

    def iprobe(self, source: int = ANY_SOURCE,
               tag: int = ANY_TAG) -> Optional[Status]:
        self._check()
        return self.u.protocol.iprobe(source, self.ctx_pt2pt, tag)

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check()
        return self.u.protocol.improbe(source, self.ctx_pt2pt, tag)

    def mrecv(self, message, buf, count: Optional[int] = None,
              datatype: Optional[Datatype] = None) -> Status:
        count, datatype = _resolve(buf, count, datatype)
        return self.u.protocol.mrecv(message, buf, count, datatype).wait()

    # persistent requests (MPI_Send_init / MPI_Recv_init / MPI_Start)
    def send_init(self, buf, dest: int, tag: int = 0, **kw) -> Request:
        req = Request(self.u.engine, "persistent-send")
        req.persistent = True

        def starter(r):
            i = self.isend(buf, dest, tag, **kw)
            # MPI_Cancel on the persistent handle cancels the active
            # communication, even one already locally complete
            r._cancel_override = True

            def pcancel():
                with self.u.engine.mutex:
                    r.complete_flag = False
                i.cancel()

                def redone(ireq):
                    r.status.cancelled = bool(ireq.cancelled
                                              or ireq.status.cancelled)
                    r.complete(ireq.error)
                i.add_callback(redone)
                return False
            r._cancel_fn = pcancel

            def done(ireq):
                r.status.cancelled = bool(ireq.cancelled
                                          or ireq.status.cancelled)
                r.complete(ireq.error)

            i.add_callback(done)

        req._start_fn = starter
        return req

    def recv_init(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                  **kw) -> Request:
        req = Request(self.u.engine, "persistent-recv")
        req.persistent = True

        def starter(r):
            i = self.irecv(buf, source, tag, **kw)
            r._cancel_fn = (lambda: (i.cancel(), False)[1]) \
                if not i.complete_flag else None

            def done(ireq):
                r.status = ireq.status
                r.status.cancelled = bool(ireq.cancelled
                                          or ireq.status.cancelled)
                r.complete(ireq.error)

            i.add_callback(done)

        req._start_fn = starter
        return req

    # -- persistent collectives (MPI_Allreduce_init and its kin, MPI-4) ----
    def _coll_init(self, kind: str, ifn, warm=None) -> Request:
        """A persistent collective's inactive request: every start()
        posts ``ifn()``, the nonblocking twin, and completes with it.
        ``warm`` runs once here: on the device channel it builds the
        call's programs and loads the kernels
        (``coll/device.py`` ``prewarm_persistent``). A start that rides
        the device NBC tier counts dev_persistent_starts."""
        req = Request(self.u.engine, f"persistent-{kind}")
        req.persistent = True
        if warm is not None:
            warm()

        def starter(r):
            i = ifn()
            if i.device_nbc:
                from .. import mpit
                mpit.pvar("dev_persistent_starts").inc()
            r._cancel_fn = None
            if not i.complete_flag:
                def pcancel():
                    try:
                        i.cancel()
                    except MPIException:
                        pass
                    return False
                r._cancel_fn = pcancel
            i.add_callback(lambda ireq: r.complete(ireq.error))

        req._start_fn = starter
        return req

    def _coll_warm(self, name: str, *a):
        """The device pre-warm of ``_coll_init`` (None without a device
        channel)."""
        if self.device_channel is None:
            return None
        from ..coll import device as _dev
        return lambda: _dev.prewarm_persistent(self, name, *a)

    def allreduce_init(self, sendbuf, recvbuf, op=None,
                       count: Optional[int] = None,
                       datatype: Optional[Datatype] = None) -> Request:
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return self._coll_init(
            "allreduce",
            lambda: self.iallreduce(sendbuf, recvbuf, op, count, datatype),
            self._coll_warm("allreduce", sendbuf, recvbuf, count, datatype,
                            op))

    def bcast_init(self, buf, root: int = 0, count: Optional[int] = None,
                   datatype: Optional[Datatype] = None) -> Request:
        self._check_root(root)
        count, datatype = _resolve(buf, count, datatype)
        return self._coll_init(
            "bcast", lambda: self.ibcast(buf, root, count, datatype),
            self._coll_warm("bcast", buf, count, datatype, root))

    def allgather_init(self, sendbuf, recvbuf, count: Optional[int] = None,
                       datatype: Optional[Datatype] = None) -> Request:
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return self._coll_init(
            "allgather",
            lambda: self.iallgather(sendbuf, recvbuf, count, datatype),
            self._coll_warm("allgather", sendbuf, recvbuf, count, datatype))

    def alltoall_init(self, sendbuf, recvbuf, count: Optional[int] = None,
                      datatype: Optional[Datatype] = None) -> Request:
        if count is None:
            count = _numel(sendbuf) // getattr(self, "remote_size", self.size)
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return self._coll_init(
            "alltoall",
            lambda: self.ialltoall(sendbuf, recvbuf, count, datatype),
            self._coll_warm("alltoall", sendbuf, recvbuf, count, datatype))

    def alltoallv_init(self, sendbuf, sendcounts, sdispls, recvbuf,
                       recvcounts, rdispls,
                       datatype: Optional[Datatype] = None) -> Request:
        _, datatype = _resolve(sendbuf, None, datatype, alt=recvbuf)
        sd = list(sdispls) if sdispls is not None else None
        rd = list(rdispls) if rdispls is not None else None
        return self._coll_init(
            "alltoallv",
            lambda: self.ialltoallv(sendbuf, sendcounts, sdispls, recvbuf,
                                    recvcounts, rdispls, datatype),
            self._coll_warm("alltoallv", sendbuf, list(sendcounts), sd,
                            recvbuf, list(recvcounts), rd, datatype))

    def reduce_init(self, sendbuf, recvbuf, op=None, root: int = 0,
                    count: Optional[int] = None,
                    datatype: Optional[Datatype] = None) -> Request:
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return self._coll_init(
            "reduce",
            lambda: self.ireduce(sendbuf, recvbuf, op, root, count,
                                 datatype))

    def barrier_init(self) -> Request:
        return self._coll_init("barrier", lambda: self.ibarrier())

    # ------------------------------------------------------------------
    # collectives: dispatch through coll_fns
    # ------------------------------------------------------------------
    def _coll(self, name: str):
        if not self.coll_fns:
            from ..coll.tuning import install_coll_ops
            install_coll_ops(self)
        return self.coll_fns[name]

    def _stage_if_unbound(self, sendbuf, recvbuf):
        """A CPU tensor sendbuf on a comm with no device channel is read
        as numpy (the result comes back as numpy), as the JAX package
        stages a device array. A tensor on the card raises: such a comm
        (COMM_SELF, a comm whose members' geometry binds no channel, any
        comm under a mesh whose shape does not fit the ranks, or a
        process-mode rank's) has no device path, and its host tier does
        not move the tensor to the host and back. A tensor recvbuf needs
        the device-bound path. A comm made by dup, create or split of a
        bound comm (``coll/device.py`` ``bind_derived``) runs a tensor on
        its channel and treats a call with no tensor to run as a comm
        with no channel would."""
        ch = self.device_channel
        eff = recvbuf if _is_in_place(sendbuf) else sendbuf
        if ch is not None and (not ch.derived or _is_device(eff)):
            return sendbuf, recvbuf
        for b in (sendbuf, recvbuf):
            if on_card(b):
                why = self.unbound_why or "no device channel is bound to it"
                raise NotImplementedError(
                    f"communicator {self.name or self.context_id} has no "
                    f"device channel ({why}); a tensor on {b.device} is "
                    f"not moved to the host")
        if _is_device(recvbuf):
            raise MPIException(
                MPI_ERR_COMM, "a tensor recvbuf requires a communicator "
                "bound to a device channel (see coll/device.py)")
        if _is_device(sendbuf):
            sendbuf = to_host(sendbuf)
        return sendbuf, recvbuf

    def barrier(self) -> None:
        self._check()
        self._coll("barrier")(self)

    def bcast(self, buf, root: int = 0, count: Optional[int] = None,
              datatype: Optional[Datatype] = None):
        self._check()
        self._check_root(root)
        count, datatype = _resolve(buf, count, datatype)
        staged, _ = self._stage_if_unbound(buf, None)
        ret = self._coll("bcast")(self, staged, count, datatype, root)
        if ret is not None:
            return ret
        return staged if staged is not buf else buf

    def reduce(self, sendbuf, recvbuf=None, op=None, root: int = 0,
               count: Optional[int] = None,
               datatype: Optional[Datatype] = None):
        self._check()
        self._check_root(root)
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None and self.rank == root and not _is_device(sendbuf):
            recvbuf = _result_like(sendbuf)
        ret = self._coll("reduce")(self, sendbuf, recvbuf, count, datatype,
                                   op, root)
        return ret if ret is not None else recvbuf

    def allreduce(self, sendbuf, recvbuf=None, op=None,
                  count: Optional[int] = None,
                  datatype: Optional[Datatype] = None):
        self._check()
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None and not _is_device(sendbuf):
            recvbuf = _result_like(sendbuf)
        ret = self._coll("allreduce")(self, sendbuf, recvbuf, count,
                                      datatype, op)
        return ret if ret is not None else recvbuf

    def allgather(self, sendbuf, recvbuf=None, count: Optional[int] = None,
                  datatype: Optional[Datatype] = None):
        self._check()
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if _is_in_place(sendbuf):
            count = _numel(recvbuf) // self.size
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None and not _is_device(sendbuf):
            sb = np.asarray(sendbuf)
            recvbuf = np.empty((self.size * count,), dtype=sb.dtype)
        ret = self._coll("allgather")(self, sendbuf, recvbuf, count,
                                      datatype)
        return ret if ret is not None else recvbuf

    def gather(self, sendbuf, recvbuf=None, root: int = 0,
               count: Optional[int] = None,
               datatype: Optional[Datatype] = None):
        self._check()
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if recvbuf is None and self.rank == root:
            sb = np.asarray(sendbuf)
            recvbuf = np.empty((self.size * count,), dtype=sb.dtype)
        self._coll("gather")(self, sendbuf, recvbuf, count, datatype, root)
        return recvbuf

    def scatter(self, sendbuf, recvbuf, root: int = 0,
                count: Optional[int] = None,
                datatype: Optional[Datatype] = None):
        self._check()
        count, datatype = _resolve(recvbuf, count, datatype)
        self._coll("scatter")(self, sendbuf, recvbuf, count, datatype, root)
        return recvbuf

    def alltoall(self, sendbuf, recvbuf=None, count: Optional[int] = None,
                 datatype: Optional[Datatype] = None):
        self._check()
        if count is None:
            sb = recvbuf if _is_in_place(sendbuf) else sendbuf
            count = _numel(sb) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None and not _is_device(sendbuf):
            recvbuf = np.empty_like(np.asarray(sendbuf))
        ret = self._coll("alltoall")(self, sendbuf, recvbuf, count, datatype)
        return ret if ret is not None else recvbuf

    def reduce_scatter_block(self, sendbuf, recvbuf=None, op=None,
                             count: Optional[int] = None,
                             datatype: Optional[Datatype] = None):
        self._check()
        op = op or opmod.SUM
        if count is None:
            sb = recvbuf if _is_in_place(sendbuf) else sendbuf
            count = _numel(sb) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None and not _is_device(sendbuf):
            sb = np.asarray(sendbuf)
            recvbuf = _result_like(sb, count)
        ret = self._coll("reduce_scatter_block")(self, sendbuf, recvbuf,
                                                 count, datatype, op)
        return ret if ret is not None else recvbuf

    def reduce_scatter(self, sendbuf, recvbuf=None, counts=None, op=None,
                       datatype: Optional[Datatype] = None):
        """Irregular-counts reduce_scatter (MPI-3.1 §5.10)."""
        self._check()
        op = op or opmod.SUM
        if counts is None:
            sb = recvbuf if _is_in_place(sendbuf) else sendbuf
            n = _numel(sb) // self.size
            counts = [n] * self.size
        _, datatype = _resolve(sendbuf, None, datatype, alt=recvbuf)
        if recvbuf is None:
            sb = np.asarray(sendbuf)
            recvbuf = _result_like(sb, list(counts)[self.rank])
        self._coll("reduce_scatter")(self, sendbuf, recvbuf,
                                     list(counts), datatype, op)
        return recvbuf

    def scan(self, sendbuf, recvbuf=None, op=None,
             count: Optional[int] = None,
             datatype: Optional[Datatype] = None):
        self._check()
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if recvbuf is None:
            recvbuf = _result_like(sendbuf)
        self._coll("scan")(self, sendbuf, recvbuf, count, datatype, op)
        return recvbuf

    def exscan(self, sendbuf, recvbuf=None, op=None,
               count: Optional[int] = None,
               datatype: Optional[Datatype] = None):
        self._check()
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if recvbuf is None:
            recvbuf = _result_like(sendbuf)
        self._coll("exscan")(self, sendbuf, recvbuf, count, datatype, op)
        return recvbuf

    def allgatherv(self, sendbuf, recvbuf, counts: Sequence[int],
                   displs: Optional[Sequence[int]] = None,
                   datatype: Optional[Datatype] = None):
        self._check()
        _, datatype = _resolve(sendbuf, None, datatype)
        self._coll("allgatherv")(self, sendbuf, recvbuf, list(counts),
                                 list(displs) if displs is not None else None,
                                 datatype)
        return recvbuf

    def alltoallv(self, sendbuf, sendcounts, sdispls, recvbuf, recvcounts,
                  rdispls, datatype: Optional[Datatype] = None):
        """Variable-count alltoall: ``sendcounts[j]`` elements from
        ``sdispls[j]`` of ``sendbuf`` go to rank j, whose payload for
        this rank lands at ``rdispls[j]``. Displacements of ``None`` are
        dense (the JAX package requires them). A numpy ``recvbuf``
        (allocated when absent and ``sendbuf`` is numpy) is filled and
        returned; with a tensor ``sendbuf`` on the device channel the
        result tensor is returned."""
        self._check()
        _, datatype = _resolve(sendbuf, None, datatype, alt=recvbuf)
        scounts = [int(c) for c in sendcounts]
        rcounts = [int(c) for c in recvcounts]
        if len(scounts) != self.size or len(rcounts) != self.size:
            raise MPIException(MPI_ERR_COUNT, f"alltoallv needs {self.size} "
                               f"send and receive counts")
        if recvbuf is None and not _is_device(sendbuf) \
                and not _is_in_place(sendbuf):
            ext = sum(rcounts) if rdispls is None else max(
                int(rdispls[j]) + rcounts[j] for j in range(self.size))
            recvbuf = np.zeros((ext,), dtype=np.asarray(sendbuf).dtype)
        ret = self._coll("alltoallv")(
            self, sendbuf, scounts,
            [int(d) for d in sdispls] if sdispls is not None
            else _dense(scounts), recvbuf, rcounts,
            [int(d) for d in rdispls] if rdispls is not None
            else _dense(rcounts), datatype)
        return ret if ret is not None else recvbuf

    def gatherv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0,
                datatype: Optional[Datatype] = None):
        self._check()
        _, datatype = _resolve(sendbuf, None, datatype)
        self._coll("gatherv")(self, sendbuf, recvbuf, list(counts),
                              list(displs) if displs is not None else None,
                              datatype, root)
        return recvbuf

    def scatterv(self, sendbuf, counts, displs, recvbuf, root: int = 0,
                 datatype: Optional[Datatype] = None):
        self._check()
        _, datatype = _resolve(recvbuf, None, datatype)
        self._coll("scatterv")(self, sendbuf,
                               list(counts) if counts is not None else None,
                               list(displs) if displs is not None else None,
                               recvbuf, datatype, root)
        return recvbuf

    # -- nonblocking collectives (coll/nonblocking.py) --------------------
    def ibarrier(self) -> Request:
        from ..coll import nonblocking as nb
        return nb.ibarrier(self)

    def ibcast(self, buf, root: int = 0, count: Optional[int] = None,
               datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        self._check_root(root)
        count, datatype = _resolve(buf, count, datatype)
        return nb.ibcast(self, buf, count, datatype, root)

    def iallreduce(self, sendbuf, recvbuf, op=None,
                   count: Optional[int] = None,
                   datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.iallreduce(self, sendbuf, recvbuf, count, datatype, op)

    def iallgather(self, sendbuf, recvbuf, count: Optional[int] = None,
                   datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if _is_in_place(sendbuf):
            count = _numel(recvbuf) // self.size
        return nb.iallgather(self, sendbuf, recvbuf, count, datatype)

    def ialltoall(self, sendbuf, recvbuf, count: Optional[int] = None,
                  datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        if count is None:
            # an intercomm's blocks address the remote group (MPI-3.1 §5.8)
            sb = recvbuf if _is_in_place(sendbuf) else sendbuf
            count = _numel(sb) // getattr(self, "remote_size", self.size)
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.ialltoall(self, sendbuf, recvbuf, count, datatype)

    def ireduce(self, sendbuf, recvbuf, op=None, root: int = 0,
                count: Optional[int] = None,
                datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.ireduce(self, sendbuf, recvbuf, count, datatype, op, root)

    def iscan(self, sendbuf, recvbuf, op=None,
              count: Optional[int] = None,
              datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.iscan(self, sendbuf, recvbuf, count, datatype, op)

    def iexscan(self, sendbuf, recvbuf, op=None,
                count: Optional[int] = None,
                datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.iexscan(self, sendbuf, recvbuf, count, datatype, op)

    def igather(self, sendbuf, recvbuf=None, root: int = 0,
                count: Optional[int] = None,
                datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.igather(self, sendbuf, recvbuf, count, datatype, root)

    def iscatter(self, sendbuf, recvbuf, root: int = 0,
                 count: Optional[int] = None,
                 datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        count, datatype = _resolve(recvbuf, count, datatype)
        return nb.iscatter(self, sendbuf, recvbuf, count, datatype, root)

    def igatherv(self, sendbuf, recvbuf, counts, displs=None,
                 root: int = 0,
                 datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        _, datatype = _resolve(sendbuf, None, datatype)
        sendcount = _numel(sendbuf)
        return nb.igatherv(self, sendbuf, sendcount, recvbuf,
                           list(counts) if counts is not None else None,
                           list(displs) if displs is not None else None,
                           datatype, root)

    def iscatterv(self, sendbuf, counts, displs, recvbuf,
                  root: int = 0,
                  datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        _, datatype = _resolve(recvbuf, None, datatype)
        recvcount = _numel(recvbuf) if recvbuf is not None else 0
        return nb.iscatterv(self, sendbuf,
                            list(counts) if counts is not None else None,
                            list(displs) if displs is not None else None,
                            recvbuf, recvcount, datatype, root)

    def iallgatherv(self, sendbuf, recvbuf, counts, displs=None,
                    datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        _, datatype = _resolve(sendbuf, None, datatype)
        sendcount = _numel(sendbuf)
        return nb.iallgatherv(self, sendbuf, sendcount, recvbuf,
                              list(counts),
                              list(displs) if displs is not None
                              else None, datatype)

    def ialltoallv(self, sendbuf, sendcounts, sdispls, recvbuf, recvcounts,
                   rdispls, datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        _, datatype = _resolve(sendbuf, None, datatype, alt=recvbuf)
        scounts = [int(c) for c in sendcounts]
        rcounts = [int(c) for c in recvcounts]
        if len(scounts) != self.size or len(rcounts) != self.size:
            raise MPIException(MPI_ERR_COUNT, f"ialltoallv needs "
                               f"{self.size} send and receive counts")
        return nb.ialltoallv(
            self, sendbuf, scounts,
            list(sdispls) if sdispls is not None else None, recvbuf,
            rcounts, list(rdispls) if rdispls is not None else None,
            datatype)

    def ireduce_scatter(self, sendbuf, recvbuf, counts, op=None,
                        datatype: Optional[Datatype] = None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        _, datatype = _resolve(sendbuf, None, datatype)
        return nb.ireduce_scatter(self, sendbuf, recvbuf, list(counts),
                                  datatype, op)

    def ireduce_scatter_block(self, sendbuf, recvbuf, op=None,
                              count: Optional[int] = None,
                              datatype: Optional[Datatype] = None
                              ) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        if count is None:
            sb = recvbuf if _is_in_place(sendbuf) else sendbuf
            count = _numel(sb) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.ireduce_scatter_block(self, sendbuf, recvbuf, count,
                                        datatype, op)

    # ------------------------------------------------------------------
    # communicator management
    # ------------------------------------------------------------------
    def _derive(self, comm: "Comm") -> "Comm":
        """A new comm's device channel, by its members' geometry, when
        the run bound one (``coll/device.py`` ``bind_derived``)."""
        if getattr(self.u, "device_binding", None) is not None:
            from ..coll.device import bind_derived
            bind_derived(comm)
        return comm

    def dup(self) -> "Comm":
        self._check()
        ctx = self.u.allocate_context_id(self)
        new = self._derive(Comm(self.u, self.group, ctx, self.name + "_dup"))
        self.attrs.copy_all(self, new.attrs)
        new.topo = self.topo
        return new

    def create(self, group: Group) -> Optional["Comm"]:
        """MPI_Comm_create: collective over self; None for non-members."""
        self._check()
        # the group must be a subset of this comm's group (MPI-3.1
        # §6.4.2), checked before the context collective so every member
        # reaches the same verdict
        mine = {self.group.world_of_rank(r)
                for r in range(self.group.size)}
        for r in range(group.size):
            if group.world_of_rank(r) not in mine:
                raise MPIException(
                    MPI_ERR_GROUP,
                    "Comm_create group is not a subset of the "
                    "communicator's group")
        ctx = self.u.allocate_context_id(self)
        if group.rank_of_world(self.u.world_rank) == UNDEFINED:
            # a non-member hands the id straight back
            self.u.release_context_id(ctx)
            return None
        return self._derive(Comm(self.u, group, ctx,
                                 self.name + "_create"))

    def create_group(self, group: Group, tag: int = 0) -> Optional["Comm"]:
        """MPI_Comm_create_group: collective only over ``group``'s members
        (MPI-3.1 §6.4.2); a non-member returns None at once. The members
        agree on a context id by a binomial AND-reduce of their masks
        and a binomial bcast, over this comm's point-to-point with
        ``tag`` (the standard's contract: the parent's tag space carries
        the internal traffic), carrying the guarded payload
        (``Universe.ctx_payload``) so an agreement of another thread of
        the process forces a retry of all members instead of a
        duplicate id. Disjoint groups may agree on equal ids at once:
        matching keys are (context, source, tag) and their member sets
        are disjoint, so their traffic never meets, and their device
        rendezvous keys name their members (``bind_derived``)."""
        self._check()
        me = group.rank_of_world(self.u.world_rank)
        if me == UNDEFINED:
            return None
        m = group.size
        name = self.name + "_create_group"
        if m == 1:
            # single member: no agreement (see alloc_context_local)
            return self._derive(Comm(self.u, group,
                                     self.u.alloc_context_local(), name))
        parent_of = {g: self.group.rank_of_world(group.world_of_rank(g))
                     for g in range(m)}
        key = (self.context_id, tag)
        while True:
            val, own = self.u.ctx_payload(key)
            try:
                other = np.empty_like(val)
                # binomial reduce (bitwise AND) to group rank 0
                mask = 1
                while mask < m:
                    if me & mask:
                        self.send(val, parent_of[me & ~mask], tag)
                        break
                    partner = me | mask
                    if partner < m:
                        self.recv(other, parent_of[partner], tag)
                        val &= other
                    mask <<= 1
                # binomial bcast of the agreed payload from group rank 0
                mask = 1
                while mask < m:
                    if me & mask:
                        self.recv(val, parent_of[me - mask], tag)
                        break
                    mask <<= 1
                mask >>= 1
                while mask > 0:
                    if me + mask < m:
                        self.send(val, parent_of[me + mask], tag)
                    mask >>= 1
            except BaseException:
                self.u.ctx_release(own, key, done=True)
                raise
            ctx = self.u.ctx_resolve(val, own, key)
            if ctx >= 0:
                break
            time.sleep(0.0002)   # let the mask-holding thread finish
        return self._derive(Comm(self.u, group, ctx, name))

    def split(self, color: int, key: int = 0) -> Optional["Comm"]:
        """MPI_Comm_split: allgather the (color, key, world rank) triples,
        then agree on a context id (the JAX package's stepped path)."""
        self._check()
        my_color = int(color) if color is not None else UNDEFINED
        mine = np.array([my_color, key, self.u.world_rank],
                        dtype=np.int64)
        if self.size == 1:
            # single member: no agreement (see alloc_context_local)
            if my_color == UNDEFINED:
                return None
            return self._derive(Comm(self.u, Group([self.u.world_rank]),
                                     self.u.alloc_context_local(),
                                     f"{self.name}_split"))
        allv = np.empty(3 * self.size, dtype=np.int64)
        self.allgather(mine, allv, count=3)
        ctx = self.u.allocate_context_id(self)
        if my_color == UNDEFINED:
            # UNDEFINED color burns no budget (see create())
            self.u.release_context_id(ctx)
            return None
        members = []
        for r in range(self.size):
            c, k, wr = (int(allv[3 * r]), int(allv[3 * r + 1]),
                        int(allv[3 * r + 2]))
            if c == my_color:
                members.append((k, r, wr))   # sort by key, then comm rank
        members.sort()
        return self._derive(Comm(self.u, Group([wr for _, _, wr in members]),
                                 ctx, f"{self.name}_split"))

    def split_type_shared(self, key: int = 0) -> "Comm":
        """MPI_Comm_split_type(COMM_TYPE_SHARED): ranks on my node."""
        return self.split(self.u.node_ids[self.u.world_rank], key)

    def compare(self, other: "Comm") -> str:
        if self is other:
            return "ident"
        g = self.group.compare(other.group)
        if g == "ident":
            return "congruent"
        return g

    def free(self) -> None:
        if self.freed:
            return
        # the delete callbacks first: the comm still works inside them
        self.attrs.delete_all(self)
        if self.device_channel is not None:
            self.device_channel.release()
        self.u.comms_by_ctx.pop(self.context_id, None)
        # a mask-allocated context id returns to the pool, so dup/free
        # loops never exhaust the budget
        self.u.release_context_id(self.context_id)
        self.freed = True

    def build_2level(self) -> Tuple[Optional["Comm"], Optional["Comm"]]:
        """(shmem_comm, leader_comm): the ranks of my node, and the lowest
        rank of each node (None on non-leaders)."""
        if self._twolevel_ready:
            return self._shmem_comm, self._leader_comm
        node_of_me = self.u.node_ids[self.u.world_rank]
        shmem = self.split(node_of_me, self.rank)
        am_leader = shmem.rank == 0
        leader = self.split(0 if am_leader else None, self.rank)
        self._shmem_comm = shmem
        self._leader_comm = leader if am_leader else None
        self._twolevel_ready = True
        return self._shmem_comm, self._leader_comm

    # ------------------------------------------------------------------
    # topologies (core/topo.py)
    # ------------------------------------------------------------------
    def cart_create(self, dims, periods=None, reorder: bool = False):
        from . import topo as _topo
        if periods is None:
            periods = [False] * len(dims)
        return _topo.cart_create(self, dims, periods, reorder)

    def graph_create(self, index, edges, reorder: bool = False):
        from . import topo as _topo
        return _topo.graph_create(self, index, edges, reorder)

    def dist_graph_create_adjacent(self, sources, destinations,
                                   sweights=None, dweights=None,
                                   reorder: bool = False):
        from . import topo as _topo
        return _topo.dist_graph_create_adjacent(self, sources, destinations,
                                                sweights, dweights, reorder)

    def dist_graph_create(self, sources, degrees, destinations,
                          weights=None, reorder: bool = False):
        from . import topo as _topo
        return _topo.dist_graph_create(self, sources, degrees,
                                       destinations, weights, reorder)

    def topo_test(self) -> str:
        from . import topo as _topo
        return _topo.topo_test(self)

    def cart_coords(self, rank: Optional[int] = None):
        from . import topo as _topo
        t = _topo._cart(self)
        return t.coords_of(self.rank if rank is None else rank)

    def cart_rank(self, coords) -> int:
        from . import topo as _topo
        return _topo._cart(self).rank_of(coords)

    def cart_get(self):
        from . import topo as _topo
        t = _topo._cart(self)
        return list(t.dims), list(t.periods), t.coords_of(self.rank)

    def cartdim_get(self) -> int:
        from . import topo as _topo
        return _topo._cart(self).ndims

    def cart_shift(self, direction: int, disp: int = 1):
        from . import topo as _topo
        return _topo.cart_shift(self, direction, disp)

    def cart_sub(self, remain_dims):
        from . import topo as _topo
        return _topo.cart_sub(self, remain_dims)

    def graph_neighbors(self, rank: Optional[int] = None):
        if self.topo is None:
            raise MPIException(MPI_ERR_TOPOLOGY, "no topology")
        return self.topo.neighbors_of(self.rank if rank is None else rank)

    def dist_graph_neighbors(self):
        """(sources, destinations) of a dist-graph comm."""
        from . import topo as _topo
        if not isinstance(self.topo, _topo.DistGraphTopology):
            raise MPIException(MPI_ERR_TOPOLOGY,
                               "not a distributed-graph communicator")
        return (list(self.topo.sources), list(self.topo.destinations))

    def neighbor_allgather(self, sendbuf, recvbuf, count=None, datatype=None):
        from . import topo as _topo
        _topo.neighbor_allgather(self, sendbuf, recvbuf, count, datatype)

    def neighbor_alltoall(self, sendbuf, recvbuf, count=None, datatype=None):
        from . import topo as _topo
        _topo.neighbor_alltoall(self, sendbuf, recvbuf, count, datatype)

    def neighbor_alltoallv(self, sendbuf, sendcounts, sdispls, recvbuf,
                           recvcounts, rdispls, datatype=None):
        from . import topo as _topo
        _topo.neighbor_alltoallv(self, sendbuf, sendcounts, sdispls, recvbuf,
                                 recvcounts, rdispls, datatype)

    # ------------------------------------------------------------------
    # -- one-sided host windows (rma/win.py) -------------------------------
    def win_create(self, buf, disp_unit: int = 1):
        from ..rma import win as _rw
        return _rw.win_create(self, buf, disp_unit)

    def win_allocate(self, size: int, disp_unit: int = 1):
        from ..rma import win as _rw
        return _rw.win_allocate(self, size, disp_unit)

    def win_allocate_shared(self, size: int, disp_unit: int = 1):
        from ..rma import win as _rw
        return _rw.win_allocate_shared(self, size, disp_unit)

    def win_create_dynamic(self):
        from ..rma import win as _rw
        return _rw.win_create_dynamic(self)

    def set_name(self, name: str) -> None:
        self.name = name

    def get_name(self) -> str:
        return self.name

    def __repr__(self):
        return (f"Comm({self.name or 'anon'}, rank={self.rank}/{self.size}, "
                f"ctx={self.context_id})")


def _dense(counts) -> list:
    out, acc = [], 0
    for c in counts:
        out.append(acc)
        acc += int(c)
    return out
