"""The communicator's collective surface (counterpart of the JAX
package's ``core/comm.py``), for the seven collectives the device
channels run, with the JAX package's signatures (alltoallv runs on the
1:1 mesh channel only), their nonblocking twins (``i*``: ibcast,
iallreduce, iallgather, ialltoall and ialltoallv on the 1:1 mesh
channel's device NBC tier, ``coll/nonblocking.py``) and the persistent
collectives (``*_init``, MPI-4), whose request re-posts the ``i*`` twin
on every ``start()``.

Counts come from the buffer's element count and the element type from
its dtype (a numpy array's or a tensor's); ``datatype``, where given,
must name that dtype. Derived datatypes are not ported.

Buffers: a numpy ``recvbuf`` is filled in place (device-to-host copy)
and returned. With a tensor ``sendbuf`` the result tensor is returned;
for allreduce/reduce/bcast every rank is handed the same shared tensor,
which must not be written in place. A nonblocking call needs a numpy
``recvbuf`` (``ibcast``: a numpy ``buf``), filled when its request
completes; its ``sendbuf`` may be a tensor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import op as opmod
from .errors import MPI_ERR_COUNT, MPI_ERR_ROOT, MPI_ERR_TYPE, MPIException
from .request import Request


class _InPlace:
    """The MPI_IN_PLACE sentinel."""

    def __repr__(self):
        return "MPI_IN_PLACE"


IN_PLACE = _InPlace()


def _is_device(buf) -> bool:
    return isinstance(buf, torch.Tensor)


def _numel(buf) -> int:
    return buf.numel() if _is_device(buf) else int(np.asarray(buf).size)


def _resolve(buf, count: Optional[int], datatype, alt=None):
    """(count, datatype) of a buffer: the element count and dtype of
    ``buf`` (or of ``alt`` when ``buf`` is MPI_IN_PLACE)."""
    b = alt if isinstance(buf, _InPlace) else buf
    dtype = b.dtype if _is_device(b) else np.asarray(b).dtype
    if datatype is not None and datatype != dtype:
        raise MPIException(MPI_ERR_TYPE, f"datatype {datatype!r} does not "
                           f"match the buffer's dtype {dtype}")
    return (_numel(b) if count is None else int(count)), dtype


class Comm:
    """One rank's communicator: ``rank``, ``size``, the device channel it
    is bound to, its collective table ``coll_fns`` (filled by
    ``coll.device.install_device_coll``), and ``u``, the rank's
    ``Universe`` (its recorder is ``u.tracer``; None outside one)."""

    def __init__(self, rank: int, size: int, universe=None):
        self.rank = rank
        self.size = size
        self.u = universe
        self.device_channel = None
        self.coll_fns = {}

    def _coll(self, name: str):
        fn = self.coll_fns.get(name)
        if fn is None:
            raise NotImplementedError(
                f"{name} on a communicator with no device channel: the "
                f"host collective tier is not ported")
        return fn

    def _check_root(self, root: int) -> None:
        if not 0 <= root < self.size:
            raise MPIException(MPI_ERR_ROOT, f"bad root {root} for a "
                               f"communicator of size {self.size}")

    def bcast(self, buf, root: int = 0, count: Optional[int] = None,
              datatype=None):
        self._check_root(root)
        count, datatype = _resolve(buf, count, datatype)
        ret = self._coll("bcast")(self, buf, count, datatype, root)
        return ret if ret is not None else buf

    def reduce(self, sendbuf, recvbuf=None, op=None, root: int = 0,
               count: Optional[int] = None, datatype=None):
        self._check_root(root)
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if recvbuf is None and self.rank == root and not _is_device(sendbuf):
            recvbuf = np.empty_like(np.asarray(sendbuf))
        ret = self._coll("reduce")(self, sendbuf, recvbuf, count, datatype,
                                   op, root)
        return ret if ret is not None else recvbuf

    def allreduce(self, sendbuf, recvbuf=None, op=None,
                  count: Optional[int] = None, datatype=None):
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if recvbuf is None and not _is_device(sendbuf):
            recvbuf = np.empty_like(np.asarray(sendbuf))
        ret = self._coll("allreduce")(self, sendbuf, recvbuf, count,
                                      datatype, op)
        return ret if ret is not None else recvbuf

    def allgather(self, sendbuf, recvbuf=None, count: Optional[int] = None,
                  datatype=None):
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if isinstance(sendbuf, _InPlace):
            count = _numel(recvbuf) // self.size
        if recvbuf is None and not _is_device(sendbuf):
            sb = np.asarray(sendbuf)
            recvbuf = np.empty((self.size * count,), dtype=sb.dtype)
        ret = self._coll("allgather")(self, sendbuf, recvbuf, count,
                                      datatype)
        return ret if ret is not None else recvbuf

    def alltoall(self, sendbuf, recvbuf=None, count: Optional[int] = None,
                 datatype=None):
        if count is None:
            sb = recvbuf if isinstance(sendbuf, _InPlace) else sendbuf
            count = _numel(sb) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if recvbuf is None and not _is_device(sendbuf):
            recvbuf = np.empty_like(np.asarray(sendbuf))
        ret = self._coll("alltoall")(self, sendbuf, recvbuf, count, datatype)
        return ret if ret is not None else recvbuf

    def alltoallv(self, sendbuf, sendcounts, sdispls, recvbuf, recvcounts,
                  rdispls, datatype=None):
        """Variable-count alltoall: ``sendcounts[j]`` elements from
        ``sdispls[j]`` of ``sendbuf`` go to rank j, whose payload for
        this rank lands at ``rdispls[j]``. Displacements of ``None`` are
        dense. A numpy ``recvbuf`` (allocated when absent and
        ``sendbuf`` is numpy) is filled and returned; with a tensor
        ``sendbuf`` the result tensor is returned."""
        _, datatype = _resolve(sendbuf, None, datatype, alt=recvbuf)
        scounts = [int(c) for c in sendcounts]
        rcounts = [int(c) for c in recvcounts]
        if len(scounts) != self.size or len(rcounts) != self.size:
            raise MPIException(MPI_ERR_COUNT, f"alltoallv needs {self.size} "
                               f"send and receive counts")
        if recvbuf is None and not _is_device(sendbuf) \
                and not isinstance(sendbuf, _InPlace):
            ext = sum(rcounts) if rdispls is None else max(
                int(rdispls[j]) + rcounts[j] for j in range(self.size))
            recvbuf = np.zeros((ext,), dtype=np.asarray(sendbuf).dtype)
        ret = self._coll("alltoallv")(
            self, sendbuf, scounts,
            list(sdispls) if sdispls is not None else None, recvbuf,
            rcounts, list(rdispls) if rdispls is not None else None,
            datatype)
        return ret if ret is not None else recvbuf

    def reduce_scatter_block(self, sendbuf, recvbuf=None, op=None,
                             count: Optional[int] = None, datatype=None):
        op = op or opmod.SUM
        if count is None:
            sb = recvbuf if isinstance(sendbuf, _InPlace) else sendbuf
            count = _numel(sb) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if recvbuf is None and not _is_device(sendbuf):
            recvbuf = np.empty((count,), dtype=np.asarray(sendbuf).dtype)
        ret = self._coll("reduce_scatter_block")(self, sendbuf, recvbuf,
                                                 count, datatype, op)
        return ret if ret is not None else recvbuf

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
                    i.cancel()
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
                       datatype=None) -> Request:
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return self._coll_init(
            "allreduce",
            lambda: self.iallreduce(sendbuf, recvbuf, op, count, datatype),
            self._coll_warm("allreduce", sendbuf, recvbuf, count, datatype,
                            op))

    def bcast_init(self, buf, root: int = 0, count: Optional[int] = None,
                   datatype=None) -> Request:
        self._check_root(root)
        count, datatype = _resolve(buf, count, datatype)
        return self._coll_init(
            "bcast", lambda: self.ibcast(buf, root, count, datatype),
            self._coll_warm("bcast", buf, count, datatype, root))

    def allgather_init(self, sendbuf, recvbuf, count: Optional[int] = None,
                       datatype=None) -> Request:
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return self._coll_init(
            "allgather",
            lambda: self.iallgather(sendbuf, recvbuf, count, datatype),
            self._coll_warm("allgather", sendbuf, recvbuf, count, datatype))

    def alltoall_init(self, sendbuf, recvbuf, count: Optional[int] = None,
                      datatype=None) -> Request:
        if count is None:
            count = _numel(sendbuf) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return self._coll_init(
            "alltoall",
            lambda: self.ialltoall(sendbuf, recvbuf, count, datatype),
            self._coll_warm("alltoall", sendbuf, recvbuf, count, datatype))

    def alltoallv_init(self, sendbuf, sendcounts, sdispls, recvbuf,
                       recvcounts, rdispls, datatype=None) -> Request:
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
                    count: Optional[int] = None, datatype=None) -> Request:
        """Raises as ``ireduce`` does: the JAX package runs it on its host
        schedule."""
        return self.ireduce(sendbuf, recvbuf, op, root, count, datatype)

    def barrier_init(self) -> Request:
        """Raises as ``ibarrier`` does (the host schedule)."""
        return self.ibarrier()

    # -- nonblocking collectives (coll/nonblocking.py) --------------------
    def ibarrier(self) -> Request:
        from ..coll import nonblocking as nb
        return nb.ibarrier(self)

    def ibcast(self, buf, root: int = 0, count: Optional[int] = None,
               datatype=None) -> Request:
        from ..coll import nonblocking as nb
        self._check_root(root)
        count, datatype = _resolve(buf, count, datatype)
        return nb.ibcast(self, buf, count, datatype, root)

    def iallreduce(self, sendbuf, recvbuf, op=None,
                   count: Optional[int] = None, datatype=None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.iallreduce(self, sendbuf, recvbuf, count, datatype, op)

    def iallgather(self, sendbuf, recvbuf, count: Optional[int] = None,
                   datatype=None) -> Request:
        from ..coll import nonblocking as nb
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        if isinstance(sendbuf, _InPlace):
            count = _numel(recvbuf) // self.size
        return nb.iallgather(self, sendbuf, recvbuf, count, datatype)

    def ialltoall(self, sendbuf, recvbuf, count: Optional[int] = None,
                  datatype=None) -> Request:
        from ..coll import nonblocking as nb
        if count is None:
            sb = recvbuf if isinstance(sendbuf, _InPlace) else sendbuf
            count = _numel(sb) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.ialltoall(self, sendbuf, recvbuf, count, datatype)

    def ireduce(self, sendbuf, recvbuf, op=None, root: int = 0,
                count: Optional[int] = None, datatype=None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.ireduce(self, sendbuf, recvbuf, count, datatype, op, root)

    def ialltoallv(self, sendbuf, sendcounts, sdispls, recvbuf, recvcounts,
                   rdispls, datatype=None) -> Request:
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

    def ireduce_scatter_block(self, sendbuf, recvbuf, op=None,
                              count: Optional[int] = None,
                              datatype=None) -> Request:
        from ..coll import nonblocking as nb
        op = op or opmod.SUM
        if count is None:
            sb = recvbuf if isinstance(sendbuf, _InPlace) else sendbuf
            count = _numel(sb) // self.size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        return nb.ireduce_scatter_block(self, sendbuf, recvbuf, count,
                                        datatype, op)
