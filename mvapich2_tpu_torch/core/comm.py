"""The communicator's collective surface (counterpart of the JAX
package's ``core/comm.py``), for the seven collectives the device
channels run, with the JAX package's signatures (alltoallv runs on the
1:1 mesh channel only).

Counts come from the buffer's element count and the element type from
its dtype (a numpy array's or a tensor's); ``datatype``, where given,
must name that dtype. Derived datatypes are not ported.

Buffers: a numpy ``recvbuf`` is filled in place (device-to-host copy)
and returned. With a tensor ``sendbuf`` the result tensor is returned;
for allreduce/reduce/bcast every rank is handed the same shared tensor,
which must not be written in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import op as opmod
from .errors import MPI_ERR_COUNT, MPI_ERR_ROOT, MPI_ERR_TYPE, MPIException


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
    is bound to, and its collective table ``coll_fns`` (filled by
    ``coll.device.install_device_coll``)."""

    def __init__(self, rank: int, size: int):
        self.rank = rank
        self.size = size
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
