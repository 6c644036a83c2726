"""Nonblocking collectives (a trimmed copy of the JAX package's
``coll/nonblocking.py``): the device-tier routing of its i-collectives.

On a comm bound to the 1:1 mesh channel, ``ibcast``, ``iallreduce``,
``iallgather``, ``ialltoall`` and ``ialltoallv`` ride the device NBC tier
(``coll/device.py`` ``build_nonblocking_request``), as the JAX package
routes them. Where the JAX package builds its host schedule instead (a
call the channel cannot route, which counts ``dev_coll_fallback_nbc``; a
comm with no device channel; ``ireduce``, ``ireduce_scatter_block`` and
``ibarrier``, which always run there) the port raises
``NotImplementedError``: the host schedule is not ported.
"""

from __future__ import annotations

from ..core.request import Request

_HOST_NBC = "the host NBC schedule is not ported"


def _device_nbc(comm, name: str, *a) -> Request:
    """The device-tier request of ``i<name>``, or NotImplementedError
    where the JAX package builds its host schedule."""
    if comm.device_channel is None:
        raise NotImplementedError(
            f"i{name} on a communicator with no device channel: "
            f"{_HOST_NBC}")
    from . import device as _dev
    req = _dev.build_nonblocking_request(comm, name, *a)
    if req is None:
        raise NotImplementedError(
            f"i{name}: the call does not route to the device tier (the "
            f"slot or fold channel, MPI_IN_PLACE, a missing or tensor "
            f"recvbuf, a dtype or op that does not lower, or a host-tier "
            f"size); {_HOST_NBC}")
    return req


def _host_only(name: str):
    raise NotImplementedError(
        f"{name} runs on the host NBC schedule in the JAX package; "
        f"{_HOST_NBC}")


def ibarrier(comm) -> Request:
    _host_only("ibarrier")


def ibcast(comm, buf, count: int, datatype, root: int) -> Request:
    return _device_nbc(comm, "bcast", buf, count, datatype, root)


def iallreduce(comm, sendbuf, recvbuf, count: int, datatype, op) -> Request:
    return _device_nbc(comm, "allreduce", sendbuf, recvbuf, count,
                       datatype, op)


def iallgather(comm, sendbuf, recvbuf, count: int, datatype) -> Request:
    return _device_nbc(comm, "allgather", sendbuf, recvbuf, count,
                       datatype)


def ialltoall(comm, sendbuf, recvbuf, count: int, datatype) -> Request:
    return _device_nbc(comm, "alltoall", sendbuf, recvbuf, count,
                       datatype)


def ireduce(comm, sendbuf, recvbuf, count: int, datatype, op,
            root: int) -> Request:
    _host_only("ireduce")


def ialltoallv(comm, sendbuf, scounts, sdispls, recvbuf, rcounts,
               rdispls, datatype) -> Request:
    return _device_nbc(comm, "alltoallv", sendbuf, scounts, sdispls,
                       recvbuf, rcounts, rdispls, datatype)


def ireduce_scatter_block(comm, sendbuf, recvbuf, count: int, datatype,
                          op) -> Request:
    _host_only("ireduce_scatter_block")
