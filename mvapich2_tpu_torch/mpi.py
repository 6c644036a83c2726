"""The MPI-flavored top-level surface (a trimmed copy of the JAX package's
``mpi.py``).

* Process mode: ``mpi.Init()`` under ``mpirun`` (``python -m
  mvapich2_tpu_torch.run -np N python prog.py``; the environment carries
  the rank, the size and the KVS address) runs the light boot and the
  world build (``runtime/boot.py``, ``runtime/bootstrap.py``) and binds
  the universe to the process; without ``mpirun`` it builds a singleton.
* Rank threads (``run_ranks``, ``mpirun --vpod``): each thread's
  universe is already bound, and ``Init`` returns at once.

``COMM_WORLD`` and ``COMM_SELF`` resolve at each access to the calling
thread's universe, else the process's. ``Abort`` publishes the abort on
the job's KVS (the launcher kills every rank and exits with the code)
and exits.

Dynamic processes (``runtime/spawn.py``, ``runtime/nameserv.py``):
``Comm_spawn`` and ``Comm_spawn_multiple`` (a program in process mode, a
callable with rank threads), ``Comm_get_parent``, ``Get_appnum``, the
ports (``Open_port``, ``Close_port``, ``Comm_accept``,
``Comm_connect``) and the name service (``Publish_name``,
``Lookup_name``, ``Unpublish_name``); intercommunicators
(``Intercomm_create``, ``Intercomm_merge``, ``core/intercomm.py``).
``Comm_join`` (a socket handshake between two jobs) raises
MPI_ERR_OTHER, as the JAX package's record of it says. MPI-IO waits
with its tier.
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np

from .coll.api import IN_PLACE
from .core import datatype as _dt
from .core import op as _op
from .core.comm import Comm
from .core.errors import MPI_ERR_OTHER, MPIException
from .core.request import (testall, testany, testsome, waitall, waitany,
                           waitsome)
from .core.status import (ANY_SOURCE, ANY_TAG, PROC_NULL, ROOT, UNDEFINED,
                          Status)
from .runtime import universe as _uni
from .version import version_string

# thread support levels
THREAD_SINGLE = 0
THREAD_FUNNELED = 1
THREAD_SERIALIZED = 2
THREAD_MULTIPLE = 3

_provided_level = THREAD_SERIALIZED


def Init(required: int = THREAD_SINGLE) -> int:
    """Initialize process-mode MPI; returns the thread level provided. A
    no-op where a universe is already bound (a rank thread)."""
    u = _uni.current_universe()
    if u is not None and u.initialized:
        return min(required, _provided_level)
    from .runtime.bootstrap import bootstrap_from_env
    from .utils import timestamps as ts
    with ts.phase("MPI_Init"):
        u = bootstrap_from_env()
        _uni.set_universe(u, process_wide=True)
    if u.world_rank == 0:
        ts.print_timestamps()
    return min(required, _provided_level)


Init_thread = Init


def Initialized() -> bool:
    u = _uni.current_universe()
    return u is not None and u.initialized


def Finalized() -> bool:
    u = _uni.current_universe()
    return u is not None and u.finalized


def Finalize() -> None:
    """Quiesce (a COMM_WORLD barrier) and tear the rank down. In process
    mode every rank first meets the others at the KVS rendezvous; a job
    in which no rank built a world closes its KVS connection only."""
    u = _uni.current_universe()
    from .runtime import boot as _boot
    b = _boot.current_boot()
    if b is not None and not b.finalized:
        b.finalized = True
        built_somewhere = _boot.finalize_rendezvous(b)
        if u is None and not built_somewhere:
            _boot.close_light(b)
            return
        if u is None:
            # a peer built a world: join the collective teardown
            from .runtime.bootstrap import build_world
            u = build_world(b)
            _uni.set_universe(u, process_wide=True)
    if u is None:
        return
    if u.comm_world is not None and u.world_size > 1 and not u.finalized:
        u.comm_world.barrier()
    u.finalize()
    if u.spawned:
        # Finalize is collective over connected processes: a spawn root
        # waits for the children it started
        from .runtime.spawn import reap_spawned
        reap_spawned(u)


def Abort(comm=None, errorcode: int = 1) -> None:
    """Kill the job (MPI-3.1 §8.7): publish the abort on the job's KVS,
    which the launcher watches (it kills every rank and exits with
    ``errorcode``), then exit this process at once."""
    u = _uni.current_universe()
    kvs = getattr(u, "kvs", None) if u is not None else None
    if kvs is not None:
        kvs.abort(f"rank {u.world_rank} called MPI_Abort({errorcode})")
    os._exit(errorcode)


def _world() -> Comm:
    u = _uni.current_universe()
    if u is None or u.comm_world is None:
        raise MPIException(MPI_ERR_OTHER,
                           "MPI not initialized (no universe bound)")
    return u.comm_world


def _self() -> Comm:
    u = _uni.current_universe()
    if u is None or u.comm_self is None:
        raise MPIException(MPI_ERR_OTHER, "MPI not initialized")
    return u.comm_self


def __getattr__(name: str):
    if name == "COMM_WORLD":
        return _world()
    if name == "COMM_SELF":
        return _self()
    raise AttributeError(name)


def Wtime() -> float:
    return time.perf_counter()


def Wtick() -> float:
    return time.get_clock_info("perf_counter").resolution


def Get_processor_name() -> str:
    return socket.gethostname()


def Get_version():
    return (3, 1)


def Get_library_version() -> str:
    return version_string()


# constant re-exports for MPI-ish call sites
SUM, PROD, MAX, MIN = _op.SUM, _op.PROD, _op.MAX, _op.MIN
LAND, LOR, LXOR = _op.LAND, _op.LOR, _op.LXOR
BAND, BOR, BXOR = _op.BAND, _op.BOR, _op.BXOR
MINLOC, MAXLOC = _op.MINLOC, _op.MAXLOC
BYTE, INT, FLOAT, DOUBLE = _dt.BYTE, _dt.INT, _dt.FLOAT, _dt.DOUBLE
LONG, CHAR = _dt.LONG, _dt.CHAR
BFLOAT16 = _dt.BFLOAT16
run_ranks = _uni.run_ranks


# ---------------------------------------------------------------------------
# dynamic processes (MPI-3.1 §10; runtime/spawn.py) and the name service
# ---------------------------------------------------------------------------

def _u():
    u = _uni.current_universe()
    if u is None:
        raise MPIException(MPI_ERR_OTHER, "MPI not initialized")
    return u


def Comm_spawn(command, args=(), maxprocs=1, root=0, comm=None, info=None):
    from .runtime import spawn as _sp
    return _sp.comm_spawn(comm or _world(), command, args, maxprocs, root,
                          info)


def Comm_spawn_multiple(cmds, root=0, comm=None, info=None):
    from .runtime import spawn as _sp
    return _sp.comm_spawn_multiple(comm or _world(), cmds, root, info)


def Comm_get_parent():
    from .runtime import spawn as _sp
    return _sp.get_parent(_u())


def Get_appnum():
    """MPI_APPNUM: which command of a Comm_spawn_multiple this process
    runs; None when it was not spawned (the attribute is undefined)."""
    return _u().appnum


def Open_port(info=None) -> str:
    from .runtime import spawn as _sp
    return _sp.open_port(_u(), info)


def Close_port(port_name: str) -> None:
    from .runtime import spawn as _sp
    _sp.close_port(_u(), port_name)


def Comm_accept(port_name: str, comm=None, root: int = 0, info=None):
    from .runtime import spawn as _sp
    return _sp.comm_accept(port_name, comm or _world(), root, info)


def Comm_connect(port_name: str, comm=None, root: int = 0, info=None):
    from .runtime import spawn as _sp
    return _sp.comm_connect(port_name, comm or _world(), root, info)


def Comm_join(fd: int):
    """MPI_Comm_join is not supported: it raises MPI_ERR_OTHER (the JAX
    package's conformance record gives the same error for it)."""
    raise MPIException(MPI_ERR_OTHER, "MPI_Comm_join is not supported")


def Intercomm_create(local_comm, local_leader, peer_comm, remote_leader,
                     tag=0):
    from .core.intercomm import intercomm_create
    return intercomm_create(local_comm, local_leader, peer_comm,
                            remote_leader, tag)


def Intercomm_merge(intercomm, high: bool = False):
    return intercomm.merge(high)


def Publish_name(service_name: str, port_name: str, info=None) -> None:
    from .runtime import nameserv as _ns
    _ns.publish_name(_u(), service_name, port_name, info)


def Lookup_name(service_name: str, info=None) -> str:
    from .runtime import nameserv as _ns
    return _ns.lookup_name(_u(), service_name, info)


def Unpublish_name(service_name: str, port_name: str = "",
                   info=None) -> None:
    from .runtime import nameserv as _ns
    _ns.unpublish_name(_u(), service_name, port_name, info)


# ---------------------------------------------------------------------------
# pack/unpack (MPI-3.1 §4.2)
# ---------------------------------------------------------------------------

def _bytes_of(buf):
    return buf.view(np.uint8).reshape(-1) if isinstance(buf, np.ndarray) \
        else np.frombuffer(buf, dtype=np.uint8)


def Pack(inbuf, incount, datatype, outbuf, position: int) -> int:
    """Pack into ``outbuf`` at byte ``position``; returns the new
    position."""
    data = np.asarray(datatype.pack(inbuf, incount))
    _bytes_of(outbuf)[position:position + data.size] = data
    return position + data.size


def Unpack(inbuf, position: int, outbuf, outcount, datatype) -> int:
    nbytes = datatype.size * outcount
    datatype.unpack(_bytes_of(inbuf)[position:position + nbytes], outbuf,
                    outcount)
    return position + nbytes


def Pack_size(incount: int, datatype) -> int:
    return incount * datatype.size
