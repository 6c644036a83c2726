"""The name service: MPI_Publish_name, MPI_Lookup_name and
MPI_Unpublish_name (a copy of the JAX package's ``runtime/nameserv.py``).

Two backends: in process mode the job's KVS, under ``__ns_<service>``
keys (every rank of the job and its spawned children see them); with
thread ranks an in-process registry. That registry is process-global,
as in the JAX package: every ``run_ranks`` of one process shares it, so
a service name is published once at a time in a process.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..core.errors import MPIException, MPI_ERR_NAME, MPI_ERR_SERVICE

_LOCAL_NS: Dict[str, str] = {}
_LOCAL_LOCK = threading.Lock()


def publish_name(u, service_name: str, port_name: str, info=None) -> None:
    kvs = u.kvs
    if kvs is not None:
        kvs.put(f"__ns_{service_name}", port_name)
        return
    with _LOCAL_LOCK:
        _LOCAL_NS[service_name] = port_name


def lookup_name(u, service_name: str, info=None) -> str:
    kvs = u.kvs
    if kvs is not None:
        val = kvs.peek(f"__ns_{service_name}")
    else:
        with _LOCAL_LOCK:
            val = _LOCAL_NS.get(service_name)
    if val is None:
        raise MPIException(MPI_ERR_NAME,
                           f"service {service_name!r} not published")
    return val


def unpublish_name(u, service_name: str, port_name: str = "",
                   info=None) -> None:
    kvs = u.kvs
    if kvs is not None:
        if kvs.peek(f"__ns_{service_name}") is None:
            raise MPIException(MPI_ERR_SERVICE,
                               f"service {service_name!r} not published")
        kvs.delete(f"__ns_{service_name}")
        return
    with _LOCAL_LOCK:
        if service_name not in _LOCAL_NS:
            raise MPIException(MPI_ERR_SERVICE,
                               f"service {service_name!r} not published")
        del _LOCAL_NS[service_name]
