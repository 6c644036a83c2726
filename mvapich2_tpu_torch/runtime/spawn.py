"""Dynamic processes: spawn, ports, connect and accept (a trimmed copy of
the JAX package's ``runtime/spawn.py``, MPI-3.1 §10).

* ``comm_spawn`` / ``comm_spawn_multiple``: the spawn root starts the
  children itself, and they join the job. All children share one child
  COMM_WORLD of proc ids ``base .. base + n - 1`` past every id in use;
  every parent extends its proc table with them
  (``Universe.extend_procs``) and gets the parent side of the spawn
  intercomm, the children ``MPI_COMM_PARENT`` (``get_parent``);
  ``Universe.appnum`` says which command a child runs. Two modes:

  - process mode (a job of ``mpirun``): ``command`` is a program. The
    root takes ``base`` from the KVS watermark ``__next_proc`` and
    starts one OS process a child, which bootstraps through the KVS
    (``runtime/bootstrap.py`` ``_bootstrap_spawned``) and talks to the
    parents over TCP (a parent dials a new id by its ``tcp-addr-<id>``
    card). The root watches the children until they are ready; a child
    that cannot start, or dies first, fails the spawn with
    MPI_ERR_SPAWN on every parent, its ids published dead so a later
    spawn's children do not wait for them. The root reaps its children
    at ``mpi.Finalize``;
  - thread mode (``run_ranks``): ``command`` is a callable, run as
    ``command(child_world)`` on rank threads registered on the parents'
    ``LocalFabric`` (``run_ranks`` joins them and reports their
    failures). Their universes name the CPU and bind no device
    channel, as the JAX package's children run the host runtime.

* ports: ``open_port`` names a (proc id, tag) pair,
  ``mv2t-port:<proc>:<tag>``; ``comm_connect`` and ``comm_accept`` are a
  leader handshake on the reserved context ``PORT_CTX`` followed by the
  context agreement of ``core/intercomm.py`` ``bridge_agree``.

The JAX package's CPU rebinding after a spawn (``bind_among``) is left
out: the port binds no CPU cores.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.comm import Comm
from ..core.datatype import INT64_T
from ..core.errors import (MPI_ERR_OTHER, MPI_ERR_PORT, MPI_ERR_SPAWN,
                           MPI_SUCCESS, MPIException, mpi_assert)
from ..core.group import Group
from ..core.intercomm import Intercomm, bcast_json, bridge_agree
from ..core.status import ANY_SOURCE
from .childenv import rank_env

log = logging.getLogger("mvapich2_tpu_torch.runtime.spawn")

# the reserved context of the port handshake (0/1 world, 2/3 self, 4
# ports; the agreed ids start at 8)
PORT_CTX = 4
# how often the spawn root looks at its children while they start (s)
READY_POLL_S = 0.005


# ---------------------------------------------------------------------------
# MPI_Comm_spawn / MPI_Comm_spawn_multiple
# ---------------------------------------------------------------------------

def comm_spawn(comm: Comm, command: Union[str, Sequence[str], Callable],
               args: Sequence[str] = (), maxprocs: int = 1, root: int = 0,
               info=None) -> Tuple[Intercomm, List[int]]:
    return comm_spawn_multiple(comm, [(command, list(args), maxprocs)],
                               root, info)


def comm_spawn_multiple(comm: Comm, cmds: Sequence[Tuple], root: int = 0,
                        info=None) -> Tuple[Intercomm, List[int]]:
    """``cmds``: (command, args, maxprocs) triples, with an optional
    fourth item, a dict of per-command hints (``wd``, ``path``) that
    override ``info``'s. Collective over ``comm``; ``cmds`` is
    significant at ``root`` only (MPI-3.1 §10.3.2), but thread mode
    reads it everywhere to tell the modes apart. Returns the parent
    side of the spawn intercomm and one error code a child."""
    u = comm.u
    total = sum(c[2] for c in cmds)
    if comm.rank == root:
        mpi_assert(total > 0, MPI_ERR_SPAWN, "spawn of zero processes")
    ctx = u.allocate_context_id(comm)
    if cmds and callable(cmds[0][0]):
        return _spawn_threads(comm, cmds, root, ctx, total)
    return _spawn_procs(comm, cmds, root, ctx, total, info)


def _finish_spawn(comm: Comm, hdr, root: int, ctx: int):
    """The parents' common tail: broadcast the spawn envelope, extend the
    proc table, build the parent side of the intercomm."""
    u = comm.u
    hdr = bcast_json(comm, hdr, root)
    if hdr.get("error"):
        raise MPIException(MPI_ERR_SPAWN, hdr["error"])
    base, total = hdr["base"], hdr["total"]
    u.extend_procs(base, hdr["names"])
    private = comm.dup()
    inter = Intercomm(u, private.group, Group(range(base, base + total)),
                      ctx, private, name="spawn_parent")
    return inter, hdr.get("errcodes", [MPI_SUCCESS] * total)


def _resolve_program(argv: List[str], spath: Optional[str]) -> List[str]:
    """A bare program name resolves against the ``path`` hint's
    directories, then the working directory, before PATH (MPICH's
    spawn tests pass path=".")."""
    if argv and os.sep not in argv[0]:
        cands = [os.path.join(d, argv[0])
                 for d in (spath.split(os.pathsep) if spath else [])]
        cands.append(argv[0])
        for cand in cands:
            if os.path.exists(cand):
                argv[0] = os.path.abspath(cand)
                break
    return argv


def _await_ready(kvs, base: int, procs: List[subprocess.Popen]):
    """The children's node names, once their world is wired
    (``__spawn_ready_<base>``); None if a child exited first."""
    key = f"__spawn_ready_{base}"
    while True:
        val = kvs.peek(key)
        if val is not None:
            return json.loads(val)
        for p in procs:
            if p.poll() is not None:
                log.error("spawned process %d exited with %s before its "
                          "world was up", p.pid, p.returncode)
                return None
        time.sleep(READY_POLL_S)


def _spawn_procs(comm: Comm, cmds, root: int, ctx: int, total: int,
                 info=None) -> Tuple[Intercomm, List[int]]:
    u = comm.u
    kvs = u.kvs
    if kvs is None:
        raise MPIException(MPI_ERR_OTHER, "a spawn of programs needs the "
                           "KVS of a job started by mpirun")
    hdr = None
    if comm.rank == root:
        base = kvs.add("__next_proc", total) - total
        errcodes = [MPI_SUCCESS] * total
        procs: List[subprocess.Popen] = []
        hints = info if isinstance(info, dict) else {}
        parents = json.dumps(list(comm.group.world_ranks))
        i = 0
        for appnum, cmd in enumerate(cmds):
            command, args, m = cmd[0], cmd[1], cmd[2]
            cinfo = cmd[3] if len(cmd) > 3 and isinstance(cmd[3], dict) \
                else {}
            wd = cinfo.get("wd") or hints.get("wd")
            argv = _resolve_program(
                ([command] if isinstance(command, str) else list(command))
                + list(args), cinfo.get("path") or hints.get("path"))
            for _ in range(m):
                env = rank_env(i, total, os.environ.get("MV2T_KVS", ""),
                               extra={"MV2T_WORLD_BASE": str(base),
                                      "MV2T_SPAWN_CTX": str(ctx),
                                      "MV2T_APPNUM": str(appnum),
                                      "MV2T_PARENT_RANKS": parents})
                try:
                    procs.append(subprocess.Popen(argv, env=env,
                                                  cwd=wd or None))
                except OSError as e:
                    errcodes[i] = MPI_ERR_SPAWN
                    log.error("spawn of %r failed: %s", argv, e)
                i += 1
        u.spawned.extend(procs)
        names = None
        if all(c == MPI_SUCCESS for c in errcodes):
            names = _await_ready(kvs, base, procs)
        if names is None:
            # a partial world would wait in its bootstrap fence forever:
            # stop what started, and publish the ids dead, since a later
            # spawn's children read node-<r> for every r below their base
            for p in procs:
                p.kill()
            kvs.put_many({f"node-{r}": "__dead__"
                          for r in range(base, base + total)})
            hdr = {"error": f"spawn failed: errcodes {errcodes}"}
        else:
            hdr = {"base": base, "total": total, "names": names,
                   "errcodes": errcodes}
    return _finish_spawn(comm, hdr, root, ctx)


def _spawn_threads(comm: Comm, cmds, root: int, ctx: int,
                   total: int) -> Tuple[Intercomm, List[int]]:
    """Thread mode: the children are rank threads over the parents'
    LocalFabric running ``command(child_world)``, on the spawn root's
    (synthetic) node, named through the shared ``__node_<id>`` table so
    every parent extends its proc table alike."""
    from ..transport.local import LocalChannel
    from .universe import Universe, set_universe
    u = comm.u
    parent_ranks = list(comm.group.world_ranks)
    hdr = None
    if comm.rank == root:
        fabric = u.channel_for(u.world_rank).fabric
        with fabric._lock:
            base = fabric._next_proc
            fabric._next_proc = base + total
        node_ids = list(u.node_ids)
        while len(node_ids) < base:
            node_ids.append(-1000 - len(node_ids))
        node_ids += [u.my_node] * total
        children = []
        for i in range(total):
            cu = Universe(base + i, total, torch.device("cpu"), node_ids,
                          world_ranks=range(base, base + total))
            cu.node_name_to_id = {f"__node_{v}": v
                                  for v in sorted(set(node_ids)) if v >= 0}
            cu.set_default_channel(LocalChannel(fabric, base + i))
            fabric.register(base + i, cu.engine)
            children.append(cu)
        for cu in children:
            cu.initialize()
            cu.claim_context_id(ctx)

        def body(i: int):
            cu = children[i]
            set_universe(cu)
            try:
                private = cu.comm_world.dup()
                cu.parent_intercomm = Intercomm(
                    cu, private.group, Group(parent_ranks), ctx, private,
                    name="spawn_child")
                k = i
                for appnum, (command, _args, m) in enumerate(
                        c[:3] for c in cmds):
                    if k < m:
                        cu.appnum = appnum
                        command(cu.comm_world)
                        break
                    k -= m
            except BaseException as e:  # noqa: BLE001 - run_ranks reports
                fabric.spawn_errors[base + i] = e
            finally:
                set_universe(None)

        for i in range(total):
            t = threading.Thread(target=body, args=(i,), daemon=True,
                                 name=f"spawned-{base + i}")
            fabric.spawned.append(t)
            t.start()
        hdr = {"base": base, "total": total,
               "names": [f"__node_{u.my_node}"] * total}
    return _finish_spawn(comm, hdr, root, ctx)


def get_parent(u) -> Optional[Intercomm]:
    """MPI_Comm_get_parent: the spawn intercomm of a spawned rank."""
    return u.parent_intercomm


def reap_spawned(u, timeout: float = 60.0) -> None:
    """Finalize of a process-mode spawn root: wait for the children it
    started (killing one still running after ``timeout`` seconds) and
    remove the shared-memory files they left."""
    from .launcher import sweep_segments
    deadline = time.monotonic() + timeout
    for p in u.spawned:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            log.error("spawned process %d still running at Finalize; "
                      "killed", p.pid)
            p.kill()
            p.wait()
    sweep_segments([p.pid for p in u.spawned])
    u.spawned.clear()


# ---------------------------------------------------------------------------
# ports: MPI_Open_port / MPI_Comm_accept / MPI_Comm_connect
# ---------------------------------------------------------------------------

def open_port(u, info=None) -> str:
    tag = int.from_bytes(os.urandom(4), "little") & 0x0FFFFFFF
    name = f"mv2t-port:{u.world_rank}:{tag}"
    u.ports[tag] = name
    return name


def close_port(u, port_name: str) -> None:
    try:
        _, _, tag = _parse_port(port_name)
    except MPIException:
        return
    u.ports.pop(tag, None)


def _parse_port(port_name: str) -> Tuple[str, int, int]:
    parts = port_name.split(":")
    if len(parts) != 3 or parts[0] != "mv2t-port":
        raise MPIException(MPI_ERR_PORT, f"bad port name {port_name!r}")
    return parts[0], int(parts[1]), int(parts[2])


def _ensure_proc(u, pid: int) -> None:
    """Extend the proc table for a proc this rank never heard of (a
    sibling spawn's child) from the node card every rank publishes at
    its bootstrap (``node-<pid>``); the TCP channel dials it lazily."""
    if pid < len(u.node_ids):
        return
    mpi_assert(u.kvs is not None, MPI_ERR_PORT,
               f"unknown process {pid} and no KVS to resolve it")
    u.extend_procs(pid, [u.kvs.get(f"node-{pid}")])


def _port_send(u, dest_world: int, tag: int, arr: np.ndarray) -> None:
    _ensure_proc(u, dest_world)
    u.protocol.isend(arr, arr.size, INT64_T, dest_world, u.world_rank,
                     PORT_CTX, tag).wait()


def _port_recv(u, source: int, tag: int) -> Tuple[np.ndarray, int]:
    """Probe and receive an int64 array on the port context: (data, the
    sender's proc id)."""
    st = u.protocol.probe(source, PORT_CTX, tag)
    out = np.empty(st.count // 8, dtype=np.int64)
    u.protocol.irecv(out, out.size, INT64_T, st.source, PORT_CTX,
                     tag).wait()
    return out, st.source


def comm_accept(port_name: str, comm: Comm, root: int = 0,
                info=None) -> Intercomm:
    """Collective over ``comm``; ``root`` is the rank that opened the
    port. The handshake is intercomm_create's leader exchange."""
    u = comm.u
    private = comm.dup()

    def exchange(lmax: int) -> dict:
        _, owner, tag = _parse_port(port_name)
        if owner != u.world_rank:
            raise MPIException(MPI_ERR_PORT,
                               f"accept on foreign port {port_name!r}")
        if tag not in u.ports:
            raise MPIException(MPI_ERR_PORT,
                               f"port {port_name!r} is not open")
        req, peer = _port_recv(u, ANY_SOURCE, tag)
        ctx = max(lmax, int(req[0]))
        _port_send(u, peer, tag, np.array(
            [ctx] + list(private.group.world_ranks), dtype=np.int64))
        return {"ctx": ctx, "remote": [int(x) for x in req[1:]]}

    hdr = bridge_agree(private, root, exchange)
    for r in hdr["remote"]:
        _ensure_proc(u, r)
    return Intercomm(u, private.group, Group(hdr["remote"]),
                     int(hdr["ctx"]), private, name="accepted")


def comm_connect(port_name: str, comm: Comm, root: int = 0,
                 info=None) -> Intercomm:
    u = comm.u
    private = comm.dup()

    def exchange(lmax: int) -> dict:
        _, owner, tag = _parse_port(port_name)
        _port_send(u, owner, tag, np.array(
            [lmax] + list(private.group.world_ranks), dtype=np.int64))
        reply, _ = _port_recv(u, owner, tag)
        return {"ctx": int(reply[0]), "remote": [int(x) for x in reply[1:]]}

    hdr = bridge_agree(private, root, exchange)
    for r in hdr["remote"]:
        _ensure_proc(u, r)
    return Intercomm(u, private.group, Group(hdr["remote"]),
                     int(hdr["ctx"]), private, name="connected")
