"""The rank runtime (counterpart of the JAX package's
``runtime/universe.py`` ``Universe``, ``set_universe`` /
``current_universe``, ``local_universe`` and ``run_ranks``).

A ``Universe`` is one rank's world: its world rank and size, node ids,
device, ``ProgressEngine`` (``transport/progress.py``), ``Pt2ptProtocol``
(``pt2pt/protocol.py``), its channels, COMM_WORLD (context 0) and
COMM_SELF (context 2). It is built two ways:

* ``local_universe`` / ``run_ranks``: ranks are threads of one process,
  each with a ``LocalChannel`` over one ``LocalFabric``
  (``transport/local.py``). ``nodes=`` gives each rank a fake node id,
  so the node-aware paths (the two-level allreduce, the inter-node eager
  threshold) run. ``mpirun --vpod`` (``runtime/launcher.py``) runs a
  program's rank threads over these universes;
* process mode (``runtime/bootstrap.py``, from ``mpi.Init`` under
  ``mpirun``): one rank a process, with a TCP channel to every peer and
  a shared-memory channel to the peers of its node (``set_channel``),
  and the job's KVS client (``kvs``).

New communicators agree on context ids as the JAX package does: an
allreduce (bitwise AND) of every member's availability mask, the lowest
common free bit wins, and a thread that cannot own its process's mask
contributes an empty one so the members retry together.

COMM_WORLD gets the host collective table first; the device binding
(``coll/device.py`` ``bind_universes``) then overwrites the entries a
device channel runs: through the slot channel on one device, one to one
to the virtual devices of a ``device_mesh`` (``parallel/mesh.py``, 1-D or
multi-axis), or ``k`` ranks to each of its devices (the fold channel);
a mesh of another geometry leaves COMM_WORLD on the host tier, as in the
JAX package. The device is ``cuda:0`` unless the caller names another;
without a CUDA device the caller must ask for the CPU (``device="cpu"``,
or a mesh made on the CPU), or the harness raises. A process-mode rank
binds no device channel: its COMM_WORLD is host-only, as in the JAX
package.

A universe also holds its rank's host windows (``windows``, by id) and
the hub of their packet handlers (``_rma_manager``, ``rma/win.py``),
made with the first window.

``current_universe()`` is the calling thread's universe (a rank thread's,
set by ``run_ranks`` and ``launch_vpod``), else the process-wide one
(``mpi.Init`` in process mode).

Dynamic processes (``runtime/spawn.py``) grow a universe's proc table
past its COMM_WORLD: ``extend_procs`` for spawned ids, ``learn_procs``
for procs an intercomm's bridge names (``node_name_of`` ships a proc's
node), each giving every rank the same table from the same inputs. A
spawned rank's COMM_WORLD is ``world_ranks`` = ``range(base, base +
n)``. The two-sided agreements of ``core/intercomm.py`` take their
context ids from ``_next_ctx``, a counter below ``CTX_MASK_BASE``.

Observability, as the JAX package's ``Universe.initialize`` and
``finalize`` set it up: under MV2T_TRACE each rank's Universe carries an
event recorder (``tracer``, ``trace/recorder.py``; None otherwise), the
latency-histogram gate is armed (``metrics.ensure_live``), and
``run_ranks`` writes every rank's ring to MV2T_TRACE_DIR when the ranks
end, also when one failed or hung (``Universe.finalize``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import metrics, trace
from ..core.comm import Comm
from ..core.errors import MPI_ERR_INTERN, MPI_ERR_OTHER, MPIException
from ..core.group import Group
from ..pt2pt.protocol import Pt2ptProtocol
from ..transport.base import Channel
from ..transport.local import LocalChannel, LocalFabric
from ..transport.progress import ProgressEngine

DeviceLike = Union[str, torch.device, None]

# mask-allocated context ids live high, clear of the predefined ones
CTX_MASK_BASE = 1 << 20
# context ids a rank can hold (the JAX package's default budget)
MAX_CONTEXTS = 2048


def _lowest_bit(mask) -> int:
    """Index of the lowest set bit across the uint64 word array, -1 if
    none."""
    for w in range(len(mask)):
        v = int(mask[w])
        if v:
            return w * 64 + (v & -v).bit_length() - 1
    return -1


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` -> ``cuda:0``. A CUDA device that is not present raises:
    the harness never carries on quietly on the CPU."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Universe:
    """One rank's world: its world rank and size, node ids, the device
    its collectives run on, its progress engine, protocol and channels,
    COMM_WORLD and COMM_SELF, its event recorder (``tracer``, None while
    MV2T_TRACE is off) and its context-id mask; in process mode also the
    job's KVS client (``kvs``), the node-name table and the
    shared-memory channel (``shm_channel``)."""

    def __init__(self, world_rank: int, world_size: int,
                 device: torch.device,
                 node_ids: Optional[Sequence[int]] = None,
                 world_ranks: Optional[Sequence[int]] = None):
        """``world_rank`` is this rank's proc id across the job, and
        ``world_ranks`` the proc ids of its COMM_WORLD: ``range(base,
        base + n)`` for a spawned child world (``runtime/spawn.py``),
        else ``range(world_size)``. ``node_ids`` is indexed by proc id
        and covers every proc this rank can address."""
        self.world_rank = world_rank
        self.world_size = world_size
        self.world_ranks: List[int] = list(world_ranks) \
            if world_ranks is not None else list(range(world_size))
        self.node_ids: List[int] = list(node_ids) if node_ids is not None \
            else [0] * (max(self.world_ranks) + 1)
        if world_ranks is None and len(self.node_ids) != world_size:
            raise ValueError(f"nodes= names {len(self.node_ids)} node ids "
                             f"for {world_size} ranks")
        self.node_name_to_id: Dict[str, int] = {}
        # dynamic processes (runtime/spawn.py): the spawn intercomm of a
        # spawned rank, the command index of Comm_spawn_multiple it runs
        # (None when not spawned), this rank's open ports (tag -> name)
        # and, on a process-mode spawn root, the child processes it
        # started (reaped at Finalize)
        self.parent_intercomm = None
        self.appnum: Optional[int] = None
        self.ports: Dict[int, str] = {}
        self.spawned: List = []
        # the next id of the two-sided agreements (core/intercomm.py
        # bridge_agree), monotonic from 8 and far below CTX_MASK_BASE:
        # 0/1 world, 2/3 self, 4 the port handshake (PORT_CTX)
        self._next_ctx = 8
        self.device = device
        self.tracer: Optional[trace.Recorder] = None
        self.engine = ProgressEngine(world_rank)
        self.engine.universe = self
        self._default_channel: Optional[Channel] = None
        self._channels: Dict[int, Channel] = {}   # world rank -> channel
        self.kvs = None           # the job's KVS client (process mode)
        self.shm_channel = None   # the node's shared-memory channel
        self.comms_by_ctx: Dict[int, Comm] = {}
        # host windows (rma/win.py): win_id -> Win, and the packet
        # handlers' hub, made with the first window
        self.windows: Dict[int, object] = {}
        self._rma_manager = None
        self._ctx_mask = None   # lazily sized (ctx_mask())
        self._ctx_lock = threading.Lock()
        self._ctx_holder = None   # key of the agreement holding the mask
        self._ctx_waiting = set()  # keys of locally pending agreements
        self.protocol: Optional[Pt2ptProtocol] = None
        self.comm_world: Optional[Comm] = None
        self.comm_self: Optional[Comm] = None
        # what coll/device.py bind_universes bound (None: no device
        # channel); the comms made from COMM_WORLD derive theirs from it
        self.device_binding = None
        self.initialized = False
        self.finalized = False

    def initialize(self) -> None:
        self.protocol = Pt2ptProtocol(self)
        self.comm_world = Comm(self, Group(self.world_ranks),
                               context_id=0, name="MPI_COMM_WORLD")
        self.comm_self = Comm(self, Group([self.world_rank]),
                              context_id=2, name="MPI_COMM_SELF")
        from ..coll.tuning import install_coll_ops
        install_coll_ops(self.comm_world)
        self.initialized = True

    # -- wiring -----------------------------------------------------------
    def set_default_channel(self, ch: Channel) -> None:
        if ch.polled:
            self.engine.add_channel(ch)
        self._default_channel = ch

    def set_channel(self, world_rank: int, ch: Channel) -> None:
        """Route ``world_rank``'s traffic through ``ch`` (the node's
        shared-memory channel in process mode)."""
        if ch.polled and ch not in self.engine.channels:
            self.engine.add_channel(ch)
        self._channels[world_rank] = ch

    def channel_for(self, dest_world: int) -> Channel:
        ch = self._channels.get(dest_world, self._default_channel)
        if ch is None:
            raise MPIException(MPI_ERR_INTERN,
                               f"no channel for rank {dest_world}")
        return ch

    def is_local(self, dest_world: int) -> bool:
        """Same node? (the eager threshold and the two-level splits)"""
        return self.node_ids[dest_world] == self.node_ids[self.world_rank]

    def num_nodes(self) -> int:
        return len(set(self.node_ids))

    @property
    def my_node(self) -> int:
        return self.node_ids[self.world_rank]

    # -- the proc table's growth (dynamic processes) -----------------------
    def extend_procs(self, base: int, node_names: Sequence[str]) -> None:
        """Grow the proc table for spawned processes with ids ``base ..
        base + len(node_names) - 1``. Names map through
        ``node_name_to_id``, the same table on every rank, and an
        unknown name gets the next id, so every rank extends its table
        identically from the same inputs."""
        if base > 0:
            self._grow_proc_table(base - 1)
        for i, name in enumerate(node_names):
            pid = base + i
            nid = self._intern_node(name)
            if pid < len(self.node_ids):
                self.node_ids[pid] = nid
            else:
                self.node_ids.append(nid)

    def node_name_of(self, pid: int) -> str:
        """The node name of proc ``pid``, shipped across an intercomm's
        bridge so a group that never met these procs learns where they
        live; a node that was never named gets the synthetic name
        ``__node_<id>`` (the thread harness's convention), a proc this
        rank does not know ``__proc_<pid>``."""
        if 0 <= pid < len(self.node_ids):
            nid = self.node_ids[pid]
            for name, i in self.node_name_to_id.items():
                if i == nid:
                    return name
            return f"__node_{nid}"
        return f"__proc_{pid}"

    def _grow_proc_table(self, pid: int) -> None:
        """Gap-fill the table to cover ``pid`` with distinct negative
        node ids (``is_local`` never true for them): the one formula of
        extend_procs and learn_procs."""
        while len(self.node_ids) <= pid:
            self.node_ids.append(-1000 - len(self.node_ids))

    def _intern_node(self, name: str) -> int:
        m = self.node_name_to_id
        if name not in m:
            m[name] = max(max(self.node_ids, default=0),
                          max(m.values(), default=0)) + 1
        return m[name]

    def learn_procs(self, pairs) -> None:
        """Extend the table with (proc id, node name) pairs learned from
        a peer group (``core/intercomm.py`` ``intercomm_create``).
        Idempotent; the same inputs give the same table on every rank."""
        for pid, name in pairs:
            self._grow_proc_table(pid)
            if name not in self.node_name_to_id \
                    and name.startswith("__node_") \
                    and name[7:].lstrip("-").isdigit():
                # a synthetic id-carrying name: the id itself
                self.node_ids[pid] = int(name[7:])
                continue
            self.node_ids[pid] = self._intern_node(name)

    # -- context ids (the JAX package's MPIR_Get_contextid scheme) --------
    def ctx_mask(self):
        """This rank's context-id availability mask (MAX_CONTEXTS bits,
        the JAX package's default budget); freed ids return to it."""
        if self._ctx_mask is None:
            nbits = MAX_CONTEXTS
            fresh = np.full((nbits + 63) // 64,
                            np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
            with self._ctx_lock:
                if self._ctx_mask is None:
                    self._ctx_mask = fresh
        return self._ctx_mask

    def release_context_id(self, ctx: int) -> None:
        if ctx < CTX_MASK_BASE or self._ctx_mask is None:
            return   # predefined id: not pooled
        bit = (ctx - CTX_MASK_BASE) // 2
        w, b = divmod(bit, 64)
        if w < len(self._ctx_mask):
            with self._ctx_lock:
                self._ctx_mask[w] |= np.uint64(1 << b)

    def claim_context_id(self, ctx: int) -> None:
        """Mark a mask id that another group agreed on as taken here: a
        spawned rank claims its spawn intercomm's id, which the parents'
        comm allocated, so none of its own comms is given the same."""
        if ctx < CTX_MASK_BASE:
            return
        w, b = divmod((ctx - CTX_MASK_BASE) // 2, 64)
        mask = self.ctx_mask()
        with self._ctx_lock:
            mask[w] &= np.uint64(~np.uint64(1 << b))

    def _ctx_local_words(self) -> int:
        """Words at the top of the mask reserved for single-member
        allocations; agreements advertise them unavailable."""
        return min(max(1, len(self.ctx_mask()) // 8),
                   len(self.ctx_mask()) - 1)

    def ctx_payload(self, key):
        """One agreement attempt's contribution, (payload, owns_mask):
        the mask words and an all-ones guard word, or, when another
        agreement of this process holds the mask (or ``key`` is not the
        lowest pending one), zeros: the AND then tells every member to
        retry together."""
        mask = self.ctx_mask()
        pay = np.empty(len(mask) + 1, dtype=np.uint64)
        with self._ctx_lock:
            self._ctx_waiting.add(key)
            if self._ctx_holder is not None \
                    or key != min(self._ctx_waiting):
                pay[:] = 0
                return pay, False
            self._ctx_holder = key
            pay[:len(mask)] = mask
            pay[len(mask) - self._ctx_local_words():len(mask)] = 0
        pay[len(mask)] = np.uint64(0xFFFFFFFFFFFFFFFF)
        return pay, True

    def ctx_release(self, own: bool, key, done: bool = False) -> None:
        """Drop the mask-holder flag after a failed attempt; ``done``
        also retires the key."""
        with self._ctx_lock:
            if own:
                self._ctx_holder = None
            if done:
                self._ctx_waiting.discard(key)

    def ctx_resolve(self, agreed, own: bool, key,
                    claim: bool = True) -> int:
        """An agreed [mask..., guard] payload -> a context id; -1 when the
        members must retry; raises when the ids are exhausted."""
        bit = _lowest_bit(agreed[:-1])
        with self._ctx_lock:
            if own:
                self._ctx_holder = None
            if bit >= 0:
                self._ctx_waiting.discard(key)
                if claim:
                    w, b = divmod(bit, 64)
                    self._ctx_mask[w] &= np.uint64(~np.uint64(1 << b))
                return CTX_MASK_BASE + 2 * bit
        if int(agreed[-1]) == 0:
            return -1
        self.ctx_release(False, key, done=True)
        nw = len(agreed) - 1
        raise MPIException(
            MPI_ERR_OTHER,
            "out of collective context ids "
            f"({(nw - self._ctx_local_words()) * 64} of "
            f"MAX_CONTEXTS={nw * 64}; the rest are reserved "
            "single-member)")

    def alloc_context_local(self) -> int:
        """A single-member allocation (size-1 dups and splits): the lowest
        free bit of the reserved words, with no collective."""
        mask = self.ctx_mask()
        base = len(mask) - self._ctx_local_words()
        deadline = time.monotonic() + 60.0
        while True:
            with self._ctx_lock:
                bit = _lowest_bit(mask[base:])
                if bit >= 0:
                    bit += base * 64
                elif self._ctx_holder is None:
                    bit = _lowest_bit(mask[:base])
                    if bit < 0:
                        raise MPIException(
                            MPI_ERR_OTHER, "out of context ids "
                            f"(MAX_CONTEXTS={len(mask) * 64})")
                else:
                    bit = -1    # wait out the in-flight agreement
                if bit >= 0:
                    w, b = divmod(bit, 64)
                    self._ctx_mask[w] &= np.uint64(~np.uint64(1 << b))
                    return CTX_MASK_BASE + 2 * bit
            if time.monotonic() > deadline:
                raise MPIException(
                    MPI_ERR_INTERN, "alloc_context_local stalled 60s "
                    "waiting out an in-flight context-id agreement")
            time.sleep(0.0002)

    def allocate_context_id(self, parent_comm) -> int:
        """Collective over ``parent_comm``: agree on a fresh context id by
        an allreduce (bitwise AND) of the members' masks. It runs the
        fixed recursive-doubling algorithm, not the tuned dispatch (a
        forced two-level allreduce would re-enter split here)."""
        from ..coll import algorithms as alg
        from ..core import op as opmod
        if parent_comm.size == 1:
            return self.alloc_context_local()
        key = (parent_comm.context_id, 0)
        while True:
            pay, own = self.ctx_payload(key)
            try:
                agreed = alg.allreduce_recursive_doubling(
                    parent_comm, pay, opmod.BAND,
                    parent_comm.next_coll_tag())
            except BaseException:
                self.ctx_release(own, key, done=True)
                raise
            ctx = self.ctx_resolve(agreed, own, key)
            if ctx >= 0:
                return ctx
            time.sleep(0.0002)   # let the mask-holding thread finish

    def finalize(self) -> None:
        """Drain leftover traffic, write this rank's ring to
        MV2T_TRACE_DIR and drop the recorder (the JAX package's
        Finalize); the trace part is a no-op when untraced."""
        if self.finalized:
            return
        self.engine.drain_all(timeout=0.5)
        trace.dump_rank(self)
        trace.detach(self)
        self.engine.close()
        self.finalized = True


_tls = threading.local()
_process_universe: Optional[Universe] = None


def set_universe(u: Optional[Universe], process_wide: bool = False) -> None:
    """Bind ``u`` to the calling thread, or (``process_wide``) to the
    process: the fallback of every thread that has none of its own."""
    global _process_universe
    if process_wide:
        _process_universe = u
    else:
        _tls.universe = u


def current_universe() -> Optional[Universe]:
    """The Universe of the calling rank thread, else the process-wide one
    (None outside both)."""
    u = getattr(_tls, "universe", None)
    return u if u is not None else _process_universe


def local_universe(nranks: int, device: DeviceLike = None,
                   device_mesh=None,
                   nodes: Optional[Sequence[int]] = None) -> List[Universe]:
    """Build ``nranks`` thread-rank universes over one LocalFabric.

    ``nodes`` assigns a fake node id a rank, so node-aware (two-level)
    paths run without several hosts. With ``device_mesh`` (a
    ``parallel.mesh.Mesh``) of ``nranks`` devices, their COMM_WORLDs bind
    the 1:1 mesh channel on the mesh's device; of fewer devices that
    divide the ranks, the fold channel; of another geometry, none (the
    host tier); without one (or with one device) they share ``device``
    through the slot channel (coll/device.py ``bind_universes``)."""
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1, got {nranks}")
    if device_mesh is not None:
        if device is not None and resolve_device(device) != \
                device_mesh.device:
            raise ValueError(f"device {device} differs from the mesh's "
                             f"{device_mesh.device}")
        dev = device_mesh.device
    else:
        dev = resolve_device(device)
    fabric = LocalFabric(nranks)
    universes = []
    for r in range(nranks):
        u = Universe(r, nranks, dev, nodes)
        # the JAX package's synthetic node-name table (the same on every
        # rank)
        u.node_name_to_id = {f"__node_{v}": v for v in sorted(set(u.node_ids))}
        u.set_default_channel(LocalChannel(fabric, r))
        fabric.register(r, u.engine)
        universes.append(u)
    for u in universes:
        u.initialize()
    from ..coll.device import bind_universes
    bind_universes(universes, dev, device_mesh)
    for u in universes:
        trace.maybe_attach(u)
    metrics.ensure_live()
    return universes


def run_ranks(nranks: int, fn: Callable, *args, device: DeviceLike = None,
              timeout: float = 120.0, device_mesh=None,
              nodes: Optional[Sequence[int]] = None) -> List:
    """Run ``fn(comm_world, *args)`` on every rank (threads); return the
    per-rank results. ``device_mesh`` and ``nodes``: see
    :func:`local_universe`. On a CUDA device each rank thread runs on
    its own stream, synchronized before the rank finishes. A rank's
    exception aborts the device rendezvous (its peers fail instead of
    hanging: a peer blocked in a device collective, or in the wait() of
    a nonblocking one, which then raises MPIX_ERR_PROC_FAILED), wakes
    every rank's engine, and is re-raised with its rank noted; a peer
    waiting on it in a host call waits until ``timeout``, as in the JAX
    package. A rank still running after ``timeout`` seconds raises
    ``TimeoutError``. Ranks spawned on the run's fabric (``Comm_spawn``
    of a callable) are waited for within the same ``timeout``, and a
    spawned rank's exception is re-raised too. Every rank's Universe is
    finalized when the ranks end, however they end."""
    universes = local_universe(nranks, device, device_mesh, nodes)
    dev = universes[0].device
    fabric = universes[0].channel_for(0).fabric
    results: List = [None] * nranks
    errors: List[Optional[BaseException]] = [None] * nranks

    def abort():
        ch = universes[0].comm_world.device_channel
        if ch is not None:
            ch.abort()           # break the device rendezvous
        for eng in list(fabric.engines.values()):
            eng.wakeup()         # the ranks' and any spawned rank's

    def body(r: int):
        comm = universes[r].comm_world
        set_universe(universes[r])
        try:
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    results[r] = fn(comm, *args)
                stream.synchronize()
            else:
                results[r] = fn(comm, *args)
        except BaseException as e:  # noqa: BLE001 - reported by run_ranks
            errors[r] = e
            abort()
        finally:
            set_universe(None)

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"rank-{r}")
               for r in range(nranks)]
    finished = False
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                abort()
                raise TimeoutError(
                    f"rank thread {t.name} did not finish within "
                    f"{timeout}s (errors so far: {[e for e in errors if e]}"
                    f"; spawned ranks' {dict(fabric.spawn_errors)})")
        # ranks spawned on this fabric (Comm_spawn from a callable) end
        # within the same deadline, and their failures are reported
        for t in list(fabric.spawned):
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                abort()
                raise TimeoutError(
                    f"spawned rank thread {t.name} did not finish within "
                    f"{timeout}s")
        finished = True
    finally:
        for u in universes:
            if finished:
                u.finalize()
            else:
                # ranks still running own their engines: only the trace
                trace.dump_rank(u)
                trace.detach(u)
    for r, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"rank {r} failed: {e!r}") from e
    for pid, e in sorted(fabric.spawn_errors.items()):
        raise RuntimeError(f"spawned rank {pid} failed: {e!r}") from e
    return results
