"""One-sided host windows: the creation flavors, the communication ops
and the three synchronization families (a copy of the JAX package's
``rma/win.py``).

Window memory is host (numpy) memory; the device window is
``rma/device.py`` ``DeviceWin``. Every op is a packet applied at the
target under its progress engine's mutex, which makes every accumulate
element-atomic. FIFO order on each pair of ranks makes FLUSH and UNLOCK
completion fences: a FLUSH_ACK answers only after every earlier op from
that origin was applied. The handlers (``RmaManager``) are asynchronous
packet types of the engine (``transport/progress.py``): a passive target
applies a lock, put or accumulate while its rank computes outside MPI,
on the thread that delivered the packet (thread ranks; a process rank
applies them at its next MPI call, as in the JAX package).

``win_create``, ``win_allocate``, ``win_create_dynamic`` and
``win_allocate_shared`` (one ``multiprocessing.shared_memory`` segment in
rank order, whose name rank 0 draws and broadcasts) are collective.

Tensors follow the port's host-tier rule: a CPU tensor is taken in place
as numpy (as a window buffer, an attached region or an origin, result
or compare buffer, so a CPU tensor given to ``win_create`` IS the window
memory), and a tensor on the card raises ``NotImplementedError`` before
any packet leaves, never staged to the host. In ``win_create`` that
check runs before the collective id agreement, so when every rank
passes a card tensor every rank raises and none blocks; ranks that
disagree make an erroneous program, which hangs as in the JAX package.

The JAX package's direct cross-memory path (``rma/cma.py``) answers only
for a universe with a C-plane channel, which the port does not have:
``_setup_direct`` leaves ``Win._cma`` at None, and every op takes the
packet protocol (see ``_setup_direct``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import datatype as dtmod
from ..core import op as opmod
from ..core.attr import AttrCache
from ..core.comm import to_host
from ..core.datatype import Datatype, as_bytes_view
from ..core.errors import (MPIException, MPI_ERR_ARG, MPI_ERR_RANK,
                           MPI_ERR_RMA_SYNC, MPI_ERR_WIN, mpi_assert)
from ..core.info import Info
from ..core.request import CompletedRequest, Request
from ..core.status import PROC_NULL
from ..transport.base import Packet, PktType
from ..utils import on_card

# Bound on the engine-thread wait for a direct-access window's
# accumulate mutex (the JAX package's rma/cma.py; unused while _cma is
# None): 60 s of contention means a peer died holding it.
_ACC_MUTEX_TIMEOUT = 60.0

LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2

# shared segments whose mappings outlive their window (see Win.free)
_leaked_shm: list = []

# MPI_Win_flavor / memory model constants
FLAVOR_CREATE = 1
FLAVOR_ALLOCATE = 2
FLAVOR_DYNAMIC = 3
FLAVOR_SHARED = 4
WIN_SEPARATE = 1
WIN_UNIFIED = 2


def _on_host(what: str, *bufs):
    """``bufs`` as numpy: a CPU tensor as its numpy view (reads and writes
    land in the tensor), None and numpy as they are; a tensor on the card
    is refused."""
    out = []
    for b in bufs:
        if on_card(b):
            raise NotImplementedError(
                f"{what}: a host window has no device path and a tensor "
                f"on {b.device} is not moved to the host; the device "
                f"window is rma.device.DeviceWin")
        out.append(to_host(b) if isinstance(b, torch.Tensor) else b)
    return out


def _ser_basic(b):
    if b is None:
        return None
    if b.names:
        # structured (pair) dtype incl. padding offsets
        return {"names": list(b.names),
                "formats": [b.fields[n][0].str for n in b.names],
                "offsets": [int(b.fields[n][1]) for n in b.names],
                "itemsize": int(b.itemsize)}
    return b.str


def _ser_dt(dt: Datatype) -> dict:
    return {"spans": np.asarray(dt.spans).tolist(),
            "extent": dt.extent, "lb": dt.lb,
            "basic": _ser_basic(dt.basic)}


def _dt_span(dt: Datatype, count: int) -> int:
    """Bytes the target region must cover for `count` extent-strided
    elements — true-extent aware (the last element may trail past the
    extent: transpose2's vector-of-vector target)."""
    if count <= 0:
        return 0
    sp = np.asarray(dt.spans, dtype=np.int64).reshape(-1, 2)
    if sp.size == 0:
        return count * dt.extent
    hi = int((sp[:, 0] + sp[:, 1]).max())
    return (count - 1) * dt.extent + max(hi, dt.extent)


def _rmw_packed(old: np.ndarray, inc: np.ndarray, tdt: Datatype,
                op) -> np.ndarray:
    """The accumulate read-modify-write core: new packed bytes =
    op(inc, old) elementwise through tdt's basic dtype (one copy for the
    packet handler and a later direct path)."""
    basic = tdt.basic if tdt.basic is not None else np.dtype(np.uint8)
    cur = dtmod.packed_to_basic(old, basic).copy()
    res = op(dtmod.packed_to_basic(inc[:len(old)], basic), cur)
    return dtmod.basic_to_packed(np.asarray(res), basic)


def _deser_dt(d: dict) -> Datatype:
    b = d["basic"]
    basic = None if b is None else np.dtype(b)
    return Datatype([tuple(s) for s in d["spans"]], d["extent"], d["lb"],
                    basic, "rma_wire", True)


class _TargetSync:
    """Per-window target-side (exposure) state."""

    def __init__(self):
        self.lock_mode = 0              # 0 free, else LOCK_EXCLUSIVE/SHARED
        self.lock_holders: set = set()  # origin world ranks
        # pending lock requests: (origin, mode, rreq_id)
        self.lock_queue: List[Tuple[int, int, int]] = []
        self.posts_from: set = set()    # PSCW: origins we posted to
        self.completes: set = set()     # PSCW: origins that completed


class Win:
    """An RMA window (MPID_Win analog)."""

    _next_id = 1
    _id_lock = threading.Lock()

    def __init__(self, comm, base: Optional[np.ndarray], size: int,
                 disp_unit: int, flavor: int, win_id: int):
        self.comm = comm
        self.u = comm.u
        self.group = comm.group
        self.base = base                  # uint8 ndarray or None (dynamic)
        self.size = size
        self.disp_unit = disp_unit
        self.flavor = flavor
        self.model = WIN_UNIFIED
        self.win_id = win_id
        self.name = f"win{win_id}"
        self.info: Dict[str, str] = {}
        self.attrs = AttrCache()          # keyval attribute cache
        self.freed = False
        # dynamic windows: address -> attached array
        self._attached: Dict[int, np.ndarray] = {}
        self._next_addr = 0x1000
        # origin-side sync state
        self.epoch: Optional[str] = None  # None|fence|start|lock|lock_all
        self._locked_targets: Dict[int, int] = {}   # target -> mode
        self._start_group = None
        self._posts_seen: set = set()
        self._touched: set = set()        # targets with ops since last sync
        self._acks_wanted = 0             # outstanding FLUSH/UNLOCK acks
        self._acks_seen = 0
        # target-side sync state
        self.tsync = _TargetSync()
        # shared-window bookkeeping
        self._shm = None
        self._shm_owner = False
        self._peers: Dict[int, Tuple[int, int]] = {}  # rank->(offset,size)
        # direct cross-memory access; None on the port (_setup_direct)
        self._cma = None
        # register with the universe's RMA manager
        _manager(self.u).add_window(self)

    # ------------------------------------------------------------------
    # memory addressing
    # ------------------------------------------------------------------
    def _region(self, disp: int, nbytes: int) -> np.ndarray:
        """Byte view of [disp*unit, +nbytes) in this window (target side)."""
        if self.flavor == FLAVOR_DYNAMIC:
            for addr, arr in self._attached.items():
                raw = arr.reshape(-1).view(np.uint8)
                if addr <= disp and disp + nbytes <= addr + raw.nbytes:
                    off = disp - addr
                    return raw[off:off + nbytes]
            raise MPIException(MPI_ERR_ARG,
                               f"dynamic window: no region at {disp}")
        off = disp * self.disp_unit
        mpi_assert(0 <= off and off + nbytes <= self.size, MPI_ERR_ARG,
                   f"window access [{off},{off + nbytes}) outside size "
                   f"{self.size}")
        return self.base[off:off + nbytes]

    # -- dynamic windows ------------------------------------------------
    def attach(self, arr) -> int:
        """MPI_Win_attach; returns the region's address token (the value
        remote ranks use as target_disp). The token IS the region's raw
        virtual address, what MPI_Get_address hands a C program. A CPU
        tensor is attached in place."""
        arr, = _on_host("Win.attach", arr)
        mpi_assert(self.flavor == FLAVOR_DYNAMIC, MPI_ERR_WIN,
                   "attach on non-dynamic window")
        mpi_assert(arr.flags["C_CONTIGUOUS"], MPI_ERR_ARG,
                   "attached region must be C-contiguous (reshaping "
                   "would copy and the token would dangle)")
        raw = arr.reshape(-1).view(np.uint8)
        addr = int(raw.ctypes.data) if raw.nbytes else self._next_addr
        self._next_addr += 64
        self._attached[addr] = arr
        return addr

    def detach(self, addr_or_arr) -> None:
        if isinstance(addr_or_arr, (int, np.integer)):
            self._attached.pop(int(addr_or_arr), None)
            return
        for a, arr in list(self._attached.items()):
            if arr is addr_or_arr:
                del self._attached[a]

    # ------------------------------------------------------------------
    # epoch guards
    # ------------------------------------------------------------------
    def _need_access_epoch(self, target: int) -> None:
        if self.epoch is None:
            raise MPIException(MPI_ERR_RMA_SYNC,
                               "RMA op outside an access epoch "
                               "(call fence/start/lock first)")
        if self.epoch == "lock" and target not in self._locked_targets:
            raise MPIException(MPI_ERR_RMA_SYNC,
                               f"target {target} is not locked")

    def _check_target(self, rank: int) -> bool:
        """False = MPI_PROC_NULL (the op is a no-op, MPI-3.1 §11.3)."""
        if rank == PROC_NULL:
            return False
        if not (0 <= rank < self.comm.size):
            raise MPIException(MPI_ERR_RANK, f"bad target rank {rank}")
        return True

    def _send(self, target: int, pkt: Packet) -> None:
        self._send_world(self.comm.world_of(target), pkt)

    def _send_world(self, world: int, pkt: Packet) -> None:
        _manager(self.u).send_to(world, pkt)

    # ------------------------------------------------------------------
    # communication ops (origin side)
    # ------------------------------------------------------------------
    def put(self, origin, target_rank: int, target_disp: int = 0,
            count: Optional[int] = None, origin_dt: Optional[Datatype] = None,
            target_dt: Optional[Datatype] = None,
            target_count: Optional[int] = None) -> None:
        self.rput(origin, target_rank, target_disp, count, origin_dt,
                  target_dt, target_count)  # locally complete (data copied)

    def rput(self, origin, target_rank: int, target_disp: int = 0,
             count: Optional[int] = None, origin_dt: Optional[Datatype] = None,
             target_dt: Optional[Datatype] = None,
             target_count: Optional[int] = None) -> Request:
        origin, = _on_host("Win.put", origin)
        if not self._check_target(target_rank):
            return CompletedRequest()
        self._need_access_epoch(target_rank)
        odt, cnt = _resolve_dt(origin, count, origin_dt)
        tdt = target_dt or odt
        tcnt = cnt if target_count is None else target_count
        data = np.asarray(odt.pack(origin, cnt))
        if self._cma is not None \
                and self._cma.put(target_rank, int(target_disp), data,
                                  tdt, tcnt):
            return CompletedRequest()    # applied synchronously
        pkt = Packet(PktType.RMA_PUT, self.u.world_rank, nbytes=len(data),
                     data=data,
                     extra={"win": self.win_id, "disp": int(target_disp),
                            "count": tcnt, "tdt": _ser_dt(tdt)})
        self._touched.add(target_rank)
        self._send(target_rank, pkt)
        return CompletedRequest()

    def get(self, origin, target_rank: int, target_disp: int = 0,
            count: Optional[int] = None, origin_dt: Optional[Datatype] = None,
            target_dt: Optional[Datatype] = None,
            target_count: Optional[int] = None) -> None:
        req = self.rget(origin, target_rank, target_disp, count, origin_dt,
                        target_dt, target_count)
        req.wait()

    def rget(self, origin, target_rank: int, target_disp: int = 0,
             count: Optional[int] = None, origin_dt: Optional[Datatype] = None,
             target_dt: Optional[Datatype] = None,
             target_count: Optional[int] = None) -> Request:
        origin, = _on_host("Win.get", origin)
        if not self._check_target(target_rank):
            return CompletedRequest()
        self._need_access_epoch(target_rank)
        odt, cnt = _resolve_dt(origin, count, origin_dt)
        tdt = target_dt or odt
        tcnt = cnt if target_count is None else target_count
        if self._cma is not None:
            packed = self._cma.get(target_rank, int(target_disp), tdt,
                                   tcnt)
            if packed is not None:
                if cnt and origin is not None:
                    odt.unpack(packed, origin, cnt)
                return CompletedRequest()
        req = _GetRequest(self.u.engine, origin, cnt, odt)
        with self.u.engine.mutex:
            self.u.engine.track(req)
        pkt = Packet(PktType.RMA_GET, self.u.world_rank, rreq_id=req.req_id,
                     extra={"win": self.win_id, "disp": int(target_disp),
                            "count": tcnt, "tdt": _ser_dt(tdt)})
        self._touched.add(target_rank)
        self._send(target_rank, pkt)
        return req

    def accumulate(self, origin, target_rank: int, target_disp: int = 0,
                   count: Optional[int] = None, op: opmod.Op = opmod.SUM,
                   origin_dt: Optional[Datatype] = None,
                   target_dt: Optional[Datatype] = None,
                   target_count: Optional[int] = None) -> None:
        self.raccumulate(origin, target_rank, target_disp, count, op,
                         origin_dt, target_dt, target_count)

    def raccumulate(self, origin, target_rank: int, target_disp: int = 0,
                    count: Optional[int] = None, op: opmod.Op = opmod.SUM,
                    origin_dt: Optional[Datatype] = None,
                    target_dt: Optional[Datatype] = None,
                    target_count: Optional[int] = None) -> Request:
        origin, = _on_host("Win.accumulate", origin)
        if not self._check_target(target_rank):
            return CompletedRequest()
        self._need_access_epoch(target_rank)
        odt, cnt = _resolve_dt(origin, count, origin_dt)
        tdt = target_dt or odt
        tcnt = cnt if target_count is None else target_count
        data = np.asarray(odt.pack(origin, cnt))
        if self._cma is not None:
            # MPI-3.1 §11.7.2: same-origin accumulates to a target are
            # ordered; a pending packet-fallback accumulate must land
            # before this synchronous direct one applies
            if target_rank in self._touched:
                self._await_acks(target_rank, PktType.RMA_FLUSH)
            if self._cma.accumulate(target_rank, int(target_disp),
                                    data, tdt, tcnt, op,
                                    fetch=False) is not None:
                return CompletedRequest()
        pkt = Packet(PktType.RMA_ACC, self.u.world_rank, nbytes=len(data),
                     data=data,
                     extra={"win": self.win_id, "disp": int(target_disp),
                            "count": tcnt, "tdt": _ser_dt(tdt),
                            "op": op.name})
        self._touched.add(target_rank)
        self._send(target_rank, pkt)
        return CompletedRequest()

    def get_accumulate(self, origin, result, target_rank: int,
                       target_disp: int = 0, count: Optional[int] = None,
                       op: opmod.Op = opmod.SUM,
                       origin_dt: Optional[Datatype] = None,
                       target_dt: Optional[Datatype] = None,
                       odt: Optional[Datatype] = None,
                       ocount: Optional[int] = None,
                       tcount: Optional[int] = None) -> None:
        self.rget_accumulate(origin, result, target_rank, target_disp,
                             count, op, origin_dt, target_dt, odt, ocount,
                             tcount).wait()

    def rget_accumulate(self, origin, result, target_rank: int,
                        target_disp: int = 0, count: Optional[int] = None,
                        op: opmod.Op = opmod.SUM,
                        origin_dt: Optional[Datatype] = None,
                        target_dt: Optional[Datatype] = None,
                        odt: Optional[Datatype] = None,
                        ocount: Optional[int] = None,
                        tcount: Optional[int] = None) -> Request:
        """All three geometries are honored: the origin packs with
        (ocount, odt), the fetch scatters into the result with
        (count, origin_dt), the target applies with (tcount,
        target_dt). Unspecified ones default to the result's — the
        MPI-3.1 §11.3.4 common case."""
        origin, result = _on_host("Win.get_accumulate", origin, result)
        if not self._check_target(target_rank):
            return CompletedRequest()
        self._need_access_epoch(target_rank)
        rdt, rcnt = _resolve_dt(result, count, origin_dt)
        tdt = target_dt or rdt
        tcnt = rcnt if tcount is None else tcount
        real_odt = odt or rdt
        ocnt = rcnt if ocount is None else ocount
        if op is opmod.NO_OP or origin is None:
            data = np.empty(0, dtype=np.uint8)
        else:
            data = np.asarray(real_odt.pack(origin, ocnt))
        if self._cma is not None:
            if target_rank in self._touched:
                # accumulate ordering vs pending packet-fallback ops
                self._await_acks(target_rank, PktType.RMA_FLUSH)
            old = self._cma.accumulate(target_rank, int(target_disp),
                                       data, tdt, tcnt, op, fetch=True)
            if old is not None:
                if rcnt and result is not None and len(old):
                    rdt.unpack(old, result, rcnt)
                return CompletedRequest()
        req = _GetRequest(self.u.engine, result, rcnt, rdt)
        with self.u.engine.mutex:
            self.u.engine.track(req)
        pkt = Packet(PktType.RMA_GET_ACC, self.u.world_rank,
                     nbytes=len(data), data=data, rreq_id=req.req_id,
                     extra={"win": self.win_id, "disp": int(target_disp),
                            "count": tcnt, "tdt": _ser_dt(tdt),
                            "op": op.name})
        self._touched.add(target_rank)
        self._send(target_rank, pkt)
        return req

    def fetch_and_op(self, origin, result, target_rank: int,
                     target_disp: int = 0, op: opmod.Op = opmod.SUM,
                     datatype: Optional[Datatype] = None) -> None:
        self.rget_accumulate(origin, result, target_rank, target_disp, 1, op,
                             datatype, datatype).wait()

    def compare_and_swap(self, origin, compare, result, target_rank: int,
                         target_disp: int = 0,
                         datatype: Optional[Datatype] = None) -> None:
        origin, compare, result = _on_host("Win.compare_and_swap", origin,
                                           compare, result)
        if not self._check_target(target_rank):
            return None              # PROC_NULL: no-op, result untouched
        self._need_access_epoch(target_rank)
        dt, _ = _resolve_dt(origin, 1, datatype)
        if self._cma is not None:
            if target_rank in self._touched:
                # accumulate-family ordering vs pending packet ops
                self._await_acks(target_rank, PktType.RMA_FLUSH)
            old = self._cma.cas(target_rank, int(target_disp),
                                np.asarray(dt.pack(origin, 1)),
                                np.asarray(dt.pack(compare, 1)), dt)
            if old is not None:
                dt.unpack(old, result, 1)
                return None
        req = _GetRequest(self.u.engine, result, 1, dt)
        with self.u.engine.mutex:
            self.u.engine.track(req)
        pkt = Packet(PktType.RMA_CAS, self.u.world_rank, rreq_id=req.req_id,
                     nbytes=2 * dt.size,   # new value + compare operand
                     data=np.concatenate([np.asarray(dt.pack(origin, 1)),
                                          np.asarray(dt.pack(compare, 1))]),
                     extra={"win": self.win_id, "disp": int(target_disp),
                            "tdt": _ser_dt(dt)})
        self._touched.add(target_rank)
        self._send(target_rank, pkt)
        req.wait()

    # ------------------------------------------------------------------
    # synchronization: fence
    # ------------------------------------------------------------------
    def fence(self, assertion: int = 0) -> None:
        """MPI_Win_fence: complete my issued ops everywhere, then barrier
        so everyone's exposure epoch closes together."""
        self._flush_targets(sorted(self._touched))
        self.comm.barrier()
        self.epoch = "fence"

    # ------------------------------------------------------------------
    # synchronization: PSCW (general active target)
    # ------------------------------------------------------------------
    def post(self, group) -> None:
        """Expose this window to ``group`` (a Group of origin ranks)."""
        me = self.u.world_rank
        with self.u.engine.mutex:
            self.tsync.completes.clear()
            self.tsync.posts_from = set(group.world_ranks)
        for wr in group.world_ranks:
            pkt = Packet(PktType.RMA_PSCW_POST, me,
                         extra={"win": self.win_id})
            self._send_world(wr, pkt)

    def start(self, group) -> None:
        """Begin an access epoch to ``group`` (target ranks). Blocks until
        all targets have posted (the strict interpretation)."""
        mpi_assert(self.epoch not in ("start", "lock", "lock_all"),
                   MPI_ERR_RMA_SYNC,
                   f"start() inside an open {self.epoch} epoch "
                   "(errors/rma/win_sync_nested.c)")
        self._start_group = group
        worlds = set(group.world_ranks)
        self.u.engine.progress_wait(
            lambda: worlds.issubset(self._posts_seen))
        with self.u.engine.mutex:
            self._posts_seen -= worlds
        self.epoch = "start"

    def complete(self) -> None:
        """End the access epoch begun by start(): flush, notify targets."""
        mpi_assert(self.epoch == "start", MPI_ERR_RMA_SYNC,
                   "complete() without start()")
        group = self._start_group
        self._flush_targets([self.comm.group.rank_of_world(wr)
                             for wr in group.world_ranks])
        for wr in group.world_ranks:
            self._send_world(wr, Packet(PktType.RMA_PSCW_COMPLETE,
                                        self.u.world_rank,
                                        extra={"win": self.win_id}))
        self._start_group = None
        self.epoch = None

    def wait(self) -> None:
        """Close the exposure epoch: wait for COMPLETE from every origin."""
        ts = self.tsync
        self.u.engine.progress_wait(
            lambda: ts.posts_from.issubset(ts.completes))
        with self.u.engine.mutex:
            ts.posts_from.clear()
            ts.completes.clear()

    def test(self) -> bool:
        self.u.engine.progress_poke()
        ts = self.tsync
        with self.u.engine.mutex:
            done = ts.posts_from.issubset(ts.completes)
            if done:
                ts.posts_from.clear()
                ts.completes.clear()
        return done

    # ------------------------------------------------------------------
    # synchronization: passive target (lock/flush)
    # ------------------------------------------------------------------
    def lock(self, rank: int, lock_type: int = LOCK_SHARED,
             assertion: int = 0) -> None:
        mpi_assert(self.epoch != "start", MPI_ERR_RMA_SYNC,
                   "lock() inside an active-target (start) epoch "
                   "(errors/rma/win_sync_lock_at.c)")
        mpi_assert(rank not in self._locked_targets, MPI_ERR_RMA_SYNC,
                   f"target {rank} is already locked "
                   "(errors/rma/win_sync_lock_pt.c)")
        if not self._check_target(rank):
            # PROC_NULL epoch: legal and empty (rmanull.c) — track it so
            # the matching unlock is accepted
            self._locked_targets[rank] = lock_type
            self.epoch = "lock"
            return
        if self._cma is not None:
            # native passive lock: kernel record lock, no round trip
            self._cma.lock_target(rank, lock_type == LOCK_EXCLUSIVE,
                                  self.u.engine)
            self._locked_targets[rank] = lock_type
            self.epoch = "lock"
            return
        req = _LockRequest(self.u.engine)
        with self.u.engine.mutex:
            self.u.engine.track(req)
        self._send(rank, Packet(PktType.RMA_LOCK, self.u.world_rank,
                                rreq_id=req.req_id,
                                extra={"win": self.win_id,
                                       "mode": lock_type}))
        req.wait()
        self._locked_targets[rank] = lock_type
        self.epoch = "lock"

    def unlock(self, rank: int) -> None:
        mpi_assert(rank in self._locked_targets, MPI_ERR_RMA_SYNC,
                   f"unlock of unlocked target {rank}")
        if not self._check_target(rank):      # PROC_NULL: empty epoch
            del self._locked_targets[rank]
            if not self._locked_targets:
                self.epoch = None
            return
        if self._cma is not None:
            # direct ops are already applied; only packet-fallback ops
            # need a completion fence before the kernel lock releases
            if rank in self._touched:
                self._await_acks(rank, PktType.RMA_FLUSH)
            self._cma.unlock_target(rank)
            del self._locked_targets[rank]
            self._touched.discard(rank)
            if not self._locked_targets:
                self.epoch = None
            return
        # UNLOCK is ordered after all my ops on this channel, and its ack
        # confirms both application and lock release (flush semantics).
        self._await_acks(rank, PktType.RMA_UNLOCK)
        del self._locked_targets[rank]
        self._touched.discard(rank)
        if not self._locked_targets:
            self.epoch = None

    def lock_all(self, assertion: int = 0) -> None:
        for r in range(self.comm.size):
            self.lock(r, LOCK_SHARED, assertion)
        self.epoch = "lock_all"

    def unlock_all(self) -> None:
        self.epoch = "lock"   # so unlock() bookkeeping runs
        for r in list(self._locked_targets):
            self.unlock(r)

    def flush(self, rank: int) -> None:
        if not self._check_target(rank):
            return
        if rank not in self._touched:
            # nothing packet-pending toward this target (direct CMA ops
            # complete synchronously): flush is a local no-op
            return
        self._await_acks(rank, PktType.RMA_FLUSH)

    def flush_all(self) -> None:
        self._flush_targets(sorted(self._touched))

    def flush_local(self, rank: int) -> None:
        # all ops buffer their payload at issue time → locally complete
        pass

    def flush_local_all(self) -> None:
        pass

    def sync(self) -> None:
        """Memory barrier between window copies — unified model no-op."""
        self.u.engine.progress_poke()

    def _await_acks(self, rank: int, ptype: PktType) -> None:
        with self.u.engine.mutex:
            self._acks_wanted += 1
        self._send(rank, Packet(ptype, self.u.world_rank,
                                extra={"win": self.win_id}))
        self.u.engine.progress_wait(
            lambda: self._acks_seen >= self._acks_wanted)
        self._touched.discard(rank)

    def _flush_targets(self, targets: Sequence[int]) -> None:
        if not targets:
            return
        with self.u.engine.mutex:
            self._acks_wanted += len(targets)
        for r in targets:
            self._send(r, Packet(PktType.RMA_FLUSH, self.u.world_rank,
                                 extra={"win": self.win_id}))
        self.u.engine.progress_wait(
            lambda: self._acks_seen >= self._acks_wanted)
        self._touched.clear()

    # ------------------------------------------------------------------
    # shared windows
    # ------------------------------------------------------------------
    def shared_query(self, rank: int) -> Tuple[np.ndarray, int, int]:
        """(memory view, size, disp_unit) of ``rank``'s segment."""
        mpi_assert(self.flavor == FLAVOR_SHARED, MPI_ERR_WIN,
                   "shared_query on non-shared window")
        if rank == PROC_NULL:   # lowest rank with a nonzero segment
            nz = [r for r, (_, sz) in self._peers.items() if sz > 0]
            rank = min(nz) if nz else 0
        off, size = self._peers[rank]
        seg = np.frombuffer(self._shm.buf, dtype=np.uint8)
        return seg[off:off + size], size, self.disp_unit

    # ------------------------------------------------------------------
    # admin
    # ------------------------------------------------------------------
    def get_group(self):
        return self.group

    def set_name(self, name: str) -> None:
        self.name = name

    def get_name(self) -> str:
        return self.name

    def set_info(self, info) -> None:
        """``info``: a dict or a ``core/info.py`` ``Info``."""
        self.info.update(dict(info.items()) if isinstance(info, Info)
                         else info)

    def get_info(self) -> Dict[str, str]:
        return dict(self.info)

    def check_free(self) -> None:
        """Free inside an open LOCK or PSCW epoch is an RMA sync error,
        reported (not fatal) through the window's errhandler — the
        window must survive (errors/rma/win_sync_free_pt.c frees while
        locked, then unlocks and frees again). A closed fence sequence
        leaves epoch == "fence"; that is NOT an open epoch (§11.5.1:
        fence both closes and opens — free after a final fence is the
        normal shutdown). Exposed separately so the C boundary can
        validate BEFORE running attribute delete callbacks (which must
        see a live window)."""
        mpi_assert(self.epoch != "start" and not self._locked_targets
                   and not self.tsync.posts_from, MPI_ERR_RMA_SYNC,
                   "free of a window with an open epoch")

    def free(self) -> None:
        if not self.freed:
            self.check_free()
        self.attrs.delete_all(self)
        if self.freed:
            return
        self.comm.barrier()
        _manager(self.u).remove_window(self)
        if self._cma is not None:
            self._cma.close()
            if self.comm.rank == 0:
                import os
                try:
                    os.unlink(self._cma.lockpath)
                except OSError:
                    pass
            self._cma = None
        if self._shm is not None:
            self.base = None
            if self._shm_owner:
                try:
                    self._shm.unlink()   # POSIX: ok while still mapped
                except FileNotFoundError:
                    pass
            try:
                self._shm.close()
            except BufferError:
                # user-held views (shared_query results) keep the mapping
                # alive; the segment is already unlinked, so it dies with
                # the last view. Pin the handle so __del__ doesn't retry
                # (and noisily fail) at GC time.
                _leaked_shm.append(self._shm)
        self.freed = True

    def __repr__(self):
        return (f"Win(id={self.win_id}, flavor={self.flavor}, "
                f"size={self.size}, epoch={self.epoch})")


class _GetRequest(Request):
    """Origin-side request completed by a *_RESP packet."""

    def __init__(self, engine, buf, count: int, dt: Datatype):
        super().__init__(engine, "rma_get")
        self.buf = buf
        self.count = count
        self.dt = dt


class _LockRequest(Request):
    def __init__(self, engine):
        super().__init__(engine, "rma_lock")


def _resolve_dt(buf, count, dt) -> Tuple[Datatype, int]:
    if dt is None:
        arr = np.asarray(buf)
        dt = dtmod.from_numpy_dtype(arr.dtype)
        if count is None:
            count = arr.size
    elif count is None:
        raw = as_bytes_view(buf)
        count = len(raw) // dt.extent if dt.extent else 0
    return dt, int(count)


# ---------------------------------------------------------------------------
# target-side manager (packet handlers)
# ---------------------------------------------------------------------------

class RmaManager:
    """Per-universe handler hub for RMA packets (the ch3u_rma_* packet
    handler table analog). All handlers run under the engine mutex."""

    def __init__(self, universe):
        self.u = universe
        eng = universe.engine
        for pt, fn in [(PktType.RMA_PUT, self._on_put),
                       (PktType.RMA_GET, self._on_get),
                       (PktType.RMA_GET_RESP, self._on_get_resp),
                       (PktType.RMA_ACC, self._on_acc),
                       (PktType.RMA_GET_ACC, self._on_get_acc),
                       (PktType.RMA_CAS, self._on_cas),
                       (PktType.RMA_LOCK, self._on_lock),
                       (PktType.RMA_LOCK_GRANTED, self._on_lock_granted),
                       (PktType.RMA_UNLOCK, self._on_unlock),
                       (PktType.RMA_FLUSH, self._on_flush),
                       (PktType.RMA_FLUSH_ACK, self._on_flush_ack),
                       (PktType.RMA_PSCW_POST, self._on_post),
                       (PktType.RMA_PSCW_COMPLETE, self._on_complete)]:
            # asynchronous: passive-target ops must progress while the
            # target rank is idle (progress.py ProgressEngine.async_types)
            eng.register_handler(pt, fn, asynchronous=True)

    def add_window(self, win: Win) -> None:
        self.u.windows[win.win_id] = win

    def remove_window(self, win: Win) -> None:
        self.u.windows.pop(win.win_id, None)

    def _win(self, pkt: Packet) -> Win:
        win = self.u.windows.get(pkt.extra["win"])
        if win is None:
            raise MPIException(MPI_ERR_WIN,
                               f"packet for unknown window {pkt.extra}")
        return win

    def send_to(self, dest_world: int, pkt: Packet) -> None:
        """Single routing point: self-targets dispatch inline under the
        engine RLock (reentrant — safe from inside handlers too), remote
        targets go through the channel."""
        if dest_world == self.u.world_rank:
            with self.u.engine.mutex:
                self.u.engine._dispatch(pkt)
        else:
            self.u.channel_for(dest_world).send_packet(dest_world, pkt)

    def _reply(self, pkt: Packet, out: Packet) -> None:
        self.send_to(pkt.src_world, out)

    # -- data ops --------------------------------------------------------
    def _on_put(self, pkt: Packet) -> None:
        win = self._win(pkt)
        tdt = _deser_dt(pkt.extra["tdt"])
        cnt = pkt.extra["count"]
        region = win._region(pkt.extra["disp"], _dt_span(tdt, cnt))
        if cnt:
            tdt.unpack(pkt.data, region, cnt)

    def _on_get(self, pkt: Packet) -> None:
        win = self._win(pkt)
        tdt = _deser_dt(pkt.extra["tdt"])
        cnt = pkt.extra["count"]
        region = win._region(pkt.extra["disp"], _dt_span(tdt, cnt))
        data = np.asarray(tdt.pack(region, cnt)) if cnt else \
            np.empty(0, np.uint8)
        self._reply(pkt, Packet(PktType.RMA_GET_RESP, self.u.world_rank,
                                nbytes=len(data), data=data,
                                rreq_id=pkt.rreq_id))

    def _on_get_resp(self, pkt: Packet) -> None:
        req = self.u.engine.outstanding.get(pkt.rreq_id)
        if req is None:
            return
        if req.buf is not None and pkt.nbytes:
            req.dt.unpack(pkt.data, req.buf, req.count)
        req.complete()

    def _apply_acc(self, win: Win, pkt: Packet, fetch: bool) -> Optional[np.ndarray]:
        tdt = _deser_dt(pkt.extra["tdt"])
        cnt = pkt.extra["count"]
        op = _op_by_name(pkt.extra["op"])
        # a packet acc on a direct-access window must hold the same
        # mutex direct origins use, or span-overflow fallbacks race
        # them. Bounded: this runs on the engine thread, and holders
        # are short memory-op critical sections — expiry means a peer
        # died mid-section and must surface as an error, not a hang.
        cma = win._cma
        if cma is not None:
            cma.acquire(timeout=_ACC_MUTEX_TIMEOUT)
        try:
            region = win._region(pkt.extra["disp"], _dt_span(tdt, cnt))
            old = np.asarray(tdt.pack(region, cnt)) if cnt else \
                np.empty(0, np.uint8)
            if cnt and op is not opmod.NO_OP and pkt.nbytes:
                tdt.unpack(_rmw_packed(old, pkt.data, tdt, op), region,
                           cnt)
        finally:
            if cma is not None:
                cma.release()
        return old if fetch else None

    def _on_acc(self, pkt: Packet) -> None:
        self._apply_acc(self._win(pkt), pkt, fetch=False)

    def _on_get_acc(self, pkt: Packet) -> None:
        old = self._apply_acc(self._win(pkt), pkt, fetch=True)
        self._reply(pkt, Packet(PktType.RMA_GET_RESP, self.u.world_rank,
                                nbytes=len(old), data=old,
                                rreq_id=pkt.rreq_id))

    def _on_cas(self, pkt: Packet) -> None:
        win = self._win(pkt)
        tdt = _deser_dt(pkt.extra["tdt"])
        # the same bounded accumulate mutex as _apply_acc
        cma = win._cma
        if cma is not None:
            cma.acquire(timeout=_ACC_MUTEX_TIMEOUT)
        try:
            region = win._region(pkt.extra["disp"], tdt.extent)
            old = np.asarray(tdt.pack(region, 1))
            n = tdt.size
            newv, comp = pkt.data[:n], pkt.data[n:2 * n]
            if np.array_equal(old, comp):
                tdt.unpack(newv, region, 1)
        finally:
            if cma is not None:
                cma.release()
        self._reply(pkt, Packet(PktType.RMA_GET_RESP, self.u.world_rank,
                                nbytes=len(old), data=old,
                                rreq_id=pkt.rreq_id))

    # -- locks -----------------------------------------------------------
    def _grant(self, win: Win, origin: int, rreq_id: int) -> None:
        self.send_to(origin, Packet(PktType.RMA_LOCK_GRANTED,
                                    self.u.world_rank, rreq_id=rreq_id,
                                    extra={"win": win.win_id}))

    def _on_lock(self, pkt: Packet) -> None:
        win = self._win(pkt)
        ts = win.tsync
        mode = pkt.extra["mode"]
        origin = pkt.src_world
        if ts.lock_mode == 0 or (ts.lock_mode == LOCK_SHARED
                                 and mode == LOCK_SHARED
                                 and not ts.lock_queue):
            ts.lock_mode = mode
            ts.lock_holders.add(origin)
            self._grant(win, origin, pkt.rreq_id)
        else:
            ts.lock_queue.append((origin, mode, pkt.rreq_id))

    def _on_lock_granted(self, pkt: Packet) -> None:
        req = self.u.engine.outstanding.get(pkt.rreq_id)
        if req is not None:
            req.complete()

    def _on_unlock(self, pkt: Packet) -> None:
        win = self._win(pkt)
        ts = win.tsync
        ts.lock_holders.discard(pkt.src_world)
        if not ts.lock_holders:
            ts.lock_mode = 0
            while ts.lock_queue:
                origin, mode, rid = ts.lock_queue[0]
                if ts.lock_mode == 0:
                    ts.lock_mode = mode
                    ts.lock_holders.add(origin)
                    ts.lock_queue.pop(0)
                    self._grant(win, origin, rid)
                    if mode == LOCK_EXCLUSIVE:
                        break
                elif ts.lock_mode == LOCK_SHARED and mode == LOCK_SHARED:
                    ts.lock_holders.add(origin)
                    ts.lock_queue.pop(0)
                    self._grant(win, origin, rid)
                else:
                    break
        # unlock acks like a flush (ops already applied: FIFO order)
        self._reply(pkt, Packet(PktType.RMA_FLUSH_ACK, self.u.world_rank,
                                extra={"win": win.win_id}))

    def _on_flush(self, pkt: Packet) -> None:
        win = self._win(pkt)
        self._reply(pkt, Packet(PktType.RMA_FLUSH_ACK, self.u.world_rank,
                                extra={"win": win.win_id}))

    def _on_flush_ack(self, pkt: Packet) -> None:
        win = self._win(pkt)
        win._acks_seen += 1
        self.u.engine.wakeup()

    # -- PSCW ------------------------------------------------------------
    def _on_post(self, pkt: Packet) -> None:
        win = self._win(pkt)
        win._posts_seen.add(pkt.src_world)
        self.u.engine.wakeup()

    def _on_complete(self, pkt: Packet) -> None:
        win = self._win(pkt)
        win.tsync.completes.add(pkt.src_world)
        self.u.engine.wakeup()


_OPS_BY_NAME = {op.name: op for op in
                (opmod.SUM, opmod.PROD, opmod.MAX, opmod.MIN, opmod.LAND,
                 opmod.LOR, opmod.LXOR, opmod.BAND, opmod.BOR, opmod.BXOR,
                 opmod.MINLOC, opmod.MAXLOC, opmod.REPLACE, opmod.NO_OP)}


def _op_by_name(name: str) -> opmod.Op:
    op = _OPS_BY_NAME.get(name)
    if op is None:
        raise MPIException(MPI_ERR_ARG, f"unknown RMA op {name}")
    return op


def _manager(universe) -> RmaManager:
    mgr = getattr(universe, "_rma_manager", None)
    if mgr is None:
        mgr = RmaManager(universe)
        universe._rma_manager = mgr
    return mgr


# ---------------------------------------------------------------------------
# window constructors (all collective over comm)
# ---------------------------------------------------------------------------

def _setup_direct(win) -> None:
    """Direct cross-memory access for the new window: none on the port.
    The JAX package's ``rma/cma.py`` grants it only to a window whose
    universe has a C-plane channel that owns the comm, and the port has
    no C plane, so its verdict would always be None; the direct path
    waits with the C plane. Every ``if self._cma is not None`` branch of
    ``Win`` stays, for that path to drop in."""
    win._cma = None


def _alloc_win_id(comm) -> int:
    """Collectively agree on a fresh window id (context-id discipline)."""
    from ..coll import api as coll
    with Win._id_lock:
        mine = Win._next_id
    arr = np.array([mine], dtype=np.int64)
    out = np.zeros_like(arr)
    coll.allreduce(comm, arr, out, 1, None, opmod.MAX)
    wid = int(out[0])
    with Win._id_lock:
        Win._next_id = max(Win._next_id, wid + 1)
    return wid


def win_create(comm, buf, disp_unit: int = 1) -> Win:
    """MPI_Win_create: expose caller-provided memory (numpy, or a CPU
    tensor in place)."""
    buf, = _on_host("win_create", buf)
    wid = _alloc_win_id(comm)
    if buf is None:
        base, size = np.empty(0, np.uint8), 0
    else:
        if not buf.flags["C_CONTIGUOUS"]:
            # reshape(-1) would copy and silently decouple the window
            raise MPIException(MPI_ERR_ARG,
                               "window buffer must be C-contiguous")
        raw = buf.reshape(-1).view(np.uint8)
        base, size = raw, raw.nbytes
    win = Win(comm, base, size, disp_unit, FLAVOR_CREATE, wid)
    _setup_direct(win)
    comm.barrier()   # all ranks registered before any op can arrive
    return win


def win_allocate(comm, size: int, disp_unit: int = 1) -> Win:
    """MPI_Win_allocate: framework-allocated memory (win.base)."""
    wid = _alloc_win_id(comm)
    base = np.zeros(size, dtype=np.uint8)
    win = Win(comm, base, size, disp_unit, FLAVOR_ALLOCATE, wid)
    _setup_direct(win)
    comm.barrier()
    return win


def win_create_dynamic(comm) -> Win:
    """MPI_Win_create_dynamic: no memory until attach()."""
    wid = _alloc_win_id(comm)
    win = Win(comm, None, 0, 1, FLAVOR_DYNAMIC, wid)
    _setup_direct(win)
    comm.barrier()
    return win


def win_allocate_shared(comm, size: int, disp_unit: int = 1) -> Win:
    """MPI_Win_allocate_shared: one cross-process segment, contiguous
    rank-ordered layout (the mv2_rma_allocate_shm analog). The owner
    (rank 0) unlinks it in ``free``; a mapping a ``shared_query`` view
    still holds stays pinned in ``_leaked_shm``."""
    from multiprocessing import shared_memory
    from ..coll import api as coll

    wid = _alloc_win_id(comm)
    sizes = np.zeros(comm.size, dtype=np.int64)
    coll.allgather(comm, np.array([size], dtype=np.int64), sizes, 1, None)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    total = max(1, int(sizes.sum()))

    # unique segment name generated by rank 0 and broadcast, so concurrent
    # jobs on one host can't collide (same discipline as transport/shm.py)
    shm = None
    owner = False
    namebuf = np.zeros(64, dtype=np.uint8)
    if comm.rank == 0:
        import os
        import uuid
        name = f"mv2tpu_win_{os.getpid()}_{uuid.uuid4().hex[:12]}"
        shm = shared_memory.SharedMemory(name=name, create=True, size=total)
        shm.buf[:total] = b"\0" * total
        owner = True
        enc = name.encode()
        namebuf[:len(enc)] = np.frombuffer(enc, dtype=np.uint8)
    comm.bcast(namebuf, 0)
    if shm is None:
        name = bytes(namebuf[namebuf != 0]).decode()
        shm = shared_memory.SharedMemory(name=name, create=False)

    seg = np.frombuffer(shm.buf, dtype=np.uint8)
    off = int(offsets[comm.rank])
    base = seg[off:off + size]
    win = Win(comm, base, size, disp_unit, FLAVOR_SHARED, wid)
    win._shm = shm
    win._shm_owner = owner
    win._peers = {r: (int(offsets[r]), int(sizes[r]))
                  for r in range(comm.size)}
    _setup_direct(win)
    comm.barrier()
    return win
