"""The per-rank progress engine every blocking call funnels into (a
trimmed copy of the JAX package's ``transport/progress.py``).

    loop { drain inbox; poll channels; run progress hooks; sleep }

One engine a rank. Thread ranks of one process deliver a packet by
appending it to the peer engine's inbox and ringing its doorbell; the
rank processes of ``mpirun`` (``runtime/launcher.py``) reach each other
through channels the engine polls in each pass (``add_channel``: the TCP
and shared-memory channels, ``transport/tcp.py`` and
``transport/shm.py``). All rank-local protocol state (matching queues,
requests, schedules) is mutated under ``mutex``.

The idle wait takes one of two forms:

* when no channel names a file (the in-process fabric, with or without
  a device channel), a wait sleeps on the doorbell (:class:`Doorbell`):
  a delivery, a completion or ``wakeup`` rings it, and the device
  channels' rendezvous rings every member engine's doorbell when a
  nonblocking deposit lands, a segment launches or a rank aborts
  (``coll/device.py``). A device segment's completion on the card rings
  nothing, so while a schedule has a parked device poll a wait sleeps at
  most ``POLL_SLICE_S``;
* when a channel names files (``wait_fds``: sockets, shared-memory
  doorbells), the wait selects on their union plus the engine's
  self-pipe, which ``wakeup`` writes, as the JAX engine does; channels
  are told before the last poll that the rank is about to sleep
  (``pre_wait``) and after the wait that it woke (``post_wait``).

Either way futile passes back off from 0.5 ms to 8 ms, as the JAX
engine's do. The JAX engine's asynchronous packet types (passive-target
host windows), liveness leases, stall watchdog and lock-order monitor
belong to tiers that are not ported.

Pvar: ``progress_polls`` (poll passes, every rank of the process).
"""

from __future__ import annotations

import collections
import os
import select
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import mpit
from ..core.errors import MPI_ERR_INTERN, MPIException
from ..core.request import Request
from .base import Channel, Packet, PktType

# the longest a waiter sleeps between two passes while a device segment
# is parked on its schedule (seconds)
POLL_SLICE_S = 2e-4

_pv_polls = mpit.pvar("progress_polls", mpit.PVAR_CLASS_COUNTER,
                      "progress-engine poll passes (all ranks in this "
                      "process)")


class Doorbell:
    """A condition with a ring counter: ``ring`` wakes every sleeper (and
    rings every doorbell in ``followers``); ``sleep(seen, timeout)``
    returns at once if a ring came after the caller read ``rings`` as
    ``seen``, so no ring between a pass and the sleep is lost. A ring
    notifies only a bell that has a sleeper: the device rendezvous rings
    the bells of all its member ranks on every deposit and launch, and
    most of them are awake."""

    def __init__(self):
        self._lock = threading.Lock()
        self.cond = threading.Condition(self._lock)
        self.rings = 0
        self.sleepers = 0
        self.followers: List["Doorbell"] = []

    def ring(self) -> None:
        for b in (self, *self.followers):
            with b._lock:
                b.rings += 1
                if b.sleepers:
                    b.cond.notify_all()

    def sleep(self, seen: int, timeout: float) -> bool:
        """True when a ring came since ``seen`` (before or during the
        sleep), False when the timeout ended it."""
        with self._lock:
            if self.rings == seen:
                self.sleepers += 1
                try:
                    self.cond.wait(timeout)
                finally:
                    self.sleepers -= 1
            return self.rings != seen


class ProgressEngine:
    def __init__(self, rank: int):
        self.rank = rank
        self.mutex = threading.RLock()
        self._inbox = collections.deque()
        self._inbox_lock = threading.Lock()
        self.bell = Doorbell()
        # pkt type -> handler(pkt); populated by the protocol layer
        self.pkt_handlers: Dict[int, Callable[[Packet], None]] = {}
        # req_id -> Request, for CTS/FIN/RESP lookup
        self.outstanding: Dict[int, Request] = {}
        # registered progress hooks (the nonblocking-collective scheduler)
        self.hooks: List[Callable[[], bool]] = []
        self.universe = None
        self.nbc = None          # coll/nbc/engine.py nbc_engine
        # polled channels (process mode) and the self-pipe ``wakeup``
        # writes so a wait blocked in select() on their files ends; the
        # pipe is made when the first channel with files is added
        self.channels: List[Channel] = []
        self._fd_channels = False
        self._wake_r: Optional[int] = None
        self._wake_w: Optional[int] = None

    @property
    def tracer(self):
        u = self.universe
        return u.tracer if u is not None else None

    # -- wiring -----------------------------------------------------------
    def add_channel(self, ch: Channel) -> None:
        ch.attach(self)
        self.channels.append(ch)
        if ch.wait_fds():
            self._fd_channels = True
            if self._wake_r is None:
                self._wake_r, self._wake_w = os.pipe2(os.O_NONBLOCK)

    def register_handler(self, ptype: PktType, fn: Callable) -> None:
        self.pkt_handlers[int(ptype)] = fn

    def register_hook(self, fn: Callable[[], bool]) -> None:
        """Register a progress hook, run (mutex held) at the end of every
        poll pass; it returns True when it made progress. Whatever can
        make a hook's work runnable (a completion, a delivery) rings the
        doorbell, so a waiter re-polls at once."""
        self.hooks.append(fn)

    # -- packet delivery (any thread) -------------------------------------
    def enqueue_incoming(self, pkt: Packet) -> None:
        with self._inbox_lock:
            self._inbox.append(pkt)
        self.bell.ring()

    def wakeup(self) -> None:
        self.bell.ring()
        if self._wake_w is not None:
            try:
                os.write(self._wake_w, b"x")
            except OSError:
                pass    # pipe full: a wakeup byte is already pending

    # -- completion (owning thread, mutex held) ---------------------------
    def complete_request(self, req: Request) -> None:
        with self.mutex:
            self.outstanding.pop(req.req_id, None)
            req._fire()
        self.wakeup()

    def track(self, req: Request) -> Request:
        self.outstanding[req.req_id] = req
        return req

    # -- the loop ---------------------------------------------------------
    def _dispatch(self, pkt: Packet) -> None:
        fn = self.pkt_handlers.get(int(pkt.type))
        if fn is None:
            raise MPIException(MPI_ERR_INTERN,
                               f"no handler for packet {pkt.type.name}")
        fn(pkt)

    def _drain_inbox(self) -> int:
        n = 0
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    break
                pkt = self._inbox.popleft()
            self._dispatch(pkt)
            n += 1
        return n

    def progress_poke(self) -> bool:
        """One nonblocking pass (MPID_Progress_test analog). The rank
        threads of a device NBC wait run one every POLL_SLICE_S under the
        GIL, so it does no more than it must."""
        with self.mutex:
            _pv_polls.inc()
            npkts = self._drain_inbox() if self._inbox else 0
            if self.channels:       # process mode; thread ranks have none
                moved = False
                for ch in self.channels:
                    if ch.poll():
                        moved = True
                if moved:           # the channels' I/O counts as work
                    npkts += 1 + self._drain_inbox()
            nhooks = 0
            for hook in self.hooks:
                if hook():
                    nhooks += 1
        return bool(npkts or nhooks)

    def progress_wait(self, pred: Callable[[], bool],
                      timeout: Optional[float] = None) -> None:
        """Poll and sleep until ``pred()`` (MPID_Progress_wait analog)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.mutex:
            if pred():
                return
        if self._fd_channels:
            return self._progress_wait_fds(pred, deadline)
        spin = 0
        while True:
            seen = self.bell.rings     # sampled before the poll
            if self.progress_poke():
                spin = 0
            with self.mutex:
                if pred():
                    return
            spin += 1
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("progress_wait timed out")
            nbc = self.nbc
            if nbc is not None and nbc.has_parked_polls():
                idle_t = POLL_SLICE_S
            else:
                idle_t = min(0.0005 * (1 << min(spin - 1, 4)), 0.008)
            if self.bell.sleep(seen, idle_t) and nbc is not None:
                nbc.note_wakeup()

    def _progress_wait_fds(self, pred: Callable[[], bool],
                           deadline: Optional[float]) -> None:
        """The idle wait of a rank with polled channels: select on their
        files and the self-pipe (the JAX engine's wait)."""
        spin = 0
        while True:
            # advertise the sleep BEFORE the final empty poll: a sender
            # writing after that poll sees the flag and rings the
            # doorbell; one writing before it is caught by the poll
            for ch in self.channels:
                ch.pre_wait()
            try:
                seen = self.bell.rings
                if self.progress_poke():
                    spin = 0
                with self.mutex:
                    if pred():
                        return
                spin += 1
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("progress_wait timed out")
                if self.bell.rings != seen:
                    continue        # a completion came during the pass
                nbc = self.nbc
                if nbc is not None and nbc.has_parked_polls():
                    idle_t = POLL_SLICE_S
                else:
                    idle_t = min(0.0005 * (1 << min(spin - 1, 4)), 0.008)
                fds = [self._wake_r]
                for ch in self.channels:
                    fds.extend(ch.wait_fds())
                try:
                    ready, _, _ = select.select(fds, [], [], idle_t)
                except (OSError, ValueError):
                    ready = ()      # a file closed under the wait
                    time.sleep(idle_t)
                if self._wake_r in ready:
                    try:
                        os.read(self._wake_r, 4096)
                    except OSError:
                        pass
                if ready and nbc is not None:
                    nbc.note_wakeup()
            finally:
                for ch in self.channels:
                    ch.post_wait()

    def drain_all(self, timeout: float = 5.0) -> int:
        """Progress until no work remains (Finalize); returns the passes
        that did work."""
        end = time.monotonic() + timeout
        idle, did = 0, 0
        while time.monotonic() < end:
            if self.progress_poke():
                idle = 0
                did += 1
            else:
                idle += 1
                if idle > 3:
                    break
                time.sleep(0.0002)
        return did

    def close(self) -> None:
        for ch in self.channels:
            ch.close()
        self.wakeup()
        for fd in (self._wake_r, self._wake_w):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._wake_r = self._wake_w = None
