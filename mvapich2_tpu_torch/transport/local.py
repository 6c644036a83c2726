"""The in-process fabric of thread ranks (a copy of the JAX package's
``transport/local.py``).

Every rank is a thread of one process: packets hop between the ranks'
engine inboxes by reference, and the zero-copy rendezvous (RGET) passes
numpy buffer references directly: the receiver pulls from the sender's
exposed buffer through a fabric handle.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List

import numpy as np

from .base import Channel, Packet
from .progress import ProgressEngine


class LocalFabric:
    """Shared switchboard: world rank -> engine."""

    def __init__(self, nranks: int):
        self.nranks = nranks
        self.engines: Dict[int, ProgressEngine] = {}
        self._lock = threading.Lock()
        # thread-mode spawn (runtime/spawn.py): the next free proc id,
        # the spawned ranks' threads and the errors they ended with
        # (proc id -> exception), which run_ranks joins and reports
        self._next_proc = nranks
        self.spawned: List[threading.Thread] = []
        self.spawn_errors: Dict[int, BaseException] = {}
        # exposed buffers for the RGET path: handle -> ndarray
        self._exposed: Dict[int, np.ndarray] = {}
        self._handle_ids = itertools.count(1)

    def register(self, rank: int, engine: ProgressEngine) -> None:
        with self._lock:
            self.engines[rank] = engine

    def deliver(self, dest: int, pkt: Packet) -> None:
        eng = self.engines.get(dest)
        if eng is None:
            raise RuntimeError(f"no engine for rank {dest}")
        eng.enqueue_incoming(pkt)

    def expose(self, arr: np.ndarray) -> int:
        h = next(self._handle_ids)
        with self._lock:
            self._exposed[h] = arr
        return h

    def pull(self, handle: int) -> np.ndarray:
        with self._lock:
            return self._exposed[handle]

    def release(self, handle: int) -> None:
        with self._lock:
            self._exposed.pop(handle, None)


class LocalChannel(Channel):
    name = "local"
    supports_rget = True

    def __init__(self, fabric: LocalFabric, my_rank: int):
        self.fabric = fabric
        self.my_rank = my_rank

    def send_packet(self, dest_world: int, pkt: Packet) -> None:
        if pkt.data is not None:
            # Eager payloads are copied at injection so the sender's buffer
            # is immediately reusable (MPI eager semantics; the vbuf copy).
            # Self-sends included: the protocol may hand a live VIEW of
            # the user buffer (zero-copy eager), which the user can
            # overwrite the moment the send completes locally.
            pkt.data = np.array(pkt.data, dtype=np.uint8, copy=True)
        # no wire blob on the thread fabric: the payload size is the
        # honest byte count (delivery is a reference hop, recv side has
        # no channel pass — send-side accounting covers the traffic)
        self.account_send(dest_world, pkt.nbytes)
        self.fabric.deliver(dest_world, pkt)

    def expose_buffer(self, array: np.ndarray):
        return self.fabric.expose(array)

    def pull_buffer(self, src_world: int, handle, nbytes: int) -> np.ndarray:
        src = self.fabric.pull(handle)
        return src[:nbytes]

    def release_buffer(self, handle) -> None:
        self.fabric.release(handle)
