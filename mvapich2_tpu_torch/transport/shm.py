"""The shared-memory channel between rank processes of one node (a trimmed
copy of the JAX package's ``transport/shm.py``, on its Python ring).

One segment a node, created by the node's leader (the lowest co-located
rank) at the light boot (``runtime/boot.py``) and mapped by every
co-located rank: ``n_local x n_local`` single-producer rings, one a
(src, dst) pair, in the JAX package's layout (:class:`_PyRing`: a
128-byte control block with the head and tail counters, then
length-prefixed records aligned to 8 bytes, a wrap marker where a
record does not fit before the end). A packet travels as its wire blob
(``transport/base.py`` ``encode_packet``); a full ring backlogs the blob
and ``poll`` flushes it; a blob larger than the ring spills to a file
beside the segment and the ring carries a note that names it.

Doorbells: each rank binds a unix datagram socket beside the segment
(its ``shm-bell-<rank>`` card). The flags segment holds one sleep byte a
rank, set while the rank is parked in its engine's idle wait
(``pre_wait`` / ``post_wait``); a sender rings the receiver's doorbell
only when that byte is set (the adaptive bell), and the engine selects
on its own doorbell (``wait_fds``).

Wiring is lazy, as the JAX package's default: a channel carries eager
traffic as soon as it is built, and learns its peers' doorbells from
their cards on a later poll (``try_wire``, throttled); a sender that
must wake a sleeping peer before then reads that peer's card.

Rendezvous (RGET) takes the last rung of the JAX package's handle
ladder: the sender writes the packed buffer to a file beside the
segment, ``("file", path)`` rides the RTS, the receiver maps it and
answers FIN, and the sender unlinks it. The native ring and C plane,
cross-memory attach, the scratch arena, liveness leases and the metrics
ring are not ported: the JAX constructor takes this branch when they
are unavailable.

Pvars: ``chan_shm_{msgs,bytes}_{sent,recv}`` (wire bytes).
"""

from __future__ import annotations

import collections
import mmap
import os
import socket
import struct
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from ..runtime.boot import flags_len
from .base import Channel, Packet, decode_packet, encode_packet

# ring framing (the JAX package's _HEADER, _WRAP and _ALIGN)
_HEADER = 128            # per-ring control block
_WRAP = 0xFFFFFFFF       # wrap marker
_ALIGN = 8               # record alignment

# first byte of a ring note that names a spill file (no packet type is
# 0xFF); the JAX package's arena notes (0xFE) are never written here
_SPILL_FILE = 0xFF


class _PyRing:
    """The rings of one node in one mapped segment (the JAX package's
    ``_PyRing``, byte for byte)."""

    def __init__(self, path: str, nranks: int, ring_bytes: int):
        self.fd = os.open(path, os.O_RDWR)
        self.mm = mmap.mmap(self.fd, nranks * nranks * ring_bytes)
        self.nranks = nranks
        self.ring_bytes = ring_bytes
        self.cap = ring_bytes - _HEADER

    def _off(self, src: int, dst: int) -> int:
        return (src * self.nranks + dst) * self.ring_bytes

    def _head(self, off: int) -> int:
        return struct.unpack_from("<Q", self.mm, off)[0]

    def _tail(self, off: int) -> int:
        return struct.unpack_from("<Q", self.mm, off + 8)[0]

    def send(self, src: int, dst: int, payload: bytes) -> int:
        """1 when written, 0 when the ring is full, -1 when the record
        can never fit."""
        off = self._off(src, dst)
        cap = self.cap
        need = (4 + len(payload) + _ALIGN - 1) & ~(_ALIGN - 1)
        if need + _ALIGN >= cap:
            return -1
        head, tail = self._head(off), self._tail(off)
        used = tail - head
        pos = tail % cap
        contig = cap - pos
        base = off + _HEADER
        if contig < need:
            if used + contig + need > cap:
                return 0
            struct.pack_into("<I", self.mm, base + pos, _WRAP)
            tail += contig
            struct.pack_into("<Q", self.mm, off + 8, tail)
            pos = 0
        elif used + need > cap:
            return 0
        struct.pack_into("<I", self.mm, base + pos, len(payload))
        self.mm[base + pos + 4:base + pos + 4 + len(payload)] = payload
        struct.pack_into("<Q", self.mm, off + 8, tail + need)
        return 1

    def recv(self, src: int, dst: int) -> Optional[bytes]:
        off = self._off(src, dst)
        cap = self.cap
        base = off + _HEADER
        while True:
            head, tail = self._head(off), self._tail(off)
            if head == tail:
                return None
            pos = head % cap
            ln = struct.unpack_from("<I", self.mm, base + pos)[0]
            if ln == _WRAP or cap - pos < 4:
                head += cap - pos
                struct.pack_into("<Q", self.mm, off, head)
                continue
            data = bytes(self.mm[base + pos + 4:base + pos + 4 + ln])
            need = (4 + ln + _ALIGN - 1) & ~(_ALIGN - 1)
            struct.pack_into("<Q", self.mm, off, head + need)
            return data

    def close(self):
        self.mm.close()
        os.close(self.fd)


class ShmChannel(Channel):
    name = "shm"
    polled = True
    supports_rget = True

    def __init__(self, my_rank: int, local_ranks: List[int], kvs,
                 card: dict):
        """Attach to the segment the node's leader created at the light
        boot (its ``shm-boot-<leader>`` card, ``card``)."""
        self.my_rank = my_rank           # world rank
        self.local_ranks = sorted(local_ranks)
        self.local_index = {r: i for i, r in enumerate(self.local_ranks)}
        self.n_local = len(self.local_ranks)
        self.my_i = self.local_index[my_rank]
        self.kvs = kvs
        self._owner = my_rank == self.local_ranks[0]
        self.path = card["ring"]
        self._ring = _PyRing(self.path, self.n_local, int(card["ring_bytes"]))
        # a full ring's blobs, by destination index; _send_lock keeps
        # one producer a (src, dst) ring and serializes the backlog
        self._backlog: Dict[int, collections.deque] = {}
        self._send_lock = threading.Lock()
        # the doorbell: one best-effort datagram after a ring write wakes
        # a receiver parked in select() at once
        self._bell = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._bell_path = f"{self.path}.bell-{my_rank}"
        try:
            os.unlink(self._bell_path)
        except OSError:
            pass
        self._bell.bind(self._bell_path)
        self._bell.setblocking(False)
        self._peer_bells: Dict[int, str] = {}
        # the flags segment: one sleep byte a rank (the adaptive bell)
        self._flags_path = card["flags"]
        self._flags_f = open(self._flags_path, "r+b")
        self._flags = mmap.mmap(self._flags_f.fileno(),
                                flags_len(self.n_local))
        # lazy wiring state
        self._wired = False
        self._wire_try_at = 0.0
        self._wire_lock = threading.Lock()
        kvs.put(f"shm-bell-{my_rank}", self._bell_path)

    # -- lazy wiring ------------------------------------------------------
    def _wire_step(self) -> bool:  # holds: _wire_lock
        """One nonblocking look at the peers' doorbell cards: wired once
        every co-located rank has built its channel."""
        if self._wired:
            return True
        peers = [r for r in self.local_ranks if r != self.my_rank]
        vals = self.kvs.peek_many([f"shm-bell-{r}" for r in peers])
        if any(v is None for v in vals):
            return False
        self._peer_bells.update(zip(peers, vals))
        self._wired = True
        return True

    def try_wire(self, force: bool = False) -> bool:
        """Opportunistic, throttled wire attempt from the poll path; never
        blocks and never waits on a lock."""
        if self._wired:
            return True
        now = time.monotonic()
        if not force and now < self._wire_try_at:
            return False
        if not self._wire_lock.acquire(blocking=False):
            return self._wired
        try:
            self._wire_try_at = now + 0.01
            return self._wire_step()
        finally:
            self._wire_lock.release()

    # -- sending ------------------------------------------------------------
    def _ring_bell(self, dest_world: int) -> None:
        if self._flags[self.local_index[dest_world]] == 0:
            return    # the receiver is awake and polling
        addr = self._peer_bells.get(dest_world)
        if addr is None:
            # a sleeping rank has built its channel: its card is there
            addr = self.kvs.get(f"shm-bell-{dest_world}")
            self._peer_bells[dest_world] = addr
        try:
            self._bell.sendto(b"x", addr)
        except OSError:
            pass    # a full or raced doorbell is fine: the receiver polls

    def send_packet(self, dest_world: int, pkt: Packet) -> None:
        blob = encode_packet(pkt)
        self.account_send(dest_world, len(blob))
        dst_i = self.local_index[dest_world]
        with self._send_lock:
            bl = self._backlog.setdefault(dst_i, collections.deque())
            if bl:
                bl.append(blob)
                self._flush(dst_i)
            else:
                rc = self._ring.send(self.my_i, dst_i, blob)
                if rc == 0:
                    bl.append(blob)       # ring full: flushed from poll
                elif rc < 0:
                    note = self._spill_oversize(blob)
                    if self._ring.send(self.my_i, dst_i, note) == 0:
                        bl.append(note)
        self._ring_bell(dest_world)

    def _spill_oversize(self, blob: bytes) -> bytes:
        """Write a blob larger than the ring to a file beside the
        segment; returns the ring note that names it (the receiver
        unlinks the file when it reads it)."""
        path = self.path + f".big-{self.my_rank}-{uuid.uuid4().hex[:8]}"
        with open(path, "wb") as f:
            f.write(blob)
        return bytes((_SPILL_FILE,)) + path.encode()

    def _flush(self, dst_i: int) -> None:  # holds: _send_lock
        bl = self._backlog.get(dst_i)
        while bl:
            rc = self._ring.send(self.my_i, dst_i, bl[0])
            if rc == 0:
                return
            blob = bl.popleft()
            if rc < 0:
                note = self._spill_oversize(blob)
                if self._ring.send(self.my_i, dst_i, note) == 0:
                    bl.appendleft(note)   # keep FIFO order, retry later
                    return

    # -- receiving ----------------------------------------------------------
    def _drain_bell(self) -> None:
        while True:
            try:
                self._bell.recv(4096)
            except OSError:
                break

    def poll(self) -> bool:
        if not self._wired:
            self.try_wire()
        self._drain_bell()
        with self._send_lock:
            for dst_i in list(self._backlog):
                self._flush(dst_i)
        did = False
        for src_i in range(self.n_local):
            if src_i == self.my_i:
                continue
            while True:
                blob = self._ring.recv(src_i, self.my_i)
                if blob is None:
                    break
                if blob[0] == _SPILL_FILE:
                    path = blob[1:].decode()
                    with open(path, "rb") as f:
                        blob = f.read()
                    os.unlink(path)
                self.account_recv(len(blob))
                self.engine.enqueue_incoming(decode_packet(blob))
                did = True
        return did

    def wait_fds(self):
        return [self._bell]

    def pre_wait(self) -> None:
        self._flags[self.my_i] = 1

    def post_wait(self) -> None:
        self._flags[self.my_i] = 0

    # -- rendezvous (RGET through a file) -----------------------------------
    def expose_buffer(self, array: np.ndarray):
        """Write the packed send buffer to a file beside the segment; the
        handle ``("file", path)`` rides the RTS."""
        arr = np.ascontiguousarray(array).view(np.uint8).reshape(-1)
        if arr.size == 0:
            return ("null",)
        path = self.path + f".rget-{self.my_rank}-{uuid.uuid4().hex[:8]}"
        with open(path, "wb") as f:
            f.write(memoryview(arr))
        return ("file", path)

    def pull_buffer(self, src_world: int, handle, nbytes: int) -> np.ndarray:
        """A view of the peer's exposed file, mapped read-only (the
        caller unpacks out of it before its FIN releases the file)."""
        with open(handle[1], "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        return np.frombuffer(mm, dtype=np.uint8, count=nbytes)

    def release_buffer(self, handle) -> None:
        if handle[0] == "file":
            try:
                os.unlink(handle[1])
            except OSError:
                pass

    def close(self) -> None:
        try:
            self._bell.close()
            os.unlink(self._bell_path)
        except OSError:
            pass
        try:
            self._flags.close()
            self._flags_f.close()
        except (OSError, ValueError, BufferError):
            pass
        try:
            self._ring.close()
        except (OSError, ValueError, BufferError):
            pass
        if self._owner:
            for p in (self.path, self._flags_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass
