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

Rendezvous (RGET) climbs the JAX package's handle ladder, best rung
first: ``("cma", pid, addr, tok)``, the receiver reads the sender's live
buffer with ``process_vm_readv`` (``transport/arena.py`` ``cma_read``,
in ``RNDV_CHUNK`` steps); ``("arena", off, tok)``, one copy into a
block of the node's scratch arena, read in place; ``("file", path)``,
the packed buffer written to a file beside the segment and mapped by the
receiver, kept as the rung of an exhausted arena. The receiver answers
FIN and the sender releases the handle. A multi-chunk send over the
arena without CMA takes the pipelined rendezvous instead
(``pt2pt/protocol.py`` APIPE). Which rungs a node may use is agreed in
the lazy wiring, so sender and receiver always pick the same: every
rank publishes its CMA verdict (``USE_CMA`` and a read of its left
neighbour's ``shm-cma-<rank>`` probe buffer) and whether it mapped the
arena that the leader made beside its segment (the ``shm-arena-<leader>``
card), and a rung is used only where every co-located rank said yes. A
blob larger than the ring spills into the arena (an ``0xFE`` note: the
sender's local index, the offset and the length; the receiver bumps its
spill-consumed counter, and the sender frees the block once the counter
passes it), or, when the arena is not agreed or is full, into a file
(an ``0xFF`` note). The native ring and C plane, liveness leases, the
metrics ring and the node daemon's warm attach are not ported: the JAX
constructor takes this branch when they are unavailable.

Pvars: ``chan_shm_{msgs,bytes}_{sent,recv}`` (wire bytes), and the
arena's and the rendezvous's (``transport/arena.py``).
"""

from __future__ import annotations

import collections
import logging
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
from ..utils.config import get_config
from .arena import ShmArena, cma_probe, cma_read
from .base import Channel, Packet, decode_packet, encode_packet

log = logging.getLogger("mvapich2_tpu_torch.transport.shm")

# ring framing (the JAX package's _HEADER, _WRAP and _ALIGN)
_HEADER = 128            # per-ring control block
_WRAP = 0xFFFFFFFF       # wrap marker
_ALIGN = 8               # record alignment

# first byte of a ring note that names a spill file or an arena block
# (no packet type is 0xFE or 0xFF)
_SPILL_FILE = 0xFF
_SPILL_ARENA = 0xFE


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
        # lazy wiring state (stage 0: bells and probes read, verdicts
        # published; stage 1: every verdict read and applied)
        self._wired = False
        self._wire_stage = 0
        self._wire_try_at = 0.0
        self._wire_lock = threading.Lock()
        self.cma_ok = False           # the node's CMA agreement
        self._arena_ready = False     # the node's arena agreement
        # the exposure table: handle -> keepalive (the buffer for CMA, the
        # block for the arena), leak-checked at close
        self._exposed: Dict[tuple, object] = {}
        self._expose_tok = 0
        # arena spills: dst index -> deque of (seq, block), freed once
        # the receiver's consumed counter passes seq
        self._spill_pending: Dict[int, collections.deque] = {}
        self._spill_seq: Dict[int, int] = {}
        self._spill_lock = threading.Lock()
        cards = {f"shm-bell-{my_rank}": self._bell_path}
        # the leader makes the node's scratch arena beside its segment
        self.arena: Optional[ShmArena] = None
        if self._owner:
            cards[f"shm-arena-{my_rank}"] = self._make_arena()
        # the CMA probe buffer a neighbour reads in its wire step; kept
        # alive as long as the channel
        self._cma_probe = np.frombuffer(
            f"mv2t-cma-{my_rank:012d}".encode(), dtype=np.uint8).copy()
        cards[f"shm-cma-{my_rank}"] = (f"{os.getpid()}:"
                                       f"{self._cma_probe.ctypes.data}:"
                                       f"{self._cma_probe.size}")
        # one put: a peer that reads the bell card finds the others
        kvs.put_many(cards)

    def _make_arena(self) -> str:
        """Leader: create the arena file (``mv2t-arena-<pid>-<8 hex>``)
        beside the segment; its card, ``path:part_bytes``, or "" when it
        could not be made. Nothing else in the directory is touched: it
        is shared with other jobs, and the launcher removes this job's
        files however the job ends (``runtime/launcher.sweep_segments``)."""
        base = os.path.dirname(self.path)
        try:
            apath = os.path.join(
                base, f"mv2t-arena-{os.getpid()}-{uuid.uuid4().hex[:8]}")
            self.arena = ShmArena(apath, self.n_local, self.my_i,
                                  create=True)
            return f"{apath}:{self.arena.part_bytes}"
        except Exception as e:   # noqa: BLE001 - the file rung remains
            log.warning("arena create failed (%s); file rendezvous", e)
            self.arena = None
            return ""

    # -- lazy wiring ------------------------------------------------------
    def _wire_step(self) -> bool:  # holds: _wire_lock
        """One nonblocking advance of the wiring: stage 0 waits for every
        co-located rank's bell and probe cards, reads the left
        neighbour's probe buffer, maps the leader's arena and publishes
        this rank's verdicts; stage 1 waits for every verdict and applies
        the unanimous ones (``_apply_wire``)."""
        if self._wired:
            return True
        peers = [r for r in self.local_ranks if r != self.my_rank]
        n = len(peers)
        if self._wire_stage == 0:
            vals = self.kvs.peek_many([f"shm-bell-{r}" for r in peers]
                                      + [f"shm-cma-{r}" for r in peers])
            if any(v is None for v in vals):
                return False
            self._peer_bells.update(zip(peers, vals[:n]))
            cards = dict(zip(peers, vals[n:]))
            my_ok = bool(get_config()["USE_CMA"]) and self._probe_cma(cards)
            if self.arena is None and not self._owner:
                self._attach_follower_arena()
            self._my_verdicts = (my_ok, self.arena is not None)
            self.kvs.put_many({
                f"shm-cma-ok-{self.my_rank}": "1" if my_ok else "0",
                f"shm-arena-ok-{self.my_rank}":
                    "1" if self.arena is not None else "0"})
            self._wire_stage = 1
        vals = self.kvs.peek_many([f"shm-cma-ok-{r}" for r in peers]
                                  + [f"shm-arena-ok-{r}" for r in peers])
        if any(v is None for v in vals):
            return False
        my_ok, my_arena = self._my_verdicts
        self._apply_wire(my_ok and all(v == "1" for v in vals[:n]),
                         my_arena and all(v == "1" for v in vals[n:]))
        return True

    def _probe_cma(self, cards: Dict[int, str]) -> bool:
        """Can this process read a co-located rank's memory? Reads the
        left neighbour's published probe buffer with process_vm_readv and
        checks the bytes."""
        idx = self.local_ranks.index(self.my_rank)
        left = self.local_ranks[idx - 1]
        try:
            pid, addr, n = map(int, cards[left].split(":"))
        except (KeyError, ValueError):
            return False
        expect = f"mv2t-cma-{left:012d}".encode()
        if n != len(expect):
            return False
        ok = cma_probe(pid, addr, n) == expect
        if not ok:
            log.warning("CMA probe of pid %d failed; no CMA rendezvous", pid)
        return ok

    def _attach_follower_arena(self) -> None:
        """Follower: map the arena the leader published with its cards
        (its bell card's presence implies the arena card's)."""
        try:
            card = self.kvs.peek_many(
                [f"shm-arena-{self.local_ranks[0]}"])[0]
            if card:
                apath, part = card.rsplit(":", 1)
                self.arena = ShmArena(apath, self.n_local, self.my_i,
                                      int(part))
        except Exception as e:   # noqa: BLE001 - the file rung remains
            log.warning("arena attach failed (%s); file rendezvous", e)
            self.arena = None

    def _apply_wire(self, all_ok: bool, all_arena: bool) -> None:
        """Stage 1: apply the unanimous agreements and go live."""
        self.cma_ok = all_ok
        if not all_arena and self.arena is not None:
            self.arena.close(unlink=self._owner)
            self.arena = None
        self._arena_ready = self.arena is not None
        self._wired = True
        log.info("node wire complete (cma=%s arena=%s)", all_ok, all_arena)

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
                    note = self._spill_oversize(blob, dst_i)
                    if self._ring.send(self.my_i, dst_i, note) == 0:
                        bl.append(note)
        self._ring_bell(dest_world)

    def _spill_oversize(self, blob: bytes, dst_i: int) -> bytes:
        """Stage a blob larger than the ring in an arena block (a
        ``0xFE`` note: sender index, offset, length), or in a file beside
        the segment when the arena is not agreed or is full (a ``0xFF``
        note naming it; the receiver unlinks the file when it reads
        it). Returns the ring note."""
        if self._arena_ready:
            self._reclaim_spills()
            h = self.arena.alloc(len(blob))
            if h is not None:
                self.arena.view(h.off, len(blob))[:] = \
                    np.frombuffer(blob, dtype=np.uint8)
                with self._spill_lock:
                    seq = self._spill_seq.get(dst_i, 0) + 1
                    self._spill_seq[dst_i] = seq
                    self._spill_pending.setdefault(
                        dst_i, collections.deque()).append((seq, h))
                return bytes((_SPILL_ARENA,)) + struct.pack(
                    "<qqq", self.my_i, h.off, len(blob))
        path = self.path + f".big-{self.my_rank}-{uuid.uuid4().hex[:8]}"
        with open(path, "wb") as f:
            f.write(blob)
        return bytes((_SPILL_FILE,)) + path.encode()

    def _reclaim_spills(self) -> None:
        """Free the arena spill blocks whose notes the receiver has
        consumed (its counter in the arena header passed them)."""
        with self._spill_lock:
            for dst_i, pend in self._spill_pending.items():
                if not pend:
                    continue
                c = self.arena.spill_consumed(self.my_i, dst_i)
                while pend and pend[0][0] <= c:
                    self.arena.free(pend.popleft()[1])

    def _consume_spill_note(self, blob) -> bytes:
        """The blob an inbound spill note names (0xFE arena, 0xFF
        file)."""
        if blob[0] == _SPILL_ARENA:
            src_i, off, n = struct.unpack_from("<qqq", blob, 1)
            data = bytes(self.arena.view(off, n))
            self.arena.bump_spill(src_i, self.my_i)
            return data
        path = bytes(blob[1:]).decode()
        with open(path, "rb") as f:
            data = f.read()
        os.unlink(path)
        return data

    def _flush(self, dst_i: int) -> None:  # holds: _send_lock
        bl = self._backlog.get(dst_i)
        while bl:
            rc = self._ring.send(self.my_i, dst_i, bl[0])
            if rc == 0:
                return
            blob = bl.popleft()
            if rc < 0:
                note = self._spill_oversize(blob, dst_i)
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
        # a racy read: a stale one delays a reclaim by one poll
        if self._spill_pending:
            self._reclaim_spills()
        did = False
        for src_i in range(self.n_local):
            if src_i == self.my_i:
                continue
            while True:
                blob = self._ring.recv(src_i, self.my_i)
                if blob is None:
                    break
                if blob[0] in (_SPILL_ARENA, _SPILL_FILE):
                    blob = self._consume_spill_note(blob)
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

    # -- rendezvous (RGET: the handle ladder, CMA > arena > file) -----------
    def expose_buffer(self, array: np.ndarray):
        """Register the packed send buffer for the receiver's pull; the
        handle rides the RTS. The best agreed rung: ``("cma", pid, addr,
        tok)`` (the live buffer, no copy), ``("arena", off, tok)`` (one
        copy into a block), else ``("file", path)``. The keepalive stays
        in the exposure table until ``release_buffer``."""
        arr = np.ascontiguousarray(array).view(np.uint8).reshape(-1)
        if arr.size == 0:
            return ("null",)
        if not self._wired:
            # both ends are live: a natural point to finish the wiring;
            # unwired, the file rung needs no agreement
            self.try_wire(force=True)
        if self.cma_ok:
            self._expose_tok += 1
            h = ("cma", os.getpid(), arr.ctypes.data, self._expose_tok)
            self._exposed[h] = arr
            return h
        if self._arena_ready:
            ah = self.arena.alloc(arr.size)
            if ah is not None:
                self.arena.view(ah.off, arr.size)[:] = arr
                self._expose_tok += 1
                h = ("arena", ah.off, self._expose_tok)
                self._exposed[h] = ah
                return h
        path = self.path + f".rget-{self.my_rank}-{uuid.uuid4().hex[:8]}"
        with open(path, "wb") as f:
            f.write(memoryview(arr))
        return ("file", path)

    def pull_buffer(self, src_world: int, handle, nbytes: int) -> np.ndarray:
        """Read the peer's exposed buffer: a CMA read into a fresh array
        (``RNDV_CHUNK`` bytes a call, a ``rndv_chunk`` instant each), or
        a view of the arena block or of the mapped file (the caller
        unpacks out of it before its FIN releases it)."""
        tr = self.engine.tracer if hasattr(self, "engine") else None
        kind = handle[0]
        if kind == "cma":
            _, pid, addr, _tok = handle
            out = np.empty(nbytes, dtype=np.uint8)
            cma_read(pid, addr, out, chunk=get_config()["RNDV_CHUNK"],
                     tracer=tr)
            return out
        if kind == "arena":
            if tr is not None:
                tr.record("protocol", "rndv_chunk", "i", dir="arena",
                          bytes=nbytes)
            return self.arena.view(handle[1], nbytes)
        with open(handle[1], "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        return np.frombuffer(mm, dtype=np.uint8, count=nbytes)

    def release_buffer(self, handle) -> None:
        kind = handle[0]
        if kind in ("cma", "null"):
            self._exposed.pop(handle, None)
        elif kind == "arena":
            ah = self._exposed.pop(handle, None)
            if ah is not None:
                self.arena.free(ah)
        else:
            try:
                os.unlink(handle[1])
            except OSError:
                pass

    def close(self) -> None:
        if self.arena is not None:
            # the leak check: every exposure must have been released by
            # its FIN or cancel; spills may still await their reclaim
            with self._spill_lock:
                for pend in self._spill_pending.values():
                    while pend:
                        self.arena.free(pend.popleft()[1])
            if self._exposed or self.arena.outstanding:
                log.warning("arena handle leak at close: %d exposures, "
                            "%d arena blocks live", len(self._exposed),
                            self.arena.outstanding)
            self.arena.close(unlink=self._owner)
            self.arena = None
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
