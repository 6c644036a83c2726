"""The TCP channel between rank processes (a copy of the JAX package's
``transport/tcp.py``, without the node daemon's listener handoff).

* Connections are made on demand at the first send to a peer; each is
  one way (initiator -> acceptor), so there is no simultaneous-connect
  handshake. A rank's listening address is its ``tcp-addr-<rank>`` card
  in the job's KVS.
* Outgoing data is queued and flushed with nonblocking writes, from
  ``send_packet`` and again from ``poll``, so a rank never blocks in a
  send while its peer is also mid-send (no head-of-line deadlock on
  bidirectional large messages).
* Frame: a 4-byte length, then the packet's wire blob
  (``transport/base.py`` ``encode_packet``). The channel has no
  zero-copy handle (``supports_rget`` False), so a rendezvous on it
  takes RPUT/R3: the receiver answers CTS and the sender pushes
  R3_CHUNK_SIZE chunks.

Pvars: ``chan_tcp_{msgs,bytes}_{sent,recv}`` (wire bytes).
"""

from __future__ import annotations

import collections
import logging
import selectors
import socket
import struct
import threading
import time
from typing import Dict, List

from .base import Channel, Packet, decode_packet, encode_packet

log = logging.getLogger("mvapich2_tpu_torch.transport.tcp")

_LEN = struct.Struct("<I")


class _Conn:
    """One inbound or outbound stream with reassembly state."""

    __slots__ = ("sock", "rbuf", "outq", "osent")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.outq: collections.deque = collections.deque()
        self.osent = 0


class TcpChannel(Channel):
    name = "tcp"
    polled = True
    supports_rget = False

    def __init__(self, my_rank: int, kvs):
        self.my_rank = my_rank
        self.kvs = kvs
        self.sel = selectors.DefaultSelector()
        self.listener = self._bind_listener()
        self.listener.setblocking(False)
        self.sel.register(self.listener, selectors.EVENT_READ, "accept")
        host, port = self.listener.getsockname()[:2]
        kvs.put(f"tcp-addr-{my_rank}", f"{host}:{port}")
        self._out: Dict[int, _Conn] = {}      # dest rank -> conn
        self._in: List[_Conn] = []
        self._closed = False
        # serializes outbound conn state (outq + flush cursor): sends
        # may come from any user thread while poll()'s backlog flush
        # runs under the engine mutex; without this lock the two
        # interleave and corrupt the stream. Channel-local, never held
        # while waiting on a peer.
        self._slock = threading.Lock()

    @staticmethod
    def _bind_listener() -> socket.socket:
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind(("127.0.0.1", 0))
        lst.listen(128)
        return lst

    # -- outgoing ---------------------------------------------------------
    def _connect(self, dest: int) -> _Conn:
        addr = self.kvs.get(f"tcp-addr-{dest}")
        host, port = addr.rsplit(":", 1)
        s = socket.create_connection((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        conn = _Conn(s)
        self._out[dest] = conn
        self.sel.register(s, selectors.EVENT_READ, ("out", conn))
        return conn

    def send_packet(self, dest_world: int, pkt: Packet) -> None:
        blob = encode_packet(pkt)
        with self._slock:
            conn = self._out.get(dest_world) or self._connect(dest_world)
            conn.outq.append(_LEN.pack(len(blob)))
            conn.outq.append(blob)
            self._flush(conn)
        self.account_send(dest_world, 4 + len(blob))

    def _flush(self, conn: _Conn) -> bool:
        """Nonblocking flush of the backlog; True if fully drained."""
        while conn.outq:
            buf = conn.outq[0]
            off = conn.osent
            try:
                n = conn.sock.send(memoryview(buf)[off:])
            except (BlockingIOError, InterruptedError):
                return False
            except OSError as e:  # peer died
                log.error("send to peer failed: %s", e)
                conn.outq.clear()
                return True
            conn.osent += n
            if conn.osent >= len(buf):
                conn.outq.popleft()
                conn.osent = 0
            if n == 0:
                return False
        return True

    # -- incoming ---------------------------------------------------------
    def _on_readable(self, conn: _Conn) -> bool:
        try:
            chunk = conn.sock.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            chunk = b""
        if not chunk:
            # the peer closed: drop the stream, so the idle wait never
            # selects on a closed socket
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.sock.close()
            if conn in self._in:
                self._in.remove(conn)
            with self._slock:
                for dest, c in list(self._out.items()):
                    if c is conn:
                        del self._out[dest]
            return False
        conn.rbuf.extend(chunk)
        any_pkt = False
        while self._try_extract(conn):
            any_pkt = True
        return any_pkt

    def _try_extract(self, conn: _Conn) -> bool:
        buf = conn.rbuf
        if len(buf) < 4:
            return False
        blen = _LEN.unpack_from(buf, 0)[0]
        if len(buf) < 4 + blen:
            return False
        pkt = decode_packet(bytes(buf[4:4 + blen]))
        del buf[:4 + blen]
        self.account_recv(4 + blen)
        self.engine.enqueue_incoming(pkt)
        return True

    # -- progress ---------------------------------------------------------
    def poll(self) -> bool:
        if self._closed:
            return False
        did = False
        for key, _ in self.sel.select(timeout=0):
            data = key.data
            if data == "accept":
                try:
                    s, _ = self.listener.accept()
                except OSError:
                    continue
                s.setblocking(False)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn = _Conn(s)
                self._in.append(conn)
                self.sel.register(s, selectors.EVENT_READ, ("in", conn))
                did = True
            else:
                _, conn = data
                if self._on_readable(conn):
                    did = True
        with self._slock:
            for conn in list(self._out.values()):
                if conn.outq:
                    self._flush(conn)
                    did = True
        return did

    def wait_fds(self):
        if self._closed:
            return []
        # snapshot: another thread may add a connection while the
        # progress thread builds the list
        fds = [self.listener]
        fds.extend(c.sock for c in list(self._in))
        fds.extend(c.sock for c in list(self._out.values()))
        return fds

    def close(self) -> None:
        # flush best-effort before teardown
        deadline = time.monotonic() + 2.0
        while any(c.outq for c in self._out.values()) and \
                time.monotonic() < deadline:
            with self._slock:
                for c in list(self._out.values()):
                    self._flush(c)
        self._closed = True
        for conn in list(self._out.values()) + self._in:
            try:
                conn.sock.close()
            except OSError:
                pass
        try:
            self.listener.close()
            self.sel.close()
        except OSError:
            pass
