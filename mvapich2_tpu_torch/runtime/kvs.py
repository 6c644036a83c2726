"""The key-value store of process mode: the PMI analog (a copy of the
JAX package's ``runtime/kvs.py``, with its wire protocol, so a client of
either package talks to a server of the other).

``mpirun`` (``runtime/launcher.py``) owns one :class:`KVSServer` a job: a
TCP server of JSON lines. Rank processes reach it through a
:class:`KVSClient` at the address in ``MV2T_KVS`` and exchange their
business cards (node keys, segment paths, socket addresses) with its
verbs: put / mput, get / mget (blocking until every key is present),
mpeek / peek (nonblocking), fence (a barrier that may carry cards;
a named group has its own member count, as the spawned worlds' fences
``spawn-<base>`` do), add (an atomic fetch-add: ``__next_proc``, the
watermark of spawned proc ids, starts at the job's size), del and
abort (``MPI_Abort``: the launcher watches it and kills the job, and the
server releases every blocked get and fence). The JAX package's fault
injection sites are not ported.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Dict, List, Optional


class _KVSState:
    def __init__(self, nranks: int):
        self.nranks = nranks
        self.data: Dict[str, str] = {}
        self.cond = threading.Condition()
        # named fence groups with their own member counts ("" = the
        # whole job)
        self.fences: Dict[str, List[int]] = {"": [nranks, 0, 0]}
        self.aborted: Optional[str] = None


class _HandlerBody:
    """Verb dispatch shared by the socketserver handler (built lazily in
    KVSServer — rank clients must not pay the socketserver import)."""

    def handle(self):
        state: _KVSState = self.server.state  # type: ignore
        for line in self.rfile:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                break
            cmd = msg.get("cmd")
            if cmd == "put":
                with state.cond:
                    state.data[msg["key"]] = msg["val"]
                    state.cond.notify_all()
                self._reply({"ok": True})
            elif cmd == "mput":
                # batched put: one message publishes a whole card set
                # (the startup-path replacement for N serial round trips)
                with state.cond:
                    state.data.update(msg["kv"])
                    state.cond.notify_all()
                self._reply({"ok": True})
            elif cmd == "get":
                with state.cond:
                    while msg["key"] not in state.data and not state.aborted:
                        state.cond.wait(timeout=60)
                    val = state.data.get(msg["key"])
                self._reply({"ok": val is not None, "val": val})
            elif cmd == "mget":
                # batched blocking get: waits until EVERY key is present
                # (one round trip for a full business-card sweep)
                keys = msg["keys"]
                with state.cond:
                    while not all(k in state.data for k in keys) \
                            and not state.aborted:
                        state.cond.wait(timeout=60)
                    vals = [state.data.get(k) for k in keys]
                self._reply({"ok": all(v is not None for v in vals),
                             "vals": vals})
            elif cmd == "mpeek":
                # batched nonblocking get (lazy-wiring probes poll peers'
                # cards without committing to a blocking wait)
                with state.cond:
                    vals = [state.data.get(k) for k in msg["keys"]]
                self._reply({"ok": True, "vals": vals})
            elif cmd == "fence":
                grp = msg.get("group", "")
                with state.cond:
                    # a fence may carry the caller's cards: merge-then-
                    # barrier in ONE message, so by the time the fence
                    # releases, every member's cards are readable (the
                    # PMI put+fence collapse of the batched bootstrap)
                    cards = msg.get("cards")
                    if cards:
                        state.data.update(cards)
                        state.cond.notify_all()
                    f = state.fences.setdefault(
                        grp, [int(msg.get("count", state.nranks)), 0, 0])
                    gen = f[2]
                    f[1] += 1
                    if f[1] == f[0]:
                        f[1] = 0
                        f[2] += 1
                        state.cond.notify_all()
                    else:
                        while f[2] == gen and not state.aborted:
                            state.cond.wait(timeout=60)
                self._reply({"ok": True})
            elif cmd == "add":
                # atomic fetch-add on an integer key
                with state.cond:
                    cur = int(state.data.get(msg["key"], "0"))
                    cur += int(msg.get("delta", 1))
                    state.data[msg["key"]] = str(cur)
                    state.cond.notify_all()
                self._reply({"ok": True, "val": cur})
            elif cmd == "peek":
                # nonblocking get
                with state.cond:
                    val = state.data.get(msg["key"])
                self._reply({"ok": val is not None, "val": val})
            elif cmd == "del":
                with state.cond:
                    state.data.pop(msg["key"], None)
                self._reply({"ok": True})
            elif cmd == "abort":
                with state.cond:
                    state.aborted = msg.get("why", "abort")
                    state.cond.notify_all()
                self._reply({"ok": True})
            else:
                self._reply({"ok": False, "err": f"bad cmd {cmd}"})

    def _reply(self, obj) -> None:
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()


class KVSServer:
    """Launcher-side server; one per job."""

    def __init__(self, nranks: int, host: str = "127.0.0.1"):
        import socketserver   # launcher-side only; see _HandlerBody
        self.state = _KVSState(nranks)
        # the proc-id watermark of dynamic spawn (runtime/spawn.py)
        self.state.data["__next_proc"] = str(nranks)

        class _Handler(_HandlerBody, socketserver.StreamRequestHandler):
            pass

        self._srv = socketserver.ThreadingTCPServer((host, 0), _Handler,
                                                    bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.state = self.state  # type: ignore
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="kvs-server")
        self._thread.start()

    @property
    def address(self) -> str:
        h, p = self._srv.server_address[:2]
        return f"{h}:{p}"

    def shutdown(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class KVSClient:
    """Rank-side client (the UPMI analog)."""

    def __init__(self, address: str, timeout: Optional[float] = 600):
        # a long READ timeout: a blocking get long-polls the server
        # while a slow peer boots. The CONNECT keeps a short timeout, so
        # a dead launcher errors in seconds, not minutes.
        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection(
            (host, int(port)),
            timeout=min(timeout, 60) if timeout else timeout)
        self._sock.settimeout(timeout)
        self._f = self._sock.makefile("rwb")
        self._lock = threading.Lock()

    def _rpc(self, obj) -> dict:
        with self._lock:
            self._f.write((json.dumps(obj) + "\n").encode())
            self._f.flush()
            line = self._f.readline()
        if not line:
            raise ConnectionError("KVS server closed connection")
        return json.loads(line)

    def put(self, key: str, val: str) -> None:
        self._rpc({"cmd": "put", "key": key, "val": val})

    def put_many(self, kv: Dict[str, str]) -> None:
        """Publish a whole card set in one round trip."""
        self._rpc({"cmd": "mput", "kv": dict(kv)})

    def get(self, key: str) -> str:
        r = self._rpc({"cmd": "get", "key": key})
        if not r.get("ok"):
            raise KeyError(key)
        return r["val"]

    def get_many(self, keys: List[str]) -> List[str]:
        """Blocking multi-get: one round trip, waits for every key."""
        r = self._rpc({"cmd": "mget", "keys": list(keys)})
        if not r.get("ok"):
            raise KeyError(repr(keys))
        return r["vals"]

    def peek_many(self, keys: List[str]) -> List[Optional[str]]:
        """Nonblocking multi-peek (None for absent keys)."""
        return self._rpc({"cmd": "mpeek", "keys": list(keys)})["vals"]

    def fence(self, group: str = "", count: Optional[int] = None,
              cards: Optional[Dict[str, str]] = None) -> None:
        """Barrier of ``count`` members (the job's size by default);
        ``cards`` ride the fence message, so publication and the barrier
        cost ONE round trip and the release guarantees every member's
        cards are readable."""
        msg = {"cmd": "fence", "group": group}
        if count is not None:
            msg["count"] = count
        if cards:
            msg["cards"] = dict(cards)
        self._rpc(msg)

    def add(self, key: str, delta: int = 1) -> int:
        """Atomic fetch-add; returns the post-add value."""
        return int(self._rpc({"cmd": "add", "key": key, "delta": delta})
                   ["val"])

    def peek(self, key: str) -> Optional[str]:
        """Nonblocking get (None for an absent key)."""
        r = self._rpc({"cmd": "peek", "key": key})
        return r["val"] if r.get("ok") else None

    def delete(self, key: str) -> None:
        self._rpc({"cmd": "del", "key": key})

    def abort(self, why: str = "") -> None:
        try:
            self._rpc({"cmd": "abort", "why": why})
        except Exception:
            pass

    def close(self) -> None:
        try:
            self._f.close()
            self._sock.close()
        except Exception:
            pass
