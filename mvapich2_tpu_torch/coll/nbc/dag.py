"""Schedule DAGs of the nonblocking collectives (a copy of the JAX
package's ``coll/nbc/dag.py``).

A schedule is a DAG of vertices with explicit dependency edges: a local
``CALL`` (run once, complete at issue), a ``RECV`` and a ``SEND`` over
the comm's collective context (the host schedule's point-to-point,
complete when their requests do), and a ``POLL`` (called when it
becomes runnable, then re-called on every engine progress pass until it
returns True: the device segment's shape). The kind numbers are the JAX
package's, so the ``vertex_issue`` trace events carry the same ``kind``
values.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

# vertex kinds (numeric order is the issue order inside one ready batch:
# local calls prepare buffers, receives are posted before the matching
# sends go out, and polls issue last, so a deposit lands before a
# segment launches)
CALL = 0
RECV = 1
SEND = 2
POLL = 3

_KIND_NAMES = {CALL: "call", RECV: "recv", SEND: "send", POLL: "poll"}


class Vertex:
    __slots__ = ("vid", "kind", "comm", "buf", "peer", "tag", "fn", "out",
                 "ndeps")

    def __init__(self, vid: int, kind: int, comm=None, buf=None,
                 peer: int = -1, tag: int = 0,
                 fn: Optional[Callable] = None):
        self.vid = vid
        self.kind = kind
        self.comm = comm
        self.buf = buf
        self.peer = peer
        self.tag = tag
        self.fn = fn
        self.out: List[int] = []     # vertices unblocked by my completion
        self.ndeps = 0               # static in-degree

    def __repr__(self):
        return (f"Vertex({_KIND_NAMES[self.kind]} #{self.vid}, "
                f"peer={self.peer}, deps={self.ndeps})")


class SchedDAG:
    """One rank's schedule of one nonblocking collective."""

    def __init__(self):
        self.vertices: List[Vertex] = []

    def _add(self, v: Vertex, after: Sequence[int]) -> int:
        for dep in after:
            self.vertices[dep].out.append(v.vid)
            v.ndeps += 1
        self.vertices.append(v)
        return v.vid

    def send(self, comm, buf: np.ndarray, dest: int, tag: int,
             after: Sequence[int] = ()) -> int:
        """Send ``buf`` to comm rank ``dest`` over ``comm``'s collective
        context once every vertex of ``after`` has completed."""
        return self._add(Vertex(len(self.vertices), SEND, comm, buf, dest,
                                tag), after)

    def recv(self, comm, buf: np.ndarray, src: int, tag: int,
             after: Sequence[int] = ()) -> int:
        return self._add(Vertex(len(self.vertices), RECV, comm, buf, src,
                                tag), after)

    def call(self, fn: Callable[[], None],
             after: Sequence[int] = ()) -> int:
        """Local work run once every vertex of ``after`` has completed."""
        return self._add(Vertex(len(self.vertices), CALL, fn=fn), after)

    def poll(self, fn: Callable[[], bool],
             after: Sequence[int] = ()) -> int:
        """Asynchronous local work polled to completion: ``fn`` is called
        when the vertex becomes runnable and then on every engine progress
        pass until it returns True."""
        return self._add(Vertex(len(self.vertices), POLL, fn=fn), after)

    def roots(self) -> List[int]:
        return [v.vid for v in self.vertices if v.ndeps == 0]

    def __len__(self) -> int:
        return len(self.vertices)
