"""Schedule DAGs of the nonblocking device collectives (a trimmed copy of
the JAX package's ``coll/nbc/dag.py``).

A schedule is a DAG of vertices with explicit dependency edges. Two
kinds are ported: a local ``CALL`` (run once, complete at issue) and a
``POLL`` (called when it becomes runnable, then re-called on every
engine progress pass until it returns True: the device segment's shape).
The JAX package's ``SEND``/``RECV`` vertices belong to its host schedule,
which is not ported; the kind numbers are the JAX package's, so the
``vertex_issue`` trace events carry the same ``kind`` values.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

# vertex kinds (numeric order is the issue order inside one ready batch:
# local calls before polls, so a deposit lands before a segment launches)
CALL = 0
POLL = 3

_KIND_NAMES = {CALL: "call", POLL: "poll"}


class Vertex:
    __slots__ = ("vid", "kind", "fn", "out", "ndeps")

    def __init__(self, vid: int, kind: int, fn: Callable):
        self.vid = vid
        self.kind = kind
        self.fn = fn
        self.out: List[int] = []     # vertices unblocked by my completion
        self.ndeps = 0               # static in-degree

    def __repr__(self):
        return f"Vertex({_KIND_NAMES[self.kind]} #{self.vid}, " \
               f"deps={self.ndeps})"


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

    def call(self, fn: Callable[[], None],
             after: Sequence[int] = ()) -> int:
        """Local work run once every vertex of ``after`` has completed."""
        return self._add(Vertex(len(self.vertices), CALL, fn), after)

    def poll(self, fn: Callable[[], bool],
             after: Sequence[int] = ()) -> int:
        """Asynchronous local work polled to completion: ``fn`` is called
        when the vertex becomes runnable and then on every engine progress
        pass until it returns True."""
        return self._add(Vertex(len(self.vertices), POLL, fn), after)

    def roots(self) -> List[int]:
        return [v.vid for v in self.vertices if v.ndeps == 0]

    def __len__(self) -> int:
        return len(self.vertices)
