"""Where the time of one shared-memory rendezvous goes, rung by rung.

Two rank processes on one node (the shared-memory channel)::

    python -m mvapich2_tpu_torch.run -np 2 \\
        python -m mvapich2_tpu_torch.bench.shm_rndv --out o.json

Rank 1 sends rank 0 one message of each of ``--sizes`` bytes (numpy
uint8), ``--iters`` times after 2 warm-ups, each after a barrier, under
each rung of the rendezvous the node offers: CMA (where the node agreed
it), the arena with the pipelined rendezvous, the file (the lower rungs
are taken in the same job by ``progs/pingpong.take_rung``). The
sender's ``Datatype.pack`` and ``ShmChannel.expose_buffer`` and the
receiver's ``ShmChannel.pull_buffer`` and ``Datatype.unpack`` are
timed by wrappers on the one clock both processes share
(``time.perf_counter``, CLOCK_MONOTONIC). A message's split, medians in
microseconds: ``pack`` and ``expose`` (the sender), ``rts_hop`` (the
expose's end to the pull's start: the RTS through the ring, the
receiver's poll and match), ``pull`` and ``unpack`` (the receiver),
``fin_hop`` (the unpack's end to the sender's return: the FIN through
the ring and the sender's poll), and ``one_way`` (the sender's start to
the receiver's return). Under the arena the pipelined rendezvous moves
the chunks itself: only ``pack``, ``one_way`` and ``send`` (the
sender's call) are split out.

Then the parts of one CMA pull of the largest size alone (rank 1's
buffer exposed, rank 0 reading it with no protocol around it):
``pull_buffer`` (what the rendezvous runs: an ``np.empty`` and
``RNDV_CHUNK`` reads; each result dropped at once, so the allocator
hands the same pages back), ``pull_buffer_kept`` (every result kept
alive: each pull lands in pages never touched before), ``alloc_touch``
(an ``np.empty`` with one byte a page written), ``copy_kept`` (a copy
into a new array, each kept alive: the pack's copy into fresh pages),
``cma_chunked_reused`` and ``cma_one_call_reused`` (the reads into a
buffer already touched), ``memcpy`` (a ``np.copyto`` of that size
between touched buffers).

Rank 0 prints ``SHM_RNDV_JSON {...}`` and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from typing import Dict, List

import numpy as np

from .. import mpi
from ..core import datatype as dtmod
from ..progs.pingpong import take_rung
from ..runtime.universe import current_universe
from ..transport import shm as shm_mod
from ..transport.arena import cma_read
from ..utils.config import get_config

MARKED = ((dtmod.Datatype, "pack", lambda a: a[2] * a[0].size),
          (dtmod.Datatype, "unpack", lambda a: len(memoryview(a[1]))),
          (shm_mod.ShmChannel, "expose_buffer",
           lambda a: np.asarray(a[1]).nbytes),
          (shm_mod.ShmChannel, "pull_buffer", lambda a: a[3]))


def _wrap(marks: List[tuple]):
    """Time the calls of ``MARKED``: (name, bytes, t0, t1) into
    ``marks``; returns a function that restores them."""
    saved = []
    for cls, name, size in MARKED:
        fn = cls.__dict__[name]
        saved.append((cls, name, fn))

        def timed(*a, _fn=fn, _name=name, _size=size, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                marks.append((_name, _size(a), t0, time.perf_counter()))
        setattr(cls, name, timed)

    def restore():
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return restore


def _one_way(comm, nbytes: int, iters: int) -> List[tuple]:
    """``iters`` timed messages of rank 1 to rank 0 (after 2): each
    rank's (t0, t1) of its send or recv."""
    buf = np.full(nbytes, 3, np.uint8)
    back = np.empty(nbytes, np.uint8)
    stamps = []
    for i in range(iters + 2):
        comm.barrier()
        t0 = time.perf_counter()
        if comm.rank == 1:
            comm.send(buf, dest=0, tag=7)
        elif comm.rank == 0:
            comm.recv(back, source=1, tag=7)
        t1 = time.perf_counter()
        if i >= 2:
            stamps.append((t0, t1))
    if comm.rank == 0 and not (back == 3).all():
        raise AssertionError(f"{nbytes} B: wrong payload")
    return stamps


def _exchange(comm, stamps, marks):
    """Rank 1's stamps and marks to rank 0 (None elsewhere)."""
    names = [name for _, name, _ in MARKED]
    rows = np.array([(names.index(m[0]), m[1], m[2], m[3]) for m in marks]
                    or np.zeros((0, 4)), np.float64).reshape(-1, 4)
    st = np.array(stamps, np.float64).reshape(-1, 2)
    if comm.rank == 1:
        comm.send(np.array([len(rows), len(st)], np.int64), dest=0, tag=8)
        comm.send(rows, dest=0, tag=9)
        comm.send(st, dest=0, tag=10)
        return None
    if comm.rank != 0:
        return None
    n = np.empty(2, np.int64)
    comm.recv(n, source=1, tag=8)
    peer_rows = np.empty((int(n[0]), 4), np.float64)
    peer_st = np.empty((int(n[1]), 2), np.float64)
    comm.recv(peer_rows, source=1, tag=9)
    comm.recv(peer_st, source=1, tag=10)
    peer = [(names[int(r[0])], int(r[1]), r[2], r[3]) for r in peer_rows]
    return peer, [tuple(s) for s in peer_st]


def _split(nbytes, stamps, marks, peer_stamps, peer_marks, rung):
    """The medians of one size's messages (see the module docstring)."""
    def within(ms, lo, hi, name):
        got = [m for m in ms if m[0] == name and m[1] == nbytes
               and lo <= m[2] <= hi]
        return got[-1] if got else None
    parts: Dict[str, List[float]] = collections.defaultdict(list)
    for (r0, r1), (s0, s1) in zip(stamps, peer_stamps):
        lo, hi = min(r0, s0), max(r1, s1)
        parts["one_way"].append(r1 - s0)
        parts["send"].append(s1 - s0)
        pack = within(peer_marks, lo, hi, "pack")
        if pack:
            parts["pack"].append(pack[3] - pack[2])
        if rung == "arena":
            continue
        expose = within(peer_marks, lo, hi, "expose_buffer")
        pull = within(marks, lo, hi, "pull_buffer")
        unpack = within(marks, lo, hi, "unpack")
        if not (expose and pull and unpack):
            continue
        parts["expose"].append(expose[3] - expose[2])
        parts["rts_hop"].append(pull[2] - expose[3])
        parts["pull"].append(pull[3] - pull[2])
        parts["unpack"].append(unpack[3] - unpack[2])
        parts["fin_hop"].append(s1 - unpack[3])
    out = {k: statistics.median(v) * 1e6 for k, v in parts.items()}
    out["messages_split"] = len(parts.get("pull", parts["one_way"]))
    return out


def _pull_parts(comm, shm, nbytes: int, iters: int) -> Dict[str, float]:
    """The parts of one CMA pull of ``nbytes`` (rank 0 reads rank 1's
    exposed buffer), medians in microseconds; {} on rank 1."""
    buf = np.full(nbytes, 5, np.uint8)
    meta = np.empty(3, np.int64)
    handle = None
    if comm.rank == 1:
        handle = shm.expose_buffer(buf)
        if handle[0] != "cma":
            raise AssertionError(f"exposed as {handle[0]}, not cma")
        comm.send(np.array(handle[1:], np.int64), dest=0, tag=11)
    elif comm.rank == 0:
        comm.recv(meta, source=1, tag=11)
    out = {}
    if comm.rank == 0:
        pid, addr, tok = (int(v) for v in meta)
        h = ("cma", pid, addr, tok)
        chunk = get_config()["RNDV_CHUNK"]
        reused = np.zeros(nbytes, np.uint8)
        other = np.ones(nbytes, np.uint8)

        kept: List[np.ndarray] = []

        def alloc_touch():
            a = np.empty(nbytes, np.uint8)
            a[::4096] = 0

        cases = {
            "pull_buffer": lambda: shm.pull_buffer(1, h, nbytes),
            "pull_buffer_kept": lambda: kept.append(
                shm.pull_buffer(1, h, nbytes)),
            "alloc_touch": alloc_touch,
            "copy_kept": lambda: kept.append(reused.copy()),
            "cma_chunked_reused": lambda: cma_read(pid, addr, reused,
                                                   chunk=chunk),
            "cma_one_call_reused": lambda: cma_read(pid, addr, reused),
            "memcpy": lambda: np.copyto(other, reused)}
        for name, fn in cases.items():
            lat = []
            for i in range(iters + 2):
                t0 = time.perf_counter()
                fn()
                if i >= 2:
                    lat.append(time.perf_counter() - t0)
            out[name] = statistics.median(lat) * 1e6
            kept.clear()
        if not (reused == 5).all():
            raise AssertionError("CMA pull: wrong payload")
    comm.barrier()
    if handle is not None:
        shm.release_buffer(handle)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="65536,4194304")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    mpi.Init()
    comm = mpi.COMM_WORLD
    shm = current_universe().shm_channel
    if comm.size != 2 or shm is None:
        raise SystemExit("needs two ranks on one node")
    while not shm.try_wire(force=True):
        time.sleep(0.001)
    comm.barrier()
    sizes = [int(v) for v in a.sizes.split(",")]
    rungs = (["cma"] if shm.cma_ok else []) + ["arena", "file"]
    res = {"sizes": sizes, "iters": a.iters,
           "rndv_chunk": get_config()["RNDV_CHUNK"], "rungs": {}}
    for rung in rungs:
        if rung != "cma":
            take_rung(comm, shm, rung)
        per = {}
        for nbytes in sizes:
            marks: List[tuple] = []
            restore = _wrap(marks)
            try:
                stamps = _one_way(comm, nbytes, a.iters)
            finally:
                restore()
            got = _exchange(comm, stamps, marks)
            if got is not None:
                per[nbytes] = _split(nbytes, stamps, marks, got[1], got[0],
                                     rung)
        res["rungs"][rung] = per
    if "cma" in rungs:
        # the rungs were lowered: CMA back for the parts of a pull alone
        shm.cma_ok = True
        comm.barrier()
        res["cma_pull_parts_us"] = _pull_parts(comm, shm, max(sizes),
                                               a.iters)
    if comm.rank == 0:
        line = json.dumps(res)
        print("SHM_RNDV_JSON " + line, flush=True)
        if a.out:
            with open(a.out, "w") as f:
                f.write(line + "\n")
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
