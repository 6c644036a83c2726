"""Process-mode dynamic processes behind the MPI entry point:

    python -m mvapich2_tpu_torch.run -np 2 \\
        python mvapich2_tpu_torch/progs/spawn_parent.py [--big 4194304]

The parents call ``mpi.Comm_spawn_multiple`` with two commands, each
``spawn_child.py`` once, so the two children share one child COMM_WORLD
and see ``Get_appnum()`` 0 and 1 (rank 0's ``Comm_spawn`` wall time is
measured: mostly the children's import and ``Init``). Over the spawn
intercomm the children's pids and appnums come to parent 0 by an
intercomm gather; then the intercomm allreduce of float32 at 8 bytes and
``--big`` bytes (the remote group's sum, integer-valued, checked
exactly), ``--iters`` calls after one warm-up, the median of rank 0's;
then ``merge`` (the parents low: merged rank = world rank) and an
allreduce over the merged comm; then ``disconnect``. Every rank checks
what it got. Rank 0 prints ``No Errors`` and then one line
``SPAWN_JSON {...}``: the spawn time in seconds, the allreduce medians
in microseconds and the children's pids. ``mpi.Finalize`` on rank 0
waits for the children (``runtime/spawn.py`` ``reap_spawned``).
``--bad-first`` first spawns a program that does not exist, which must
fail with MPI_ERR_SPAWN on every parent (its proc ids are published
dead, so the spawn after it comes up all the same).
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

from mvapich2_tpu_torch import mpi
from mvapich2_tpu_torch.core.errors import MPI_ERR_SPAWN, MPIException

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "spawn_child.py")
SMALL = 8


def intercomm_allreduce(inter, nbytes, iters, base):
    """``iters`` timed intercomm allreduces (one warm-up) of float32
    ``base`` everywhere; returns (median seconds, the last result)."""
    x = np.full(nbytes // 4, base, np.float32)
    out = np.empty_like(x)
    times = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        inter.allreduce(x, out)
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:]), out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", type=int, default=4 << 20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--bad-first", action="store_true",
                    help="first spawn a program that does not exist: "
                         "every parent must see MPI_ERR_SPAWN")
    a = ap.parse_args()
    mpi.Init()
    comm = mpi.COMM_WORLD
    bad = []
    args = ["--big", str(a.big), "--iters", str(a.iters)]
    bad_class = None
    if a.bad_first:
        try:
            mpi.Comm_spawn([os.path.join(os.path.dirname(CHILD),
                                         "no-such-program")], comm=comm)
            bad.append("a spawn of a missing program succeeded")
        except MPIException as e:
            bad_class = e.error_class
            if bad_class != MPI_ERR_SPAWN:
                bad.append(f"missing program: error class {bad_class}")
    comm.barrier()
    t0 = time.perf_counter()
    inter, codes = mpi.Comm_spawn_multiple(
        [([sys.executable, CHILD], args, 1),
         ([sys.executable, CHILD], args, 1)], root=0, comm=comm)
    spawn_s = time.perf_counter() - t0
    if any(codes) or inter.remote_size != 2 or not inter.is_inter:
        bad.append(f"spawn: codes {codes}, remote {inter.remote_size}")
    got = inter.gather(np.zeros(2, np.int64), count=2,
                       root=mpi.ROOT if comm.rank == 0 else mpi.PROC_NULL)
    pids = []
    if comm.rank == 0:
        pids = [int(p) for p in got[0::2]]
        if list(got[1::2]) != [0, 1]:
            bad.append(f"appnums {list(got[1::2])}")
    want = 2 * 100.0 + 1.0      # children send 100 + child rank
    lat = {}
    for nbytes in (SMALL, a.big):
        t, out = intercomm_allreduce(inter, nbytes, a.iters, comm.rank + 1)
        lat[nbytes] = t
        if not (out == want).all():
            bad.append(f"intercomm allreduce {nbytes} B: {out[:4]}")
    merged = inter.merge(high=False)
    if merged.size != comm.size + 2 or merged.rank != comm.rank:
        bad.append(f"merge {merged.rank}/{merged.size}")
    tot = merged.allreduce(np.ones(4, np.float32))
    if not (tot == merged.size).all():
        bad.append(f"merged allreduce {tot}")
    inter.disconnect()
    ok = comm.allreduce(np.array([len(bad)], np.int32))
    if bad:
        print(f"rank {comm.rank}: {bad}", flush=True)
    if comm.rank == 0 and int(ok[0]) == 0:
        print("No Errors\nSPAWN_JSON " + json.dumps({
            "parents": comm.size, "children": 2, "spawn_s": spawn_s,
            "allreduce_small_us": lat[SMALL] * 1e6,
            "allreduce_big_us": lat[a.big] * 1e6, "big_bytes": a.big,
            "iters": a.iters, "child_pids": pids,
            "bad_spawn_class": bad_class}), flush=True)
    mpi.Finalize()
    sys.exit(1 if int(ok[0]) else 0)


if __name__ == "__main__":
    main()
