"""Process-mode latencies behind the MPI entry point:

    python -m mvapich2_tpu_torch.run -np 4 --fake-nodes 0,0,1,1 \\
        python mvapich2_tpu_torch/progs/pingpong.py [--sizes 1,65536,...]

Each rank process calls ``mpi.Init()`` (its wall time is measured) and
runs on the host tier: a numpy ping-pong of rank 0 with rank 1 (the same
fake node: the shared-memory channel) and with rank 2 (another fake
node: the TCP channel) at each of ``--sizes`` bytes, ``--iters`` round
trips after 2 warm-ups, the half round trip's median; the median of an
8-byte allreduce and of a barrier. Every payload is checked. Then a
tensor on the card (a meta tensor where no card is present) given to
``allreduce`` must raise ``NotImplementedError``: a process-mode
COMM_WORLD has no device channel, and a tensor is never moved to the
host and back.

Rank 0 prints one line ``PINGPONG_JSON {...}`` with the figures in
microseconds, the ranks' ``mpi.Init`` wall times in seconds, the
point-to-point pvars of rank 0 (eager and rendezvous sends, and the
counters of the shared-memory rendezvous's rungs: ``rndv_cma_bytes``,
``rndv_pipeline_chunks``, ``arena_allocs``) and the rungs its node
agreed (``rungs``: ``cma`` and ``arena``). ``MV2T_USE_CMA=0`` takes the
arena (and the pipelined rendezvous) where CMA would serve;
``MV2T_USE_CMA=0 MV2T_ARENA_BYTES=4096`` leaves the file rung (no block
of the arena fits).

``--rungs arena,file`` measures the shared-memory ping-pong again at
each size under each named lower rung in the same job (``rung_runs``:
its latencies, rank 0's pvar deltas and the verdicts it ran under): once
every rank has wired its node and met the others at a barrier, so that
no rendezvous is in flight, each rank drops its node's higher verdicts
(``arena``: CMA off; ``file``: CMA and the arena off). A sender picks
its rung from those verdicts and a receiver follows the handle it is
sent, so this is the rung that the environment variables above select
at start-up.
"""

import argparse
import json
import statistics
import sys
import time

t_start = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mvapich2_tpu_torch import mpi, mpit  # noqa: E402
from mvapich2_tpu_torch.runtime.universe import current_universe  # noqa: E402


def _pingpong(comm, peer, nbytes, iters):
    r = comm.rank
    buf = np.full(nbytes, r + 1, np.uint8)
    back = np.empty(nbytes, np.uint8)
    lat = []
    for i in range(iters + 2):
        comm.barrier()
        t0 = time.perf_counter()
        if r == 0:
            comm.send(buf, dest=peer, tag=5)
            comm.recv(back, source=peer, tag=6)
        elif r == peer:
            comm.recv(back, source=0, tag=5)
            comm.send(back, dest=0, tag=6)
        if i >= 2:
            lat.append((time.perf_counter() - t0) / 2)
    if r in (0, peer) and not (back == 1).all():
        raise AssertionError(f"ping-pong {nbytes} B with rank {peer}: "
                             f"wrong payload")
    return statistics.median(lat) * 1e6


def verdicts(shm):
    """The rungs this rank's node agreed (None without a shm channel)."""
    return None if shm is None else {"cma": bool(shm.cma_ok),
                                     "arena": bool(shm._arena_ready)}


def take_rung(comm, shm, rung):
    """Every rank from here on sends its shared-memory rendezvous over
    ``rung`` ("arena" or "file"); see the module docstring."""
    if shm is not None:
        while not shm.try_wire(force=True):
            time.sleep(0.001)
    comm.barrier()
    if shm is not None:
        if rung == "arena" and not shm._arena_ready:
            raise AssertionError("the arena rung was not agreed")
        shm.cma_ok = False
        if rung == "file":
            shm._arena_ready = False
    comm.barrier()


def _lat(fn, iters):
    for _ in range(2):
        fn()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out) * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,65536,4194304")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rungs", default="",
                    help="lower rungs to measure the shm ping-pong under "
                    "too, of arena and file, in this order")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mpi.Init()
    init_s = time.perf_counter() - t0
    comm = mpi.COMM_WORLD
    r = comm.rank
    pv = ("pt2pt_eager_sent", "pt2pt_rndv_sent", "chan_shm_bytes_sent",
          "chan_tcp_bytes_sent", "rndv_cma_bytes", "rndv_pipeline_chunks",
          "arena_allocs")
    before = {k: mpit.pvar(k).read() for k in pv}
    out = {"ranks": comm.size, "pingpong_us": {}}
    for peer, chan in ((1, "shm"), (2, "tcp")):
        if peer >= comm.size:
            continue
        out["pingpong_us"][chan] = {
            n: _pingpong(comm, peer, n, args.iters)
            for n in map(int, args.sizes.split(","))}
    x = np.full(2, float(r), np.float32)
    want = float(sum(range(comm.size)))
    if comm.allreduce(x)[0] != want:
        raise AssertionError("8 B allreduce: wrong sum")
    out["allreduce_8B_us"] = _lat(lambda: comm.allreduce(x), args.iters)
    out["barrier_us"] = _lat(comm.barrier, args.iters)
    card = "cuda" if torch.cuda.is_available() else "meta"
    try:
        comm.allreduce(torch.ones(4, device=card))
    except NotImplementedError:
        out["card_tensor_refused"] = card
    else:
        raise AssertionError(f"a tensor on {card} was taken by a "
                             f"process-mode allreduce")
    out["pvars_rank0"] = {k: mpit.pvar(k).read() - before[k] for k in pv}
    shm = current_universe().shm_channel
    out["rungs"] = verdicts(shm)
    out["rung_runs"] = {}
    for rung in filter(None, args.rungs.split(",")):
        take_rung(comm, shm, rung)
        before = {k: mpit.pvar(k).read() for k in pv}
        out["rung_runs"][rung] = {
            "pingpong_us": {"shm": {
                n: _pingpong(comm, 1, n, args.iters)
                for n in map(int, args.sizes.split(","))}},
            "pvars_rank0": {k: mpit.pvar(k).read() - before[k]
                            for k in pv},
            "rungs": verdicts(shm)}
    out["init_s"] = comm.gather(np.array([init_s]), root=0)
    out["import_and_init_s"] = time.perf_counter() - t_start
    if r == 0:
        out["init_s"] = [float(v) for v in np.asarray(out["init_s"]).ravel()]
        print("PINGPONG_JSON " + json.dumps(out), flush=True)
    mpi.Finalize()


if __name__ == "__main__":
    sys.exit(main())
