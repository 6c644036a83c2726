"""The device collectives behind the MPI entry point:

    python -m mvapich2_tpu_torch.run -np 8 --vpod \\
        python mvapich2_tpu_torch/progs/vpod_collectives.py [--big N] ...

Each rank thread calls ``mpi.Init()`` and runs, on its COMM_WORLD (bound
one to one to a mesh of virtual ranks on the card): allreduces of
``--big`` f32 a rank (64 MiB: K3) and ``--small`` (4 KiB: K6), allgathers
of ``--ag-big`` (1 MiB: K5, past the resident edge) and ``--ag-small``
(64 KiB: K7), an alltoall of ``--a2a`` (64 MiB: K10) and an alltoallv of a
seeded count matrix (K11). The data are integer-valued f32 made on the
device from seeds, so every result is held bit for bit against stock
torch on the same device (sums of the regenerated inputs, ``torch.cat``
and slices). ``--iters`` allreduces of each size are timed on the host
clock around the call and a stream synchronize, after 2 warm-ups.

Rank 0 prints one line ``VPOD_JSON {...}``: the medians in seconds, the
number of calls of each kind, the kernels' launch counts over the run
(``ops/ici.py``, ``ops/ring.py``, ``ops/alltoall.py`` ``LAUNCHES``; their
``PLAIN_CALLS`` on the CPU, under ``MV2T_VPOD_REAL=0``) and whether every
result matched. A mismatch raises, so the job exits nonzero.
"""

import argparse
import json
import statistics
import sys
import time

import torch

from mvapich2_tpu_torch import mpi
from mvapich2_tpu_torch.ops import alltoall, ici, ring

SEED = 2024
MODS = (ici, ring, alltoall)


def _counts(dev):
    name = "LAUNCHES" if dev.type == "cuda" else "PLAIN_CALLS"
    out = {}
    for m in MODS:
        out.update(getattr(m, name))
    return out


def _data(seed, n, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-8, 9, (n,), generator=g, dtype=torch.float32,
                         device=dev)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _check(what, got, want):
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"vpod {what}: the result differs from stock "
                             f"torch on {want.device}")


def _timed(comm, x, dev, iters):
    for _ in range(2):
        comm.allreduce(x)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        comm.allreduce(x)
        _sync(dev)
        lat.append(time.perf_counter() - t0)
    return lat


def _count_matrix(p, total):
    g = torch.Generator().manual_seed(SEED + 7)
    w = torch.rand((p, p), generator=g) + 0.05
    return (w / w.sum(1, keepdim=True) * total).long().tolist()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", type=int, default=16 << 20)
    ap.add_argument("--small", type=int, default=1024)
    ap.add_argument("--ag-big", type=int, default=256 << 10)
    ap.add_argument("--ag-small", type=int, default=16 << 10)
    ap.add_argument("--a2a", type=int, default=16 << 20)
    ap.add_argument("--a2av", type=int, default=4 << 20)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    mpi.Init()
    comm = mpi.COMM_WORLD
    r, p = comm.rank, comm.size
    dev = comm.u.device
    if r == 0:
        for m in MODS:
            m.reset_counts()
    comm.barrier()
    calls = {"allreduce_big": 0, "allreduce_small": 0}
    for k, (kind, n) in enumerate((("big", args.big),
                                   ("small", args.small))):
        xs = [_data(SEED + 100 * k + j, n, dev) for j in range(p)]
        want = torch.zeros_like(xs[0])
        for x in xs:
            want += x
        _check(f"allreduce {n}", comm.allreduce(xs[r]), want)
        lat = _timed(comm, xs[r], dev, args.iters)
        calls[f"allreduce_{kind}"] += args.iters + 3
        calls[f"median_{kind}_s"] = statistics.median(lat)
        del xs, want
    for k, n in enumerate((args.ag_big, args.ag_small)):
        xs = [_data(SEED + 1000 + 100 * k + j, n, dev) for j in range(p)]
        _check(f"allgather {n}", comm.allgather(xs[r]), torch.cat(xs))
    xs = [_data(SEED + 2000 + j, args.a2a - args.a2a % p, dev)
          for j in range(p)]
    c = xs[0].numel() // p
    want = torch.cat([xs[j][r * c:(r + 1) * c] for j in range(p)])
    _check(f"alltoall {args.a2a}", comm.alltoall(xs[r]), want)
    del xs, want
    counts = _count_matrix(p, args.a2av)
    xs = [_data(SEED + 3000 + j, sum(counts[j]), dev) for j in range(p)]
    sd = [[sum(row[:k]) for k in range(p)] for row in counts]
    rc = [counts[j][r] for j in range(p)]
    want = torch.cat([xs[j][sd[j][r]:sd[j][r] + counts[j][r]]
                      for j in range(p)])
    _check("alltoallv", comm.alltoallv(xs[r], counts[r], None, None, rc,
                                       None), want)
    _sync(dev)
    comm.barrier()
    if r == 0:
        print("VPOD_JSON " + json.dumps({
            "ranks": p, "device": str(dev), "calls": calls,
            "counts_of": "LAUNCHES" if dev.type == "cuda" else "PLAIN_CALLS",
            "launches": _counts(dev), "bitwise": True}), flush=True)
    mpi.Finalize()


if __name__ == "__main__":
    sys.exit(main())
