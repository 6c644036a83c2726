"""Host cost of one collective call on the 1:1 mesh channel, on the host
clock and under cProfile (the end-to-end latencies of ``chip_smoke.py``'s
``[mesh]`` alltoall and ``[nbc]`` iallreduce + wait, with their small
twins where the host's share is largest).

Over ``p`` rank threads bound one to one to a mesh of ``p`` virtual ranks
of one card (``run_ranks(p, app, device_mesh=make_mesh((p,), ("x",),
dev))``), each case runs ``warmup`` calls, then ``iters`` timed calls,
each followed by a synchronize of the rank's stream. A case's figure is
the median over the ranks of each rank's median, in ms; ``rounds``
separate ``run_ranks`` give one figure each. The cases:

* ``alltoall_64m``: ``comm.alltoall`` of 64 MiB f32 a rank (K10);
* ``alltoall_4k``: the same of 4 KiB a rank;
* ``allreduce_4k``: ``comm.allreduce`` of a 4 KiB f32 tensor;
* ``iallreduce_wait_64m``: ``comm.iallreduce(x, out).wait()`` of 64 MiB
  f32 into a numpy ``out`` (the device NBC tier, 8 segments);
* ``iallreduce_wait_64k``: the same of 64 KiB.

Then one more ``run_ranks`` in which rank 0 runs ``prof_iters`` calls of
each case under ``cProfile``: Python function calls a call (a count, the
same on any machine for the same code path) and the functions that took
most of rank 0's own time. Inputs are integer-valued f32 from a seeded
``torch.Generator``.

The artifact (``--out``)::

    {"device": ..., "rounds": {"<case>": [ms, ...]},
     "profile": {"<case>": {"calls_per_call": n, "top": [[fn, ncalls,
                 tottime_s, cumtime_s], ...]}}}

    python -m mvapich2_tpu_torch.bench.call_overhead --out o.json

runs on ``cuda:0``; ``--device cpu --iters 3 --rounds 1`` is a dry run.
It uses only entry points that every tree since the 1:1 mesh's
nonblocking tier has, so the same file compares two checkouts: copy it
into the other tree's ``mvapich2_tpu_torch/bench/`` and run it there.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel.mesh import make_mesh
from ..runtime.universe import resolve_device, run_ranks

BIG = 64 * 1024 * 1024 // 4        # f32 elements: 64 MiB a rank
SMALL = 1024                       # f32 elements: 4 KiB a rank
NBC_SMALL = 16 * 1024              # f32 elements: 64 KiB a rank
CASES = ("alltoall_64m", "alltoall_4k", "allreduce_4k",
         "iallreduce_wait_64m", "iallreduce_wait_64k")


def _inputs(p: int, dev: torch.device, seed: int) -> Dict[str, list]:
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(n):
        return [torch.randint(-1000, 1000, (n,), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.float32)
                for _ in range(p)]
    return {"big": ints(BIG), "small": ints(SMALL), "nbc": ints(NBC_SMALL)}


def _calls(comm, xs: Dict[str, list]) -> Dict[str, Callable[[], object]]:
    r = comm.rank
    out_big = np.empty(BIG, np.float32)
    out_nbc = np.empty(NBC_SMALL, np.float32)
    return {
        "alltoall_64m": lambda: comm.alltoall(xs["big"][r]),
        "alltoall_4k": lambda: comm.alltoall(xs["small"][r]),
        "allreduce_4k": lambda: comm.allreduce(xs["small"][r]),
        "iallreduce_wait_64m": lambda: comm.iallreduce(
            xs["big"][r], out_big).wait(),
        "iallreduce_wait_64k": lambda: comm.iallreduce(
            xs["nbc"][r], out_nbc).wait(),
    }


def _sync_fn(dev: torch.device) -> Callable[[], None]:
    if dev.type == "cuda":
        return lambda: torch.cuda.current_stream().synchronize()
    return lambda: None


def timed_round(p: int, dev: torch.device, xs, warmup: int,
                iters: int) -> Dict[str, float]:
    """One run_ranks: every case's median over the ranks of each rank's
    median latency, in ms."""
    sync = _sync_fn(dev)
    mesh = make_mesh((p,), ("x",), dev)

    def app(comm):
        lat: Dict[str, List[float]] = {}
        for name, fn in _calls(comm, xs).items():
            for _ in range(warmup):
                fn()
                sync()
            got = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                sync()
                got.append(time.perf_counter() - t0)
            lat[name] = got
        return lat

    res = run_ranks(p, app, device_mesh=mesh)
    return {c: statistics.median(statistics.median(r[c]) for r in res) * 1e3
            for c in CASES}


def profile_round(p: int, dev: torch.device, xs, warmup: int,
                  iters: int, top: int = 12) -> Dict[str, dict]:
    """One run_ranks in which rank 0 profiles ``iters`` calls of each
    case: Python function calls a call and the ``top`` functions by own
    time."""
    sync = _sync_fn(dev)
    mesh = make_mesh((p,), ("x",), dev)

    def app(comm):
        out = {}
        for name, fn in _calls(comm, xs).items():
            for _ in range(warmup):
                fn()
                sync()
            prof = cProfile.Profile() if comm.rank == 0 else None
            if prof is not None:
                prof.enable()
            for _ in range(iters):
                fn()
                sync()
            if prof is None:
                continue
            prof.disable()
            st = pstats.Stats(prof)
            rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
            out[name] = {
                "calls_per_call": st.total_calls / iters,
                "top": [[f"{fn_[0].split('/')[-1]}:{fn_[1]}:{fn_[2]}",
                         v[1], round(v[2], 6), round(v[3], 6)]
                        for fn_, v in rows]}
        return out

    return run_ranks(p, app, device_mesh=mesh)[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="host cost of one collective call on the 1:1 mesh")
    ap.add_argument("--device", default=None, help="default cuda:0")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--prof-iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    xs = _inputs(a.ranks, dev, a.seed)
    rounds: Dict[str, List[float]] = {c: [] for c in CASES}
    for _ in range(a.rounds):
        for c, ms in timed_round(a.ranks, dev, xs, a.warmup,
                                 a.iters).items():
            rounds[c].append(ms)
    prof = profile_round(a.ranks, dev, xs, a.warmup, a.prof_iters)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for c in CASES:
        print(f"[overhead] {a.label} {name}: {c} ms "
              f"{[round(v, 4) for v in rounds[c]]}; "
              f"{prof[c]['calls_per_call']:.0f} Python calls a call")
    art = {"device": name, "label": a.label, "ranks": a.ranks,
           "iters": a.iters, "rounds": rounds, "profile": prof}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(art, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
