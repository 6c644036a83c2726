"""Host time of the nonblocking device tier's landing copies while the
process's other threads poll, as rank threads do.

An iallreduce of 64 MiB on the slot or fold channel finishes on every
rank with ``coll/device.py`` ``_land``: one ``copy_`` a segment (8 of 8
MiB) into the receive tensor on the card. Here one thread times those
eight copies (``--iters`` times after 2; host time up to their return,
then a synchronize outside the timing) while ``--threads`` other threads
of the same process do one of:

* ``alone``: nothing (no other thread runs);
* ``query``: call ``query()`` on a recorded CUDA event in a loop, as an
  engine's poll pass does on a segment's completion event;
* ``python``: run a pure-Python loop that makes no CUDA call (it holds
  only the GIL);
* ``copy``: land copies of their own in a loop, each thread on its own
  stream, as the other ranks' finishes do at the same time.

Every thread, the timing one too, launches on a stream of its own, as the
rank threads of ``run_ranks`` do.

Each case runs under Python's GIL switch interval and under
``--switch`` ms. Medians in ms, with the number of queries the other
threads made a copy round::

    python -m mvapich2_tpu_torch.bench.land_contention --out o.json

runs on ``cuda:0``; ``--device cpu --iters 3 --seg-kib 64`` is a dry
run (a CPU event's ``query`` is a Python stub).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

from ..runtime.universe import resolve_device

SEGS = 8
CASES = ("alone", "query", "python", "copy")


class _CpuEvent:
    def query(self) -> bool:
        return True


def _stream(dev: torch.device):
    return torch.cuda.stream(torch.cuda.Stream(dev)) \
        if dev.type == "cuda" else contextlib.nullcontext()


def _land(parts: List[torch.Tensor], flat: torch.Tensor) -> None:
    off = 0
    for p in parts:
        flat[off:off + p.numel()].copy_(p)
        off += p.numel()


def _land_ms(dev: torch.device, case: str, threads: int, iters: int,
             switch: float, seg: int) -> Dict[str, float]:
    """One case: the median host ms of the eight copies of ``seg`` f32
    elements each, and the other threads' polls (or copy rounds) a
    timed round."""
    def inputs():
        return ([torch.full((seg,), float(i), device=dev)
                 for i in range(SEGS)], torch.empty(SEGS * seg, device=dev))
    parts, flat = inputs()
    if dev.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        torch.cuda.synchronize(dev)
    else:
        ev = _CpuEvent()
    stop = threading.Event()
    polls = [0] * threads

    def worker(i: int) -> None:
        mine = inputs() if case == "copy" else None
        n = 0
        with _stream(dev):
            while not stop.is_set():
                if case == "query":
                    ev.query()
                elif case == "copy":
                    _land(*mine)
                else:
                    sum(range(64))
                n += 1
        polls[i] = n

    others = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(threads if case != "alone" else 0)]
    real_switch = sys.getswitchinterval()
    sys.setswitchinterval(switch)
    lat: List[float] = []
    try:
        for t in others:
            t.start()
        with _stream(dev):
            for i in range(iters + 2):
                t0 = time.perf_counter()
                _land(parts, flat)
                t1 = time.perf_counter()
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                if i >= 2:
                    lat.append((t1 - t0) * 1e3)
    finally:
        stop.set()
        for t in others:
            t.join()
        sys.setswitchinterval(real_switch)
    if not torch.equal(flat[::seg].cpu(),
                       torch.arange(SEGS, dtype=torch.float32)):
        raise AssertionError("landing copies: wrong result")
    return {"ms": statistics.median(lat),
            "polls_a_round": sum(polls) / (iters + 2)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default cuda:0")
    ap.add_argument("--threads", type=int, default=7)
    ap.add_argument("--seg-kib", type=int, default=8192,
                    help="a segment's bytes: 8 MiB, an eighth of 64 MiB")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--switch", type=float, default=0.5,
                    help="the second GIL switch interval, ms")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    seg = a.seg_kib * 1024 // 4
    res = {"device": name, "threads": a.threads, "iters": a.iters,
           "segments": SEGS, "segment_bytes": seg * 4, "cases": {}}
    for switch in (sys.getswitchinterval(), a.switch * 1e-3):
        key = f"switch_{switch * 1e3:g}ms"
        res["cases"][key] = {c: _land_ms(dev, c, a.threads, a.iters, switch,
                                         seg) for c in CASES}
        print(f"[land] {name}, GIL switch interval {switch * 1e3:g} ms: "
              + "; ".join(f"{c} {v['ms']:.4f} ms ({v['polls_a_round']:.0f} "
                          f"polls a round)"
                          for c, v in res["cases"][key].items()),
              flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
