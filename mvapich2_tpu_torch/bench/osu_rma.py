"""OSU one-sided band on device windows (counterpart of the JAX
package's ``benchmarks/osu_put_bw.py`` device mode and of the one-sided
band of ``bench/dev_sweep.py``).

Over ``p`` virtual ranks of one card (``make_mesh((p,), ("x",), dev)``,
``MeshComm``, ``DeviceWin`` of ``n`` f32 elements a rank): for each
message size and each of put, get and accumulate, ``window`` ops from
origin 0 to target p-1 at disp 0 per fence (OSU's window), ``warmup``
fences, then ``iters`` timed fences. A fence ends with the completion
wave (the stream drained), so the host clock around the timed fences
is the time of the ops. Bandwidth is OSU's model, ``size * window *
iters / t`` in MB/s; the per-op latency is ``t / (window * iters)``.
Then one whole-window op of each kind (put, get and accumulate of ``n``
elements through the window, and the single-shot ``direct_put`` K17 of
``n`` elements into it), each timed on the host clock around it and a
synchronize. Payloads come from a seeded ``torch.Generator``.

The artifact::

    {"results": {"dev_put_bw": {"<bytes>": MB/s, ...},
                 "dev_get_bw": {...}, "dev_acc_bw": {...}},
     "latency_us": {"put": {"<bytes>": us, ...}, "get": ..., "acc": ...},
     "rma_tiers": {"<bytes>": "rdma|epoch", ...},
     "whole": {"put": {"bytes": B, "ms": t}, "get": ..., "acc": ...,
               "direct_put": ...},
     "detail": {...}}

    python -m mvapich2_tpu_torch.bench.osu_rma

runs the full band (1 KiB to 4 MiB, 64 MiB windows on 8 ranks) on
``cuda:0``; ``--device cpu --sizes 1024 --n 1024`` is a dry run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import rma
from ..parallel.mesh import MeshComm, make_mesh
from ..rma.device import DeviceWin
from ..runtime.universe import resolve_device

SIZES = [1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20]
WINDOW = 32
WIN_ELEMS = 64 * 1024 * 1024 // 4          # f32 elements a rank: 64 MiB
BANDS = {"put": "dev_put_bw", "get": "dev_get_bw", "acc": "dev_acc_bw"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _enqueue(win: DeviceWin, kind: str, src: torch.Tensor, origin: int,
             target: int):
    if kind == "put":
        return win.put(src, origin, target)
    if kind == "acc":
        return win.accumulate(src, origin, target)
    return win.get(src.numel(), origin, target)


def sweep(sizes: Sequence[int] = SIZES, *, n: Optional[int] = None,
          p: int = 8, device=None, warmup: int = 3, iters: int = 12,
          window: int = WINDOW, seed: int = 0,
          keep: Optional[List[Dict]] = None) -> Dict:
    """The one-sided band on ``device`` (``cuda:0`` unless the caller
    passes another, e.g. ``"cpu"``). ``n``: window elements a rank
    (default 64 MiB of f32, or the largest size on the CPU). ``keep``: a
    list that receives, per band and size, what a plain replay needs:
    ``{"kind", "bytes", "src", "ops", "value"}`` (``ops`` the count of
    identical ops, ``value`` the last get's result), then one entry per
    whole-window op, and finally ``{"kind": "window", "win": the
    DeviceWin}``. Returns the artifact dict (module docstring)."""
    if p < 2 or iters < 1:
        raise ValueError("the one-sided band needs p >= 2 ranks and "
                         "iters >= 1")
    dev = resolve_device(device)
    if n is None:
        n = WIN_ELEMS if dev.type == "cuda" else max(sizes) // 4
    if max(sizes) // 4 > n:
        raise ValueError(f"a {max(sizes)}-byte message does not fit a "
                         f"window of {n} f32 elements")
    comm = MeshComm(make_mesh((p,), ("x",), dev))
    win = DeviceWin(comm, n, torch.float32)
    origin, target = 0, p - 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    bands: Dict[str, Dict[str, float]] = {b: {} for b in BANDS.values()}
    lat: Dict[str, Dict[str, float]] = {k: {} for k in BANDS}
    tiers: Dict[str, str] = {}
    for kind, band in BANDS.items():
        for size in sizes:
            m = max(1, size // 4)
            src = torch.randn(m, generator=gen, device=dev)
            tiers[str(size)] = rma.planned_rma_tier(
                "put", m * 4, torch.float32, True, p, count=m)[0]
            h = None
            for it in range(warmup + iters):
                if it == warmup:
                    _sync(dev)
                    t0 = time.perf_counter()
                for _ in range(window):
                    h = _enqueue(win, kind, src, origin, target)
                win.fence()
            _sync(dev)
            t = time.perf_counter() - t0
            bands[band][str(size)] = m * 4 * window * iters / t / 1e6
            lat[kind][str(size)] = t / (window * iters) * 1e6
            if keep is not None:
                keep.append({"kind": kind, "bytes": m * 4, "src": src,
                             "ops": (warmup + iters) * window,
                             "value": h.value() if kind == "get" else None})
    whole: Dict[str, Dict[str, float]] = {}
    for kind in ("put", "get", "acc", "direct_put"):
        src = torch.randn(n, generator=gen, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        if kind == "direct_put":
            rma.direct_put(src, win.win, origin, target)
            h = None
        else:
            h = _enqueue(win, kind, src, origin, target)
            win.fence()
        _sync(dev)
        whole[kind] = {"bytes": n * 4,
                       "ms": (time.perf_counter() - t0) * 1e3}
        if keep is not None:
            keep.append({"kind": kind, "bytes": n * 4, "src": src, "ops": 1,
                         "value": h.value() if kind == "get" else None})
    if keep is not None:
        keep.append({"kind": "window", "win": win})
    return {"results": bands, "latency_us": lat, "rma_tiers": tiers,
            "whole": whole,
            "detail": {"devices": p,
                       "platform": "gpu" if dev.type == "cuda" else "cpu",
                       "device": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                       "window_elems": n, "window": window,
                       "warmup": warmup, "iters": iters,
                       "origin": origin, "target": target, "seed": seed,
                       "timing": "host clock around the timed fences, "
                                 "each ending in the completion wave"}}


def breakdown(win: DeviceWin, kind: str, size: int,
              window: int = WINDOW) -> Dict:
    """Device time of one fence of ``window`` ops of ``kind`` ('put',
    'get' or 'acc') at ``size`` bytes from rank 0 to rank p-1 on the
    card, from ``torch.profiler`` (one warm-up fence, then one
    profiled): ``kernel`` (K12/K13/K14) and ``other`` (counter zeroing,
    copies), in microseconds, with the profiled fence's host-clock time
    and the idle share ``1 - busy / wall``. All of a window's ops run on
    one stream, so the sum is the device's busy time. Raises without a
    CUDA device; ``{}`` when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    dev = win.device
    if dev.type != "cuda":
        raise RuntimeError("breakdown times the card: it needs a window "
                           "on a CUDA device")
    src = torch.ones(max(1, size // 4), device=dev)

    def fence():
        for _ in range(window):
            _enqueue(win, kind, src, 0, win.p - 1)
        win.fence()
        torch.cuda.synchronize(dev)

    fence()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fence()
        wall = time.perf_counter() - t0
    groups = {"kernel": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = "kernel" if "rma_" in ev.key.lower() else "other"
        groups[g] += ev.self_device_time_total
    if not any(groups.values()):
        return {}
    busy = sum(groups.values())
    return {**groups, "busy_us": busy, "fence_us": wall * 1e6,
            "idle_share": 1 - busy / (wall * 1e6)}


def replay(keep: Sequence[Dict], p: int, n: int,
           device) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Replay a ``sweep``'s ``keep`` list with the plain versions on a
    fresh window: returns the window and, in order, the expected value of
    each kept get."""
    win = torch.zeros((p, n), dtype=torch.float32, device=device)
    gets = []
    for e in keep:
        kind, src = e["kind"], e.get("src")
        if kind == "put" or kind == "direct_put":
            rma.rma_put_ref(src, win, 0, p - 1)
        elif kind == "acc":
            for _ in range(e["ops"]):
                rma.rma_accumulate_ref(src, win, 0, p - 1)
        elif kind == "get":
            gets.append(rma.rma_get_ref(win, src.numel(), 0, p - 1))
    return win, gets


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="osu_rma", description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="",
                    help="comma-separated message bytes (default 1 KiB to "
                         "4 MiB, times 4)")
    ap.add_argument("--n", type=int, default=None,
                    help="window f32 elements a rank (default 64 MiB on "
                         "the card, the largest message on the CPU)")
    ap.add_argument("--np", type=int, default=8,
                    help="virtual ranks sharing the device")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--window", type=int, default=WINDOW,
                    help="ops per fence (OSU's window size)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    ap.add_argument("--out", default="",
                    help="artifact path (default: stdout)")
    args = ap.parse_args(argv)
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes
             else SIZES)
    art = sweep(sizes, n=args.n, p=args.np, device=args.device,
                warmup=args.warmup, iters=args.iters, window=args.window)
    text = json.dumps(art, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
