"""Token-routing MoE step bench (counterpart of the JAX package's
``bench/moe.py``): the workload the alltoall(v) kernels exist for.

One expert-parallel Mixture-of-Experts step over ``p`` virtual ranks of
one card (one expert per rank) is dispatch alltoallv -> expert matmul ->
combine alltoallv, with the per-peer token counts set by a static top-1
router (``uniform`` / ``skew`` / ``hot``, :func:`routing`, the JAX
bench's matrices). The alltoall(v) halves go through the tier dispatch of
``ops/alltoall.py`` (K10, K11); the expert product is one
``torch.matmul`` per rank, as the JAX bench leaves it to XLA, in full
float32 (``torch.backends.cuda.matmul.allow_tf32`` is left False; the
artifact records it). Each rank's shard is its own allocation on the
device, at its own length (the JAX bench pads every shard to the
mesh-wide maximum, which ``shard_map`` needs and the port does not).
Token values and ``W`` come from seeded ``torch.Generator`` s.

Times are host-clock medians around each call followed by a device
synchronize (the JAX bench's ``block_until_ready`` timing), after one
warm-up call. The artifact has the JAX bench's keys::

    {"results": {"dev_alltoall_effbw": {"<bytes>": GB/s, ...},
                 "moe_step":           {"<bytes>": us, ...},
                 "moe_step_skew":      {"<bytes>": us, ...},
                 "moe_step_hot":       {"<bytes>": us, ...}},
     "a2a_tiers":   {"<bytes>": "hbm|xla", ...},
     "wire_bytes":  {"<bytes>": {"uniform": N, "skew": N, "hot": N}},
     "detail": {...}}

keyed by the per-rank token payload bytes ``m``; ``dev_alltoall_effbw``
is the uniform alltoall at ``m`` a rank, effbw = ``(p-1)/p * m / t``;
``wire_bytes`` the analytic per-rank bytes that leave a rank.

    python -m mvapich2_tpu_torch.bench.moe --tokens 4096 --dmodel 4096

runs on ``cuda:0`` (``--device cpu`` for a CPU dry run).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops import alltoall
from ..runtime.universe import resolve_device

SHAPES = {"moe_step": "uniform", "moe_step_skew": "skew",
          "moe_step_hot": "hot"}


def routing(p: int, tokens: int, shape: str) -> List[List[int]]:
    """Static per-rank routing ``counts[i][j]`` = tokens rank ``i``
    sends expert ``j`` (deterministic; rows sum to ``tokens``).

      uniform  every expert gets tokens/p
      skew     zipf-ish: expert j's share ~ 1/(j+1+i) rotated per rank,
               so no expert is globally cold
      hot      half of every rank's tokens pile onto expert 0
    """
    out = []
    for i in range(p):
        if shape == "uniform":
            row = [tokens // p] * p
        elif shape == "hot":
            rest = tokens - tokens // 2
            row = [tokens // 2 if j == 0 else 0 for j in range(p)]
            for j in range(p):
                row[(i + j) % p] += rest // p
            row[i] += rest - p * (rest // p)
        else:                     # skew
            w = [1.0 / ((i + j) % p + 1) for j in range(p)]
            tot = sum(w)
            row = [int(tokens * x / tot) for x in w]
            row[i] += tokens - sum(row)
        out.append(row)
    return out


def moe_step(xs: Sequence[torch.Tensor], W: torch.Tensor,
             counts: Sequence[Sequence[int]]):
    """One MoE step: ``xs[r]`` is rank r's tokens, flat, ``counts[r][j]``
    the elements (tokens x dmodel) it routes to expert j, packed in
    expert order. Returns (dispatched, expert outputs, combined), one
    tensor per rank each; ``combined[r]`` is ``xs[r]`` with every token
    multiplied by ``W``, back in rank r's order."""
    p, dmodel = len(xs), W.shape[0]
    back = [[counts[j][i] for j in range(p)] for i in range(p)]
    toks = alltoall.ici_all_to_allv(xs, counts)
    h = [torch.matmul(t.view(-1, dmodel), W).view(-1) for t in toks]
    return toks, h, alltoall.ici_all_to_allv(h, back)


def breakdown(xs: Sequence[torch.Tensor], W: torch.Tensor,
              counts: Sequence[Sequence[int]]) -> Dict:
    """Device time of one MoE step on the card by kernel group, from
    ``torch.profiler`` (one warm-up step, then one profiled): ``K11``
    (``hbm_alltoallv_direct_kernel``), ``gemm`` (the expert products) and
    ``other`` (copies), in microseconds, with the
    profiled step's host-clock time. All of the step's kernels run on
    one stream, so their sum is the device's busy time. Raises without
    a CUDA device; ``{}`` when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    dev = W.device
    if dev.type != "cuda":
        raise RuntimeError("breakdown times the card: it needs CUDA "
                           "tensors")
    moe_step(xs, W, counts)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        moe_step(xs, W, counts)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    groups = {"K11": 0.0, "gemm": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        g = ("K11" if "alltoallv" in name else
             "gemm" if "gemm" in name or "xmma" in name else "other")
        groups[g] += ev.self_device_time_total
    if not any(groups.values()):
        return {}
    return {**groups, "busy_us": sum(groups.values()),
            "profiled_step_us": wall * 1e6}


def _timer(dev: torch.device, iters: int) -> Callable:
    def timed(fn) -> float:
        def run():
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out
        run()                           # warm-up: builds and allocates
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)
    return timed


def sweep(token_counts: Sequence[int], dmodel: int = 16, iters: int = 5,
          device=None, p: int = 8, seed: int = 0) -> Dict:
    """The uniform alltoall band and the MoE step at each per-rank token
    count, over ``p`` virtual ranks on ``device`` (``cuda:0`` unless the
    caller passes another, e.g. ``"cpu"``). Returns the artifact dict
    (module docstring)."""
    if p < 2:
        raise ValueError("the MoE bench needs p >= 2 ranks")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn(dmodel, dmodel, generator=gen, device=dev)
    timed = _timer(dev, iters)
    effbw: Dict[str, float] = {}
    steps: Dict[str, Dict[str, float]] = {band: {} for band in SHAPES}
    a2a_tiers: Dict[str, str] = {}
    wire_bytes: Dict[str, Dict[str, int]] = {}

    for tokens in token_counts:
        tokens -= tokens % p                  # uniform band needs p | T
        tokens = max(tokens, p)
        n = tokens * dmodel                   # per-rank payload elements
        m = n * 4
        a2a_tiers[str(m)] = alltoall.planned_a2a_tier(m, torch.float32)[0]

        # the uniform alltoall: the raw wire band
        xs = [torch.arange(r * n, (r + 1) * n, dtype=torch.float32,
                           device=dev) for r in range(p)]
        t = timed(lambda: alltoall.ici_all_to_all(xs))
        effbw[str(m)] = (p - 1) / p * m / t / 1e9
        del xs

        # the MoE step per routing shape
        wb: Dict[str, int] = {}
        for band, shape in SHAPES.items():
            ecounts = [[c * dmodel for c in row]
                       for row in routing(p, tokens, shape)]
            wb[shape] = 4 * max(sum(c for j, c in enumerate(row) if j != i)
                                for i, row in enumerate(ecounts))
            xs = [torch.randn(n, generator=gen, device=dev)
                  for _ in range(p)]
            steps[band][str(m)] = timed(
                lambda: moe_step(xs, W, ecounts)) * 1e6
            del xs
        wire_bytes[str(m)] = wb

    return {"results": {"dev_alltoall_effbw": effbw, **steps},
            "a2a_tiers": a2a_tiers,
            "wire_bytes": wire_bytes,
            "detail": {"devices": p,
                       "platform": "gpu" if dev.type == "cuda" else "cpu",
                       "device": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                       "dmodel": dmodel,
                       "iters": iters,
                       "seed": seed,
                       "timing": "host clock around each call and a "
                                 "device synchronize, median",
                       "matmul_allow_tf32":
                           torch.backends.cuda.matmul.allow_tf32}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="moe", description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", default="",
                    help="comma-separated per-rank token counts "
                         "(default: 4096,16384,65536 on the card, 32,128 "
                         "on the CPU)")
    ap.add_argument("--dmodel", type=int, default=16,
                    help="model width per token (default 16)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--np", type=int, default=8,
                    help="virtual ranks sharing the device")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    ap.add_argument("--out", default="",
                    help="artifact path (default: stdout)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tokens = ([int(s) for s in args.tokens.split(",")] if args.tokens
              else ([4096, 16384, 65536] if dev.type == "cuda"
                    else [32, 128]))
    art = sweep(tokens, dmodel=args.dmodel, iters=args.iters, device=dev,
                p=args.np)
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
