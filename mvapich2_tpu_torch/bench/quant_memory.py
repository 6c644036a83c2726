"""Device memory and time of one quantized allreduce on the card, for the
port of a given checkout, so that two trees are compared in one run.

``quant_ring_all_reduce`` at 8 ranks x 64 MiB f32 on the q8 and fp8
wires, inputs made from a seed on the card: the peak of
``torch.cuda.max_memory_allocated`` during one call above what was
allocated before it (the result included), and the call's time by CUDA
events (median of 20 after 3).

    python mvapich2_tpu_torch/bench/quant_memory.py [--root DIR] [--out F]

``--root`` is the checkout whose ``mvapich2_tpu_torch`` is measured
(default: the one that holds this file). The script is run by its path,
not with ``-m``, so that the package is imported from ``--root`` alone.
Needs one CUDA card of compute capability 9.0 and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

SEED = 1234
R, N = 8, 16 * 1024 * 1024


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from mvapich2_tpu_torch.ops import quant, ring
    from mvapich2_tpu_torch.utils import timing
    if not Path(quant.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {quant.__file__}, not from {root}")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    res = {"root": str(root)}
    for wire in ("q8", "fp8"):
        def call():
            return quant.quant_ring_all_reduce(xs, wire=wire)
        call()                                   # builds and warms up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        res[f"{wire}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        del out
        res[f"{wire}_ms"] = timing.time_ms(call)
        ring.check_errors()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="the checkout whose port is measured")
    ap.add_argument("--out", help="also write the result as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_memory: no CUDA device is available", file=sys.stderr)
        return 2
    res = measure(Path(args.root).resolve())
    res["device"] = torch.cuda.get_device_name(0)
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
