"""Ablations of the flash kernel (K15/K16, ``csrc/flash.cu``) on the card:
how much of its time each part of its work takes.

Each variant is ``csrc/flash.cu`` with named text edits (:data:`EDITS`;
an anchor must occur exactly once, so an edit that no longer fits the
kernel fails loudly), cut to its f32 instance at head width 128, built
by nvcc with the port's flags into ``build/flash_ablation/`` (all at
once, one nvcc each), bound with ctypes in place of the built library,
and timed by CUDA events, median of 5 after 1, at the attention paths'
shapes: K15 over Ulysses' 8 x 2 head rows of 32,768 tokens (causal) and
K16 over the ring's first past step (7 ranks x 16 heads x 4096^2), f32.

Variants that drop work compute wrong results on purpose
(``one_product``, ``no_split``, ``no_barrier``): they measure, and are
no kernels of the port. Each row gives the max abs error of K16's
normalised output (num / den) against f64 attention on the last 256
rows of each head row.

    python -m mvapich2_tpu_torch.bench.flash_ablation --out flash_ablation.json

Needs one CUDA card of compute capability 9.0 and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from ..models import flash
from ..ops import _build
from ..utils import timing

BUILD = _build.BUILD_DIR.parent / "flash_ablation"
SEED = 1234

_SPLIT = "  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));"

# variant -> [(anchor, replacement)]
EDITS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    # one TF32 product a multiply-add: the time of the other two HMMAs
    "one_product": [("  mma(lo, as, bb);\n  mma(lo, ab, bs);\n", "")],
    # the three products without the split's arithmetic
    "no_split": [(_SPLIT, "  small = big;")],
    # both parts rounded to nearest by cvt.rna.tf32.f32
    "cvt_rna": [("  big = __float_as_uint(x);\n" + _SPLIT,
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(big) : "
                 "\"f\"(x));\n  const float r = x - __uint_as_float(big);\n"
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(small) : "
                 "\"f\"(r));")],
    # big rounded to nearest by an add and a mask, small truncated
    "round_big": [("  big = __float_as_uint(x);\n" + _SPLIT,
                   "  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                   "  small = __float_as_uint(x - __uint_as_float(big));")],
    "fast_exp": [("expf(s[j][e] - safe)", "__expf(s[j][e] - safe)"),
                 ("expf(m_acc[r] - safe)", "__expf(m_acc[r] - safe)")],
    # no wait or barrier a tile (races: timing only)
    "no_barrier": [("    cp_async_wait_all();\n    __syncthreads();", "")],
    "bk32": [("BK = D <= 128 ? 64 : 32;", "BK = 32;")],
}

# the instances other than f32 at head width 128, cut from every variant
_OTHER_INSTANCES = (
    (r"\n    case (16|32|64|256): return launch<T, \d+>\([^\n]*", 4),
    (r"\n    case (F16|BF16): return launch_d<[^\n]*", 2))


def variant_source(name: str) -> str:
    """``csrc/flash.cu`` with variant ``name``'s edits, cut to its f32
    instance at head width 128."""
    src = (_build.CSRC_DIR / "flash.cu").read_text()
    for pattern, count in _OTHER_INSTANCES:
        src, n = re.subn(pattern, "", src)
        if n != count:
            raise ValueError(f"flash.cu: {n} launch cases match "
                             f"{pattern!r}, expected {count}")
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: anchor {old!r} occurs "
                             f"{src.count(old)} times in flash.cu")
        src = src.replace(old, new)
    return src


def build(name: str) -> Path:
    BUILD.mkdir(parents=True, exist_ok=True)
    src, out = BUILD / f"{name}.cu", BUILD / f"{name}.so"
    src.write_text(variant_source(name))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs = re.search(r"Used (\d+) registers", proc.stdout + proc.stderr)
    print(f"[build] {name}: {regs.group(0) if regs else 'built'}",
          flush=True)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, args) in _build.SIGNATURES["flash"].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = [t for _, t in args]
    return lib


def _f64_rows(q, k, v, rows=256):
    """Non-causal attention in f64 of the last ``rows`` query rows of
    each [B, T, H, D] block."""
    lo, D = q.shape[1] - rows, q.shape[-1]
    s = torch.einsum("bthd,bkhd->bhtk", q[:, lo:].double() * flash._scale(D),
                     k.double())
    return torch.einsum("bhtk,bkhd->bthd", torch.softmax(s, -1), v.double())


def run(names, device="cuda:0") -> Dict[str, Dict[str, float]]:
    _build.check_device(device)
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build, names)))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qu, ku, vu = (torch.randn((8, 32768, 2, 128), generator=gen, device=dev)
                  for _ in range(3))
    q1, k1, v1 = (torch.randn((7, 4096, 16, 128), generator=gen, device=dev)
                  for _ in range(3))
    want = _f64_rows(q1, k1, v1)
    saved = _build._loaded.get("flash")
    rows = {}
    try:
        for name in names:
            _build._loaded["flash"] = _bind(paths[name])
            k15 = timing.time_ms(lambda: flash.flash_attention(qu, ku, vu,
                                                               True),
                                 warmup=1, iters=5)
            k16 = timing.time_ms(lambda: flash.flash_attention_parts(
                q1, k1, v1, False), warmup=1, iters=5)
            _, num, den = flash.flash_attention_parts(q1, k1, v1, False)
            out = (num / den.transpose(-1, -2)[..., None])[:, -256:]
            rows[name] = {"k15_ms": k15, "k16_ms": k16,
                          "k16_f64_err": (out.double() - want).abs().max()
                          .item()}
            print(f"[ablation] {name}: {json.dumps(rows[name])}", flush=True)
    finally:
        if saved is None:
            _build._loaded.pop("flash", None)
        else:
            _build._loaded["flash"] = saved
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(EDITS),
                    help="comma-separated names of EDITS (default: all)")
    ap.add_argument("--out", help="also write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device is available", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    unknown = [n for n in names if n not in EDITS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(EDITS)}")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows = run(names)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
