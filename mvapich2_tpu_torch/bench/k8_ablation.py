"""Ablations of K8's bulk-copy pipeline (``remote_sendrecv_kernel``,
``csrc/ring.cu``) on the card: what its copy engine, its cache policy
and its proxy fence are worth against the same tile walk by the
threads' registers.

Each variant is ``csrc/ring.cu`` with named text edits (:data:`EDITS`;
an anchor must occur exactly once, so an edit that no longer fits the
kernel fails loudly), built by nvcc with the port's flags into
``build/k8_ablation/`` (all at once, one nvcc each), bound with ctypes
in place of the built library, held bitwise against the plain version
and timed by CUDA events, median of 20 after 3, at the exchange's 8 x
64 MiB f32 (ranks 2 and 5 swapping), beside ``torch.stack`` by partner
in the same run. A variant runs at each of its launch shapes
(:data:`SHAPES`: bytes a tile, stages, tiles ahead, blocks per SM).

    python -m mvapich2_tpu_torch.bench.k8_ablation --out k8_ablation.json

Needs one CUDA card of compute capability 9.0 and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..coll import tuning
from ..ops import _build, ici, ring
from ..utils import timing

BUILD = _build.BUILD_DIR.parent / "k8_ablation"
SEED = 1234
R, N = 8, 16 * 1024 * 1024

_BUF = "  const unsigned buf = smem_u32(k8_buf), bar = smem_u32(k8_bar);\n"
_LOAD = ('''          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(buf + s * tile), "l"(f), "r"(bytes), "r"(bar + 8u * s)
''')
_STORE = ('''      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(t), "r"(buf + s * tile), "r"(bytes) : "memory");
''')
_ELECT = ("  if (threadIdx.x != 0) return;\n"
          "  // the bulk tiles, by this block's elected thread\n")
# the same tiles walked by every thread of the block, two 16-byte loads
# in flight a thread, in place of the elected thread's bulk copies
_REGISTERS = '''  const long long tiles = static_cast<long long>(__popcll(bulk)) * tpr;
  for (long long g = blockIdx.x; g < tiles; g += gridDim.x) {
    const int r = nth_bit(bulk, static_cast<int>(g / tpr));
    const long long k = g % tpr;
    char* to = static_cast<char*>(ptrs.out[r]);
    long long h, m;
    k8_cut(to, nbytes, &h, &m);
    const long long off = h + k * tile;
    const long long nw =
        max(0LL, min(static_cast<long long>(tile), m - k * tile)) / 16;
    const uint4* f = reinterpret_cast<const uint4*>(
        static_cast<const char*>(ptrs.in[k8_from(r, src, dst)]) + off);
    uint4* t = reinterpret_cast<uint4*>(to + off);
    for (long long w = threadIdx.x; w < nw; w += 2LL * blockDim.x) {
      const bool two = w + blockDim.x < nw;
      const uint4 a = ld_nc(f + w);
      uint4 b = a;
      if (two) b = ld_nc(f + w + blockDim.x);
      t[w] = a;
      if (two) t[w + blockDim.x] = b;
    }
  }
  return;
'''

# variant -> [(anchor, replacement)]
EDITS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    # both bulk copies with an L2 evict-first policy (the data streams)
    "l2_evict_first": [
        (_BUF, _BUF + '  unsigned long long pol;\n  asm volatile('
         '"createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : '
         '"=l"(pol));\n'),
        (_LOAD, _LOAD.replace("::bytes\"", "::bytes.L2::cache_hint\"")
         .replace("[%3];", "[%3], %4;").replace(
             '"r"(bar + 8u * s)\n', '"r"(bar + 8u * s), "l"(pol)\n')),
        (_STORE, _STORE.replace("bulk_group [%0], [%1], %2;",
                                "bulk_group.L2::cache_hint [%0], [%1], %2, "
                                "%3;").replace('"r"(bytes) :',
                                               '"r"(bytes), "l"(pol) :'))],
    # no async-proxy fence before a tile's store
    "no_proxy_fence": [
        ('      asm volatile("fence.proxy.async.shared::cta;" ::: '
         '"memory");\n', "")],
    "registers": [(_ELECT, _REGISTERS)],
}

# variant -> launch shapes (tile bytes, stages, ahead, blocks per SM);
# the registers variant keeps one stage only to leave room for blocks
SHAPES: Dict[str, List[Tuple[int, int, int, int]]] = {
    "kernel": [(32768, 6, 5, 1), (32768, 4, 3, 1)],
    "l2_evict_first": [(32768, 6, 5, 1)],
    "no_proxy_fence": [(32768, 6, 5, 1)],
    "registers": [(32768, 1, 1, 8), (16384, 1, 1, 8), (65536, 1, 1, 8)],
}
_KEYS = ("k8_tile_bytes", "k8_stages", "k8_ahead", "k8_ctas_per_sm")


def variant_source(name: str) -> str:
    """``csrc/ring.cu`` with variant ``name``'s edits."""
    src = (_build.CSRC_DIR / "ring.cu").read_text()
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: anchor {old!r} occurs "
                             f"{src.count(old)} times in ring.cu")
        src = src.replace(old, new)
    return src


def build(name: str, source: Optional[str] = None,
          folder: Path = BUILD) -> Path:
    """Compile ``source`` (variant ``name``'s by default) into
    ``folder/name.so``; returns its path."""
    folder.mkdir(parents=True, exist_ok=True)
    src, out = folder / f"{name}.cu", folder / f"{name}.so"
    src.write_text(variant_source(name) if source is None else source)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(f"[build] {name}", flush=True)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, args) in _build.SIGNATURES["ring"].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = [t for _, t in args]
    return lib


def run(names, device="cuda:0") -> List[Dict]:
    _build.check_device(device)
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build, names)))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    part = list(range(R))
    part[2], part[5] = 5, 2

    def lib():
        return torch.stack([xs[j] for j in part])

    want = lib()
    rows = [{"variant": "torch.stack by partner", "ms": timing.time_ms(lib)}]
    print(f"[ablation] {json.dumps(rows[-1])}", flush=True)
    saved = _build._loaded.get("ring")
    keep = {k: tuning.kernel_param(k, 0) for k in _KEYS}
    try:
        for name in names:
            _build._loaded["ring"] = _bind(paths[name])
            for shape in SHAPES[name]:
                for k, v in zip(_KEYS, shape):
                    tuning.set_kernel_param(k, v)

                def kern():
                    return ici.remote_sendrecv(xs, 2, 5)

                got = kern()
                torch.cuda.synchronize()
                ring.check_errors()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {shape}: kernel and plain "
                                         f"version disagree")
                rows.append({"variant": name, "shape": shape,
                             "ms": timing.time_ms(kern)})
                print(f"[ablation] {json.dumps(rows[-1])}", flush=True)
    finally:
        for k, v in keep.items():
            tuning.set_kernel_param(k, v)
        if saved is None:
            _build._loaded.pop("ring", None)
        else:
            _build._loaded["ring"] = saved
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(EDITS),
                    help="comma-separated names of EDITS (default: all)")
    ap.add_argument("--out", help="also write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_ablation: no CUDA device is available", file=sys.stderr)
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
