"""Build and bind the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/kernels/`` at the repository root, keyed by a hash of the source
and the flags, and loaded with ``ctypes``. Nothing here runs at import:
a CPU-only host imports this module and never calls :func:`load`.

A missing CUDA device, a card that is not sm_90, a missing ``nvcc`` or a
failed compile raises with the reason (and the compiler's log); there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signature of every C entry point, per source: (restype,
# ((argument name, ctype), ...)). Pointers and the stream are c_void_p,
# so a 64-bit address is never cut to a 32-bit int.
_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "hbm_slot": {
        "mv2t_slot_reduce": (_I, (
            ("dtype", _I), ("x", _P), ("out", _P), ("R", _I),
            ("nvec", _I64), ("rank_stride", _I64), ("row_stride", _I64),
            ("mean", _I), ("scale", _F), ("grid", _I), ("block", _I),
            ("stream", _P))),
        "mv2t_fused_allreduce": (_I, (
            ("dtype", _I), ("x", _P), ("out", _P), ("R", _I),
            ("nvec", _I64), ("mean", _I), ("scale", _F), ("grid", _I),
            ("block", _I), ("stream", _P))),
        "mv2t_error_string": (ctypes.c_char_p, (("code", _I),)),
    },
    "ring": {
        "mv2t_hbm_ring_all_reduce": (_I, (
            ("dtype", _I), ("op", _I), ("ins", _P), ("outs", _P),
            ("p", _I), ("n", _I64), ("nblk", _I64), ("chunk", _I64),
            ("depth", _I), ("ndir", _I), ("slots", _P), ("flags", _P),
            ("ctas", _I), ("vec", _I), ("threads", _I), ("stream", _P))),
        "mv2t_hbm_ring_all_gather": (_I, (
            ("dtype", _I), ("ins", _P), ("outs", _P), ("p", _I),
            ("m", _I64), ("chunk", _I64), ("depth", _I), ("ndir", _I),
            ("slots", _P), ("flags", _P), ("ctas", _I), ("vec", _I),
            ("threads", _I), ("stream", _P))),
        "mv2t_ring_all_reduce": (_I, (
            ("dtype", _I), ("ins", _P), ("outs", _P), ("p", _I),
            ("blk", _I64), ("slots", _P), ("flags", _P), ("ctas", _I),
            ("vec", _I), ("threads", _I), ("stream", _P))),
        "mv2t_ring_all_gather": (_I, (
            ("dtype", _I), ("ins", _P), ("outs", _P), ("p", _I),
            ("m", _I64), ("slots", _P), ("flags", _P), ("ctas", _I),
            ("vec", _I), ("threads", _I), ("stream", _P))),
        "mv2t_ring_error": (_I, (("clear", _I),)),
        "mv2t_error_string": (ctypes.c_char_p, (("code", _I),)),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}      # source name -> nvcc output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from source at first use")


def check_device(device=None) -> None:
    """Raise unless a CUDA device of compute capability 9.0 (Hopper) is
    present: the kernels are compiled for sm_90a only."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an "
                           "sm_90 (Hopper) GPU")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != (9, 0):
        raise RuntimeError(
            f"device {torch.cuda.get_device_name(device)!r} has compute "
            f"capability {cap[0]}.{cap[1]}; the kernels are built for "
            f"sm_90a (Hopper) only")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the keyed library exists;
    returns its path. The compiler's output is kept in BUILD_LOGS."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{log}")
    os.replace(tmp, out)     # atomic: a concurrent builder sees all or none
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            check_device()
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, args) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = [t for _, t in args]
            _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib.mv2t_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
