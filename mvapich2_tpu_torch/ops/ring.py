"""Resident ring collectives over ``p`` virtual ranks of one GPU
(counterpart of ``mvapich2_tpu/ops/pallas_ring.py``), and the ring
machinery shared with the streaming kernels of ``ops/ici.py``.

Two kernels, written in CUDA C++ in ``csrc/ring.cu``:

``ring_all_reduce`` (K6) sums ``p`` shards of ``n`` elements
(``n % p == 0``, at most 4 MiB). The JAX kernel runs a reduce-scatter
ring then an all-gather ring, ``2(p-1)`` rounds over 2 landing slots
per rank under a credit handshake. On one card the kernel computes the
ring's result directly: block ``b`` of the sum folded in the ring's
order, ``x[b] + (x[b-1] + (... + (x[b+2] + x[b+1])))`` with every
partial rounded to the dtype, stored into every rank's row, in one
ordinary launch with no slot, flag or wait.

``ring_all_gather`` (K7) gathers ``p`` shards of ``m`` elements
(``p*m`` at most 4 MiB): each shard read once and stored into every
rank's row, one ordinary launch.

Inputs: a list of ``p`` one-dimensional tensors (one per rank, each its
own allocation, read in place) or one ``(p, n)`` tensor. Output: one
``(p, ...)`` tensor whose row ``r`` is rank ``r``'s result.

Routing: a wrapper given CPU tensors computes its plain PyTorch version
(``*_ref``), which replays the ring schedule step by step so its fold
order is the JAX kernel's; given CUDA tensors it launches the kernel
on the current stream or raises. ``LAUNCHES`` counts kernel launches
only, ``PLAIN_CALLS`` the plain route.

The direct launch serves K3, K4 and K5 of ``ops/ici.py`` too (K6's fold
and K7's gather over ``lines`` rings). No kernel of ``csrc/ring.cu``
runs the TPU rings' landing slots and credits any more: each is one
ordinary launch. K8 (``ops/ici.py``) waits inside a block on its bulk
copies; a wait that outlasts 2 s sets an error word and ends the
launch; :func:`check_errors` (and the next launch through
:func:`launch`) raises on it, and the mesh channel checks it after
every collective, so that collective raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch


# the JAX kernels' VMEM budget guard (pallas_ring.VMEM_LIMIT_BYTES): past
# it the resident kernels hand the call to the stock lowering
VMEM_LIMIT_BYTES = 4 * 1024 * 1024
MAX_RANKS = 64               # csrc/ring.cu kMaxRanks
# threads per block of the direct kernels (K3-K7, K10, K11): 128, 256
# and 512 time alike for K6/K7 on an H100 at 64 KiB and at 4 MiB a
# shard (PERF.md)
DIRECT_THREADS = 256

LAUNCHES: Dict[str, int] = {"ring_all_reduce": 0, "ring_all_gather": 0}
PLAIN_CALLS: Dict[str, int] = {"ring_all_reduce": 0, "ring_all_gather": 0}

# dtype -> code of the C entry points (csrc/ring.cu enum DType, shared
# with csrc/hbm_slot.cu)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
               torch.int32: 3, torch.int16: 4, torch.int8: 5,
               torch.uint8: 6, torch.uint16: 7, torch.uint32: 8}
# dtypes torch on the CPU cannot add, multiply, compare or index-assign:
# the plain versions work on them in int64 and wrap back (``widened``)
WIDE = (torch.uint16, torch.uint32)
OP_CODES = {"sum": 0, "max": 1, "min": 2, "prod": 3}

Shards = Union[torch.Tensor, Sequence[torch.Tensor]]


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def as_shards(xs: Shards, what: str) -> List[torch.Tensor]:
    """The ``p`` per-rank shards as flat tensors of one length, dtype
    and device."""
    if isinstance(xs, torch.Tensor):
        if xs.dim() != 2:
            raise ValueError(f"{what}: expected a (p, n) tensor or a list "
                             f"of p shards, got shape {tuple(xs.shape)}")
        shards = list(xs.unbind(0))
    else:
        shards = [x.reshape(-1) for x in xs]
    if not shards:
        raise ValueError(f"{what}: no shards")
    n, dt, dev = shards[0].numel(), shards[0].dtype, shards[0].device
    for s in shards:
        if s.numel() != n or s.dtype != dt or s.device != dev:
            raise ValueError(f"{what}: shards differ in length, dtype or "
                             f"device")
    return shards


def on_cpu(shards: List[torch.Tensor]) -> bool:
    return shards[0].device.type == "cpu"


def widened(shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """uint16/uint32 shards as int64, other shards as they are: the plain
    replays index-assign and fold in int64 and wrap back with
    ``.to(dtype)`` at the end (sums and products modulo 2^k, max and
    min unchanged)."""
    if shards[0].dtype in WIDE:
        return [s.to(torch.int64) for s in shards]
    return shards


def _pick(first_wins, zero_wins):
    """max or min as the kernels' ``red(own, acc)`` takes it (csrc/ring.cu
    ``apply``): ``own`` where ``first_wins(own, acc)``; a tie of -0.0 and
    +0.0 gives the zero whose sign bit is ``zero_wins``, whatever the
    order, as XLA's jnp.maximum/minimum give it (IEEE 754-2019 maximum
    and minimum); ``own + acc`` where either is a NaN. torch.maximum on
    the CPU settles ties of zeros by where an element falls in its vector
    loop, so it cannot be the spec."""
    def red(own, acc):
        wins = first_wins(own, acc)
        if own.dtype.is_floating_point:
            wins |= (own == acc) & (own.signbit() == zero_wins)
        out = torch.where(wins, own, acc)
        if own.dtype.is_floating_point:
            out = torch.where(own.isnan() | acc.isnan(), own + acc, out)
        return out
    return red


def reducer(op: str):
    """The elementwise ``red(own, acc)`` of an op, in the kernels'
    arithmetic (csrc/ring.cu ``apply``)."""
    return {"sum": torch.add, "max": _pick(torch.gt, False),
            "min": _pick(torch.lt, True), "prod": torch.mul}[op]


def ring_replay(o: torch.Tensor, spans: List[Tuple[int, int]],
                reduce_scatter: bool, all_gather: bool, red=None) -> None:
    """Replay the ring schedule on ``o`` of shape ``(p, p, nblk)`` (rank,
    block, element) in place, step by step: the plain versions' engine.
    Direction ``d`` carries elements ``spans[d]`` of every block (d=0
    clockwise: rank r receives from r-1; d=1 counter-clockwise). In
    reduce-scatter step s rank r folds the block arriving from upstream
    into its block r-s-2 (r+s+2 for d=1) as ``red(own, incoming)``; in
    all-gather step s it stores the arriving block r-s-1 (r+s+1)."""
    p = o.shape[0]
    ranks = torch.arange(p, device=o.device)
    phases = ([(True, 2)] if reduce_scatter else []) + \
        ([(False, 1)] if all_gather else [])
    for fold, lag in phases:
        for s in range(p - 1):
            for d, (lo, hi) in enumerate(spans):
                if hi <= lo:
                    continue
                if d == 0:
                    rb, up = (ranks - s - lag) % p, (ranks - 1) % p
                else:
                    rb, up = (ranks + s + lag) % p, (ranks + 1) % p
                inc = o[up, rb, lo:hi]
                o[ranks, rb, lo:hi] = red(o[ranks, rb, lo:hi], inc) \
                    if fold else inc


def check_cuda_shards(shards: List[torch.Tensor], what: str) -> int:
    """Check CUDA shards for a ring kernel; return the dtype code."""
    dev = shards[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}; the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain path)")
    code = DTYPE_CODES.get(shards[0].dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {shards[0].dtype} is not supported "
                        f"by the kernel (supported: "
                        f"{sorted(map(str, DTYPE_CODES))})")
    if len(shards) > MAX_RANKS:
        raise ValueError(f"{what}: {len(shards)} ranks; the kernel takes at "
                         f"most {MAX_RANKS}")
    for s in shards:
        if not s.is_contiguous():
            raise ValueError(f"{what}: shards must be contiguous")
    return code


def pointers(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def row_pointers(out: torch.Tensor):
    """The addresses of the rows of a contiguous 2-D ``out``."""
    row = out.shape[1] * out.element_size()
    return (ctypes.c_void_p * out.shape[0])(
        *[out.data_ptr() + r * row for r in range(out.shape[0])])


def aligned(ts: Sequence[torch.Tensor]) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def launch(fn: str, device: torch.device, *args,
           threads: int = DIRECT_THREADS,
           stream: Optional[int] = None) -> None:
    """Call C entry ``fn`` of ``csrc/ring.cu`` with ``args`` plus the
    thread count (``DIRECT_THREADS`` unless given) and a stream; raise on
    a launch error or on a spin timeout left by an earlier launch (K8's).
    Without ``stream`` the entry runs on ``device``'s current stream with
    ``device`` made current. A caller that passes ``stream`` (a raw
    ``cudaStream_t`` handle) has made ``device`` current itself, so
    neither lookup runs (``DeviceWin`` does both once for a whole
    completion wave)."""
    from . import _build
    lib = _build.load("ring")
    _raise_pending(lib)
    if stream is not None:
        rc = getattr(lib, fn)(*args, threads, stream)
    else:
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(*args, threads, stream)
    _build.check(lib, rc, fn)


def _raise_pending(lib) -> None:
    code = lib.mv2t_ring_error(1)
    if code:
        raise RuntimeError(
            f"ring kernel: K8's wait on a bulk copy outlasted the spin "
            f"bound (error word {code}); that launch ended early and its "
            f"output is invalid")


def check_errors(device: Optional[torch.device] = None) -> None:
    """Raise if K8's spin wait timed out since the last check.
    Waits first for the work queued so far: on ``device``'s current
    stream, or on the whole card when no device is given. Nothing to
    check before the ring kernels are loaded."""
    from . import _build
    if _build._loaded.get("ring") is None:
        return
    if device is None:
        torch.cuda.synchronize()
    elif device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    raise_pending()


def raise_pending() -> None:
    """Raise if K8's spin wait timed out since the last check, without
    waiting for the card (the caller has seen the work it checks end)."""
    from . import _build
    lib = _build._loaded.get("ring")
    if lib is not None:
        _raise_pending(lib)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ring_all_reduce_ref(xs: Shards) -> torch.Tensor:
    """Plain version of K6: the sum ring replayed (one direction, no
    padding); returns ``(p, n)``."""
    shards = as_shards(xs, "ring_all_reduce")
    p, n, dt = len(shards), shards[0].numel(), shards[0].dtype
    o = torch.stack(widened(shards)).reshape(p, p, n // p)
    ring_replay(o, [(0, n // p)], True, True, reducer("sum"))
    return o.reshape(p, n).to(dt)


def ring_all_gather_ref(xs: Shards) -> torch.Tensor:
    """Plain version of K7: the gather ring replayed; returns
    ``(p, p*m)``."""
    shards = as_shards(xs, "ring_all_gather")
    p, m, dt = len(shards), shards[0].numel(), shards[0].dtype
    shards = widened(shards)
    o = torch.zeros((p, p, m), dtype=shards[0].dtype,
                    device=shards[0].device)
    for r in range(p):
        o[r, r] = shards[r]
    ring_replay(o, [(0, m)], False, True)
    return o.reshape(p, p * m).to(dt)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def launch_direct(fn: str, code: int, shards: List[torch.Tensor],
                  out: torch.Tensor, length: int,
                  lines: Optional[int] = None) -> None:
    """Launch the direct kernel ``fn`` (K6, K7, or K5 with ``lines``)
    over ``shards`` into the rows of ``out``; ``length`` is the C entry's
    ``len`` (K6: the block, K7 and K5: the shard). It runs on 16-byte
    words when every shard and output row is 16-byte aligned and
    ``length`` is a whole number of words (so no word straddles two
    blocks or shards), else element by element."""
    rows, row = out.shape[0], out.shape[1] * out.element_size()
    vec = aligned(shards) and out.data_ptr() % 16 == 0 and row % 16 == 0 \
        and length % (16 // out.element_size()) == 0
    geometry = (rows,) if lines is None else (rows // lines, lines)
    launch(f"mv2t_{fn}", out.device, code, pointers(shards),
           row_pointers(out), *geometry, length, int(vec),
           threads=DIRECT_THREADS)


def ring_all_reduce(xs: Shards) -> torch.Tensor:
    """K6: sum-allreduce of ``p`` shards of ``n`` elements, folded in the
    resident ring's order; ``n % p == 0`` and at most 4 MiB a shard (the
    JAX wrapper's own conditions; ``ops/ici.py`` checks them before it
    calls). Returns ``(p, n)``, row r for rank r."""
    shards = as_shards(xs, "ring_all_reduce")
    p, n = len(shards), shards[0].numel()
    if n % p or n * shards[0].element_size() > VMEM_LIMIT_BYTES:
        raise ValueError(f"ring_all_reduce: shard of {n} elements needs "
                         f"n % p == 0 (p={p}) and at most "
                         f"{VMEM_LIMIT_BYTES} bytes")
    if on_cpu(shards):
        PLAIN_CALLS["ring_all_reduce"] += 1
        return ring_all_reduce_ref(shards)
    code = check_cuda_shards(shards, "ring_all_reduce")
    out = torch.empty((p, n), dtype=shards[0].dtype, device=shards[0].device)
    launch_direct("ring_all_reduce", code, shards, out, n // p)
    LAUNCHES["ring_all_reduce"] += 1
    return out


def ring_all_gather(xs: Shards) -> torch.Tensor:
    """K7: all-gather of ``p`` shards of ``m`` elements, the resident
    ring's result; ``p*m`` at most 4 MiB. Returns ``(p, p*m)``, row r
    for rank r."""
    shards = as_shards(xs, "ring_all_gather")
    p, m = len(shards), shards[0].numel()
    if p * m * shards[0].element_size() > VMEM_LIMIT_BYTES:
        raise ValueError(f"ring_all_gather: output of {p * m} elements is "
                         f"past {VMEM_LIMIT_BYTES} bytes")
    if on_cpu(shards):
        PLAIN_CALLS["ring_all_gather"] += 1
        return ring_all_gather_ref(shards)
    code = check_cuda_shards(shards, "ring_all_gather")
    out = torch.empty((p, p * m), dtype=shards[0].dtype,
                      device=shards[0].device)
    launch_direct("ring_all_gather", code, shards, out, m)
    LAUNCHES["ring_all_gather"] += 1
    return out
