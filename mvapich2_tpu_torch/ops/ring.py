"""Resident ring collectives over ``p`` virtual ranks of one GPU
(counterpart of ``mvapich2_tpu/ops/pallas_ring.py``), and the ring
machinery shared with the streaming kernels of ``ops/ici.py``.

Two kernels, written in CUDA C++ in ``csrc/ring.cu``:

``ring_all_reduce`` (K6) sums ``p`` shards of ``n`` elements
(``n % p == 0``, at most 4 MiB): a reduce-scatter ring then an
all-gather ring, ``2(p-1)`` rounds over 2 landing slots per rank, with
the credit handshake of the JAX kernel (each round a rank grants one
credit to each neighbour and takes one from each).

``ring_all_gather`` (K7) gathers ``p`` shards of ``m`` elements
(``p*m`` at most 4 MiB) in ``p-1`` rounds over the same two slots.

Inputs: a list of ``p`` one-dimensional tensors (one per rank, each its
own allocation, read in place) or one ``(p, n)`` tensor. Output: one
``(p, ...)`` tensor whose row ``r`` is rank ``r``'s result.

Routing: a wrapper given CPU tensors computes its plain PyTorch version
(``*_ref``), which replays the kernel's ring schedule step by step so its
fold order is the kernel's; given CUDA tensors it launches the kernel
on the current stream or raises. ``LAUNCHES`` counts kernel launches
only, ``PLAIN_CALLS`` the plain route.

A launch covers all ``p`` ranks: every (rank, direction) lane gets ``B``
thread blocks, each running its own sub-ring over its share of the
data, with credits in global memory. All blocks must be resident at
once (a block spinning on a credit would wait forever behind a peer
that never gets an SM), so the kernels launch cooperatively. A spin
that outlasts 2 s sets an error word and ends the launch;
:func:`check_errors` (and the next launch) raises on it, and the mesh
channel checks it after every collective, so that collective raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..coll.tuning import kernel_param

# the JAX kernels' VMEM budget guard (pallas_ring.VMEM_LIMIT_BYTES): past
# it the resident kernels hand the call to the stock lowering
VMEM_LIMIT_BYTES = 4 * 1024 * 1024
MAX_RANKS = 64               # csrc/ring.cu kMaxRanks

LAUNCHES: Dict[str, int] = {"ring_all_reduce": 0, "ring_all_gather": 0}
PLAIN_CALLS: Dict[str, int] = {"ring_all_reduce": 0, "ring_all_gather": 0}

# dtype -> code of the C entry points (csrc/ring.cu enum DType, shared
# with csrc/hbm_slot.cu)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
               torch.int32: 3, torch.int16: 4, torch.int8: 5,
               torch.uint8: 6}
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


def reducer(op: str):
    return {"sum": torch.add, "max": torch.maximum, "min": torch.minimum,
            "prod": torch.mul}[op]


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


def aligned(ts: Sequence[torch.Tensor]) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def ctas_per_lane(device: torch.device, lanes: int, elems: int,
                  vec_width: int) -> int:
    """Blocks per (rank, direction) lane: ``ring_blocks_per_sm`` blocks
    per SM over all the lanes, and no more than there are 16-byte units
    in a lane's share of a chunk. The C entry lowers it further if fewer
    blocks fit on the card at once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = kernel_param("ring_blocks_per_sm", 1)
    units = max(1, -(-elems // vec_width))
    return max(1, min(sms * per_sm // lanes, units))


def launch(fn: str, device: torch.device, *args) -> None:
    """Call C entry ``fn`` of ``csrc/ring.cu`` with ``args`` plus the
    thread count and the current stream; raise on a launch error or on
    a spin timeout left by an earlier launch."""
    from . import _build
    lib = _build.load("ring")
    _raise_pending(lib)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args, kernel_param("ring_threads", 1024),
                              stream)
    _build.check(lib, rc, fn)


def _raise_pending(lib) -> None:
    code = lib.mv2t_ring_error(1)
    if code:
        raise RuntimeError(
            f"ring kernel: a credit or data wait outlasted the spin bound "
            f"(error word {code}); that launch ended early and its output "
            f"is invalid")


def check_errors(device: Optional[torch.device] = None) -> None:
    """Raise if a ring kernel's spin wait timed out since the last check.
    Waits first for the work queued so far: on ``device``'s current
    stream, or on the whole card when no device is given. Nothing to
    check before the ring kernels are loaded."""
    from . import _build
    lib = _build._loaded.get("ring")
    if lib is None:
        return
    if device is None:
        torch.cuda.synchronize()
    elif device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    _raise_pending(lib)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ring_all_reduce_ref(xs: Shards) -> torch.Tensor:
    """Plain version of K6: the sum ring replayed (one direction, no
    padding); returns ``(p, n)``."""
    shards = as_shards(xs, "ring_all_reduce")
    p, n = len(shards), shards[0].numel()
    o = torch.stack(shards).reshape(p, p, n // p)
    ring_replay(o, [(0, n // p)], True, True, torch.add)
    return o.reshape(p, n)


def ring_all_gather_ref(xs: Shards) -> torch.Tensor:
    """Plain version of K7: the gather ring replayed; returns
    ``(p, p*m)``."""
    shards = as_shards(xs, "ring_all_gather")
    p, m = len(shards), shards[0].numel()
    o = torch.zeros((p, p, m), dtype=shards[0].dtype,
                    device=shards[0].device)
    for r in range(p):
        o[r, r] = shards[r]
    ring_replay(o, [(0, m)], False, True)
    return o.reshape(p, p * m)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def ring_all_reduce(xs: Shards) -> torch.Tensor:
    """K6: sum-allreduce of ``p`` shards of ``n`` elements over the
    resident ring; ``n % p == 0`` and at most 4 MiB a shard (the JAX
    wrapper's own conditions; ``ops/ici.py`` checks them before it
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
    dev = shards[0].device
    blk = n // p
    out = torch.empty((p, n), dtype=shards[0].dtype, device=dev)
    v = 16 // out.element_size()
    vec = aligned(shards) and blk % v == 0
    ctas = ctas_per_lane(dev, p, blk, v)
    slots = torch.empty((p, 2, blk), dtype=out.dtype, device=dev)
    flags = torch.zeros(3 * p * ctas, dtype=torch.int32, device=dev)
    launch("mv2t_ring_all_reduce", dev, code, pointers(shards),
           pointers(out.unbind(0)), p, blk, slots.data_ptr(),
           flags.data_ptr(), ctas, int(vec))
    LAUNCHES["ring_all_reduce"] += 1
    return out


def ring_all_gather(xs: Shards) -> torch.Tensor:
    """K7: all-gather of ``p`` shards of ``m`` elements over the resident
    ring; ``p*m`` at most 4 MiB. Returns ``(p, p*m)``, row r for rank
    r."""
    shards = as_shards(xs, "ring_all_gather")
    p, m = len(shards), shards[0].numel()
    if p * m * shards[0].element_size() > VMEM_LIMIT_BYTES:
        raise ValueError(f"ring_all_gather: output of {p * m} elements is "
                         f"past {VMEM_LIMIT_BYTES} bytes")
    if on_cpu(shards):
        PLAIN_CALLS["ring_all_gather"] += 1
        return ring_all_gather_ref(shards)
    code = check_cuda_shards(shards, "ring_all_gather")
    dev = shards[0].device
    out = torch.empty((p, p * m), dtype=shards[0].dtype, device=dev)
    v = 16 // out.element_size()
    vec = aligned(shards) and m % v == 0
    ctas = ctas_per_lane(dev, p, m, v)
    slots = torch.empty((p, 2, m), dtype=out.dtype, device=dev)
    flags = torch.zeros(3 * p * ctas, dtype=torch.int32, device=dev)
    launch("mv2t_ring_all_gather", dev, code, pointers(shards),
           pointers(out.unbind(0)), p, m, slots.data_ptr(),
           flags.data_ptr(), ctas, int(vec))
    LAUNCHES["ring_all_gather"] += 1
    return out
