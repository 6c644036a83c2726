"""HBM slot-segment collectives on one GPU (counterpart of
``mvapich2_tpu/ops/pallas_hbm.py``).

When several ranks' buffers share one card's memory, every rank deposits
into its slot, one fused pass produces the result, and ranks read the
result back. Two kernels, written in CUDA C++ in ``csrc/hbm_slot.cu``:

``fused_reduce_to_slot`` (K1) reads all ``R`` slots and writes their sum
once: ``R*m`` read + ``m`` written. The broadcast is zero-copy: every
rank is handed the same result tensor.

``fused_allreduce`` (K2) writes the sum into every rank row of
interleaved slots: ``2*R*m``.

Layouts: *planar* ``(R, M, 128)`` (slot r contiguous) or *interleaved*
``(M, R, 128)`` (each ``(R, 128)`` tile holds one 128-lane slice of every
rank).

Routing: a wrapper given a CPU tensor computes its plain PyTorch version
(``*_ref``, the same arithmetic); given a CUDA tensor it launches the
kernel on the current stream or raises. ``LAUNCHES`` counts kernel
launches only, ``PLAIN_CALLS`` the plain route.

Kernel dtypes: float32, float16, bfloat16, int32, int16, int8, uint8,
uint16 and uint32 (the JAX channel's device dtypes of at most 4 bytes).
16-bit floats accumulate in float32; integers accumulate in int32
(uint32 in uint32) and wrap to the slot dtype on store. Any other dtype
raises ``TypeError``. The plain versions sum uint16 and uint32 in int64
and wrap back, since torch on the CPU cannot add them.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..coll.tuning import kernel_param

L = 128                      # lanes per slot row

LAUNCHES: Dict[str, int] = {"fused_reduce_to_slot": 0, "fused_allreduce": 0}
PLAIN_CALLS: Dict[str, int] = {"fused_reduce_to_slot": 0,
                               "fused_allreduce": 0}

# dtype -> code of the C entry points (csrc/hbm_slot.cu enum DType)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                torch.int32: 3, torch.int16: 4, torch.int8: 5,
                torch.uint8: 6, torch.uint16: 7, torch.uint32: 8}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _rank_axis(layout: str) -> int:
    if layout == "planar":
        return 0
    if layout == "interleaved":
        return 1
    raise ValueError(f"bad layout {layout!r}")


def _check_slots(x: torch.Tensor, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got "
                        f"{type(x).__name__}")
    if x.dim() != 3 or x.shape[2] != L:
        raise ValueError(f"{what}: expected a 3-D slot tensor with "
                         f"{L} lanes, got shape {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _sum_ranks(x: torch.Tensor, axis: int, mean: bool,
               keepdim: bool = False) -> torch.Tensor:
    """Sum over the rank axis with the kernels' accumulation types, then
    scale and cast back to the slot dtype."""
    R = x.shape[axis]
    if x.is_floating_point():
        acc = x if x.dtype == torch.float32 else x.to(torch.float32)
        s = acc.sum(axis, keepdim=keepdim)
        if mean:
            s = s * (1.0 / R)
        return s.to(x.dtype)
    if x.dtype in (torch.uint16, torch.uint32):
        s = x.to(torch.int64).sum(axis, keepdim=keepdim)
        if x.dtype == torch.uint32:
            s = s & 0xFFFFFFFF          # the kernel's uint32 accumulator
        if mean:
            s = (s.to(torch.float32) * (1.0 / R)).to(torch.int64)
        return s.to(x.dtype)
    s = x.to(torch.int32).sum(axis, keepdim=keepdim, dtype=torch.int32)
    if mean:
        s = (s.to(torch.float32) * (1.0 / R)).to(torch.int32)
    return s.to(x.dtype)


def fused_reduce_to_slot_ref(x: torch.Tensor, *, layout: str = "planar",
                             mean: bool = False) -> torch.Tensor:
    """Plain version of K1: ``x.sum(rank axis)``, times ``1/R`` for
    ``mean``, in the slot dtype."""
    return _sum_ranks(x, _rank_axis(layout), mean)


def fused_allreduce_ref(x: torch.Tensor, *,
                        mean: bool = False) -> torch.Tensor:
    """Plain version of K2: the rank sum broadcast back to every row."""
    return _sum_ranks(x, 1, mean, keepdim=True).expand_as(x).contiguous()


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _kernel_args(x: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """Check a CUDA slot tensor; return (dtype code, grid, block)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}; the kernel takes "
                         f"CUDA tensors (CPU tensors take the plain path)")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {x.dtype} is not supported by the "
                        f"kernel (supported: {sorted(map(str, _DTYPE_CODES))})")
    if not x.is_contiguous():
        raise ValueError(f"{what}: slot tensor must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: slot tensor must be 16-byte aligned")
    block = kernel_param("hbm_slot_threads", 256)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return code, sms * kernel_param("hbm_slot_blocks_per_sm", 8), block


def _launch(fn: str, kargs: Tuple[int, int, int], x: torch.Tensor,
            out: torch.Tensor, *args) -> None:
    from . import _build
    lib = _build.load("hbm_slot")
    code, grid, block = kargs
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(code, x.data_ptr(), out.data_ptr(), *args,
                              grid, block, stream)
    _build.check(lib, rc, fn)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def fused_reduce_to_slot(x: torch.Tensor, *, layout: str = "planar",
                         block_m: Optional[int] = None,
                         mean: bool = False) -> torch.Tensor:
    """K1: reduce ``R`` co-resident rank slots into one ``(M, 128)``
    result in a single pass (read ``R*m``, write ``m``).

    ``x`` is ``(R, M, 128)`` planar or ``(M, R, 128)`` interleaved.
    ``block_m`` is accepted for parity with the JAX API and ignored.
    """
    axis = _rank_axis(layout)
    _check_slots(x, "fused_reduce_to_slot")
    if x.device.type == "cpu":
        PLAIN_CALLS["fused_reduce_to_slot"] += 1
        return fused_reduce_to_slot_ref(x, layout=layout, mean=mean)
    R = x.shape[axis]
    M = x.shape[1 - axis]
    kargs = _kernel_args(x, "fused_reduce_to_slot")
    out = torch.empty((M, L), dtype=x.dtype, device=x.device)
    if layout == "planar":
        rank_stride, row_stride = M * L, L
    else:
        rank_stride, row_stride = L, R * L
    nvec = M * L * x.element_size() // 16
    _launch("mv2t_slot_reduce", kargs, x, out, R, nvec, rank_stride,
            row_stride, int(mean), 1.0 / R)
    LAUNCHES["fused_reduce_to_slot"] += 1
    return out


def fused_allreduce(x: torch.Tensor, *, block_m: Optional[int] = None,
                    mean: bool = False, donate: bool = False) -> torch.Tensor:
    """K2: materialized allreduce over interleaved ``(M, R, 128)`` slots:
    the rank sum (or mean) written into every rank row (``2*R*m``).

    ``donate=True`` writes the result in place into ``x`` and returns
    ``x`` (the counterpart of the JAX kernel's input/output alias).
    ``block_m`` is accepted for parity with the JAX API and ignored.
    """
    _check_slots(x, "fused_allreduce")
    if x.device.type == "cpu":
        PLAIN_CALLS["fused_allreduce"] += 1
        out = fused_allreduce_ref(x, mean=mean)
        if donate:
            x.copy_(out)
            return x
        return out
    M, R, _ = x.shape
    kargs = _kernel_args(x, "fused_allreduce")
    out = x if donate else torch.empty_like(x)
    nvec = M * L * x.element_size() // 16
    _launch("mv2t_fused_allreduce", kargs, x, out, R, nvec, int(mean),
            1.0 / R)
    LAUNCHES["fused_allreduce"] += 1
    return out


# ---------------------------------------------------------------------------
# (R, n) rank-buffer convenience wrappers
# ---------------------------------------------------------------------------

def _pad_to_lanes(bufs: torch.Tensor) -> Tuple[torch.Tensor, int]:
    R, n = bufs.shape
    pad = (-n) % L
    if pad:
        bufs = torch.nn.functional.pad(bufs, (0, pad))
    return bufs, n


def hbm_slot_allreduce(bufs: torch.Tensor, *, mean: bool = False,
                       block_m: Optional[int] = None) -> torch.Tensor:
    """Allreduce ``(R, n)`` co-resident rank buffers through the slot
    segment; returns the single shared ``(n,)`` result (hand every rank
    this same tensor; it must not be written in place)."""
    bufs, n = _pad_to_lanes(bufs)
    R, npad = bufs.shape
    out = fused_reduce_to_slot(bufs.reshape(R, npad // L, L),
                               layout="planar", mean=mean, block_m=block_m)
    return out.reshape(npad)[:n]


def pack_interleaved(bufs: torch.Tensor) -> torch.Tensor:
    """``(R, n)`` per-rank buffers -> interleaved ``(M, R, 128)`` slots
    (n must be a multiple of 128)."""
    R, n = bufs.shape
    return bufs.reshape(R, n // L, L).permute(1, 0, 2).contiguous()


def unpack_interleaved(slots: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_interleaved` -> ``(R, n)``."""
    M, R, lanes = slots.shape
    return slots.permute(1, 0, 2).reshape(R, M * lanes)


# ---------------------------------------------------------------------------
# bench candidate set
# ---------------------------------------------------------------------------

def bench_candidates(M: int, R: int, lanes: int = L) -> List[
        Tuple[str, Callable, int, bool]]:
    """``(name, op, bytes_moved_per_op, chains)``: the slot-reduce (K1,
    ``(R+1)*m`` traffic) and the materialized broadcast (K2, ``2*R*m``)
    over interleaved ``(M, R, lanes)`` f32 slots. ``chains`` is True when
    the op is shape-preserving (its output can feed its next call)."""
    m = M * lanes * 4
    cands: List[Tuple[str, Callable, int, bool]] = []
    for bm in (512, 1024):
        if M % bm == 0:
            cands.append((
                f"hbm_slot_reduce_b{bm}",
                functools.partial(fused_reduce_to_slot, layout="interleaved",
                                  mean=True, block_m=bm),
                (R + 1) * m, False))
    for bm in (128, 512):
        if M % bm == 0:
            cands.append((
                f"hbm_fused_bcast_b{bm}",
                functools.partial(fused_allreduce, mean=True, block_m=bm),
                2 * R * m, True))
    return cands
