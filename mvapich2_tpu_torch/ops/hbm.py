"""HBM slot-segment collectives on one GPU (counterpart of
``mvapich2_tpu/ops/pallas_hbm.py``).

When several ranks' buffers share one card's memory, every rank deposits
into its slot, one fused pass produces the result, and ranks read the
result back. Two kernels, written in CUDA C++ in ``csrc/hbm_slot.cu``:

``fused_reduce_to_slot`` (K1) reads all ``R`` slots and writes their sum
once: ``R*m`` read + ``m`` written. The broadcast is zero-copy: every
rank is handed the same result tensor. It reads the slots in one of two
addressings: a stacked tensor (``fused_reduce_to_slot``'s planar
``(R, M, 128)`` or interleaved ``(M, R, 128)``, or an ``(R, n)`` given
to ``hbm_slot_allreduce``), or ``R`` separate tensors of ``n`` elements
given to ``hbm_slot_allreduce`` as a sequence, read in place by
address: the channels hand it the ranks' deposits so, with no staging
copy.

``fused_allreduce`` (K2) writes the sum into every rank row of
interleaved slots: ``2*R*m``.

Routing: a wrapper given CPU tensors computes its plain PyTorch version
(the same arithmetic: the ranks summed in rank order); given CUDA
tensors it launches the kernel on the current stream or raises.
``LAUNCHES`` counts kernel launches only, ``PLAIN_CALLS`` the plain
route, ``PATHS`` K1's launches by addressing and instance (16-byte
words, or elements when a source or row is not 16-byte aligned).

Kernel dtypes: float32, float16, bfloat16, int32, int16, int8, uint8,
uint16 and uint32 (the JAX channel's device dtypes of at most 4 bytes).
16-bit floats accumulate in float32; integers accumulate in int32
(uint32 in uint32) and wrap to the slot dtype on store. ``mean`` rounds
the sum to the slot dtype and multiplies it by ``mean_scale``, as the
JAX kernel's ``s * scale`` does. Any other dtype raises ``TypeError``.
The plain versions sum uint16 and uint32 in int64 and wrap back, since
torch on the CPU cannot add them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..coll.tuning import kernel_param

L = 128                      # lanes per slot row
MAX_SLOTS = 64               # csrc/hbm_slot.cu kMaxSlots: sources by address

LAUNCHES: Dict[str, int] = {"fused_reduce_to_slot": 0, "fused_allreduce": 0}
PLAIN_CALLS: Dict[str, int] = {"fused_reduce_to_slot": 0,
                               "fused_allreduce": 0}
PATHS: Dict[str, int] = {"strided_words": 0, "strided_elements": 0,
                         "ptrs_words": 0, "ptrs_elements": 0}

# dtype -> code of the C entry points (csrc/hbm_slot.cu enum DType)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                torch.int32: 3, torch.int16: 4, torch.int8: 5,
                torch.uint8: 6, torch.uint16: 7, torch.uint32: 8}

Slots = Union[torch.Tensor, Sequence[torch.Tensor]]


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, PATHS):
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


def mean_scale(dtype: torch.dtype, R: int) -> float:
    """The factor ``mean`` applies: float32(1/R), rounded to the slot
    dtype for float16 and bfloat16 (the JAX kernel's ``s * scale``
    takes the Python scalar in the array's dtype). With ``R == 1`` the
    JAX kernel skips the product (``scale != 1.0``), and so do the
    kernels here and their plain versions: an int32 sum does not pass
    through float."""
    s = torch.tensor(1.0 / R, dtype=torch.float32)
    if dtype in (torch.float16, torch.bfloat16):
        s = s.to(dtype).to(torch.float32)
    return s.item()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _fold_ranks(xs: Sequence[torch.Tensor], mean: bool) -> torch.Tensor:
    """Sum ``R`` same-shaped rank tensors in rank order 0..R-1 with the
    kernels' accumulation types, then (``mean``) scale, in the slot
    dtype."""
    R, dt, x0 = len(xs), xs[0].dtype, xs[0]
    mean = mean and R > 1
    if x0.is_floating_point():
        acc = torch.zeros(x0.shape, dtype=torch.float32, device=x0.device)
        for x in xs:
            acc.add_(x)
        s = acc.to(dt)
        if mean:
            s = (s.to(torch.float32) * mean_scale(dt, R)).to(dt)
        return s
    wide = dt in (torch.uint16, torch.uint32)
    acc = torch.zeros(x0.shape, dtype=torch.int64 if wide else torch.int32,
                      device=x0.device)
    for x in xs:
        acc.add_(x.to(torch.int64) if wide else x)
    if dt == torch.uint32:
        acc &= 0xFFFFFFFF               # the kernel's uint32 accumulator
    if mean:
        acc = (acc.to(torch.float32) * mean_scale(dt, R)).to(acc.dtype)
    return acc.to(dt)


def fused_reduce_to_slot_ref(x: torch.Tensor, *, layout: str = "planar",
                             mean: bool = False) -> torch.Tensor:
    """Plain version of K1: the rank-axis sum in rank order, times
    ``mean_scale`` for ``mean``, in the slot dtype."""
    return _fold_ranks(x.unbind(_rank_axis(layout)), mean)


def fused_allreduce_ref(x: torch.Tensor, *,
                        mean: bool = False) -> torch.Tensor:
    """Plain version of K2: the rank sum broadcast back to every row."""
    return _fold_ranks(x.unbind(1), mean).unsqueeze(1).expand_as(
        x).contiguous()


def hbm_slot_allreduce_ref(bufs: Slots, *,
                           mean: bool = False) -> torch.Tensor:
    """Plain version of :func:`hbm_slot_allreduce`: ``(n,)``."""
    return _fold_ranks(_sources(bufs, "hbm_slot_allreduce_ref"), mean)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _code(x: torch.Tensor, what: str) -> int:
    """Check a CUDA slot tensor's device and dtype; its dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}; the kernel takes "
                         f"CUDA tensors (CPU tensors take the plain path)")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {x.dtype} is not supported by the "
                        f"kernel (supported: {sorted(map(str, _DTYPE_CODES))})")
    return code


def _mean_args(dtype: torch.dtype, R: int, mean: bool) -> Tuple[int, float]:
    """The C entries' (mean, scale)."""
    return (1, mean_scale(dtype, R)) if mean and R > 1 else (0, 1.0)


def _launch(fn: str, device: torch.device, *args) -> None:
    from . import _build
    lib = _build.load("hbm_slot")
    block = kernel_param("hbm_slot_threads", 256)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = sms * kernel_param("hbm_slot_blocks_per_sm", 8)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args, grid, block, stream)
    _build.check(lib, rc, fn)


def _strided(x: torch.Tensor, R: int, n: int, rank_stride: int,
             row_stride: int, mean: bool, what: str) -> torch.Tensor:
    """K1 over a stacked tensor (the strided addressing) into a fresh
    ``(n,)``; on 16-byte words when ``x`` and every rank's start are
    16-byte aligned (an ``L``-lane row is a whole number of words)."""
    code = _code(x, what)
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    words = x.data_ptr() % 16 == 0 and \
        rank_stride * x.element_size() % 16 == 0
    _launch("mv2t_slot_reduce", x.device, code, x.data_ptr(),
            out.data_ptr(), R, n, rank_stride, row_stride, int(words),
            *_mean_args(x.dtype, R, mean))
    PATHS["strided_words" if words else "strided_elements"] += 1
    LAUNCHES["fused_reduce_to_slot"] += 1
    return out


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def fused_reduce_to_slot(x: torch.Tensor, *, layout: str = "planar",
                         block_m: Optional[int] = None,
                         mean: bool = False) -> torch.Tensor:
    """K1: reduce ``R`` co-resident rank slots into one ``(M, 128)``
    result in a single pass (read ``R*m``, write ``m``).

    ``x`` is ``(R, M, 128)`` planar or ``(M, R, 128)`` interleaved, and
    contiguous. ``block_m`` is accepted for parity with the JAX API and
    ignored.
    """
    axis = _rank_axis(layout)
    _check_slots(x, "fused_reduce_to_slot")
    if x.device.type == "cpu":
        PLAIN_CALLS["fused_reduce_to_slot"] += 1
        return fused_reduce_to_slot_ref(x, layout=layout, mean=mean)
    if not x.is_contiguous():
        raise ValueError("fused_reduce_to_slot: slot tensor must be "
                         "contiguous")
    R = x.shape[axis]
    M = x.shape[1 - axis]
    rank_stride, row_stride = (M * L, L) if axis == 0 else (L, R * L)
    return _strided(x, R, M * L, rank_stride, row_stride, mean,
                    "fused_reduce_to_slot").reshape(M, L)


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
    code = _code(x, "fused_allreduce")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_allreduce: slot tensor must be contiguous "
                         "and 16-byte aligned")
    out = x if donate else torch.empty_like(x)
    nvec = M * L * x.element_size() // 16
    _launch("mv2t_fused_allreduce", x.device, code, x.data_ptr(),
            out.data_ptr(), R, nvec, *_mean_args(x.dtype, R, mean))
    LAUNCHES["fused_allreduce"] += 1
    return out


# ---------------------------------------------------------------------------
# R rank buffers of n elements
# ---------------------------------------------------------------------------

def _sources(bufs: Slots, what: str) -> List[torch.Tensor]:
    """The ``R`` rank buffers as flat tensors of one length, dtype and
    device: the rows of an ``(R, n)`` tensor, or the tensors of a
    sequence, each flattened (a view where it can be)."""
    if isinstance(bufs, torch.Tensor):
        if bufs.dim() != 2:
            raise ValueError(f"{what}: expected an (R, n) tensor or a "
                             f"sequence of R tensors, got shape "
                             f"{tuple(bufs.shape)}")
        xs = list(bufs.unbind(0))
    else:
        xs = list(bufs)
        if not all(isinstance(x, torch.Tensor) for x in xs):
            raise TypeError(f"{what}: expected a sequence of tensors")
        xs = [x.reshape(-1) for x in xs]
    if not xs:
        raise ValueError(f"{what}: no rank buffers")
    n, dt, dev = xs[0].numel(), xs[0].dtype, xs[0].device
    for x in xs:
        if x.numel() != n or x.dtype != dt or x.device != dev:
            raise ValueError(f"{what}: rank buffers differ in length, dtype "
                             f"or device")
    return xs


def hbm_slot_allreduce(bufs: Slots, *, mean: bool = False,
                       block_m: Optional[int] = None) -> torch.Tensor:
    """Allreduce ``R`` co-resident rank buffers of ``n`` elements, any
    ``n``, through K1; returns the single shared ``(n,)`` result (hand
    every rank this same tensor; it must not be written in place).

    ``bufs`` is an ``(R, n)`` tensor with contiguous rows (the strided
    addressing, any ``R``), or a sequence of ``R`` tensors of ``n``
    elements each, at most ``MAX_SLOTS``: K1 reads each where it lies, by
    address, with no staging copy (on CUDA each must be contiguous). A
    source or row that is not 16-byte aligned sends the launch to the
    element instance (``PATHS``). ``block_m`` is accepted for parity
    with the JAX API and ignored."""
    what = "hbm_slot_allreduce"
    xs = _sources(bufs, what)
    R, n = len(xs), xs[0].numel()
    if xs[0].device.type == "cpu":
        PLAIN_CALLS["fused_reduce_to_slot"] += 1
        return _fold_ranks(xs, mean)
    if isinstance(bufs, torch.Tensor):
        if n > 1 and bufs.stride(1) != 1:
            raise ValueError(f"{what}: the rows must be contiguous")
        return _strided(bufs, R, n, bufs.stride(0), L, mean, what)
    code = _code(xs[0], what)
    if R > MAX_SLOTS:
        raise ValueError(f"{what}: {R} sources; the kernel reads at most "
                         f"{MAX_SLOTS} by address (stack them into an "
                         f"(R, n) tensor)")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{what}: the sources must be contiguous")
    out = torch.empty(n, dtype=xs[0].dtype, device=xs[0].device)
    words = all(x.data_ptr() % 16 == 0 for x in xs)
    ptrs = (ctypes.c_void_p * R)(*[x.data_ptr() for x in xs])
    _launch("mv2t_slot_reduce_ptrs", out.device, code, ptrs, out.data_ptr(),
            R, n, int(words), *_mean_args(out.dtype, R, mean))
    PATHS["ptrs_words" if words else "ptrs_elements"] += 1
    LAUNCHES["fused_reduce_to_slot"] += 1
    return out


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
