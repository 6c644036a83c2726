"""One-sided RMA kernels over the rows of a device window (counterpart of
``mvapich2_tpu/ops/pallas_rma.py``): the kernel half of the one-sided
lane, whose window and epoch surface is ``rma/device.py``.

A window is a ``(p, N)`` tensor on one device, row r rank r's exposed
memory. Four kernels, written in CUDA C++ in ``csrc/ring.cu``, move
data between the origin and the target of one op.

``rma_put`` (K12): ``win[target, disp:disp+n] = src``.
``rma_get`` (K13): returns ``win[target, disp:disp+n]`` (the origin's
``n`` elements; the JAX kernel's zero rows for the other ranks come from
its symmetric DMA and have no counterpart here).
``rma_accumulate`` (K14): ``win[target, disp:disp+n] += src`` (MPI_SUM;
floats fold in float and round once, integers wrap). With
``quantized=True`` (f32 only, K14q) each block of
``min(quant_block_elems(), n)`` elements (``n`` must be a multiple) is
encoded as K9's block-scaled wire (``ops/quant.py``), decoded and folded
into the window row with one rounding.

K12, K13, K14 and K14q are one direct pass each on this card: the
origin's threads read the source (and, for the fold, the window row) and
store into the destination, one plain launch, no landing slot and no
credit (:func:`copy_plan` models how K12/K13/K14 cut a range; K14q takes
one warp a quantization block and keeps the wire words in registers).
Their ``chunk_bytes`` and ``depth`` arguments (``RMA_CHUNK_BYTES``, 0
inheriting ``ICI_CHUNK_BYTES``; ``ICI_PIPELINE_DEPTH``), which the JAX
kernels take, are validated and otherwise unused.

``direct_put`` (K17, ``rma/device.py`` ``pallas_put``) is the
single-shot put. The TPU kernel stages the payload in one landing buffer
under a flag; on one card a put is K12's direct copy, with no landing
buffer and no flag, launched through K12's C entry and counted apart.
It lives here with the other three.

A source that partly overlaps the target range (a view of the window)
is copied first, so every route writes the values it held before the op,
as the JAX package, whose sources are immutable arrays, does.

Routing is ``ops/ring.py``'s: CPU tensors take the plain version
(``*_ref``), CUDA tensors launch the kernel on the current stream (or on
the ``stream`` handle a caller passes, ``ring.launch``) or raise;
``LAUNCHES`` and ``PLAIN_CALLS`` count each. Every kernel is bitwise
equal to its plain version. A range past the window's end raises
``ValueError``.

Tier selection is :func:`planned_rma_tier`: contiguous ops of a kernel
dtype at or above DEV_RMA_RDMA_MIN take the kernels ('rdma'), an f32
accumulate of whole quantization blocks at or above DEV_RMA_QUANT_MIN
whose MV2T_QUANT_COLL budget covers one quantization takes the quantized
wire ('quant'); the rest take ``rma/device.py``'s epoch tier, with the
reason named for the ``dev_rma_fallback_*`` pvars.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import mpit
from ..coll.tuning import kernel_param
from ..utils.config import get_config
from . import ring
from .ici import _cfg_chunk_elems as _ici_chunk_elems
from .ici import _cfg_depth, dtype_kind
from .quant import (WIRE_CODES, declared_bound, decode_add_ref,
                    encode_f32_ref, quant_block_elems,
                    wire_words)  # noqa: F401  (DeviceWin counts with it)

# ``rma_accumulate`` counts K14's exact wire, ``rma_accumulate_quant``
# its quantized wire (another kernel)
LAUNCHES: Dict[str, int] = {"rma_put": 0, "rma_get": 0,
                            "rma_accumulate": 0, "rma_accumulate_quant": 0,
                            "direct_put": 0}
PLAIN_CALLS: Dict[str, int] = {"rma_put": 0, "rma_get": 0,
                               "rma_accumulate": 0,
                               "rma_accumulate_quant": 0, "direct_put": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# helpers (own copies of the JAX module's)
# ---------------------------------------------------------------------------

def _cfg_chunk_elems(dtype: torch.dtype, chunk_bytes: Optional[int]) -> int:
    """RMA chunk size in elements: MV2T_RMA_CHUNK_BYTES, inheriting
    MV2T_ICI_CHUNK_BYTES when it is 0 or less."""
    if chunk_bytes is None:
        chunk_bytes = int(get_config()["RMA_CHUNK_BYTES"])
        if chunk_bytes <= 0:
            chunk_bytes = None
    return _ici_chunk_elems(dtype, chunk_bytes)


def acc_quant_ok(dtype: torch.dtype, count: int,
                 num_devices: Optional[int] = None) -> bool:
    """Whether an accumulate sized for the quant bin may run quantized:
    f32 into a block-multiple extent, with MV2T_QUANT_COLL's budget
    covering one quantization hop."""
    if dtype != torch.float32:
        return False
    from ..coll.tuning import quant_params
    wire, budget = quant_params()
    if budget <= 0 or budget < declared_bound(1, wire):
        return False
    return count % quant_block_elems(dtype) == 0


def planned_rma_tier(kind: str, nbytes: int, dtype: torch.dtype,
                     contiguous: bool, num_devices: Optional[int] = None,
                     count: int = 0) -> Tuple[str, Optional[str]]:
    """(tier, fallback_reason) for one one-sided op (``kind``: 'put',
    'get' or 'acc'): 'rdma' or 'quant' (the kernels, reason None) or
    'epoch' with the dev_rma_fallback_* bucket: noncontig (strided),
    dtype (bool, complex), size (empty, or below DEV_RMA_RDMA_MIN; -1 =
    always). An accumulate at or above DEV_RMA_QUANT_MIN (-1 = never)
    that ``acc_quant_ok`` passes takes 'quant'. The kernel tiers are
    planned on every device (no 'platform' bucket): on the CPU the
    wrappers take their plain versions."""
    if not contiguous:
        return "epoch", "noncontig"
    if dtype_kind(dtype) not in "fiu":
        return "epoch", "dtype"
    if nbytes <= 0:
        return "epoch", "size"
    cfg = get_config()
    rmin = int(cfg["DEV_RMA_RDMA_MIN"])
    if rmin < 0 or nbytes < rmin:
        return "epoch", "size"
    if kind == "acc":
        qmin = int(cfg["DEV_RMA_QUANT_MIN"])
        if qmin >= 0 and nbytes >= qmin and \
                acc_quant_ok(dtype, count, num_devices):
            return "quant", None
    return "rdma", None


def note_rma_fallback(kind: str, reason: str, nbytes: int) -> None:
    """Count one one-sided op that took the epoch tier (pvar family
    dev_rma_fallback_*)."""
    mpit.pvar(f"dev_rma_fallback_{reason}").inc()


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check_window(win: torch.Tensor, what: str) -> None:
    if win.dim() != 2 or not win.is_contiguous():
        raise ValueError(f"{what}: the window must be a contiguous (p, N) "
                         f"tensor, got shape {tuple(win.shape)}")


def _check_rank(rank: int, p: int, what: str) -> None:
    if not 0 <= rank < p:
        raise ValueError(f"{what}: rank {rank} outside the window's {p} "
                         f"ranks")


def check_range(win_len: int, disp: int, n: int, stride: int,
                what: str) -> None:
    """Raise ``ValueError`` unless elements ``disp + stride*i`` (i < n)
    lie in a window row of ``win_len`` elements."""
    if disp < 0 or n < 0 or stride < 1:
        raise ValueError(f"{what}: disp {disp}, count {n}, stride {stride}")
    if n and disp + stride * (n - 1) >= win_len:
        raise ValueError(f"{what}: {n} elements at disp {disp} (stride "
                         f"{stride}) run past the window's {win_len} "
                         f"elements")


def _check_op(src: Optional[torch.Tensor], win: torch.Tensor, n: int,
              origin: int, target: int, disp: int, what: str) -> None:
    _check_window(win, what)
    p, length = win.shape
    _check_rank(origin, p, what)
    _check_rank(target, p, what)
    check_range(length, disp, n, 1, what)
    if src is not None and (src.dtype != win.dtype or
                            src.device != win.device):
        raise ValueError(f"{what}: src is {src.dtype} on {src.device}, the "
                         f"window {win.dtype} on {win.device}")


def _no_8byte(dtype: torch.dtype, what: str) -> None:
    if dtype_kind(dtype) in "fiu" and dtype.itemsize == 8:
        raise NotImplementedError(f"{what}: 8-byte dtype {dtype} (the "
                                  f"port's device kernels take at most 4 "
                                  f"bytes an element)")


def _elem_size(dtype: torch.dtype, what: str) -> int:
    """Element size of a dtype the copying kernels (K12, K13, K17)
    move."""
    _no_8byte(dtype, what)
    if dtype.is_complex or dtype == torch.bool:
        raise TypeError(f"{what}: dtype {dtype} does not lower to the "
                        f"kernel (the epoch tier carries it)")
    return dtype.itemsize


def _acc_code(dtype: torch.dtype, what: str) -> int:
    """dtype code of K14."""
    _no_8byte(dtype, what)
    code = ring.DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {dtype} is not supported by the "
                        f"kernel (supported: "
                        f"{sorted(map(str, ring.DTYPE_CODES))})")
    return code


def _cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device}; the kernel takes "
                         f"CUDA tensors (CPU tensors take the plain path)")


def unshared(src: torch.Tensor, win: torch.Tensor, target: int, disp: int,
             span: Optional[int] = None) -> torch.Tensor:
    """``src`` (one-dimensional), or a copy of it when the memory from
    its first to its last element meets the ``span`` window elements
    (default ``src.numel()``) of row ``target`` from ``disp``: an op then
    writes the values its source held before it, as with the JAX
    package's immutable sources. A source that is exactly the target
    range needs no copy. A test of address ranges, no tensor op."""
    n = src.numel()
    span = n if span is None else span
    if not n or not span:
        return src
    es = win.element_size()
    lo = win.data_ptr() + (target * win.stride(0) + disp) * es
    s = src.data_ptr()
    end = s + ((n - 1) * src.stride(0) + 1) * es
    if s < lo + span * es and lo < end and \
            not (s == lo and span == n and src.stride(0) == 1):
        return src.clone()
    return src


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def add_values(cur: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``cur + src`` in the window dtype as K14 folds it: floats in
    float, rounded once; integers wrapping."""
    if cur.dtype.is_floating_point:
        return (cur.float() + src.float()).to(cur.dtype)
    if cur.dtype in ring.WIDE:          # int64 -> the dtype wraps
        return (cur.to(torch.int64) + src.to(torch.int64)).to(cur.dtype)
    return torch.add(cur, src)


def _quant_block(n: int) -> int:
    """The block of a quantized accumulate of ``n`` f32 elements, as the
    JAX wrapper cuts it: min(quant_block_elems(), n). ``n`` must be a
    multiple of the block, and the block of 4 codes."""
    block = min(quant_block_elems(torch.float32), n)
    if n % block or block % 4:
        raise ValueError(f"quantized accumulate needs a block-multiple "
                         f"count of whole 4-code words (n={n}, "
                         f"block={block})")
    return block


def rma_put_ref(src: torch.Tensor, win: torch.Tensor, origin: int,
                target: int, disp: int = 0) -> torch.Tensor:
    """Plain version of K12 and K17: ``win[target, disp:disp+n] = src``,
    in place; returns ``win``."""
    win[target, disp:disp + src.numel()] = src
    return win


def rma_get_ref(win: torch.Tensor, n: int, origin: int, target: int,
                disp: int = 0) -> torch.Tensor:
    """Plain version of K13: a copy of ``win[target, disp:disp+n]``."""
    return win[target, disp:disp + n].clone()


def rma_accumulate_ref(src: torch.Tensor, win: torch.Tensor, origin: int,
                       target: int, disp: int = 0, *,
                       quantized: bool = False) -> torch.Tensor:
    """Plain version of K14: ``win[target, disp:disp+n] += src``, in
    place; returns ``win``. ``quantized``: ``src`` encoded on
    MV2T_QUANT_COLL's wire, decoded and folded with one rounding."""
    sl = win[target, disp:disp + src.numel()]
    if quantized:
        from ..coll.tuning import quant_params
        block = _quant_block(src.numel())
        wire = quant_params()[0]
        w = encode_f32_ref(src.reshape(-1), block, wire)
        sl.copy_(decode_add_ref(sl, w, block, wire))
    else:
        sl.copy_(add_values(sl, src))
    return win


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check_stream_args(dt: torch.dtype, chunk_bytes, depth) -> None:
    """Validate the chunk and depth that K12/K13/K14 take for the JAX
    kernels' sake and do not use (None: nothing to check)."""
    if chunk_bytes is not None:
        _cfg_chunk_elems(dt, chunk_bytes)
    if depth is not None:
        _cfg_depth(depth)


def _row_ptr(win: torch.Tensor, target: int) -> int:
    return win.data_ptr() + target * win.stride(0) * win.element_size()


def copy_plan(src_addr: int, dst_addr: int, n: int,
              esize: int) -> Tuple[int, int, int]:
    """(head, nvec, shift): how the direct copy of K12/K13 and the direct
    fold of K14 (their C entries, ``csrc/ring.cu`` ``launch_direct``) cut
    ``n`` elements of ``esize`` bytes from address ``src_addr`` to
    ``dst_addr`` (both element-aligned). ``head`` elements run up to the
    destination's 16-byte boundary, then ``nvec`` 16-byte destination
    words, then a tail of fewer than ``16 // esize`` elements. ``shift`` is the
    source's misalignment in bytes against the words (0: both 16-byte
    aligned; else each word is assembled from the two aligned source
    words that hold its bytes). A model for the tests; the launch does
    not call it."""
    head = min(n, (-dst_addr & 15) // esize)
    nvec = (n - head) * esize // 16
    return head, nvec, (src_addr + head * esize) & 15


def _pass(fn: str, code: int, esize: int, device: torch.device) -> int:
    from . import _build
    lib = _build.load("ring")
    with torch.cuda.device(device):
        words = getattr(lib, fn)(code, kernel_param("rma_copy_threads", 256))
    if words < 1:
        raise RuntimeError(f"{fn}: no launch shape for code {code}")
    return words * (16 // esize)


def copy_pass(device: torch.device, esize: int) -> int:
    """The elements of ``esize`` bytes that one grid-stride pass of a
    K12/K13 launch moves on ``device`` at the current block size (every
    block that fits at once, each thread its unrolled 16-byte words)."""
    return _pass("mv2t_rma_copy_pass", esize, esize, device)


def accumulate_pass(device: torch.device, dtype: torch.dtype) -> int:
    """The elements of ``dtype`` that one grid-stride pass of a K14
    launch folds on ``device`` at the current block size."""
    return _pass("mv2t_rma_accumulate_pass", _acc_code(dtype, "K14"),
                 dtype.itemsize, device)


def rma_put(src: torch.Tensor, win: torch.Tensor, origin: int, target: int,
            disp: int = 0, *, chunk_bytes: Optional[int] = None,
            depth: Optional[int] = None,
            stream: Optional[int] = None) -> torch.Tensor:
    """K12: one-sided contiguous put of ``src`` into the target's window
    row at element ``disp``, in place; returns ``win``. Rows other than
    the target's are not touched. One direct copy: ``chunk_bytes`` and
    ``depth`` (the JAX kernel's) are validated and not used. ``stream``:
    a raw stream handle on the window's device, made current by the
    caller (``ring.launch``)."""
    return _put("rma_put", src, win, origin, target, disp, stream,
                (chunk_bytes, depth))


def _put(name: str, src: torch.Tensor, win: torch.Tensor, origin: int,
         target: int, disp: int, stream: Optional[int],
         knobs: Optional[Tuple] = None) -> torch.Tensor:
    """The direct copy of K12 and K17, counted under ``name``; ``knobs``:
    K12's (chunk_bytes, depth), validated after the operands."""
    src = src.reshape(-1).contiguous()
    n = src.numel()
    _check_op(src, win, n, origin, target, disp, name)
    if knobs is not None:
        _check_stream_args(win.dtype, *knobs)
    if n == 0:
        return win
    src = unshared(src, win, target, disp)
    if win.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return rma_put_ref(src, win, origin, target, disp)
    _cuda(win, name)
    esize = _elem_size(win.dtype, name)
    ring.launch("mv2t_rma_put", win.device, esize, src.data_ptr(),
                _row_ptr(win, target), disp, n,
                threads=kernel_param("rma_copy_threads", 256), stream=stream)
    LAUNCHES[name] += 1
    return win


def rma_get(win: torch.Tensor, n: int, origin: int, target: int,
            disp: int = 0, *, chunk_bytes: Optional[int] = None,
            depth: Optional[int] = None,
            stream: Optional[int] = None) -> torch.Tensor:
    """K13: one-sided contiguous get of ``n`` elements of the target's
    window row at ``disp``; returns them, ``[n]`` (the origin's
    result). One direct copy; ``chunk_bytes``, ``depth`` and ``stream``
    as for :func:`rma_put`."""
    _check_op(None, win, n, origin, target, disp, "rma_get")
    _check_stream_args(win.dtype, chunk_bytes, depth)
    if n == 0:
        return win.new_empty(0)
    if win.device.type == "cpu":
        PLAIN_CALLS["rma_get"] += 1
        return rma_get_ref(win, n, origin, target, disp)
    _cuda(win, "rma_get")
    esize = _elem_size(win.dtype, "rma_get")
    out = win.new_empty(n)
    row = _row_ptr(win, target)
    ring.launch("mv2t_rma_get", win.device, esize, row, disp,
                out.data_ptr(), n,
                threads=kernel_param("rma_copy_threads", 256), stream=stream)
    LAUNCHES["rma_get"] += 1
    return out


def rma_accumulate(src: torch.Tensor, win: torch.Tensor, origin: int,
                   target: int, disp: int = 0, *, quantized: bool = False,
                   chunk_bytes: Optional[int] = None,
                   depth: Optional[int] = None,
                   stream: Optional[int] = None) -> torch.Tensor:
    """K14: one-sided accumulate (MPI_SUM) of ``src`` into the target's
    window row at ``disp``, in place, as one direct fold; returns
    ``win``. ``quantized=True`` (K14q) carries each block as K9's
    block-scaled wire (MV2T_QUANT_COLL's wire format), f32 only; the
    caller owns the budget check (``acc_quant_ok``), as in the JAX
    package. ``chunk_bytes``, ``depth`` and ``stream`` as for
    :func:`rma_put`."""
    src = src.reshape(-1).contiguous()
    n = src.numel()
    _check_op(src, win, n, origin, target, disp, "rma_accumulate")
    _check_stream_args(win.dtype, chunk_bytes, depth)
    if n == 0:
        return win
    src = unshared(src, win, target, disp)
    if quantized:
        return _accumulate_quant(src, win, origin, target, disp, stream)
    if win.device.type == "cpu":
        PLAIN_CALLS["rma_accumulate"] += 1
        return rma_accumulate_ref(src, win, origin, target, disp)
    _cuda(win, "rma_accumulate")
    ring.launch("mv2t_rma_accumulate", win.device,
                _acc_code(win.dtype, "rma_accumulate"), src.data_ptr(),
                _row_ptr(win, target), disp, n,
                threads=kernel_param("rma_copy_threads", 256), stream=stream)
    LAUNCHES["rma_accumulate"] += 1
    return win


def _accumulate_quant(src, win, origin, target, disp, stream
                      ) -> torch.Tensor:
    """K14's quantized wire (``rma_accumulate(quantized=True)``)."""
    from ..coll.tuning import quant_params
    if win.dtype != torch.float32:
        raise TypeError(f"rma_accumulate: the quantized wire takes f32 "
                        f"windows, not {win.dtype}")
    n = src.numel()
    block = _quant_block(n)
    if win.device.type == "cpu":
        PLAIN_CALLS["rma_accumulate_quant"] += 1
        return rma_accumulate_ref(src, win, origin, target, disp,
                                  quantized=True)
    _cuda(win, "rma_accumulate")
    ring.launch("mv2t_rma_accumulate_quant", win.device,
                WIRE_CODES[quant_params()[0]], src.data_ptr(),
                _row_ptr(win, target), disp, n, block,
                threads=kernel_param("rma_copy_threads", 256), stream=stream)
    LAUNCHES["rma_accumulate_quant"] += 1
    return win


def direct_put(src: torch.Tensor, win: torch.Tensor, origin: int,
               target: int, disp: int = 0) -> torch.Tensor:
    """K17, the port of ``rma/device.py`` ``pallas_put``: a single-shot
    put of ``src`` into the target's window row at ``disp``, in place;
    returns ``win``. K12's direct copy on the current stream: no landing
    buffer, no flag, no chunks and no credits."""
    return _put("direct_put", src, win, origin, target, disp, None)
