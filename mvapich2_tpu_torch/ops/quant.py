"""Block-scaled quantized device allreduce, the ``quant`` tier
(counterpart of ``mvapich2_tpu/ops/pallas_quant.py``).

For large float sum allreduces whose callers tolerate a bounded error
(MV2T_QUANT_COLL carries the budget), the reduce-scatter ring carries
each chunk as block-scaled codes instead of exact floats: the shard is
cut into blocks of QUANT_BLOCK bytes, and each block travels as one run
of int32 words, word 0 its f32 absmax scale (bitcast), then four codes a
word, lowest byte first. Two code flavours:

* ``q8``: code = clip(round_half_even(x / scale), +-127) + 128, scale
  = absmax * f32(1/127);
* ``fp8``: code = the e4m3 bits (rounded to nearest even) of
  clip(x / scale, +-448), scale = absmax * f32(1/448).

A block of zeros has scale 0 and divides by 1 in its place. ``x /
scale`` is an IEEE division (a tensor by a tensor: torch on the card
turns division by a Python scalar into a product with its reciprocal).

``quant_ring_all_reduce`` is one launch of **K9**,
``mv2t_quant_ring_all_reduce`` in ``csrc/ring.cu``. The JAX package runs
the reduce-scatter ring with the codec fused into every step (the sender
encodes its partial, the receiver decodes it and adds it to its own),
encodes each rank's reduced block once, gathers the wire blocks with the
exact all-gather ring and decodes them outside its kernel. Every hop's
arithmetic is local to one quantization block, so on one card K9 runs
each block's chain directly: one warp loads the block from its p ranks
in the ring's order, folds them through the codec in registers, encodes
the owner's block once, decodes it and stores the result into every
rank's row. No working array, no landing slot, no gather, and no wire
word reaches memory: ``quant_reduce_scatter``, the same launch with no
result rows, writes each rank's encoded block (the JAX kernel's
``own_wire``) instead.

Every rank's row decodes the same words, so every rank's result is the
same, and each element is quantized at most ``p`` times:
``declared_bound``. A non-sum op or a dtype of another numpy kind than
'f' takes the exact K3 ring: integers, and bfloat16 (ml_dtypes' bfloat16
has kind 'V', so the JAX package never quantizes it either).

Routing is ``ops/ring.py``'s: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. ``ops/ici.py``'s ``LAUNCHES`` and
``PLAIN_CALLS`` count K9 under ``quant_ring_all_reduce``, once a call.
The plain version (``quant_reduce_scatter_ref`` on ``ring.ring_replay``,
then the decode of the wire and the broadcast) replays the ring and is
the spec; it scales, divides, rounds, clips and converts exactly as K9 does,
and folds a decoded hop with one rounding
(``decode_add_ref``: K9 uses ``fmaf``; XLA's CPU code contracts the
JAX kernel's ``acc + q * scale`` the same way), so the kernel, the plain
version and the JAX reference agree bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..coll.tuning import kernel_param
from ..utils.config import get_config
from . import ici, ring
from .ring import Shards

WIRE_FORMATS = ("q8", "fp8")
WIRE_CODES = {"q8": 0, "fp8": 1}     # csrc/ring.cu enum Wire
_Q8_MAX = 127.0
_FP8_MAX = 448.0                     # float8_e4m3fn's largest finite value
# f32(1/127) and f32(1/448): the scale is absmax times the rounded
# reciprocal, as XLA compiles the JAX codec's ``amax / 127`` (its
# algebraic simplifier turns division by a constant into this product)
_INV = {"q8": float(np.float32(1) / np.float32(_Q8_MAX)),
        "fp8": float(np.float32(1) / np.float32(_FP8_MAX))}
_INPUT_DTYPES = (torch.float32, torch.float16)        # K9's input dtypes


def _float_kind(dtype: torch.dtype) -> bool:
    """numpy kind 'f', the JAX package's test for a dtype it quantizes:
    float16/32/64, not bfloat16 (ml_dtypes' bfloat16 has kind 'V', so
    the JAX package sends it to the exact ring)."""
    return dtype.is_floating_point and dtype != torch.bfloat16


# ---------------------------------------------------------------------------
# wire geometry and the error-bound contract
# ---------------------------------------------------------------------------

def quant_block_elems(dtype: torch.dtype = torch.float32) -> int:
    """Elements per quantization block: QUANT_BLOCK bytes of ``dtype``,
    at least 8, floored to the 4-code packing granularity."""
    b = max(8, int(get_config()["QUANT_BLOCK"]) // dtype.itemsize)
    return (b // 4) * 4


def _block_of(block_bytes: Optional[int]) -> int:
    """Elements per f32 block for a ``block_bytes`` argument (None: the
    cvar)."""
    if block_bytes is None:
        return quant_block_elems(torch.float32)
    return max(8, (int(block_bytes) // 4) // 4 * 4)


def wire_words(nelems: int, block: int) -> int:
    """int32 wire words for ``nelems`` (a block multiple): one scale
    word plus 4 codes a word, per block."""
    assert nelems % block == 0
    return (nelems // block) * (1 + block // 4)


def declared_bound(num_devices: int, wire: str = "q8") -> float:
    """The quantized allreduce's largest relative error against the
    exact fold, over the largest partial's block absmax: at most ``p``
    quantizations an element, each within half a code step."""
    per = 1.0 / 254.0 if wire == "q8" else 1.0 / 28.0
    return num_devices * per


def wire_stats(count: int, dtype: torch.dtype, num_devices: int,
               block_bytes: Optional[int] = None) -> Tuple[int, int]:
    """(exact bytes, quantized bytes) one rank sends for a ring allreduce
    of ``count`` elements, reduce-scatter and all-gather: 2(p-1) blocks
    each. The ``dev_coll_quant_bytes_saved`` pvar counts the
    difference."""
    p = num_devices
    isz = dtype.itemsize
    if block_bytes is None:
        blk = quant_block_elems(dtype)
    else:
        blk = max(8, (int(block_bytes) // isz) // 4 * 4)
    nblk = -(-(-(-count // p)) // blk) * blk
    exact = 2 * (p - 1) * nblk * isz
    quant = 2 * (p - 1) * wire_words(nblk, blk) * 4
    return exact, quant


def quant_eligible(name: str, dtype: torch.dtype, op: Optional[str],
                   num_devices: Optional[int] = None) -> bool:
    """Whether a call in the quant bin may run quantized: an allreduce
    or reduce with op sum, on f32 or f16 (see ``_float_kind``), whose
    MV2T_QUANT_COLL budget covers ``declared_bound`` for this ring
    width. Anything else takes the exact K3 ring."""
    if name not in ("allreduce", "reduce") or op != "sum":
        return False
    if not _float_kind(dtype) or dtype.itemsize > 4:
        return False
    from ..coll.tuning import quant_params
    wire, budget = quant_params()
    if budget <= 0:
        return False
    if num_devices is not None and budget < declared_bound(num_devices,
                                                           wire):
        return False
    return True


def _quant_spans(nblk: int, ndir: int, block: int
                 ) -> List[Tuple[int, int]]:
    """Per-direction element ranges of a ring block, cut on
    quantization-block boundaries so every chunk encodes whole
    blocks."""
    if ndir == 1:
        return [(0, nblk)]
    nb = nblk // block
    h = ((nb + 1) // 2) * block
    return [(0, h), (h, nblk)]


def _resolve_wire(wire: Optional[str]) -> str:
    if wire is None:
        from ..coll.tuning import quant_params
        wire = quant_params()[0]
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown quant wire format {wire!r}")
    return wire


# ---------------------------------------------------------------------------
# the codec, plain torch
# ---------------------------------------------------------------------------

def encode_f32_ref(v: torch.Tensor, block: int, wire: str) -> torch.Tensor:
    """``[m]`` values (m a block multiple, any float dtype) ->
    ``[wire_words(m)]`` int32: per block one bitcast f32 absmax scale
    word, then 4 codes a word, lowest byte first."""
    x = v.to(torch.float32).reshape(-1, block)
    amax = x.abs().amax(dim=1, keepdim=True)
    top = _Q8_MAX if wire == "q8" else _FP8_MAX
    scale = amax * torch.full_like(amax, _INV[wire])
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    if wire == "q8":
        q = torch.clamp(torch.round(x / safe), -top, top)
        u = q.to(torch.int32) + 128
    else:
        y = torch.clamp(x / safe, -top, top).to(torch.float8_e4m3fn)
        u = y.view(torch.uint8).to(torch.int32)
    u = u.reshape(x.shape[0], -1, 4)
    words = (u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
             | (u[..., 3] << 24))
    return torch.cat([scale.view(torch.int32), words], dim=1).reshape(-1)


def _codes(w: torch.Tensor, block: int, wire: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes as f32 ``(blocks, block)``, scales ``(blocks, 1)``) of
    ``[..., wire_words(m)]`` int32 wire words."""
    ww = w.reshape(-1, 1 + block // 4)
    scale = ww[:, :1].contiguous().view(torch.float32)
    words = ww[:, 1:]
    b = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    b = b.reshape(b.shape[0], -1)
    if wire == "q8":
        return b.to(torch.float32) - 128.0, scale
    return b.to(torch.uint8).view(torch.float8_e4m3fn).to(torch.float32), \
        scale


def decode_f32_ref(w: torch.Tensor, block: int, wire: str) -> torch.Tensor:
    """Inverse of :func:`encode_f32_ref`: ``[..., wire_words(m)]`` int32
    -> ``[..., m]`` f32 (code times scale, one rounding)."""
    q, scale = _codes(w, block, wire)
    return (q * scale).reshape(*w.shape[:-1], -1)


def _fma_f32(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor
             ) -> torch.Tensor:
    """``q*scale + acc`` rounded once to f32, as ``fmaf`` does. ``q*scale``
    is exact in f64 (a code has at most 8 significant bits), so the f64
    sum is one rounding away from the exact value; the only case where
    rounding that sum to f32 differs from rounding the exact value is a
    sum that fell exactly on an f32 midpoint, and there the sum's own
    rounding error (TwoSum) says which way to go."""
    p = q.double() * scale.double()
    c = acc.double()
    s = p + c
    bp = s - c
    e = (c - (s - bp)) + (p - bp)           # s + e == p + c exactly
    r = s.float()
    rd = r.double()
    other = 2 * s - rd                      # the far neighbour if s is a tie
    tie = (s != rd) & (other.float().double() == other) & (e != 0)
    if bool(tie.any()):
        inf = torch.full_like(s, float("inf"))
        toward = torch.where(e > 0, inf, -inf)   # s + e may round to s
        r = torch.where(tie, torch.nextafter(s, toward).float(), r)
    return r


def decode_add_ref(acc: torch.Tensor, w: torch.Tensor, block: int,
                   wire: str) -> torch.Tensor:
    """``acc + decode(w)`` with one rounding an element: the decode and
    the fold fused, as K9's and K14's consumers compute them (and as
    XLA's CPU code computes the JAX kernels' ``acc + q * scale``)."""
    q, scale = _codes(w, block, wire)
    return _fma_f32(q, scale, acc.reshape(q.shape)).reshape(acc.shape)


# ---------------------------------------------------------------------------
# K9: the quantized allreduce
# ---------------------------------------------------------------------------

# the largest block that K9 holds in registers, in f32 values (csrc/ring.cu
# kQuantNarrow four-value words, one a lane); a larger one keeps its
# partial in a scratch row of p*nblk f32 that the wrapper allocates only
# then
_WIDE_BLOCK = 128


def _geometry(p: int, n: int, block_bytes: Optional[int]) -> Tuple[int, int]:
    """(block, nblk) of one quantized allreduce: the ring block of
    ``nblk`` elements is ceil(n/p) rounded up to whole quantization
    blocks."""
    blk = _block_of(block_bytes)
    return blk, -(-(-(-n // p)) // blk) * blk


def _padded_f32(shards: List[torch.Tensor], n_pad: int) -> torch.Tensor:
    x = torch.stack(shards).to(torch.float32)
    n = x.shape[1]
    if n_pad > n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))   # 0: sum identity
    return x


def quant_reduce_scatter_ref(xs: Shards, nblk: int, block: int, wire: str,
                             ndir: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized reduce-scatter ring replayed block by block in the
    JAX kernel's order, the spec of K9. At each hop the sender's partial
    is encoded and decoded, then added to the receiver's. Returns (each
    rank's wire output ``(p, wire_words(nblk))`` int32, each rank's fully
    reduced own block ``(p, nblk)`` f32)."""
    shards = ring.as_shards(xs, "quant_ring_all_reduce")
    p = len(shards)
    o = _padded_f32(shards, p * nblk).reshape(p, p, nblk)

    def red(own, inc):
        return decode_add_ref(own, encode_f32_ref(inc, block, wire), block,
                              wire)

    ring.ring_replay(o, _quant_spans(nblk, ndir, block), True, False, red)
    ranks = torch.arange(p, device=o.device)
    own = o[ranks, ranks]
    return encode_f32_ref(own, block, wire).reshape(p, -1), own


def _k9(shards: List[torch.Tensor], nblk: int, block: int, wire: str,
        ndir: int, out: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Launch K9 over CUDA ``shards``: the decoded result into the rows
    of ``out`` (``(p, n)`` in the input dtype), or, when ``out`` is None,
    the wire outputs alone, returned."""
    code = ring.check_cuda_shards(shards, "quant_ring_all_reduce")
    if shards[0].dtype not in _INPUT_DTYPES:
        raise TypeError(f"quant_ring_all_reduce: dtype {shards[0].dtype}; "
                        f"the kernel takes f32 and f16")
    p, n, dev = len(shards), shards[0].numel(), shards[0].device
    wires = None if out is not None else torch.empty(
        (p, wire_words(nblk, block)), dtype=torch.int32, device=dev)
    scratch = torch.empty(p * nblk, dtype=torch.float32, device=dev) \
        if block > _WIDE_BLOCK else None
    ring.launch("mv2t_quant_ring_all_reduce", dev, code, WIRE_CODES[wire],
                ring.pointers(shards),
                None if out is None else ring.row_pointers(out),
                None if wires is None else wires.data_ptr(),
                None if scratch is None else scratch.data_ptr(), p, n, nblk,
                block, ndir, threads=kernel_param("quant_threads", 128))
    ici.LAUNCHES["quant_ring_all_reduce"] += 1
    return wires


def quant_reduce_scatter(xs: Shards, nblk: int, block: int, wire: str,
                         ndir: int) -> torch.Tensor:
    """K9's wire outputs alone: the quantized reduce-scatter of ``p``
    float shards of ``n`` elements (f32 or f16, cast to f32 and
    zero-padded to p ring blocks of ``nblk``), each rank's own block
    encoded once, ``(p, wire_words(nblk))`` int32 (the JAX kernel's
    ``own_wire``). The launch of :func:`quant_ring_all_reduce`, with
    the wire outputs in place of the result rows."""
    shards = ring.as_shards(xs, "quant_ring_all_reduce")
    if ring.on_cpu(shards):
        ici.PLAIN_CALLS["quant_ring_all_reduce"] += 1
        return quant_reduce_scatter_ref(shards, nblk, block, wire, ndir)[0]
    return _k9(shards, nblk, block, wire, ndir, None)


# ---------------------------------------------------------------------------
# the allreduce
# ---------------------------------------------------------------------------

def quant_ring_all_reduce(xs: Shards, op: str = "sum", *,
                          wire: Optional[str] = None,
                          block_bytes: Optional[int] = None,
                          chunk_bytes: Optional[int] = None,
                          depth: Optional[int] = None,
                          bidirectional: Optional[bool] = None
                          ) -> torch.Tensor:
    """Block-scaled quantized allreduce of ``p`` shards, one K9 launch.
    A non-sum op or another dtype than f32, f16 or f64 (bf16 included,
    as in the JAX package) takes the exact K3 ring. Returns ``(p, n)`` in
    the input dtype, row r for rank r. ``bidirectional`` picks which
    quantization blocks fold counter-clockwise, so it changes the
    result's bits; ``chunk_bytes`` and ``depth`` order the TPU ring's
    transfers and never its result, so they are checked and shape
    nothing here, as K3's."""
    shards = ring.as_shards(xs, "quant_ring_all_reduce")
    if op != "sum" or not _float_kind(shards[0].dtype):
        return ici.hbm_ring_all_reduce(shards, op, chunk_bytes=chunk_bytes,
                                       depth=depth,
                                       bidirectional=bidirectional)
    p, n = len(shards), shards[0].numel()
    if p == 1:
        return shards[0].reshape(1, n).clone()
    wire = _resolve_wire(wire)
    ici._cfg_chunk_elems(torch.float32, chunk_bytes)
    ici._cfg_depth(depth)
    if ring.on_cpu(shards):
        ici.PLAIN_CALLS["quant_ring_all_reduce"] += 1
        return quant_ring_all_reduce_ref(shards, wire=wire,
                                         block_bytes=block_bytes,
                                         bidirectional=bidirectional)
    blk, nblk = _geometry(p, n, block_bytes)
    out = torch.empty((p, n), dtype=shards[0].dtype, device=shards[0].device)
    _k9(shards, nblk, blk, wire, ici._resolve_ndir(p, bidirectional), out)
    return out


def quant_ring_all_reduce_ref(xs: Shards, op: str = "sum", *,
                              wire: Optional[str] = None,
                              block_bytes: Optional[int] = None,
                              bidirectional: Optional[bool] = None
                              ) -> torch.Tensor:
    """Plain version of :func:`quant_ring_all_reduce`: the ring replayed
    (``quant_reduce_scatter_ref``), every rank's result decoded from the
    concatenated wire blocks (what the JAX wrapper's exact all-gather
    carries) and cast back. Chunking and depth reorder the TPU ring's
    transfers, never its arithmetic, so they are not parameters here."""
    shards = ring.as_shards(xs, "quant_ring_all_reduce")
    if op != "sum" or not _float_kind(shards[0].dtype):
        return ici.hbm_ring_all_reduce_ref(shards, op,
                                           bidirectional=bidirectional)
    p, n = len(shards), shards[0].numel()
    if p == 1:
        return shards[0].reshape(1, n).clone()
    wire = _resolve_wire(wire)
    blk, nblk = _geometry(p, n, block_bytes)
    own, _ = quant_reduce_scatter_ref(
        shards, nblk, blk, wire, ici._resolve_ndir(p, bidirectional))
    row = decode_f32_ref(own.reshape(-1), blk, wire).to(shards[0].dtype)
    return row[:n].reshape(1, n).expand(p, n).clone()
