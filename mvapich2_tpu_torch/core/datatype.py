"""Datatypes with pack/unpack (a trimmed copy of the JAX package's
``core/datatype.py``).

Basic types are numpy dtypes, so the host algorithms' reductions
vectorize; a derived type flattens its typemap into merged (offset,
length) byte spans and pack/unpack gather and scatter over them. Ported:
the basic types and the MINLOC/MAXLOC pair types, ``from_numpy_dtype``
(which also takes a ``torch.dtype``: a tensor's datatype for the device
channels, whose ``size`` is all they read), ``as_bytes_view``, and the
constructors contiguous, vector, hvector, indexed, hindexed,
indexed_block, struct, subarray, darray (``DISTRIBUTE_*``) and
resized, each recording its envelope (``get_envelope``); ``dup``, which
runs the keyvals' ``copy_fn``, and the keyval attributes (``attrs``,
``core/attr.py``).

A torch tensor is not a host buffer: ``as_bytes_view`` refuses it with
MPI_ERR_ARG, as the JAX package refuses a ``jax.Array``. Point-to-point
calls therefore raise on a tensor; the host-tier collectives read a
CPU tensor as numpy where the JAX package stages a device array, and
raise for one on the card (``core/comm.py`` ``_stage_if_unbound``,
``coll/device.py`` ``install_device_coll``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .errors import MPIException, MPI_ERR_TYPE, MPI_ERR_ARG, mpi_assert

Span = Tuple[int, int]  # (byte offset, byte length)


class Datatype:
    """An MPI datatype.

    ``size``    — bytes of real data per element
    ``extent``  — spacing between consecutive elements (ub - lb)
    ``lb``      — lower bound
    ``spans``   — merged contiguous (offset, len) byte spans of one element
    ``basic``   — numpy dtype of the underlying basic elements if homogeneous
                  (needed by reduction ops), else None
    """

    def __init__(self, spans, extent: int, lb: int = 0,
                 basic: Optional[np.dtype] = None, name: str = "",
                 committed: bool = False):
        # spans normalize to an (N, 2) int64 array — the dataloop is
        # DATA, vectorized end-to-end (a 4M-span contig-of-indexed from
        # the MTest generators costs milliseconds, not tens of seconds
        # of tuple churn)
        arr = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
        self.spans = _merge_spans(arr)
        # Negative displacements/strides are legal MPI (vector with
        # stride < 0, MPI_LB markers — datatype/lbub.c,
        # unusual-noncontigs.c). The numpy-backed pack/unpack walks a
        # view that starts at the buffer pointer and cannot express
        # bytes before it, so such types are flagged and routed through
        # the absolute-address (ctypes) path at the C boundary
        # (cshim._abs_gather/_abs_scatter); pack/unpack refuse rather
        # than wrap-index from the end of the buffer.
        self.min_off = (int(self.spans[:, 0].min())
                        if len(self.spans) else 0)
        self.size = int(self.spans[:, 1].sum()) if len(self.spans) else 0
        self.lb = lb
        self.extent = extent
        self.basic = np.dtype(basic) if basic is not None else None
        self.name = name
        self.committed = committed

    # -- introspection ----------------------------------------------------
    @property
    def ub(self) -> int:
        return self.lb + self.extent

    def needs_abs(self, count: int = 1) -> bool:
        """True when ``count`` elements reach bytes BEFORE the buffer
        pointer (negative typemap displacements, or a negative extent
        tiling backward) — pack/unpack on a pointer-based view cannot
        express that; the absolute-address path must be used."""
        if self.min_off < 0:
            return True
        return count > 1 and self.extent < 0 and len(self.spans) > 0

    @property
    def is_contiguous(self) -> bool:
        return (len(self.spans) == 1 and self.spans[0][0] == 0
                and self.spans[0][1] == self.size and self.extent == self.size)

    @property
    def basic_size(self) -> int:
        return self.basic.itemsize if self.basic is not None else 1

    @property
    def attrs(self):
        """Keyval attribute cache (MPI_Type_set_attr family), lazy."""
        a = getattr(self, "_attrs", None)
        if a is None:
            from .attr import AttrCache
            a = self._attrs = AttrCache()
        return a

    def get_envelope(self):
        """(combiner, integers, addresses, datatypes) — MPI_Type_get_
        envelope/get_contents introspection. Basic types report
        COMBINER_NAMED with empty argument lists."""
        env = getattr(self, "_envelope", None)
        if env is None:
            return ("named", [], [], [])
        return env

    def commit(self) -> "Datatype":
        self.committed = True
        return self

    def dup(self) -> "Datatype":
        new = Datatype(self.spans, self.extent, self.lb, self.basic,
                       self.name + "_dup", self.committed)
        new._envelope = ("dup", [], [], [self])
        if getattr(self, "_attrs", None) is not None:
            self.attrs.copy_all(self, new.attrs)   # keyval copy_fn fires
        return new

    def __repr__(self) -> str:
        return (f"Datatype({self.name or 'derived'}, size={self.size}, "
                f"extent={self.extent}, spans={len(self.spans)})")

    # -- pack / unpack ----------------------------------------------------
    def flatten(self, count: int):
        """Byte spans of ``count`` elements laid out with this type's
        extent — an (N, 2) int64 array."""
        if self.is_contiguous:
            return (np.array([[0, self.size * count]], dtype=np.int64)
                    if count else np.empty((0, 2), dtype=np.int64))
        return _merge_spans(
            _replicate_spans(self.spans, count, self.extent))

    def _byte_index(self) -> np.ndarray:
        """Flat source-byte index for one element (cached): the gather
        map of the dataloop. Vectorized pack/unpack for many-span types
        is a single numpy fancy-index instead of a span loop."""
        idx = getattr(self, "_idx_cache", None)
        if idx is None:
            arr = np.asarray(self.spans, dtype=np.int64).reshape(-1, 2)
            starts, lens = arr[:, 0], arr[:, 1]
            ends = np.cumsum(lens)
            total = int(ends[-1])
            step = np.ones(total, dtype=np.int64)
            step[0] = starts[0]
            if len(starts) > 1:
                step[ends[:-1]] = starts[1:] - (starts[:-1] + lens[:-1]) \
                    + 1
            idx = np.cumsum(step)
            self._idx_cache = idx
        return idx

    def pack(self, buf, count: int) -> np.ndarray:
        """Gather ``count`` elements from ``buf`` into contiguous bytes."""
        if count and self.needs_abs(count):
            raise MPIException(
                MPI_ERR_TYPE,
                "negative-displacement type requires absolute "
                f"addressing (type {self.name or 'derived'})")
        raw = as_bytes_view(buf)
        if self.is_contiguous:
            n = self.size * count
            mpi_assert(len(raw) >= n, MPI_ERR_ARG,
                       f"buffer too small: {len(raw)} < {n}")
            return np.frombuffer(raw, dtype=np.uint8, count=n).copy()
        src = np.frombuffer(raw, dtype=np.uint8)
        if len(self.spans) > 64:
            idx = self._byte_index()
            if count == 1:
                return src[idx]
            full = (idx[None, :]
                    + (np.arange(count, dtype=np.int64)
                       * self.extent)[:, None]).reshape(-1)
            return src[full]
        out = np.empty(self.size * count, dtype=np.uint8)
        pos = 0
        for off, ln in self.flatten(count):
            out[pos:pos + ln] = src[off:off + ln]
            pos += ln
        return out

    def unpack(self, data, buf, count: int) -> None:
        """Scatter contiguous bytes ``data`` into ``buf``."""
        if count == 0:
            return
        if self.needs_abs(count):
            raise MPIException(
                MPI_ERR_TYPE,
                "negative-displacement type requires absolute "
                f"addressing (type {self.name or 'derived'})")
        raw = as_bytes_view(buf, writable=True)
        src = np.frombuffer(as_bytes_view(data), dtype=np.uint8)
        dst = np.frombuffer(raw, dtype=np.uint8)
        if self.is_contiguous:
            n = min(len(src), self.size * count)
            dst[:n] = src[:n]
            return
        if len(self.spans) > 64 and len(src) >= self.size * count:
            idx = self._byte_index()
            if count == 1:
                dst[idx] = src[:idx.size]
                return
            full = (idx[None, :]
                    + (np.arange(count, dtype=np.int64)
                       * self.extent)[:, None]).reshape(-1)
            dst[full] = src[:full.size]
            return
        pos = 0
        for off, ln in self.flatten(count):
            take = min(ln, len(src) - pos)
            if take <= 0:
                break
            dst[off:off + take] = src[pos:pos + take]
            pos += take

    def to_numpy(self, buf, count: int) -> np.ndarray:
        """Pack and view as the basic dtype (for reductions)."""
        b = np.asarray(self.pack(buf, count))
        if self.basic is None:
            raise MPIException(MPI_ERR_TYPE,
                               "heterogeneous datatype in reduction")
        if self.basic.itemsize == self.size:
            # this type's packed element already IS the basic layout
            # (plain basics, and synthesized struct basics whose element
            # carries its padding) — restaging would misparse it
            return np.ascontiguousarray(b).view(np.uint8).reshape(-1) \
                .view(self.basic)
        # true pair types (size 12 != itemsize 16): packed signature
        # bytes restage into the padded struct (rma/acc-pairtype.c)
        return packed_to_basic(b, self.basic)

    def from_numpy(self, arr: np.ndarray) -> np.ndarray:
        """The inverse of :meth:`to_numpy`: an array of the basic view
        dtype as the packed signature bytes that :meth:`unpack` scatters
        (a pair item's trailing padding left out)."""
        if self.basic is not None and self.basic.itemsize != self.size:
            return basic_to_packed(arr, self.basic)
        return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)


def _basic_sig(b: np.dtype) -> int:
    """Data bytes of ONE basic item: field sizes for padded (pair)
    struct dtypes, itemsize otherwise."""
    if b.names:
        return sum(b.fields[n][0].itemsize for n in b.names)
    return b.itemsize


def packed_to_basic(data_u8, basic: np.dtype) -> np.ndarray:
    """Packed signature bytes -> array of the (possibly padded) basic
    view dtype. Works per-ITEM, so contiguous-of-pair types restage
    correctly (rma/acc-pairtype.c)."""
    m = np.ascontiguousarray(np.asarray(data_u8)).view(np.uint8) \
        .reshape(-1)
    sig = _basic_sig(basic)
    if basic.itemsize == sig:
        return m.view(basic)
    n = m.size // sig
    out = np.zeros(n, dtype=basic)
    out.view(np.uint8).reshape(n, basic.itemsize)[:, :sig] = \
        m.reshape(n, sig)
    return out


def basic_to_packed(arr, basic: np.dtype) -> np.ndarray:
    """Items of the (possibly padded) basic view dtype -> their packed
    signature bytes, item by item: the inverse of
    :func:`packed_to_basic`."""
    items = np.ascontiguousarray(np.asarray(arr)).view(np.uint8) \
        .reshape(-1, basic.itemsize)
    return np.ascontiguousarray(items[:, :_basic_sig(basic)]).reshape(-1)


def has_padding(dt) -> bool:
    """True for a pair dtype whose items carry padding past their
    signature bytes (MPI_LONG_INT, MPI_DOUBLE_INT, MPI_SHORT_INT)."""
    dt = np.dtype(dt)
    return dt.names is not None and _basic_sig(dt) != dt.itemsize


def _merge_spans(spans) -> np.ndarray:
    """Coalesce adjacent byte spans (the dataloop optimization),
    vectorized — the MTest datatype generators build types with
    10^4-10^6 blocks, where a Python loop is the difference between
    milliseconds and minutes. Returns an (N, 2) int64 array."""
    arr = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
    if len(arr) == 0:
        return arr
    off, ln = arr[:, 0], arr[:, 1]
    keep = ln > 0
    if not keep.all():
        off, ln = off[keep], ln[keep]
    if off.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    # new group wherever a span does not extend its predecessor
    brk = np.empty(off.size, dtype=bool)
    brk[0] = True
    np.not_equal(off[1:], off[:-1] + ln[:-1], out=brk[1:])
    if brk.all():
        return np.stack([off, ln], axis=1)
    gid = np.cumsum(brk) - 1
    starts = off[brk]
    ends = np.zeros(int(gid[-1]) + 1, dtype=np.int64)
    np.maximum.at(ends, gid, off + ln)
    return np.stack([starts, ends - starts], axis=1)


def _replicate_spans(spans, count: int, stride: int) -> np.ndarray:
    """``count`` copies of a span set at ``stride``-byte steps — the
    vectorized dataloop replication every constructor builds on."""
    arr = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
    if count == 0 or len(arr) == 0:
        return np.empty((0, 2), dtype=np.int64)
    if count == 1:
        return arr
    offs = (arr[:, 0][None, :]
            + (np.arange(count, dtype=np.int64) * stride)[:, None])
    lens = np.broadcast_to(arr[:, 1][None, :], offs.shape)
    return np.stack([offs.reshape(-1), lens.reshape(-1)], axis=1)


def as_bytes_view(buf, writable: bool = False):
    """memoryview of a user buffer's bytes (numpy array / bytes / bytearray)."""
    if isinstance(buf, np.ndarray):
        if not buf.flags["C_CONTIGUOUS"]:
            raise MPIException(MPI_ERR_ARG, "buffer must be C-contiguous")
        mv = buf.reshape(-1).view(np.uint8).data
        return mv
    if isinstance(buf, (bytes, bytearray, memoryview)):
        mv = memoryview(buf)
        if writable and mv.readonly:
            raise MPIException(MPI_ERR_ARG, "read-only receive buffer")
        return mv.cast("B")
    raise MPIException(MPI_ERR_ARG, f"unsupported buffer type {type(buf)}")


# ---------------------------------------------------------------------------
# Basic datatypes (numpy-backed)
# ---------------------------------------------------------------------------

def _basic(np_dtype, name: str) -> Datatype:
    dt = np.dtype(np_dtype)
    return Datatype([(0, dt.itemsize)], dt.itemsize, 0, dt, name, True)


BYTE = _basic(np.uint8, "MPI_BYTE")
CHAR = _basic(np.int8, "MPI_CHAR")
SIGNED_CHAR = _basic(np.int8, "MPI_SIGNED_CHAR")
UNSIGNED_CHAR = _basic(np.uint8, "MPI_UNSIGNED_CHAR")
SHORT = _basic(np.int16, "MPI_SHORT")
UNSIGNED_SHORT = _basic(np.uint16, "MPI_UNSIGNED_SHORT")
INT = _basic(np.int32, "MPI_INT")
UNSIGNED = _basic(np.uint32, "MPI_UNSIGNED")
LONG = _basic(np.int64, "MPI_LONG")
UNSIGNED_LONG = _basic(np.uint64, "MPI_UNSIGNED_LONG")
LONG_LONG = _basic(np.int64, "MPI_LONG_LONG")
FLOAT = _basic(np.float32, "MPI_FLOAT")
DOUBLE = _basic(np.float64, "MPI_DOUBLE")
# bfloat16: ml_dtypes' numpy type where the package is installed (the
# JAX package's basic); else a size-only type that carries a bfloat16
# tensor's datatype to the device channels, and that the host tier
# cannot fold
try:
    import ml_dtypes
    BFLOAT16 = _basic(np.dtype(ml_dtypes.bfloat16), "MPI_BFLOAT16")
except ImportError:  # pragma: no cover - depends on the installation
    BFLOAT16 = Datatype([(0, 2)], 2, 0, None, "MPI_BFLOAT16", True)
HALF = _basic(np.float16, "MPI_HALF")
C_BOOL = _basic(np.bool_, "MPI_C_BOOL")
INT8_T = _basic(np.int8, "MPI_INT8_T")
INT16_T = _basic(np.int16, "MPI_INT16_T")
INT32_T = _basic(np.int32, "MPI_INT32_T")
INT64_T = _basic(np.int64, "MPI_INT64_T")
UINT8_T = _basic(np.uint8, "MPI_UINT8_T")
UINT16_T = _basic(np.uint16, "MPI_UINT16_T")
UINT32_T = _basic(np.uint32, "MPI_UINT32_T")
UINT64_T = _basic(np.uint64, "MPI_UINT64_T")
AINT = _basic(np.int64, "MPI_AINT")
OFFSET = _basic(np.int64, "MPI_OFFSET")
COUNT = _basic(np.int64, "MPI_COUNT")
COMPLEX = _basic(np.complex64, "MPI_COMPLEX")
DOUBLE_COMPLEX = _basic(np.complex128, "MPI_DOUBLE_COMPLEX")

# pair types for MINLOC/MAXLOC. Layout matches the C structs
# (pairtype-size-extent.c): the type SIGNATURE covers val+loc (size),
# the EXTENT includes the struct's trailing alignment padding, and the
# numpy view dtype mirrors the aligned C layout so arrays built from
# .basic stride exactly like C arrays of the struct.
def _pair(val_np, loc_np, extent, name):
    v, l = np.dtype(val_np), np.dtype(loc_np)
    basic = np.dtype({"names": ["val", "loc"], "formats": [v, l],
                      "offsets": [0, v.itemsize], "itemsize": extent})
    return Datatype([(0, v.itemsize + l.itemsize)], extent, 0, basic,
                    name, True)


FLOAT_INT = _pair(np.float32, np.int32, 8, "MPI_FLOAT_INT")
DOUBLE_INT = _pair(np.float64, np.int32, 16, "MPI_DOUBLE_INT")
TWOINT = _pair(np.int32, np.int32, 8, "MPI_2INT")
LONG_INT = _pair(np.int64, np.int32, 16, "MPI_LONG_INT")
SHORT_INT = _pair(np.int16, np.int32, 8, "MPI_SHORT_INT")
if hasattr(np, "float128"):
    LONG_DOUBLE_INT = _pair(np.float128, np.int32, 32,
                            "MPI_LONG_DOUBLE_INT")

_NP_TO_MPI = {}
for _t in (BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, HALF, C_BOOL,
           UNSIGNED_SHORT, UNSIGNED, UNSIGNED_LONG, CHAR,
           COMPLEX, DOUBLE_COMPLEX):
    _NP_TO_MPI.setdefault(_t.basic, _t)
if BFLOAT16.basic is not None:
    _NP_TO_MPI.setdefault(BFLOAT16.basic, BFLOAT16)


def from_numpy_dtype(dt) -> Datatype:
    """The basic datatype of a numpy dtype, or of a ``torch.dtype``."""
    if not isinstance(dt, np.dtype) and type(dt).__module__ == "torch":
        return from_torch_dtype(dt)
    dt = np.dtype(dt)
    got = _NP_TO_MPI.get(dt)
    if got is None:
        # synthesize a basic type for any numpy dtype
        got = _basic(dt, f"MPI_<{dt.name}>")
        _NP_TO_MPI[dt] = got
    return got


_TORCH_TO_MPI = {}


def from_torch_dtype(tdt) -> Datatype:
    """The basic datatype of a tensor's dtype: its numpy counterpart's
    (bfloat16: ``BFLOAT16``), looked up once a dtype (every collective
    call on a tensor resolves one)."""
    got = _TORCH_TO_MPI.get(tdt)
    if got is None:
        import torch
        got = BFLOAT16 if tdt == torch.bfloat16 else from_numpy_dtype(
            torch.empty((), dtype=tdt).numpy().dtype)
        _TORCH_TO_MPI[tdt] = got
    return got


# ---------------------------------------------------------------------------
# Derived-type constructors (MPI-3.1 set; reference src/mpi/datatype/)
# ---------------------------------------------------------------------------

def _env(dt: Datatype, combiner: str, ints, aints, types) -> Datatype:
    dt._envelope = (combiner, list(ints), list(aints), list(types))
    return dt


def create_contiguous(count: int, oldtype: Datatype) -> Datatype:
    if oldtype.is_contiguous:
        # one span, any count — contig-of-contig must not materialize
        # count spans (bigtype.c: MPI_Type_contiguous(2^31-1, MPI_BYTE))
        spans = (np.array([[0, count * oldtype.size]], dtype=np.int64)
                 if count else np.empty((0, 2), dtype=np.int64))
    else:
        spans = _replicate_spans(oldtype.spans, count, oldtype.extent)
    # MPI-1 §3.12.3 bounds: lb/ub are the min/max of (disp + lb/ub)
    # over the replicas — NOT lb + count*extent — so marker-pinned
    # (sticky) bounds and negative extents tile correctly
    # (datatype/lbub.c negextent contig: lb -12, extent 9)
    if count > 0:
        tail = (count - 1) * oldtype.extent
        lb = oldtype.lb + min(0, tail)
        extent = oldtype.ub + max(0, tail) - lb
    else:
        lb, extent = oldtype.lb, 0
    return _env(
        Datatype(spans, extent, lb, oldtype.basic,
                 f"contig({count},{oldtype.name})"),
        "contiguous", [count], [], [oldtype])


def create_vector(count: int, blocklength: int, stride: int,
                  oldtype: Datatype) -> Datatype:
    """stride in elements of oldtype (MPI_Type_vector)."""
    return _env(create_hvector(count, blocklength,
                               stride * oldtype.extent, oldtype),
                "vector", [count, blocklength, stride], [], [oldtype])


def create_hvector(count: int, blocklength: int, stride_bytes: int,
                   oldtype: Datatype) -> Datatype:
    if oldtype.is_contiguous and count > 16 and stride_bytes >= 0:
        # vectorized fast path: one span per block (the MTest vector
        # generators build 64k-block vectors); bounds use the SAME
        # §3.12.3 min/max rule as the generic path below — a
        # contiguous oldtype can still carry a resized (sticky) lb
        starts = (np.arange(count, dtype=np.int64)
                  * stride_bytes).tolist()
        ln = blocklength * oldtype.size
        spans = [(s, ln) for s in starts]
        lb = oldtype.lb
        extent = (oldtype.ub + (blocklength - 1) * oldtype.extent
                  + (count - 1) * stride_bytes) - lb
        return _env(
            Datatype(spans, extent, lb, oldtype.basic,
                     f"hvector({count},{blocklength},{stride_bytes})"),
            "hvector", [count, blocklength], [stride_bytes], [oldtype])
    # a block of a contiguous oldtype is ONE span — never materialize
    # blocklength spans (bigtype.c builds 2^29-element blocks)
    block = (np.array([[0, blocklength * oldtype.size]], dtype=np.int64)
             if oldtype.is_contiguous else
             _replicate_spans(oldtype.spans, blocklength, oldtype.extent))
    spans = _replicate_spans(block, count, stride_bytes)
    # spans stay in typemap (declaration) order — MPI serializes blocks
    # in declared order, which matters when stride < blocklength (the
    # blocks overlap, e.g. hvector stride 0 = N replicas of one block)
    #
    # bounds via the MPI-1 §3.12.3 min/max rule over the element
    # displacements b*stride + i*extent (both ranges independent), so
    # sticky lb/ub, negative strides, and negative extents all land
    # where datatype/lbub.c expects
    if count > 0 and blocklength > 0:
        tail_i = (blocklength - 1) * oldtype.extent
        tail_b = (count - 1) * stride_bytes
        lb = oldtype.lb + min(0, tail_i) + min(0, tail_b)
        extent = (oldtype.ub + max(0, tail_i) + max(0, tail_b)) - lb
    else:
        lb, extent = 0, 0
    return _env(
        Datatype(spans, extent, lb,
                 oldtype.basic,
                 f"hvector({count},{blocklength},{stride_bytes})"),
        "hvector", [count, blocklength], [stride_bytes], [oldtype])


def create_indexed(blocklengths: Sequence[int], displacements: Sequence[int],
                   oldtype: Datatype) -> Datatype:
    """displacements in elements of oldtype (MPI_Type_indexed)."""
    disp_b = [d * oldtype.extent for d in displacements]
    return _env(create_hindexed(blocklengths, disp_b, oldtype),
                "indexed",
                [len(blocklengths)] + list(blocklengths)
                + list(displacements), [], [oldtype])


def create_hindexed(blocklengths: Sequence[int], disp_bytes: Sequence[int],
                    oldtype: Datatype) -> Datatype:
    mpi_assert(len(blocklengths) == len(disp_bytes), MPI_ERR_ARG,
               "blocklengths/displacements length mismatch")
    if oldtype.is_contiguous and len(blocklengths) > 16:
        # fast path: each block is ONE span (bl * size bytes at disp) —
        # vectorized; the generic path below materializes bl spans per
        # block, quadratic-ish for the MTest generators' 64k-block types
        bls = np.asarray(blocklengths, dtype=np.int64)
        dps = np.asarray(disp_bytes, dtype=np.int64)
        # typemap (declaration) order — MPI_Pack serializes blocks in
        # the order they were declared, not by address
        spans = list(zip(dps.tolist(), (bls * oldtype.size).tolist()))
        # §3.12.3 min/max bounds, vectorized (same rule as the generic
        # path — contiguous oldtypes can carry sticky resized lb; a
        # contiguous oldtype's extent is its size, so block tails are
        # non-negative and the per-block min(0, tail) term vanishes)
        real = bls > 0
        if bool(real.any()):
            lb = int(dps[real].min()) + oldtype.lb
            extent = int((dps[real] + (bls[real] - 1) * oldtype.extent)
                         .max()) + oldtype.ub - lb
        else:
            lb, extent = 0, 0
        return _env(
            Datatype(spans, extent, lb,
                     oldtype.basic, f"hindexed({len(blocklengths)})"),
            "hindexed", [len(blocklengths)] + list(blocklengths),
            list(disp_bytes), [oldtype])
    parts = [
        (np.array([[disp, bl * oldtype.size]], dtype=np.int64)
         if oldtype.is_contiguous else
         _replicate_spans(oldtype.spans, bl, oldtype.extent)
         + np.array([disp, 0], dtype=np.int64))
        for bl, disp in zip(blocklengths, disp_bytes) if bl
    ]
    spans = (np.concatenate(parts)
             if parts else np.empty((0, 2), dtype=np.int64))
    # bounds (MPI-1 §3.12.3): lb/ub = min/max over blocks of
    # (disp + old.lb/ub + the block's extent-tiling tail) — NOT 0 —
    # honoring sticky bounds and negative extents/displacements
    lbs = [d + oldtype.lb + min(0, (bl - 1) * oldtype.extent)
           for bl, d in zip(blocklengths, disp_bytes) if bl > 0]
    ubs = [d + oldtype.ub + max(0, (bl - 1) * oldtype.extent)
           for bl, d in zip(blocklengths, disp_bytes) if bl > 0]
    lb = min(lbs, default=0)
    extent = max(ubs, default=0) - lb if lbs else 0
    return _env(
        Datatype(spans, extent, lb,
                 oldtype.basic, f"hindexed({len(blocklengths)})"),
        "hindexed", [len(blocklengths)] + list(blocklengths),
        list(disp_bytes), [oldtype])


def create_indexed_block(blocklength: int, displacements: Sequence[int],
                         oldtype: Datatype) -> Datatype:
    return _env(
        create_indexed([blocklength] * len(displacements), displacements,
                       oldtype),
        "indexed_block",
        [len(displacements), blocklength] + list(displacements), [],
        [oldtype])


def create_struct(blocklengths: Sequence[int], disp_bytes: Sequence[int],
                  types: Sequence[Datatype]) -> Datatype:
    mpi_assert(len(blocklengths) == len(disp_bytes) == len(types),
               MPI_ERR_ARG, "struct arg length mismatch")
    parts = []
    basics = set()
    for bl, disp, t in zip(blocklengths, disp_bytes, types):
        basics.add(t.basic)
        if t.is_contiguous:
            # one span per member block regardless of blocklength —
            # the MTest struct generators use 64k-element blocks
            parts.append(np.array([[disp, bl * t.size]], dtype=np.int64))
            continue
        parts.append(_replicate_spans(t.spans, bl, t.extent)
                     + np.array([disp, 0], dtype=np.int64))
    spans = (np.concatenate(parts)
             if parts else np.empty((0, 2), dtype=np.int64))
    basic = basics.pop() if len(basics) == 1 else None
    # natural bounds over the real (nonzero-count) members: a member of
    # blocklength bl spans [d + t.lb, d + (bl-1)*t.extent + t.ub]
    real = [(d, bl, t) for d, bl, t
            in zip(disp_bytes, blocklengths, types) if bl > 0]
    min_lb = min((d + t.lb + min(0, (bl - 1) * t.extent)
                  for d, bl, t in real), default=0)
    max_ub = max((d + t.ub + max(0, (bl - 1) * t.extent)
                  for d, bl, t in real), default=0)
    # alignment epsilon (MPI-3.1 §4.1.6 advice / the MPICH rule): the
    # extent is padded to the strictest member alignment, so an array
    # of the type strides like the corresponding C struct
    # (structpack2.c compares extent against sizeof)
    align = 1
    for _, _, t in real:
        b = t.basic
        a = b.alignment if b is not None and hasattr(b, "alignment") \
            else 8
        align = max(align, a)
    extent = max_ub - min_lb
    extent += (-extent) % align
    return _env(
        Datatype(spans, extent, min_lb, basic,
                 f"struct({len(types)})"),
        "struct", [len(types)] + list(blocklengths), list(disp_bytes),
        list(types))


def create_subarray(sizes: Sequence[int], subsizes: Sequence[int],
                    starts: Sequence[int], oldtype: Datatype,
                    order: str = "C") -> Datatype:
    """MPI_Type_create_subarray (C order or Fortran order)."""
    orig = (list(sizes), list(subsizes), list(starts))
    ndim = len(sizes)
    mpi_assert(len(subsizes) == ndim and len(starts) == ndim, MPI_ERR_ARG,
               "subarray dims mismatch")
    if order == "F":
        sizes, subsizes, starts = (list(reversed(sizes)),
                                   list(reversed(subsizes)),
                                   list(reversed(starts)))
    # strides in elements, C order
    strides = [1] * ndim
    for i in range(ndim - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    spans: List[Span] = []
    nrows = 1
    for s in subsizes[:-1]:
        nrows *= s
    if oldtype.is_contiguous and nrows * subsizes[-1] > 64:
        # vectorized: one span per innermost row; row-start element
        # offsets built by broadcasting over the outer dimensions
        # (row-major, so the result is already sorted)
        offs = np.zeros(1, dtype=np.int64)
        for d in range(ndim - 1):
            o_d = ((starts[d] + np.arange(subsizes[d], dtype=np.int64))
                   * strides[d])
            offs = (offs[:, None] + o_d[None, :]).reshape(-1)
        offs = (offs + starts[-1]) * oldtype.extent
        row_len = subsizes[-1] * oldtype.size
        spans = [(int(o), row_len) for o in offs.tolist()]
    else:
        def rec(dim: int, elem_off: int):
            if dim == ndim - 1:
                base = (elem_off + starts[dim]) * oldtype.extent
                for j in range(subsizes[dim]):
                    b2 = base + j * oldtype.extent
                    spans.extend((b2 + o, l) for o, l in oldtype.spans)
                return
            for j in range(subsizes[dim]):
                rec(dim + 1, elem_off + (starts[dim] + j) * strides[dim])

        rec(0, 0)
        spans = sorted(spans)
    total = 1
    for s in sizes:
        total *= s
    return _env(
        Datatype(spans, total * oldtype.extent, 0, oldtype.basic,
                 f"subarray{tuple(subsizes)}"),
        "subarray", [ndim] + orig[0] + orig[1] + orig[2]
        + [0 if order == "C" else 1], [], [oldtype])


# HPF distribution codes (values match mpi.h / the MPI standard)
DISTRIBUTE_BLOCK = 121
DISTRIBUTE_CYCLIC = 122
DISTRIBUTE_NONE = 123
DISTRIBUTE_DFLT_DARG = -49767


def create_darray(size: int, rank: int, gsizes: Sequence[int],
                  distribs: Sequence[int], dargs: Sequence[int],
                  psizes: Sequence[int], oldtype: Datatype,
                  order: str = "C") -> Datatype:
    """MPI_Type_create_darray (MPI-3.1 §4.1.4): this rank's share of an
    HPF block/cyclic-distributed global array. The local global-index
    set is computed per dimension with vectorized index arithmetic and
    emitted directly as ascending byte spans (the constructor merges
    abutting runs)."""
    ndim = len(gsizes)
    mpi_assert(len(distribs) == ndim and len(dargs) == ndim
               and len(psizes) == ndim, MPI_ERR_ARG,
               "darray dims mismatch")
    orig = (list(gsizes), list(distribs), list(dargs), list(psizes))
    # process-grid coordinates: row-major over the ORIGINAL dim order
    # (§4.1.4 — "as in the case of virtual Cartesian process topologies")
    procs, tmp = 1, rank
    for p in psizes:
        procs *= p
    mpi_assert(procs == size, MPI_ERR_ARG,
               f"psizes product {procs} != size {size}")
    coords = []
    for p in psizes:
        procs //= p
        coords.append(tmp // procs)
        tmp %= procs
    gsizes, distribs, dargs, psizes = (list(gsizes), list(distribs),
                                       list(dargs), list(psizes))
    if order == "F":
        gsizes.reverse(); distribs.reverse(); dargs.reverse()
        psizes.reverse(); coords.reverse()
    # per-dim sorted local global indices
    idx: List[np.ndarray] = []
    for d in range(ndim):
        g, p, c = gsizes[d], psizes[d], coords[d]
        dist, darg = distribs[d], dargs[d]
        if dist == DISTRIBUTE_NONE:
            mpi_assert(p == 1, MPI_ERR_ARG,
                       "DISTRIBUTE_NONE needs psize 1")
            ii = np.arange(g, dtype=np.int64)
        elif dist == DISTRIBUTE_BLOCK:
            b = darg if darg != DISTRIBUTE_DFLT_DARG else -(-g // p)
            mpi_assert(b > 0 and b * p >= g, MPI_ERR_ARG,
                       f"block darg {b} too small for gsize {g}/np {p}")
            ii = np.arange(b * c, min(b * c + b, g), dtype=np.int64)
        else:   # DISTRIBUTE_CYCLIC
            b = darg if darg != DISTRIBUTE_DFLT_DARG else 1
            mpi_assert(b > 0, MPI_ERR_ARG, f"bad cyclic darg {b}")
            starts_ = np.arange(c * b, g, p * b, dtype=np.int64)
            ii = (starts_[:, None]
                  + np.arange(b, dtype=np.int64)[None, :]).reshape(-1)
            ii = ii[ii < g]
        idx.append(ii)
    # element strides, C order (innermost dim contiguous)
    strides = [1] * ndim
    for i in range(ndim - 2, -1, -1):
        strides[i] = strides[i + 1] * gsizes[i + 1]
    offs = np.zeros(1, np.int64)
    for d in range(ndim - 1):
        offs = (offs[:, None] + (idx[d] * strides[d])[None, :]).reshape(-1)
    flat = (offs[:, None] + idx[ndim - 1][None, :]).reshape(-1)
    base = flat * oldtype.extent
    if oldtype.is_contiguous:
        spans = np.stack([base, np.full(len(base), oldtype.size,
                                        np.int64)], axis=1)
    else:
        sp = np.asarray(oldtype.spans, np.int64).reshape(-1, 2)
        spans = np.stack(
            [(base[:, None] + sp[None, :, 0]).reshape(-1),
             np.tile(sp[:, 1], len(base))], axis=1)
    total = 1
    for g in gsizes:
        total *= g
    return _env(
        Datatype(spans, total * oldtype.extent, 0, oldtype.basic,
                 f"darray(r{rank}/{size})"),
        "darray", [size, rank, ndim] + orig[0] + orig[1] + orig[2]
        + orig[3] + [0 if order == "C" else 1], [], [oldtype])


def create_resized(oldtype: Datatype, lb: int, extent: int) -> Datatype:
    return _env(
        Datatype(oldtype.spans, extent, lb, oldtype.basic,
                 f"resized({oldtype.name})"),
        "resized", [], [lb, extent], [oldtype])


