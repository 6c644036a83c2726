"""Pairwise-permutation alltoall(v) over ``p`` virtual ranks of one GPU,
and its tier dispatch (counterpart of
``mvapich2_tpu/ops/pallas_alltoall.py``): the MoE dispatch/combine lane.

Two kernels, written in CUDA C++ in ``csrc/ring.cu``:

``hbm_alltoall`` (K10): the uniform alltoall. Rank r's input is ``p``
blocks of ``c`` elements (block j for rank j); its output is ``p``
blocks, block j from rank j.

``hbm_alltoallv`` (K11): the variable-count alltoall under a static
``p x p`` count matrix (``counts[r][j]``: elements rank r sends rank j),
with the packed layout of :func:`packed_displs` unless displacements are
given. Each rank's input is its own packed payload, read in place at its
own length.

Neither has a schedule on one card: every pair is one copy from its
sender's payload into its receiver's output, so K11 is one direct pass
with no landing slot and no credit over a table of tiles
(:func:`tile_table`: every non-empty pair cut into tiles of at most
``TILE_BYTES``), built once per device, count matrix and displacements.
K10 is K11's kernel over the uniform plan (:func:`uniform_plan`: every
count ``c``, the packed displacements), whose table is built once per
device, ``p``, ``c`` and element size. ``chunk_bytes``, ``depth`` and
``bidirectional`` order the TPU schedule's transfers (the JAX kernels'
chunks, landing slots and lanes) and never the result, so both wrappers
take them for the JAX signature and they shape nothing.

Routing is ``ops/ring.py``'s: CPU tensors take the plain version, CUDA
tensors launch the kernel on the current stream or raise; ``LAUNCHES``
and ``PLAIN_CALLS`` count each. ``ici_all_to_all`` / ``ici_all_to_allv``
pick the tier (:func:`planned_a2a_tier`): the kernels, or the stock torch
lowering past DEV_TIER_XLA_MIN or for a dtype the kernels do not move.
The dispatchers count nothing; the mesh channel counts each call. Each
drops an ``ici_alltoall`` / ``ici_alltoallv`` instant while
``trace.LOWERING`` holds a recorder (``ops/ici.py`` ``_trace_entry``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..trace import LOWERING
from . import ring
from .ici import _trace_entry, kernel_dtype
from .ring import Shards

LAUNCHES: Dict[str, int] = {"hbm_alltoall": 0, "hbm_alltoallv": 0}
PLAIN_CALLS: Dict[str, int] = {"hbm_alltoall": 0, "hbm_alltoallv": 0}

Matrix = Tuple[Tuple[int, ...], ...]


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# helpers (own copies of the JAX module's)
# ---------------------------------------------------------------------------

def _lane_steps(p: int, ndir: int) -> List[List[int]]:
    """Permutation steps 1..p-1 split across lanes: the first lane
    carries the near half, the second the far half."""
    steps = list(range(1, p))
    if ndir == 1:
        return [steps]
    h = (len(steps) + 1) // 2
    return [steps[:h], steps[h:]]


def packed_displs(counts: Sequence[Sequence[int]]
                  ) -> Tuple[Matrix, Matrix, int, int]:
    """Canonical packed layout of a count matrix: row-major send
    displacements, column-major receive displacements, and the padded
    per-rank buffer lengths (the mesh-wide maxima, at least 1)."""
    p = len(counts)
    sd, rd = [], []
    in_len = out_len = 1
    for r in range(p):
        row, col = [], []
        so = ro = 0
        for j in range(p):
            row.append(so)
            col.append(ro)
            so += counts[r][j]
            ro += counts[j][r]
        sd.append(tuple(row))
        rd.append(tuple(col))
        in_len = max(in_len, so)
        out_len = max(out_len, ro)
    return tuple(sd), tuple(rd), in_len, out_len


def planned_a2a_tier(shard_nbytes: int, dtype: torch.dtype
                     ) -> Tuple[str, Optional[str]]:
    """(tier, fallback_reason) for one alltoall(v) call: 'hbm' (the
    kernels) or 'xla' (the stock lowering) with the dev_coll_fallback_*
    reason. The generic device tier collapses onto the one kernel tier:
    'vmem' and 'quant' read as 'hbm' (so MV2T_QUANT_COLL sends
    alltoall to the kernels, as in the JAX package)."""
    if not kernel_dtype(dtype):
        return "xla", "dtype"
    if shard_nbytes <= 0:
        return "xla", "shape"
    from ..coll.tuning import device_tier
    if device_tier("alltoall", shard_nbytes) == "xla":
        return "xla", "size"
    return "hbm", None


def _matrix(m: Sequence[Sequence[int]], p: int, what: str) -> Matrix:
    out = tuple(tuple(int(v) for v in row) for row in m)
    if len(out) != p or any(len(row) != p for row in out):
        raise ValueError(f"{what}: expected a {p} x {p} matrix")
    if any(v < 0 for row in out for v in row):
        raise ValueError(f"{what}: negative entry")
    return out


def _v_shards(xs: Sequence[torch.Tensor], what: str) -> List[torch.Tensor]:
    """The ``p`` per-rank payloads (a list, or the rows of a ``(p, n)``
    tensor) as flat tensors of one dtype and device (their lengths may
    differ)."""
    shards = [x.reshape(-1) for x in xs]
    if not shards:
        raise ValueError(f"{what}: no shards")
    dt, dev = shards[0].dtype, shards[0].device
    if any(s.dtype != dt or s.device != dev for s in shards):
        raise ValueError(f"{what}: shards differ in dtype or device")
    return shards


class _VPlan:
    """One alltoallv call resolved: the count matrix, both displacement
    tables and each rank's output length (its own receive extent, or
    ``out_len`` for all)."""

    def __init__(self, shards, counts, sdispls, rdispls, out_len, what):
        p = len(shards)
        self.p = p
        self.counts = _matrix(counts, p, f"{what} counts")
        csd, crd, _, _ = packed_displs(self.counts)
        self.sd = csd if sdispls is None else _matrix(sdispls, p,
                                                      f"{what} sdispls")
        self.rd = crd if rdispls is None else _matrix(rdispls, p,
                                                      f"{what} rdispls")
        for r in range(p):
            need = max((self.sd[r][j] + self.counts[r][j]
                        for j in range(p) if self.counts[r][j]), default=0)
            if shards[r].numel() < need:
                raise ValueError(f"{what}: rank {r}'s payload has "
                                 f"{shards[r].numel()} elements; its sends "
                                 f"need {need}")
        ext = [max((self.rd[j][r] + self.counts[r][j]
                    for r in range(p) if self.counts[r][j]), default=0)
               for j in range(p)]
        if rdispls is not None:
            # MPI requires disjoint receive ranges; K11's tiles store in
            # no set order, so an overlap would have no defined result
            for j in range(p):
                spans = sorted((self.rd[j][r], self.rd[j][r] +
                                self.counts[r][j])
                               for r in range(p) if self.counts[r][j])
                if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
                    raise ValueError(f"{what}: rank {j}'s receive ranges "
                                     f"overlap")
        if out_len is not None and out_len < max(ext):
            raise ValueError(f"{what}: out_len {out_len} is shorter than a "
                             f"receive extent ({max(ext)})")
        self.lens = ext if out_len is None else [int(out_len)] * p
        # packed receives cover their extent; anything else is zeroed
        self.zero = rdispls is not None or out_len is not None
        self.total = sum(map(sum, self.counts))

    def outputs(self, like: torch.Tensor) -> List[torch.Tensor]:
        make = torch.zeros if self.zero else torch.empty
        return [make(n, dtype=like.dtype, device=like.device)
                for n in self.lens]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _block_transpose(shards: List[torch.Tensor]) -> torch.Tensor:
    p, n = len(shards), shards[0].numel()
    return torch.stack(shards).reshape(p, p, n // p).transpose(0, 1) \
        .reshape(p, n)


def hbm_alltoall_ref(xs: Shards) -> torch.Tensor:
    """Plain version of K10: the block transpose, row r's block j is
    shard j's block r; returns ``(p, n)``."""
    return _block_transpose(ring.as_shards(xs, "hbm_alltoall"))


def hbm_alltoallv_ref(xs: Sequence[torch.Tensor],
                      counts: Sequence[Sequence[int]], *,
                      sdispls=None, rdispls=None,
                      out_len: Optional[int] = None) -> List[torch.Tensor]:
    """Plain version of K11: each ``(r -> j)`` payload copied to
    ``rdispls[j][r]`` of rank j's output; returns one tensor per rank."""
    shards = _v_shards(xs, "hbm_alltoallv")
    plan = _VPlan(shards, counts, sdispls, rdispls, out_len,
                  "hbm_alltoallv")
    return _copy_pairs(shards, plan)


def _copy_pairs(shards, plan: _VPlan) -> List[torch.Tensor]:
    outs = plan.outputs(shards[0])
    for r in range(plan.p):
        for j in range(plan.p):
            cnt = plan.counts[r][j]
            if cnt:
                src = plan.sd[r][j]
                dst = plan.rd[j][r]
                outs[j][dst:dst + cnt] = shards[r][src:src + cnt]
    return outs


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

# K11's tiles: at most TILE_BYTES of one pair each (a multiple of 16, so
# every tile of a pair whose offsets are whole 16-byte words is whole
# words too); chosen by the tile sweep of ``chip_smoke.py --sweep``
# (PERF.md)
TILE_BYTES = 128 * 1024

# K11's tile tables on the card, per (device, matrix, displacements,
# element size, tile bytes): built once, as the JAX package compiles one
# program per count matrix; each with the event after its upload
_TABLES: "OrderedDict[tuple, Tuple[torch.Tensor, torch.cuda.Event]]" = \
    OrderedDict()
_TABLES_MAX = 64


def tile_table(plan: _VPlan, esize: int,
               tile_bytes: int = TILE_BYTES) -> List[Tuple[int, ...]]:
    """K11's tiles: every non-empty ``(r -> j)`` pair, the diagonal one
    included, cut into runs of at most ``tile_bytes // esize`` elements,
    in pair order. A row is (source rank, source offset, destination
    rank, destination offset, length, vec), in elements; vec is 1 when
    both offsets and the length are whole 16-byte words (the kernel's
    word path, taken when the call's pointers are aligned too)."""
    step = max(1, tile_bytes // esize)
    rows = []
    for r in range(plan.p):
        for j in range(plan.p):
            cnt, s0, d0 = plan.counts[r][j], plan.sd[r][j], plan.rd[j][r]
            for off in range(0, cnt, step):
                n = min(step, cnt - off)
                vec = all(v * esize % 16 == 0 for v in (s0 + off, d0 + off,
                                                         n))
                rows.append((r, s0 + off, j, d0 + off, n, int(vec)))
    return rows


def _tiles(dev: torch.device, plan: _VPlan, esize: int) -> torch.Tensor:
    """:func:`tile_table` as an int64 ``(ntiles, 6)`` tensor on ``dev``,
    from the cache, with the current stream ordered after its upload. A
    new table is copied from pinned memory without waiting for the card
    (the nonblocking collectives launch from a poll that must not wait);
    the event after the copy orders every later launch on any stream."""
    key = (str(dev), plan.counts, plan.sd, plan.rd, esize, TILE_BYTES)
    stream = torch.cuda.current_stream(dev)
    got = _TABLES.get(key)
    if got is not None:
        _TABLES.move_to_end(key)
    else:
        host = torch.tensor(tile_table(plan, esize), dtype=torch.int64)
        t = host.pin_memory().to(dev, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
        got = _TABLES[key] = (t, ready)
        if len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
    stream.wait_event(got[1])
    return got[0]


def uniform_plan(shards: List[torch.Tensor]) -> _VPlan:
    """K10's exchange as K11's plan: ``p`` shards of ``p*c`` elements,
    every count ``c``, the packed displacements (rank r's block j at
    ``j*c``, its output's block j from rank j at ``j*c``)."""
    p = len(shards)
    c = shards[0].numel() // p
    return _VPlan(shards, ((c,) * p,) * p, None, None, None, "hbm_alltoall")


def _copy_tiles(code: int, shards: List[torch.Tensor], plan: _VPlan,
                outs: List[torch.Tensor]) -> None:
    """Launch K11's kernel over ``plan``'s cached tile table, from the
    payloads ``shards`` into the outputs ``outs``."""
    dev = shards[0].device
    tiles = _tiles(dev, plan, shards[0].element_size())
    # a cached table may be evicted while this launch still reads it
    tiles.record_stream(torch.cuda.current_stream(dev))
    vec = ring.aligned(shards) and ring.aligned(outs)
    ring.launch("mv2t_hbm_alltoallv", dev, code, ring.pointers(shards),
                ring.pointers(outs), plan.p, tiles.data_ptr(),
                tiles.shape[0], int(vec), threads=ring.DIRECT_THREADS)


def hbm_alltoall(xs: Shards, *, chunk_bytes: Optional[int] = None,
                 depth: Optional[int] = None,
                 bidirectional: Optional[bool] = None) -> torch.Tensor:
    """K10: uniform alltoall of ``p`` shards of ``n = p*c`` elements, as
    K11's direct copy over :func:`uniform_plan`'s tile table. Returns
    ``(p, n)``, row r for rank r (block j from rank j). An empty shard,
    or ``p == 1``, returns the input rows; ``n % p`` raises
    ``ValueError``. ``chunk_bytes``, ``depth`` and ``bidirectional``
    shape nothing (the module's docstring)."""
    shards = ring.as_shards(xs, "hbm_alltoall")
    p, n = len(shards), shards[0].numel()
    if p == 1 or n == 0:
        return torch.stack(shards)
    if n % p:
        raise ValueError(f"alltoall shard size {n} not divisible by {p}")
    if ring.on_cpu(shards):
        PLAIN_CALLS["hbm_alltoall"] += 1
        return _block_transpose(shards)
    code = ring.check_cuda_shards(shards, "hbm_alltoall")
    out = torch.empty((p, n), dtype=shards[0].dtype,
                      device=shards[0].device)
    _copy_tiles(code, shards, uniform_plan(shards), list(out.unbind(0)))
    LAUNCHES["hbm_alltoall"] += 1
    return out


def hbm_alltoallv(xs: Sequence[torch.Tensor],
                  counts: Sequence[Sequence[int]], *,
                  sdispls=None, rdispls=None, out_len: Optional[int] = None,
                  chunk_bytes: Optional[int] = None,
                  depth: Optional[int] = None,
                  bidirectional: Optional[bool] = None
                  ) -> List[torch.Tensor]:
    """K11: variable-count alltoall. ``xs``: each rank's payload (its
    own length, read in place); ``counts[r][j]``: elements rank r sends
    rank j; displacements default to :func:`packed_displs`'s, and
    explicit receive ranges must not overlap. Returns one tensor per
    rank, of its own receive extent (or ``out_len``), rank j's payload
    from r at ``rdispls[j][r]``. ``p == 1`` returns the payload's
    prefix; a matrix of zeros takes the stock lowering, as in the JAX
    wrapper. ``chunk_bytes``, ``depth`` and ``bidirectional`` shape
    nothing (the module's docstring)."""
    shards = _v_shards(xs, "hbm_alltoallv")
    plan = _VPlan(shards, counts, sdispls, rdispls, out_len, "hbm_alltoallv")
    p = plan.p
    if p == 1:
        return [shards[0][:plan.lens[0]].clone()]
    if plan.total == 0:
        return _stock_all_to_allv(shards, plan)
    if ring.on_cpu(shards):
        PLAIN_CALLS["hbm_alltoallv"] += 1
        return _copy_pairs(shards, plan)
    code = ring.check_cuda_shards(shards, "hbm_alltoallv")
    outs = plan.outputs(shards[0])
    _copy_tiles(code, shards, plan, outs)
    LAUNCHES["hbm_alltoallv"] += 1
    return outs


# ---------------------------------------------------------------------------
# tier dispatch and the stock lowerings
# ---------------------------------------------------------------------------

def _stock_all_to_allv(shards, plan: _VPlan) -> List[torch.Tensor]:
    """The stock lowering of alltoallv (counterpart of the JAX
    ``_xla_alltoallv``): one gather of every received element from the
    concatenated payloads by index, per rank."""
    dev = shards[0].device
    flat = torch.cat(shards)
    base = [0]
    for s in shards[:-1]:
        base.append(base[-1] + s.numel())
    outs = plan.outputs(shards[0])
    for j in range(plan.p):
        src, dst = [], []
        for r in range(plan.p):
            cnt = plan.counts[r][j]
            if cnt:
                src.append(torch.arange(cnt, device=dev) + base[r]
                           + plan.sd[r][j])
                dst.append(torch.arange(cnt, device=dev) + plan.rd[j][r])
        if src:
            outs[j].index_copy_(0, torch.cat(dst),
                                flat.index_select(0, torch.cat(src)))
    return outs


def stock_all_to_all(xs: Shards) -> torch.Tensor:
    """The stock lowering of the uniform alltoall, the block transpose
    (what a multi-axis mesh runs, as the JAX program lowers it through
    XLA there). Returns ``(p, p*c)``."""
    return _block_transpose(ring.as_shards(xs, "stock_all_to_all"))


def stock_all_to_allv(xs: Sequence[torch.Tensor],
                      counts: Sequence[Sequence[int]], *,
                      out_len: Optional[int] = None) -> List[torch.Tensor]:
    """The stock lowering of alltoallv over the packed layout; one
    tensor per rank."""
    shards = _v_shards(xs, "stock_all_to_allv")
    return _stock_all_to_allv(
        shards, _VPlan(shards, counts, None, None, out_len,
                       "stock_all_to_allv"))


def ici_all_to_all(xs: Shards) -> torch.Tensor:
    """Tier-dispatched uniform alltoall of ``p`` shards of ``p*c``
    elements: K10, or the stock block transpose past DEV_TIER_XLA_MIN or
    for a dtype the kernel does not move. Returns ``(p, p*c)``, one row
    per rank."""
    shards = ring.as_shards(xs, "ici_all_to_all")
    p, n = len(shards), shards[0].numel()
    if p == 1:
        return shards[0].reshape(1, n).clone()
    nbytes = n * shards[0].element_size()
    tier, _ = planned_a2a_tier(nbytes, shards[0].dtype)
    if LOWERING.rec is not None:
        _trace_entry("alltoall", tier, nbytes)
    if tier == "hbm":
        return hbm_alltoall(shards)
    return _block_transpose(shards)


def ici_all_to_allv(xs: Sequence[torch.Tensor],
                    counts: Sequence[Sequence[int]], *,
                    out_len: Optional[int] = None) -> List[torch.Tensor]:
    """Tier-dispatched variable-count alltoall over the packed layout.
    The tier keys on the heaviest rank's send bytes (the wire the
    busiest expert must move). Returns one tensor per rank."""
    shards = _v_shards(xs, "ici_all_to_allv")
    if len(shards) == 1:
        return hbm_alltoallv(shards, counts, out_len=out_len)
    nbytes = max(sum(row) for row in counts) * shards[0].element_size()
    tier, _ = planned_a2a_tier(max(1, nbytes), shards[0].dtype)
    if LOWERING.rec is not None:
        _trace_entry("alltoallv", tier, nbytes)
    if tier == "hbm":
        return hbm_alltoallv(shards, counts, out_len=out_len)
    return stock_all_to_allv(shards, counts, out_len=out_len)
