"""The HBM ring collectives over ``p`` virtual ranks of one GPU, the
device tier dispatch and the multi-axis mesh composition (counterpart of
``mvapich2_tpu/ops/pallas_ici.py``).

Four kernels, written in CUDA C++ in ``csrc/ring.cu``:

``hbm_ring_all_reduce`` (K3): the JAX kernel runs a reduce-scatter ring
then an all-gather ring over ``p`` blocks of ``nblk = ceil(n/p)``
elements (the shard padded with the op's identity), streamed in chunks
through landing slots under credits, both ring directions at once when
``p > 2`` and ``ICI_BIDIR`` (the first half of every block clockwise,
the second counter-clockwise). Its result depends only on the fold
order, so on one card the kernel computes it directly: element ``i`` of
block ``b`` folds ``x[b+1], x[b+2], ..., x[b+p]`` (counter-clockwise
``x[b-1], ..., x[b-p]``) as ``red(x, acc)``, every partial rounded to
the dtype, and stores it into every rank's row, in one ordinary launch
with no slot, flag or wait (K6's kernel over ``lines`` rings, with the
op, the direction split and a short last block). sum, max, min and
prod.

``hbm_ring_reduce_scatter`` (K4): the reduce-scatter ring alone, ``[n]``
per rank to its block ``[ceil(n/p)]`` of the folded (identity-padded)
array. The ring leaves block ``b`` of K3's fold at rank ``b``, so on one
card K4 is K3's direct fold stored into that rank's row alone: the same
kernel loop with another store, and the identity in the padded tail of
the last block (the identity folded with itself), in one ordinary
launch with no slot, flag or wait.

``hbm_ring_all_gather`` (K5): the all-gather ring's result, ``[m]`` per
rank to ``[p*m]``. Its result does not depend on the schedule (every row
is the concatenation of the shards), so on one card it is one direct
copy with no landing slot and no credit: K7's kernel
(``ops/ring.py``) over ``lines`` rings, each word of each shard read
once and stored into every row of its ring.

``remote_sendrecv`` (K8): shards ``src`` and ``dst`` swap, every other
rank keeps its own (MPI_Sendrecv's exchange); the JAX package has no
caller for it. On one card it is ``p`` row copies, which the kernel
hands to the copy engine: bulk tiles through a ring of shared-memory
stages, one elected thread a block, the rows cut by ``k8_plan``.

K3, K4 and K5 take ``lines``: ``lines * p`` shards ordered line-major
(rank i of line g is shard ``g*p + i``), run as that many independent
rings of ``p`` in one launch, one output row per shard in the same
order. That is one phase of a multi-axis mesh: ``ici_all_reduce_mesh``
(reduce-scatter down the axes, all-gather back up: RS-x, RS-y, AG-y,
AG-x, four launches on a 2-D mesh; below DEV_TIER_AXES_MIN a full
allreduce per axis instead), ``ici_all_gather_mesh`` and
``ici_reduce_scatter_mesh``. They take the ranks' shards in rank order
(row-major over the axes) and return one row per rank in rank order;
``_axis_phase`` regroups the rows into an axis's lines and back without
a copy. The port has no interpreter, so a phase under a multi-axis
``mesh_ctx`` takes the JAX package's hardware branch (``_mesh_mode``
"hw"): the resident and quant tiers clamp to the HBM ring, and only
DEV_TIER_XLA_MIN sends a phase to the stock lowering.

K3, K4, K5 and K8 use no landing slot and no credit; ``chunk_bytes``
and ``depth`` order the TPU rings' transfers and never their results,
so they shape nothing here (K3 and K4 still check them). Inputs and outputs
are as in ``ops/ring.py``, whose launch and replay machinery these
wrappers share.

``ici_all_reduce`` / ``ici_all_gather`` pick the tier by shard bytes
(``planned_tier``): the resident ring (K6/K7, ``ops/ring.py``) at or
below DEV_TIER_VMEM_MAX, the quantized ring (K9, ``ops/quant.py``) at or
above DEV_TIER_QUANT_MIN for a float sum allreduce whose MV2T_QUANT_COLL
budget covers its error bound, the HBM ring (K3, K5) otherwise, and the
stock torch reduction over the stacked shards (the port's analog of
``lax.psum``) past DEV_TIER_XLA_MIN or for an op or dtype the kernels do
not take. The mesh channel counts each call's tier or fallback in the
``dev_coll_tier_*`` / ``dev_coll_fallback_*`` pvars. ``LAUNCHES`` and
``PLAIN_CALLS`` count K3, K4, K5, K8 and K9 (``quant_ring_all_reduce``).

Trace: each dispatcher drops a ``device``-lane ``ici_<coll>`` instant
(``tier``, ``bytes``, ``op``) and each phase of the mesh composition an
``ici_axis_{rs,ag,ar}`` instant (``axis``, ``bytes``, ``op``) while
``trace.LOWERING`` holds a recorder: during the first call of a program a
device channel has just built, as the JAX package records them while it
traces a signature.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..coll.tuning import kernel_param
from ..trace import LOWERING
from ..utils.config import get_config
from . import ring
from .ring import Shards

_SUPPORTED_OPS = ("sum", "max", "min", "prod")

_KERNELS = ("hbm_ring_all_reduce", "hbm_ring_reduce_scatter",
            "hbm_ring_all_gather", "remote_sendrecv", "quant_ring_all_reduce")
LAUNCHES: Dict[str, int] = dict.fromkeys(_KERNELS, 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(_KERNELS, 0)
# K8's rows by how they were copied: by bulk tiles (source and output
# agree mod 16 bytes), or element by element whole
PATHS: Dict[str, int] = {"sendrecv_bulk_rows": 0,
                         "sendrecv_element_rows": 0}
K8_THREADS = 256             # csrc/ring.cu kK8Threads


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, PATHS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# helpers (own copies of the JAX module's)
# ---------------------------------------------------------------------------

def _cfg_chunk_elems(dtype: torch.dtype, chunk_bytes: Optional[int]) -> int:
    if chunk_bytes is None:
        chunk_bytes = int(get_config()["ICI_CHUNK_BYTES"])
    return max(1, int(chunk_bytes) // dtype.itemsize)


def _cfg_depth(depth: Optional[int]) -> int:
    if depth is None:
        depth = int(get_config()["ICI_PIPELINE_DEPTH"])
    return max(2, int(depth))


def _resolve_ndir(num_devices: int, bidirectional: Optional[bool]) -> int:
    if bidirectional is None:
        bidirectional = bool(get_config()["ICI_BIDIR"])
    return 2 if (bidirectional and num_devices > 2) else 1


def _pad_identity(dtype: torch.dtype, op: str):
    """The reduction identity: pad values that cannot perturb the result
    of the padded-tail elements."""
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        lo, hi = -float("inf"), float("inf")
    else:
        info = torch.iinfo(dtype)
        lo, hi = info.min, info.max
    return lo if op == "max" else hi


def _chunks(lo: int, hi: int, chunk: int) -> List[Tuple[int, int]]:
    """(offset, size) chunks covering [lo, hi); the last carries the
    remainder."""
    out = []
    off = lo
    while off < hi:
        out.append((off, min(chunk, hi - off)))
        off += chunk
    return out


def _block_spans(nblk: int, ndir: int) -> List[Tuple[int, int]]:
    """Element ranges of a block per direction: the clockwise lane
    carries the first half, counter-clockwise the second."""
    if ndir == 1:
        return [(0, nblk)]
    h = (nblk + 1) // 2
    return [(0, h), (h, nblk)]


def dtype_kind(dtype: torch.dtype) -> str:
    """numpy kind letter of a torch dtype, as the JAX package reads it:
    bfloat16 is ml_dtypes' kind 'V' there, so every tier decision made
    on the kind (the channel's eligibility, the planners) sends bf16
    where the JAX package does. The kernels themselves take bf16 when
    called directly, as the JAX kernels do."""
    if dtype.is_complex:
        return "c"
    if dtype == torch.bfloat16:
        return "V"
    if dtype.is_floating_point:
        return "f"
    if dtype == torch.bool:
        return "b"
    return "i" if dtype.is_signed else "u"


def planned_tier(name: str, shard_nbytes: int, dtype: torch.dtype,
                 op: Optional[str], num_devices: Optional[int] = None
                 ) -> Tuple[str, Optional[str]]:
    """(tier, fallback_reason) for one device collective call: tier is
    'vmem' | 'hbm' | 'quant' | 'xla'; the reason is None unless the
    stock lowering was taken, and then names the dev_coll_fallback_*
    bucket: size (at or past DEV_TIER_XLA_MIN), dtype (an op or dtype
    the kernels cannot reduce), shape (an empty buffer). A call in the
    quant bin that ``quant_eligible`` rejects for ``num_devices`` ranks
    (not a float sum allreduce, or a budget below the declared bound)
    takes the exact 'hbm' tier."""
    if op is not None and op not in _SUPPORTED_OPS:
        return "xla", "dtype"
    if dtype_kind(dtype) not in "fiu":
        return "xla", "dtype"
    if shard_nbytes <= 0:
        return "xla", "shape"
    from ..coll.tuning import device_tier
    tier = device_tier(name, shard_nbytes)
    if tier == "quant":
        from .quant import quant_eligible
        if not quant_eligible(name, dtype, op, num_devices):
            tier = "hbm"
    if tier == "xla":
        return "xla", "size"
    return tier, None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _padded(shards: List[torch.Tensor], op: str) -> Tuple[torch.Tensor, int]:
    """(p, n_pad) stack of the shards (``ring.widened``) padded with the
    op identity of their own dtype to p blocks; returns it and nblk. The
    identity is the shard dtype's, not the widened one's: ``pad`` takes
    its value through a double, where int64's 2^63 - 1 does not fit."""
    p, n = len(shards), shards[0].numel()
    nblk = -(-n // p)
    x = torch.stack(ring.widened(shards))
    if nblk * p > n:
        x = torch.nn.functional.pad(x, (0, nblk * p - n),
                                    value=_pad_identity(shards[0].dtype, op))
    return x, nblk


def _line_size(shards: List[torch.Tensor], lines: int, what: str) -> int:
    """Ranks per line of ``lines`` rings over the shards."""
    lines = int(lines)
    if lines < 1 or len(shards) % lines:
        raise ValueError(f"{what}: {len(shards)} shards do not split into "
                         f"{lines} lines")
    return len(shards) // lines


def _per_line(shards: List[torch.Tensor], lines: int, what: str,
              fn) -> torch.Tensor:
    """``fn`` on each line's ``p`` shards, the rows stacked line-major."""
    p = _line_size(shards, lines, what)
    if lines == 1:
        return fn(shards)
    return torch.cat([fn(shards[g * p:(g + 1) * p]) for g in range(lines)])


def _k3_replay(shards, op, bidirectional):
    p, n, dt = len(shards), shards[0].numel(), shards[0].dtype
    x, nblk = _padded(shards, op)
    o = x.reshape(p, p, nblk).clone()
    ring.ring_replay(o, _block_spans(nblk, _resolve_ndir(p, bidirectional)),
                     True, True, ring.reducer(op))
    return o.reshape(p, p * nblk)[:, :n].to(dt)


def hbm_ring_all_reduce_ref(xs: Shards, op: str = "sum", *,
                            bidirectional: Optional[bool] = None,
                            lines: int = 1) -> torch.Tensor:
    """Plain version of K3: the ring replayed block by block in the
    kernel's fold order, line by line; returns ``(lines*p, n)``.
    Chunking and depth reorder the kernel's transfers, never its
    arithmetic, so they are not parameters here."""
    shards = ring.as_shards(xs, "hbm_ring_all_reduce")
    return _per_line(shards, lines, "hbm_ring_all_reduce",
                     lambda sh: _k3_replay(sh, op, bidirectional))


def _k4_replay(shards, op, bidirectional):
    p, dt = len(shards), shards[0].dtype
    x, nblk = _padded(shards, op)
    o = x.reshape(p, p, nblk).clone()
    ring.ring_replay(o, _block_spans(nblk, _resolve_ndir(p, bidirectional)),
                     True, False, ring.reducer(op))
    ranks = torch.arange(p, device=o.device)
    return o[ranks, ranks].to(dt)


def hbm_ring_reduce_scatter_ref(xs: Shards, op: str = "sum", *,
                                bidirectional: Optional[bool] = None,
                                lines: int = 1) -> torch.Tensor:
    """Plain version of K4: the reduce-scatter half of the ring replayed
    in the kernel's fold order, line by line; row ``g*p + r`` is block
    ``r`` of line g's folded, identity-padded array, ``(lines*p,
    ceil(n/p))``."""
    shards = ring.as_shards(xs, "hbm_ring_reduce_scatter")
    return _per_line(shards, lines, "hbm_ring_reduce_scatter",
                     lambda sh: _k4_replay(sh, op, bidirectional))


def _k5_replay(shards, bidirectional):
    p, m, dt = len(shards), shards[0].numel(), shards[0].dtype
    shards = ring.widened(shards)
    o = torch.zeros((p, p, m), dtype=shards[0].dtype,
                    device=shards[0].device)
    for r in range(p):
        o[r, r] = shards[r]
    ring.ring_replay(o, _block_spans(m, _resolve_ndir(p, bidirectional)),
                     False, True)
    return o.reshape(p, p * m).to(dt)


def hbm_ring_all_gather_ref(xs: Shards, *,
                            bidirectional: Optional[bool] = None,
                            lines: int = 1) -> torch.Tensor:
    """Plain version of K5: the gather ring replayed, line by line;
    returns ``(lines*p, p*m)``."""
    shards = ring.as_shards(xs, "hbm_ring_all_gather")
    return _per_line(shards, lines, "hbm_ring_all_gather",
                     lambda sh: _k5_replay(sh, bidirectional))


def _trace_entry(coll: str, tier: str, nbytes: int, op=None) -> None:
    """The ``ici_<coll>`` instant of a dispatcher (the JAX package's
    ``_trace_entry``). Call sites test ``LOWERING.rec`` first: one
    attribute check while no program is being built."""
    LOWERING.rec.record("device", f"ici_{coll}", "i", tier=tier,
                        bytes=int(nbytes), op=op)


def _trace_axis(phase: str, axis: str, nbytes: int, op=None) -> None:
    """The ``ici_axis_<phase>`` instant of one phase of the multi-axis
    composition (the JAX package's ``_trace_axis``), under the same
    test."""
    LOWERING.rec.record("device", f"ici_axis_{phase}", "i", axis=axis,
                        bytes=int(nbytes), op=op)


def _partners(p: int, src: int, dst: int) -> List[int]:
    """Shard each rank receives: src and dst swap, the rest keep."""
    if not (0 <= src < p and 0 <= dst < p):
        raise ValueError(f"remote_sendrecv: src {src} / dst {dst} outside "
                         f"0..{p - 1}")
    part = list(range(p))
    part[src], part[dst] = dst, src
    return part


def k8_plan(from_addrs: List[int], to_addrs: List[int], nbytes: int,
            tile: int) -> Tuple[int, int, List[Optional[Tuple[int, int]]]]:
    """K8's cut of its rows (``csrc/ring.cu`` ``k8_cut``): row r copies
    ``nbytes`` from address ``from_addrs[r]`` to ``to_addrs[r]``. A row
    whose two addresses agree mod 16 goes by bulk tiles and is cut
    ``(head, mid)``: the bytes before the output's first 16-byte boundary
    (all of a row shorter than that), then whole 16-byte words; the
    tail, the rest, is under 16 bytes. Another row is ``None``: copied
    element by element whole. Returns the bulk rows' bit mask, the tiles
    of ``tile`` bytes a row (enough for any row's words) and the cuts."""
    cuts: List[Optional[Tuple[int, int]]] = []
    mask = 0
    for r, (f, t) in enumerate(zip(from_addrs, to_addrs)):
        if (f - t) % 16:
            cuts.append(None)
            continue
        head = min(nbytes, -t % 16)
        cuts.append((head, (nbytes - head) // 16 * 16))
        mask |= 1 << r
    return mask, -(-(nbytes // 16 * 16) // tile), cuts


def remote_sendrecv_ref(xs: Shards, src: int, dst: int) -> torch.Tensor:
    """Plain version of K8: an index gather of the stacked shards by
    partner; returns a fresh ``(p, n)``."""
    shards = ring.as_shards(xs, "remote_sendrecv")
    part = _partners(len(shards), src, dst)
    return torch.stack(shards)[torch.tensor(part, device=shards[0].device)]


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _fold_vec(shards, out, n, p, ndir) -> bool:
    """The word path of K3's and K4's fold: every shard and ``out`` (whose
    rows are then aligned too) 16-byte aligned, and ``n``, the block and
    (two directions) its half whole 16-byte words."""
    nblk, v = -(-n // p), 16 // out.element_size()
    return (ring.aligned(shards) and out.data_ptr() % 16 == 0
            and n % v == 0 and nblk % v == 0
            and (ndir == 1 or (nblk + 1) // 2 % v == 0))


def _check_op(op: str, what: str) -> None:
    if op not in _SUPPORTED_OPS:
        raise ValueError(f"{what}: op {op!r} (supported: "
                         f"{_SUPPORTED_OPS})")


def hbm_ring_all_reduce(xs: Shards, op: str = "sum", *,
                        chunk_bytes: Optional[int] = None,
                        depth: Optional[int] = None,
                        bidirectional: Optional[bool] = None,
                        lines: int = 1) -> torch.Tensor:
    """K3: allreduce of ``p`` shards of any length ``n``, the streaming
    ring's result (reduce-scatter + all-gather, in both ring directions
    when ``bidirectional`` resolves so) as one direct fold, on each of
    ``lines`` rings of ``p`` (shards line-major). Returns a contiguous
    ``(lines*p, n)``, one row per shard in the same order.
    ``bidirectional`` picks the fold order of the second half of every
    block, so it changes the result's bits; ``chunk_bytes`` and
    ``depth`` order the TPU ring's transfers and never its result, so
    they are checked and shape nothing here."""
    _check_op(op, "hbm_ring_all_reduce")
    shards = ring.as_shards(xs, "hbm_ring_all_reduce")
    p = _line_size(shards, lines, "hbm_ring_all_reduce")
    _cfg_chunk_elems(shards[0].dtype, chunk_bytes)
    _cfg_depth(depth)
    if ring.on_cpu(shards):
        PLAIN_CALLS["hbm_ring_all_reduce"] += 1
        return hbm_ring_all_reduce_ref(shards, op,
                                       bidirectional=bidirectional,
                                       lines=lines)
    code = ring.check_cuda_shards(shards, "hbm_ring_all_reduce")
    n = shards[0].numel()
    ndir = _resolve_ndir(p, bidirectional)
    out = torch.empty((len(shards), n), dtype=shards[0].dtype,
                      device=shards[0].device)
    ring.launch("mv2t_hbm_ring_all_reduce", out.device, code,
                ring.OP_CODES[op], ring.pointers(shards),
                ring.row_pointers(out), p, lines, n, ndir,
                int(_fold_vec(shards, out, n, p, ndir)),
                threads=ring.DIRECT_THREADS)
    LAUNCHES["hbm_ring_all_reduce"] += 1
    return out


def hbm_ring_reduce_scatter(xs: Shards, op: str = "sum", *,
                            chunk_bytes: Optional[int] = None,
                            depth: Optional[int] = None,
                            bidirectional: Optional[bool] = None,
                            lines: int = 1) -> torch.Tensor:
    """K4: reduce-scatter of ``p`` shards of any length ``n``, the
    reduce-scatter ring's result as K3's direct fold kept to each block's
    owner, on each of ``lines`` rings of ``p``. The shards are padded
    with the op's identity to ``p`` blocks of ``nblk = ceil(n/p)``; row
    ``g*p + r`` is block ``r`` of line g's folded array, ``(lines*p,
    nblk)``. ``bidirectional`` picks the fold order of the second half of
    every block; ``chunk_bytes`` and ``depth`` are checked and shape
    nothing, as K3's. With ``p == 1`` every shard is its own result (a
    copy, no launch)."""
    _check_op(op, "hbm_ring_reduce_scatter")
    shards = ring.as_shards(xs, "hbm_ring_reduce_scatter")
    p = _line_size(shards, lines, "hbm_ring_reduce_scatter")
    _cfg_chunk_elems(shards[0].dtype, chunk_bytes)
    _cfg_depth(depth)
    if p == 1:
        return torch.stack(shards)
    if ring.on_cpu(shards):
        PLAIN_CALLS["hbm_ring_reduce_scatter"] += 1
        return hbm_ring_reduce_scatter_ref(shards, op,
                                           bidirectional=bidirectional,
                                           lines=lines)
    code = ring.check_cuda_shards(shards, "hbm_ring_reduce_scatter")
    n = shards[0].numel()
    ndir = _resolve_ndir(p, bidirectional)
    out = torch.empty((len(shards), -(-n // p)), dtype=shards[0].dtype,
                      device=shards[0].device)
    ring.launch("mv2t_hbm_ring_reduce_scatter", out.device, code,
                ring.OP_CODES[op], ring.pointers(shards),
                ring.row_pointers(out), p, lines, n, ndir,
                int(_fold_vec(shards, out, n, p, ndir)),
                threads=ring.DIRECT_THREADS)
    LAUNCHES["hbm_ring_reduce_scatter"] += 1
    return out


def hbm_ring_all_gather(xs: Shards, *, chunk_bytes: Optional[int] = None,
                        depth: Optional[int] = None,
                        bidirectional: Optional[bool] = None,
                        lines: int = 1) -> torch.Tensor:
    """K5: all-gather of ``p`` shards of ``m`` elements, on each of
    ``lines`` rings of ``p``, as one direct copy. Returns
    ``(lines*p, p*m)``, one row per shard in the same order.
    ``chunk_bytes``, ``depth`` and ``bidirectional`` order the TPU ring's
    transfers and never its result, so on one card they shape nothing;
    they stay for the JAX signature."""
    shards = ring.as_shards(xs, "hbm_ring_all_gather")
    p = _line_size(shards, lines, "hbm_ring_all_gather")
    if ring.on_cpu(shards):
        PLAIN_CALLS["hbm_ring_all_gather"] += 1
        return hbm_ring_all_gather_ref(shards, bidirectional=bidirectional,
                                       lines=lines)
    code = ring.check_cuda_shards(shards, "hbm_ring_all_gather")
    m = shards[0].numel()
    out = torch.empty((len(shards), p * m), dtype=shards[0].dtype,
                      device=shards[0].device)
    ring.launch_direct("hbm_ring_all_gather", code, shards, out, m,
                       lines=lines)
    LAUNCHES["hbm_ring_all_gather"] += 1
    return out


def remote_sendrecv(xs: Shards, src: int, dst: int) -> torch.Tensor:
    """K8: shards ``src`` and ``dst`` swap, every other rank gets its own
    (MPI_Sendrecv's exchange, not ppermute's zero fill); a fresh
    ``(p, n)``, row r for rank r. ``src == dst`` or one rank: the shards
    as they are (a ``(p, n)`` tensor is returned itself), no launch. Any
    1-, 2- or 4-byte dtype, moved as its bits: the rows by bulk tiles on
    the copy engine where the shard and its output row agree mod 16 bytes
    (``k8_plan``), else element by element (``PATHS`` counts the rows of
    each)."""
    shards = ring.as_shards(xs, "remote_sendrecv")
    p = len(shards)
    part = _partners(p, src, dst)
    if p == 1 or src == dst:
        return xs if isinstance(xs, torch.Tensor) else torch.stack(shards)
    if ring.on_cpu(shards):
        PLAIN_CALLS["remote_sendrecv"] += 1
        return remote_sendrecv_ref(shards, src, dst)
    dev = shards[0].device
    if dev.type != "cuda":
        raise ValueError(f"remote_sendrecv: tensors on {dev}; the kernel "
                         f"takes CUDA tensors")
    esize = shards[0].element_size()
    if esize not in (1, 2, 4) or p > ring.MAX_RANKS or \
            not all(s.is_contiguous() for s in shards):
        raise ValueError(f"remote_sendrecv: {p} contiguous shards of 1-, "
                         f"2- or 4-byte elements (at most {ring.MAX_RANKS})"
                         f" are taken, got {shards[0].dtype}")
    n = shards[0].numel()
    out = torch.empty((p, n), dtype=shards[0].dtype, device=dev)
    if n == 0:
        return out
    rows = ring.row_pointers(out)
    tile = kernel_param("k8_tile_bytes", 32768)
    mask, tpr, _ = k8_plan([shards[j].data_ptr() for j in part],
                           list(rows), n * esize, tile)
    ring.launch("mv2t_remote_sendrecv", dev, esize, ring.pointers(shards),
                rows, p, n, src, dst, mask, tpr, tile,
                kernel_param("k8_stages", 6), kernel_param("k8_ahead", 5),
                kernel_param("k8_ctas_per_sm", 1), threads=K8_THREADS)
    bulk = bin(mask).count("1")
    PATHS["sendrecv_bulk_rows"] += bulk
    PATHS["sendrecv_element_rows"] += p - bulk
    LAUNCHES["remote_sendrecv"] += 1
    return out


# ---------------------------------------------------------------------------
# tier dispatch
# ---------------------------------------------------------------------------

def stock_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """The stock torch reduction over the rank axis of a ``(p, n)``
    stack, in the shard dtype (integers wrap as the kernels' do; uint16
    and uint32 reduce in int64, which torch on the CPU can)."""
    if x.dtype in ring.WIDE:
        return stock_reduce(x.to(torch.int64), op).to(x.dtype)
    if op == "sum":
        y = x.sum(0)
    elif op == "prod":
        y = x.prod(0)
    else:
        y = (torch.amax if op == "max" else torch.amin)(x, 0)
    return y.to(x.dtype)


def _mesh_mode(mesh_ctx) -> str:
    """'1d' without a surrounding multi-axis mesh, 'hw' inside one: the
    JAX package's hardware branch (its interpreter branch 'xla' has no
    counterpart here)."""
    return "hw" if mesh_ctx and len(mesh_ctx) > 1 else "1d"


def _check_lines(lines: int, mode: str, what: str) -> None:
    if lines != 1 and mode != "hw":
        raise ValueError(f"{what}: lines={lines} needs a multi-axis "
                         f"mesh_ctx (only the HBM ring kernels take "
                         f"lines)")


def ici_all_reduce(xs: Shards, op: str = "sum", *, lines: int = 1,
                   mesh_ctx=None) -> torch.Tensor:
    """Tier-dispatched allreduce of ``p`` shards: the resident ring (K6)
    at or below DEV_TIER_VMEM_MAX for a sum whose shard divides into p
    blocks, the quantized ring (K9) in the quant tier, the HBM ring (K3)
    otherwise, the stock reduction past DEV_TIER_XLA_MIN or
    for an op or dtype the kernels do not take. Under a multi-axis
    ``mesh_ctx`` ((axis, size) pairs) the resident and quant tiers clamp
    to K3, which then runs ``lines`` rings of p at once (shards
    line-major).
    Returns ``(lines*p, n)``, one row per shard. The dispatchers count
    nothing: the mesh channel's ``_note_tier`` counts each call's tier or
    fallback on every rank, as the JAX package's channel does."""
    shards = ring.as_shards(xs, "ici_all_reduce")
    p = _line_size(shards, lines, "ici_all_reduce")
    n = shards[0].numel()
    if p == 1:
        return torch.stack(shards)
    mode = _mesh_mode(mesh_ctx)
    _check_lines(lines, mode, "ici_all_reduce")
    nbytes = n * shards[0].element_size()
    tier, _ = planned_tier("allreduce", nbytes, shards[0].dtype, op,
                           num_devices=p)
    if mode == "hw" and tier in ("vmem", "quant"):
        tier = "hbm"
    if LOWERING.rec is not None:
        _trace_entry("allreduce", tier, nbytes, op=op)
    if tier == "quant":
        from .quant import quant_ring_all_reduce
        return quant_ring_all_reduce(shards, op)
    if tier == "vmem":
        if n % p or op != "sum":
            tier = "hbm"    # shapes/ops K6 cannot take go to K3
        elif nbytes <= ring.VMEM_LIMIT_BYTES:
            return ring.ring_all_reduce(shards)
        # else the resident kernel's own guard (a raised VMEM edge): stock
    if tier == "hbm":
        return hbm_ring_all_reduce(shards, op, lines=lines)
    return _per_line(shards, lines, "ici_all_reduce",
                     lambda sh: _stock_all_reduce(sh, op))


def _stock_all_reduce(shards, op):
    p, n = len(shards), shards[0].numel()
    if op not in _SUPPORTED_OPS:
        raise NotImplementedError(f"op {op!r} has no stock device "
                                  f"reduction")
    return stock_reduce(torch.stack(shards), op).reshape(1, n) \
        .expand(p, n).clone()


def ici_all_gather(xs: Shards, *, lines: int = 1,
                   mesh_ctx=None) -> torch.Tensor:
    """Tier-dispatched all-gather (tiled): the tier keys on the OUTPUT
    bytes, ``p`` times the shard. Under a multi-axis ``mesh_ctx`` the
    resident tier clamps to K5 over ``lines`` rings. Returns
    ``(lines*p, p*m)``, one row per shard."""
    shards = ring.as_shards(xs, "ici_all_gather")
    p = _line_size(shards, lines, "ici_all_gather")
    m = shards[0].numel()
    if p == 1:
        return torch.stack(shards)
    mode = _mesh_mode(mesh_ctx)
    _check_lines(lines, mode, "ici_all_gather")
    out_nbytes = p * m * shards[0].element_size()
    tier, _ = planned_tier("allgather", out_nbytes, shards[0].dtype, None,
                           num_devices=p)
    if mode == "hw" and tier in ("vmem", "quant"):
        tier = "hbm"
    if LOWERING.rec is not None:
        _trace_entry("allgather", tier, out_nbytes)
    if tier == "vmem" and out_nbytes <= ring.VMEM_LIMIT_BYTES:
        return ring.ring_all_gather(shards)
    if tier == "hbm":
        return hbm_ring_all_gather(shards, lines=lines)
    # the stock lowering, also past the resident kernel's own guard
    return _per_line(shards, lines, "ici_all_gather", _stock_all_gather)


def _stock_all_gather(shards):
    p, m = len(shards), shards[0].numel()
    return torch.cat(shards).reshape(1, p * m).expand(p, p * m).clone()


def _identity_padded(shards: List[torch.Tensor], n_pad: int,
                     op: str) -> List[torch.Tensor]:
    """The shards padded with the op's identity to ``n_pad`` elements,
    as rows of one new tensor (the shards themselves when no pad is
    needed)."""
    n = shards[0].numel()
    if n_pad == n:
        return shards
    x = torch.full((len(shards), n_pad),
                   _pad_identity(shards[0].dtype, op),
                   dtype=shards[0].dtype, device=shards[0].device)
    x[:, :n] = torch.stack(shards)
    return list(x.unbind(0))


def _stock_reduce_scatter(shards, op):
    """The stock lowering of the tiled reduce-scatter over one line
    (the JAX ``_xla_reduce_scatter``: psum_scatter for sum, allreduce
    then the block otherwise): the stock reduction of the identity-padded
    shards, rank r's block of it."""
    p = len(shards)
    nblk = -(-shards[0].numel() // p)
    y = stock_reduce(torch.stack(_identity_padded(shards, p * nblk, op)),
                     op)
    return y.reshape(p, nblk).clone()


def ici_reduce_scatter(xs: Shards, op: str = "sum", *, lines: int = 1,
                       mesh_ctx=None) -> torch.Tensor:
    """Tier-dispatched reduce-scatter (tiled): each shard's block of its
    line's folded array, ``(lines*p, ceil(n/p))``. The quant wire has no
    reduce-scatter form and the resident ring no reduce-scatter entry,
    so every tier but the stock one (past DEV_TIER_XLA_MIN, or an op or
    dtype the kernels do not take) runs K4, which pads."""
    if op not in _SUPPORTED_OPS:
        raise NotImplementedError(f"op {op!r} has no device reduction")
    shards = ring.as_shards(xs, "ici_reduce_scatter")
    p = _line_size(shards, lines, "ici_reduce_scatter")
    if p == 1:
        return torch.stack(shards)
    nbytes = shards[0].numel() * shards[0].element_size()
    tier, _ = planned_tier("reduce_scatter", nbytes, shards[0].dtype, op,
                           num_devices=p)
    if LOWERING.rec is not None:
        _trace_entry("reduce_scatter", "xla" if tier == "xla" else "hbm",
                     nbytes, op=op)
    if tier != "xla":
        return hbm_ring_reduce_scatter(shards, op, lines=lines)
    return _per_line(shards, lines, "ici_reduce_scatter",
                     lambda sh: _stock_reduce_scatter(sh, op))


# ---------------------------------------------------------------------------
# multi-axis mesh composition (the 2D/3D mesh decomposition)
# ---------------------------------------------------------------------------

def _mesh_axes_min() -> int:
    """The DEV_TIER_AXES_MIN edge: shard bytes at or above it take the
    per-axis reduce-scatter / all-gather decomposition; below it each
    axis runs a full allreduce in sequence. -1 = always decompose. The
    cvar only, as every edge of the port (no profile)."""
    return int(get_config()["DEV_TIER_AXES_MIN"])


def _axes(axes) -> Tuple[Tuple[str, int], ...]:
    return tuple((str(a), int(s)) for a, s in axes)


def _axis_phase(rows: List[torch.Tensor], axes, k: int,
                phase) -> List[torch.Tensor]:
    """One per-axis phase: ``rows`` (one per rank, rank order, row-major
    over ``axes``) regrouped into the lines of axis ``k`` (line-major:
    the other coordinates row-major, then the axis coordinate), handed to
    ``phase(shards, lines)``, and its output rows put back in rank order
    (views, no copy)."""
    sizes = [s for _, s in axes]
    order = torch.arange(len(rows)).reshape(sizes).movedim(k, -1) \
        .reshape(-1).tolist()
    out = phase([rows[i] for i in order], len(rows) // sizes[k]).unbind(0)
    back: List[torch.Tensor] = [None] * len(rows)   # type: ignore[list-item]
    for j, i in enumerate(order):
        back[i] = out[j]
    return back


def _mesh_shards(xs: Shards, axes, what: str):
    axes = _axes(axes)
    shards = ring.as_shards(xs, what)
    total = 1
    for _, s in axes:
        total *= s
    if len(shards) != total:
        raise ValueError(f"{what}: {len(shards)} shards on a mesh of "
                         f"{total} ranks {axes}")
    live = [k for k, (_, s) in enumerate(axes) if s > 1]
    return axes, shards, live


def ici_all_reduce_mesh(xs: Shards, axes, op: str = "sum"
                        ) -> List[torch.Tensor]:
    """Allreduce over a multi-axis mesh (``axes``: ordered (name, size)
    pairs; shards in rank order, row-major), decomposed into per-axis
    ring phases: reduce-scatter down the axis list, all-gather back up
    (RS-x, RS-y, AG-y, AG-x on a 2-D mesh: K4, K4, K5, K5), each phase
    one launch over all the axis's lines, on a payload shrunk by the axes
    already folded. The shards are padded once to a multiple of the
    mesh extent. Below DEV_TIER_AXES_MIN each live axis runs a full
    allreduce in sequence instead (K3 a phase). Unit axes are skipped; a
    single live axis is one allreduce, still under the multi-axis
    context. Returns one row per rank, in rank order."""
    axes, shards, live = _mesh_shards(xs, axes, "ici_all_reduce_mesh")
    if not live:
        return [s.clone() for s in shards]

    def allreduce(sh, lines):
        return ici_all_reduce(sh, op, lines=lines, mesh_ctx=axes)
    n = shards[0].numel()
    esize = shards[0].element_size()
    amin = _mesh_axes_min()
    if len(live) == 1 or (amin >= 0 and n * esize < amin):
        y = shards
        for k in live:
            if len(live) > 1 and LOWERING.rec is not None:
                _trace_axis("ar", axes[k][0], n * esize, op=op)
            y = _axis_phase(y, axes, k, allreduce)
        return y
    ptot = len(shards)
    y = _identity_padded(shards, -(-n // ptot) * ptot, op)
    for k in live:
        if LOWERING.rec is not None:
            _trace_axis("rs", axes[k][0], y[0].numel() * esize, op=op)
        y = _axis_phase(y, axes, k, lambda sh, lines: ici_reduce_scatter(
            sh, op, lines=lines, mesh_ctx=axes))
    for k in reversed(live):
        if LOWERING.rec is not None:
            _trace_axis("ag", axes[k][0], y[0].numel() * esize * axes[k][1],
                        op=op)
        y = _axis_phase(y, axes, k, lambda sh, lines: ici_all_gather(
            sh, lines=lines, mesh_ctx=axes))
    return [r[:n] for r in y]


def ici_all_gather_mesh(xs: Shards, axes) -> List[torch.Tensor]:
    """All-gather over a multi-axis mesh (tiled): the innermost axis
    first, then outward, so the blocks land in rank order. Returns one
    row of ``size * m`` per rank, in rank order."""
    axes, shards, live = _mesh_shards(xs, axes, "ici_all_gather_mesh")
    y = shards
    for k in reversed(live):
        if LOWERING.rec is not None:
            _trace_axis("ag", axes[k][0], y[0].numel()
                        * y[0].element_size() * axes[k][1])
        y = _axis_phase(y, axes, k, lambda sh, lines: ici_all_gather(
            sh, lines=lines, mesh_ctx=axes))
    return [r.clone() for r in y] if not live else y


def ici_reduce_scatter_mesh(xs: Shards, axes, op: str = "sum"
                            ) -> List[torch.Tensor]:
    """Reduce-scatter over a multi-axis mesh (tiled): the outermost axis
    first, then inward, so rank (i, j) of a row-major 2-D mesh ends with
    block ``i*py + j``, its rank's block. The shard length must be a
    multiple of the mesh extent for exact tiling (callers pad). Returns
    one row per rank, in rank order."""
    axes, shards, live = _mesh_shards(xs, axes, "ici_reduce_scatter_mesh")
    y = shards
    for k in live:
        if LOWERING.rec is not None:
            _trace_axis("rs", axes[k][0], y[0].numel()
                        * y[0].element_size(), op=op)
        y = _axis_phase(y, axes, k, lambda sh, lines: ici_reduce_scatter(
            sh, op, lines=lines, mesh_ctx=axes))
    return [r.clone() for r in y] if not live else y
