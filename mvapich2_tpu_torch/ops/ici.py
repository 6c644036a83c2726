"""Chunked streaming ring collectives over ``p`` virtual ranks of one GPU,
and the device tier dispatch (counterpart of
``mvapich2_tpu/ops/pallas_ici.py``).

Two kernels, written in CUDA C++ in ``csrc/ring.cu``:

``hbm_ring_all_reduce`` (K3): a reduce-scatter ring then an all-gather
ring over ``p`` blocks of ``nblk = ceil(n/p)`` elements (the shard padded
with the op's identity), streamed in ``ICI_CHUNK_BYTES`` chunks through
``ICI_PIPELINE_DEPTH`` landing slots per direction, both ring directions
at once when ``p > 2`` and ``ICI_BIDIR`` (half of every block each way).
sum, max, min and prod.

``hbm_ring_all_gather`` (K5): the all-gather ring alone, ``[m]`` per
rank to ``[p*m]``.

The schedule is the JAX kernels': the same block ids and phase order,
one global chunk counter per direction (slot = counter mod depth), and
the chunk-credit handshake (a sender writes chunk k+depth only once the
receiver has consumed chunk k). A "remote DMA" is a store into the
downstream rank's landing slot. Inputs and outputs are as in
``ops/ring.py``, whose launch and replay machinery these wrappers share.

``ici_all_reduce`` / ``ici_all_gather`` pick the tier by shard bytes
(``planned_tier``): the resident ring (K6/K7, ``ops/ring.py``) at or
below DEV_TIER_VMEM_MAX, the streaming ring above it, and the stock
torch reduction over the stacked shards (the port's analog of
``lax.psum``) past DEV_TIER_XLA_MIN or for an op or dtype the kernels do
not take. The mesh channel counts each call's tier or fallback in the
``dev_coll_tier_*`` / ``dev_coll_fallback_*`` pvars.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..utils.config import get_config
from . import ring
from .ring import Shards

_SUPPORTED_OPS = ("sum", "max", "min", "prod")

LAUNCHES: Dict[str, int] = {"hbm_ring_all_reduce": 0,
                            "hbm_ring_all_gather": 0}
PLAIN_CALLS: Dict[str, int] = {"hbm_ring_all_reduce": 0,
                               "hbm_ring_all_gather": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
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
    """numpy-style kind letter of a torch dtype."""
    if dtype.is_complex:
        return "c"
    if dtype.is_floating_point:
        return "f"
    if dtype == torch.bool:
        return "b"
    return "i" if dtype.is_signed else "u"


def planned_tier(name: str, shard_nbytes: int, dtype: torch.dtype,
                 op: Optional[str]) -> Tuple[str, Optional[str]]:
    """(tier, fallback_reason) for one device collective call: tier is
    'vmem' | 'hbm' | 'xla'; the reason is None unless the stock lowering
    was taken, and then names the dev_coll_fallback_* bucket: size (at
    or past DEV_TIER_XLA_MIN), dtype (an op or dtype the kernels cannot
    reduce), shape (an empty buffer). The quant bin (K9) is not ported:
    a call that MV2T_QUANT_COLL would send there raises."""
    if op is not None and op not in _SUPPORTED_OPS:
        return "xla", "dtype"
    if dtype_kind(dtype) not in "fiu":
        return "xla", "dtype"
    if shard_nbytes <= 0:
        return "xla", "shape"
    from ..coll.tuning import device_tier
    tier = device_tier(name, shard_nbytes)
    if tier == "quant":
        raise NotImplementedError(
            f"{name}: MV2T_QUANT_COLL opens the quantized wire tier for "
            f"{shard_nbytes}-byte shards; its kernel (K9, "
            f"quant_ring_all_reduce) is not ported")
    if tier == "xla":
        return "xla", "size"
    return tier, None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _padded(shards: List[torch.Tensor], op: str) -> Tuple[torch.Tensor, int]:
    """(p, n_pad) stack of the shards padded with the op identity to p
    blocks; returns it and nblk."""
    p, n = len(shards), shards[0].numel()
    nblk = -(-n // p)
    x = torch.stack(shards)
    if nblk * p > n:
        x = torch.nn.functional.pad(x, (0, nblk * p - n),
                                    value=_pad_identity(x.dtype, op))
    return x, nblk


def hbm_ring_all_reduce_ref(xs: Shards, op: str = "sum", *,
                            bidirectional: Optional[bool] = None
                            ) -> torch.Tensor:
    """Plain version of K3: the ring replayed block by block in the
    kernel's fold order; returns ``(p, n)``. Chunking and depth reorder
    the kernel's transfers, never its arithmetic, so they are not
    parameters here."""
    shards = ring.as_shards(xs, "hbm_ring_all_reduce")
    p, n = len(shards), shards[0].numel()
    x, nblk = _padded(shards, op)
    o = x.reshape(p, p, nblk).clone()
    ring.ring_replay(o, _block_spans(nblk, _resolve_ndir(p, bidirectional)),
                     True, True, ring.reducer(op))
    return o.reshape(p, p * nblk)[:, :n]


def hbm_ring_all_gather_ref(xs: Shards, *,
                            bidirectional: Optional[bool] = None
                            ) -> torch.Tensor:
    """Plain version of K5: the gather ring replayed; returns
    ``(p, p*m)``."""
    shards = ring.as_shards(xs, "hbm_ring_all_gather")
    p, m = len(shards), shards[0].numel()
    o = torch.zeros((p, p, m), dtype=shards[0].dtype,
                    device=shards[0].device)
    for r in range(p):
        o[r, r] = shards[r]
    ring.ring_replay(o, _block_spans(m, _resolve_ndir(p, bidirectional)),
                     False, True)
    return o.reshape(p, p * m)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _stream_args(shards, out, nblk, chunk_bytes, depth, bidirectional):
    """(chunk, depth, ndir, ctas, vec, slots, flags) of one streaming
    launch over blocks of ``nblk`` elements."""
    p, dev, dt = len(shards), out.device, out.dtype
    chunk = max(1, min(_cfg_chunk_elems(dt, chunk_bytes), nblk))
    d = _cfg_depth(depth)
    ndir = _resolve_ndir(p, bidirectional)
    v = 16 // out.element_size()
    h = (nblk + 1) // 2
    vec = (ring.aligned(shards) and ring.aligned(out.unbind(0))
           and nblk % v == 0 and chunk % v == 0
           and (ndir == 1 or h % v == 0))
    ctas = ring.ctas_per_lane(dev, p * ndir, chunk, v)
    slots = torch.empty((p, ndir, d, chunk), dtype=dt, device=dev)
    flags = torch.zeros(2 * p * ndir * ctas, dtype=torch.int32, device=dev)
    return chunk, d, ndir, ctas, int(vec), slots, flags


def hbm_ring_all_reduce(xs: Shards, op: str = "sum", *,
                        chunk_bytes: Optional[int] = None,
                        depth: Optional[int] = None,
                        bidirectional: Optional[bool] = None
                        ) -> torch.Tensor:
    """K3: allreduce of ``p`` shards of any length ``n`` through the
    chunked streaming ring (pipelined reduce-scatter + all-gather).
    Returns ``(p, n)``, row r for rank r."""
    if op not in _SUPPORTED_OPS:
        raise ValueError(f"hbm_ring_all_reduce: op {op!r} (supported: "
                         f"{_SUPPORTED_OPS})")
    shards = ring.as_shards(xs, "hbm_ring_all_reduce")
    if ring.on_cpu(shards):
        PLAIN_CALLS["hbm_ring_all_reduce"] += 1
        return hbm_ring_all_reduce_ref(shards, op,
                                       bidirectional=bidirectional)
    code = ring.check_cuda_shards(shards, "hbm_ring_all_reduce")
    p, n = len(shards), shards[0].numel()
    nblk = -(-n // p)
    out = torch.empty((p, nblk * p), dtype=shards[0].dtype,
                      device=shards[0].device)
    chunk, d, ndir, ctas, vec, slots, flags = _stream_args(
        shards, out, nblk, chunk_bytes, depth, bidirectional)
    ring.launch("mv2t_hbm_ring_all_reduce", out.device, code,
                ring.OP_CODES[op], ring.pointers(shards),
                ring.pointers(out.unbind(0)), p, n, nblk, chunk, d, ndir,
                slots.data_ptr(), flags.data_ptr(), ctas, vec)
    LAUNCHES["hbm_ring_all_reduce"] += 1
    return out[:, :n]


def hbm_ring_all_gather(xs: Shards, *, chunk_bytes: Optional[int] = None,
                        depth: Optional[int] = None,
                        bidirectional: Optional[bool] = None
                        ) -> torch.Tensor:
    """K5: all-gather of ``p`` shards of ``m`` elements through the
    chunked streaming ring. Returns ``(p, p*m)``, row r for rank r."""
    shards = ring.as_shards(xs, "hbm_ring_all_gather")
    if ring.on_cpu(shards):
        PLAIN_CALLS["hbm_ring_all_gather"] += 1
        return hbm_ring_all_gather_ref(shards, bidirectional=bidirectional)
    code = ring.check_cuda_shards(shards, "hbm_ring_all_gather")
    p, m = len(shards), shards[0].numel()
    out = torch.empty((p, p * m), dtype=shards[0].dtype,
                      device=shards[0].device)
    chunk, d, ndir, ctas, vec, slots, flags = _stream_args(
        shards, out, m, chunk_bytes, depth, bidirectional)
    ring.launch("mv2t_hbm_ring_all_gather", out.device, code,
                ring.pointers(shards), ring.pointers(out.unbind(0)), p, m,
                chunk, d, ndir, slots.data_ptr(), flags.data_ptr(), ctas,
                vec)
    LAUNCHES["hbm_ring_all_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# tier dispatch
# ---------------------------------------------------------------------------

def stock_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """The stock torch reduction over the rank axis of a ``(p, n)``
    stack, in the shard dtype (integers wrap as the kernels' do)."""
    if op == "sum":
        y = x.sum(0)
    elif op == "prod":
        y = x.prod(0)
    else:
        y = (torch.amax if op == "max" else torch.amin)(x, 0)
    return y.to(x.dtype)


def ici_all_reduce(xs: Shards, op: str = "sum") -> torch.Tensor:
    """Tier-dispatched allreduce of ``p`` shards: the resident ring (K6)
    at or below DEV_TIER_VMEM_MAX for a sum whose shard divides into p
    blocks, the streaming ring (K3) otherwise, the stock reduction past
    DEV_TIER_XLA_MIN or for an op or dtype the kernels do not take.
    Returns ``(p, n)``, one row per rank. The dispatchers count nothing:
    the mesh channel's ``_note_tier`` counts each call's tier or
    fallback on every rank, as the JAX package's channel does."""
    shards = ring.as_shards(xs, "ici_all_reduce")
    p, n = len(shards), shards[0].numel()
    if p == 1:
        return shards[0].reshape(1, n).clone()
    nbytes = n * shards[0].element_size()
    tier, _ = planned_tier("allreduce", nbytes, shards[0].dtype, op)
    if tier == "vmem":
        if n % p or op != "sum":
            tier = "hbm"    # shapes/ops K6 cannot take stream instead
        elif nbytes <= ring.VMEM_LIMIT_BYTES:
            return ring.ring_all_reduce(shards)
        # else the resident kernel's own guard (a raised VMEM edge): stock
    if tier == "hbm":
        return hbm_ring_all_reduce(shards, op)
    return _stock_all_reduce(shards, op)


def _stock_all_reduce(shards, op):
    p, n = len(shards), shards[0].numel()
    if op not in _SUPPORTED_OPS:
        raise NotImplementedError(f"op {op!r} has no stock device "
                                  f"reduction")
    return stock_reduce(torch.stack(shards), op).reshape(1, n) \
        .expand(p, n).clone()


def ici_all_gather(xs: Shards) -> torch.Tensor:
    """Tier-dispatched all-gather (tiled): the tier keys on the OUTPUT
    bytes, ``p`` times the shard. Returns ``(p, p*m)``, one row per
    rank."""
    shards = ring.as_shards(xs, "ici_all_gather")
    p, m = len(shards), shards[0].numel()
    if p == 1:
        return shards[0].reshape(1, m).clone()
    out_nbytes = p * m * shards[0].element_size()
    tier, _ = planned_tier("allgather", out_nbytes, shards[0].dtype, None)
    if tier == "vmem" and out_nbytes <= ring.VMEM_LIMIT_BYTES:
        return ring.ring_all_gather(shards)
    if tier == "hbm":
        return hbm_ring_all_gather(shards)
    # the stock lowering, also past the resident kernel's own guard
    return _stock_all_gather(shards)


def _stock_all_gather(shards):
    p, m = len(shards), shards[0].numel()
    return torch.cat(shards).reshape(1, p * m).expand(p, p * m).clone()
