"""Blockwise flash attention (counterpart of
``mvapich2_tpu/models/flash.py``): the per-shard hot op of the
sequence-parallel attention paths, written in CUDA C++ in
``csrc/flash.cu``.

``flash_attention`` (K15) returns the normalised attention output;
``flash_attention_parts`` (K16) returns the unnormalised streaming parts
``(m, num, den)`` that ``ring_attention_flash`` merges step by step. Both
compute what the JAX ``_stream_blocks`` computes: q cast to f32 and
scaled by ``f32(D ** -0.5)`` before the product, a walk over K/V tiles
carrying the running (max, numerator, denominator) of each query row in
f32, the causal mask ``q0 + row >= k0 + col`` in global positions, the
guards for rows that have seen no key yet, and the causal skip of key
tiles that start after a query tile's last row.

Layouts are the JAX ones, with optional leading batch dims: q
``[..., T, H, D]``, k/v ``[..., Tk, H, D]``; K15 gives ``[..., T, H,
D]`` in q's dtype, K16 ``m [..., H, T]``, ``num [..., T, H, D]``, ``den
[..., H, T]`` in f32 with block-local positions (``q0 = k0 = 0``). A
batch dim is how one launch covers many ranks: the stacked ``[p, T, H,
D]`` tensors of ``ops/collectives.py`` (Ulysses runs K15 once over
``p * H/p`` head rows, the ring K16 once a step over the ranks that
compute).

Routing: a CPU tensor takes the plain version (``flash_attention_ref``,
``flash_attention_parts_ref``: the ``_stream_blocks`` loop in torch, f32,
vectorised over heads and query tiles, in the JAX package's block sizes,
never building ``[H, T, Tk]``); a CUDA tensor launches the kernel on the
current stream or raises. ``LAUNCHES`` and ``PLAIN_CALLS`` count each.
``block_q`` / ``block_k`` are the JAX tile sizes: the plain version
walks them; the kernel has its own (128 query rows x 64 keys up to head
width 128, 64 x 32 at 256), so they change only the f32 summation order
there. The kernel runs both products on the tensor cores in split TF32
(three TF32 products a multiply-add, about 21 bits each), which meets
the f32 tolerance that one TF32 product misses. It reads its inputs in
vectors of four elements, so a tensor whose data is not 16-byte aligned
is copied first.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .ring_attention import NEG_INF

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_parts": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0,
                               "flash_attention_parts": 0}

# dtype -> code of the C entry points (csrc/flash.cu enum DType)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's compiled head widths


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _block_sizes(T, Tk, block_q, block_k):
    """Largest divisors of T/Tk not exceeding the requested blocks —
    non-power-of-two lengths shrink the tile instead of erroring."""
    bq = math.gcd(T, block_q) if T % min(block_q, T) else min(block_q, T)
    bk = math.gcd(Tk, block_k) if Tk % min(block_k, Tk) \
        else min(block_k, Tk)
    return bq, bk


def _scale(D: int) -> float:
    """``D ** -0.5`` rounded to f32, as the JAX kernel's weakly typed
    Python float multiplies an f32 array."""
    return float(np.float32(D ** -0.5))


def _batched(q, k, v, what: str):
    """(q, k, v) with one leading batch dim, and whether it was added."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"{what}: expected q [..., T, H, D] and k, v "
                         f"[..., Tk, H, D] of one rank, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    added = q.dim() == 3
    if added:
        q, k, v = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or "
                         f"head width")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"{what}: empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k and v lie on different devices")
    return q, k, v, added


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _nk_eff(causal: bool, q0: int, k0: int, nq: int, nk: int, bq: int,
            bk: int):
    """Key tiles each query tile walks: all, or under the causal mask
    those whose first key is at or before the tile's last query
    (``flash.py:83-84``, a floor division)."""
    if not causal:
        return [nk] * nq
    return [min(max((q0 + (qi + 1) * bq - 1 - k0) // bk + 1, 0), nk)
            for qi in range(nq)]


def _stream_ref(q, k, v, causal, q0, k0, block_q, block_k):
    """The ``_stream_blocks`` loop over ``[B, T, H, D]`` inputs; returns
    f32 ``(m [B, H, T], num [B, H, T, D], den [B, H, T])``."""
    B, T, H, D = q.shape
    Tk = k.shape[1]
    bq, bk = _block_sizes(T, Tk, block_q, block_k)
    nq, nk = T // bq, Tk // bk
    n = B * H
    qh = (q.float() * _scale(D)).permute(0, 2, 1, 3).reshape(n, nq, bq, D)
    kh = k.float().permute(0, 2, 1, 3).reshape(n, Tk, D)
    vh = v.float().permute(0, 2, 1, 3).reshape(n, Tk, D)
    m = torch.full((n, nq, bq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    num = torch.zeros((n, nq, bq, D), dtype=torch.float32, device=q.device)
    den = torch.zeros((n, nq, bq), dtype=torch.float32, device=q.device)
    walk = _nk_eff(causal, q0, k0, nq, nk, bq, bk)
    row = torch.arange(bq, device=q.device)
    col = torch.arange(bk, device=q.device)
    for kt in range(max(walk)):
        # the walk is non-decreasing in the query tile: the tiles that
        # still see key tile kt are a suffix
        lo = next(qi for qi in range(nq) if walk[qi] > kt)
        kk = kh[:, kt * bk:(kt + 1) * bk]
        vv = vh[:, kt * bk:(kt + 1) * bk]
        s = torch.matmul(qh[:, lo:], kk.transpose(1, 2).unsqueeze(1))
        if causal:
            q_pos = q0 + (torch.arange(lo, nq, device=q.device)[:, None]
                          * bq + row)
            k_pos = k0 + kt * bk + col
            s = torch.where(q_pos[:, :, None] >= k_pos, s, NEG_INF)
        m_acc, num_acc, den_acc = m[:, lo:], num[:, lo:], den[:, lo:]
        new_m = torch.maximum(m_acc, s.amax(-1))
        # guard fully-masked rows: keep them at NEG_INF with zero weight
        safe_m = torch.where(new_m > NEG_INF / 2, new_m, 0.0)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(s > NEG_INF / 2, p, 0.0)
        alpha = torch.where(m_acc > NEG_INF / 2,
                            torch.exp(m_acc - safe_m), 0.0)
        num[:, lo:] = num_acc * alpha[..., None] + torch.matmul(
            p, vv.unsqueeze(1))
        den[:, lo:] = den_acc * alpha + p.sum(-1)
        m[:, lo:] = new_m
    return (m.reshape(B, H, T), num.reshape(B, H, T, D),
            den.reshape(B, H, T))


def _out_ref(q, k, v, causal, q0, k0, block_q, block_k):
    _, num, den = _stream_ref(q, k, v, causal, int(q0), int(k0), block_q,
                              block_k)
    out = (num / torch.clamp(den, min=1e-20)[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()


def _parts_ref(q, k, v, causal, block_q, block_k):
    m, num, den = _stream_ref(q, k, v, causal, 0, 0, block_q, block_k)
    return m, num.permute(0, 2, 1, 3).contiguous(), den


def _unbatched(out, added):
    if isinstance(out, tuple):
        return tuple(x[0] for x in out) if added else out
    return out[0] if added else out


def flash_attention_ref(q, k, v, causal: bool = True, q0: int = 0,
                        k0: int = 0, block_q: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """Plain version of K15: ``[..., T, H, D]`` in q's dtype."""
    qb, kb, vb, added = _batched(q, k, v, "flash_attention")
    return _unbatched(_out_ref(qb, kb, vb, causal, q0, k0, block_q,
                               block_k), added)


def flash_attention_parts_ref(q, k, v, causal: bool, block_q: int = 128,
                              block_k: int = 128):
    """Plain version of K16: f32 ``(m [..., H, T], num [..., T, H, D],
    den [..., H, T])``, block-local positions."""
    qb, kb, vb, added = _batched(q, k, v, "flash_attention_parts")
    return _unbatched(_parts_ref(qb, kb, vb, causal, block_q, block_k),
                      added)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _kernel_args(q, k, v, what: str) -> Tuple[int, Tuple[int, ...]]:
    """Check CUDA inputs; return the dtype code and (B, H, T, Tk, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {q.device}; the kernel takes "
                         f"CUDA tensors (CPU tensors take the plain path)")
    code = DTYPE_CODES.get(q.dtype)
    if code is None or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: q, k, v of {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes one of "
                        f"{sorted(str(t) for t in DTYPE_CODES)} for all "
                        f"three")
    B, T, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head width {D}; the kernel is built "
                         f"for {HEAD_DIMS}")
    return code, (B, H, T, k.shape[1], D)


def _aligned(*xs):
    """Contiguous copies of the tensors, and a fresh one of any whose data
    does not start on a 16-byte boundary (the kernel's vector reads)."""
    out = []
    for x in xs:
        x = x.contiguous()
        out.append(x.clone() if x.data_ptr() % 16 else x)
    return out


def _launch(fn: str, device: torch.device, *args) -> None:
    from ..ops import _build
    lib = _build.load("flash")
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args, stream)
    _build.check(lib, rc, fn)


def flash_attention(q, k, v, causal: bool = True, q0: int = 0,
                    k0: int = 0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """K15: fused attention over one rank's data (or a batch of ranks).
    q ``[..., T, H, D]``, k/v ``[..., Tk, H, D]`` -> ``[..., T, H, D]``
    in q's dtype; ``q0``/``k0`` are the global position offsets of the
    first query and key. Accumulates in f32."""
    qb, kb, vb, added = _batched(q, k, v, "flash_attention")
    if qb.device.type == "cpu":
        PLAIN_CALLS["flash_attention"] += 1
        return _unbatched(_out_ref(qb, kb, vb, causal, q0, k0, block_q,
                                   block_k), added)
    code, (B, H, T, Tk, D) = _kernel_args(qb, kb, vb, "flash_attention")
    qb, kb, vb = _aligned(qb, kb, vb)
    out = torch.empty_like(qb)
    _launch("mv2t_flash_attention", qb.device, code, qb.data_ptr(),
            kb.data_ptr(), vb.data_ptr(), out.data_ptr(), B, H, T, Tk, D,
            int(q0), int(k0), int(bool(causal)), _scale(D))
    LAUNCHES["flash_attention"] += 1
    return _unbatched(out, added)


def flash_attention_parts(q, k, v, causal: bool, block_q: int = 128,
                          block_k: int = 128):
    """K16: the streaming-softmax parts of one KV block's attention,
    ``(m [..., H, T], num [..., T, H, D], den [..., H, T])`` in f32, in
    the layout ``ring_attention_flash``'s merge expects. ``causal``
    masks block-locally (the diagonal ring step); past blocks take
    ``causal=False``."""
    qb, kb, vb, added = _batched(q, k, v, "flash_attention_parts")
    if qb.device.type == "cpu":
        PLAIN_CALLS["flash_attention_parts"] += 1
        return _unbatched(_parts_ref(qb, kb, vb, causal, block_q, block_k),
                          added)
    code, (B, H, T, Tk, D) = _kernel_args(qb, kb, vb,
                                          "flash_attention_parts")
    qb, kb, vb = _aligned(qb, kb, vb)
    f32 = dict(dtype=torch.float32, device=qb.device)
    m = torch.empty((B, H, T), **f32)
    num = torch.empty((B, T, H, D), **f32)
    den = torch.empty((B, H, T), **f32)
    _launch("mv2t_flash_attention_parts", qb.device, code, qb.data_ptr(),
            kb.data_ptr(), vb.data_ptr(), m.data_ptr(), num.data_ptr(),
            den.data_ptr(), B, H, T, Tk, D, int(bool(causal)), _scale(D))
    LAUNCHES["flash_attention_parts"] += 1
    return _unbatched((m, num, den), added)
