"""Ring attention: sequence-parallel attention over the ranks of a mesh
(counterpart of ``mvapich2_tpu/models/ring_attention.py``).

KV blocks circulate the ring (``ops/collectives.py`` ``ring_shift``)
while each rank accumulates its queries' attention in streaming (flash)
form. At step s rank i holds the KV block that originated at rank
j = (i - s) mod p; under the causal mask it lies in i's past (j < i),
on the diagonal (j == i) or in i's future (j > i).

Every function here takes the stacked layout of ``ops/collectives.py``
(dim 0 is the mesh rank: ``q[i]`` is rank i's ``[T, H, Dh]`` shard) and
the ``MeshComm`` where the JAX function takes the axis name; run them
through ``MeshComm.run``. ``ring_attention`` also takes batch dims
between the rank and the sequence, and a comm over one axis of a
larger mesh (the transformer's ``sp``). ``ring_attention`` is the stock form (scores
of a whole block at once, ``[p, H, T, Tk]``: small sizes only);
``ring_attention_flash`` takes each step's parts from K16
(``models/flash.py``). ``local_attention_reference`` is dense attention
over a full sequence (``[..., T, H, Dh]``), for checks at small sizes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.collectives import axis_rank, axis_size, ring_shift

NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, k_pos, scale, causal):
    """One KV block's contribution in streaming-softmax form: (scores
    max ``[..., H, T]``, exp-scores @ v ``[..., T, H, Dh]``, exp-scores
    row sum ``[..., H, T]``). q ``[..., T, H, Dh]``, k/v ``[..., Tk, H,
    Dh]``; positions ``[..., T]`` / ``[..., Tk]`` are global token
    indices. The scores are scaled after the product."""
    s = torch.einsum("...thd,...khd->...htk", q, k) * scale
    if causal:
        mask = q_pos[..., None, :, None] >= k_pos[..., None, None, :]
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # fully-masked rows: exp(NEG_INF - NEG_INF) = 1 per element; zero them
    valid = m > NEG_INF / 2
    p = torch.where(valid[..., None], p, 0.0)
    m = torch.where(valid, m, NEG_INF)
    num = torch.einsum("...htk,...khd->...thd", p, v)
    den = p.sum(-1)
    return m, num, den


def _heads_last(x):
    """``[..., H, T]`` -> ``[..., T, H, 1]`` (``x.T[..., None]`` of one
    rank)."""
    return x.transpose(-1, -2)[..., None]


def ring_attention(q, k, v, comm, causal: bool = True,
                   scale: Optional[float] = None):
    """Streaming attention with KV blocks rotating around the comm's
    ring. q/k/v: stacked ``[S, *batch, T, H, Dh]`` (``S`` the mesh's
    ranks; the JAX function ``vmap``-ed over the batch dims), the comm
    one axis of the mesh, or all of it. Returns the same shape in q's
    dtype; accumulators are f32 whatever the input dtype. Differentiable
    (the transformer's training step runs its backward)."""
    p = axis_size(comm)
    T, H, Dh = q.shape[-3:]
    batch = tuple(q.shape[1:-3])
    one = (1,) * len(batch)
    my = axis_rank(comm).reshape((-1,) + one)      # [S, 1...]
    scale = scale if scale is not None else Dh ** -0.5
    q32 = q.float()
    q_pos = my[..., None] * T + torch.arange(T, device=q.device)
    lead = (q.shape[0],) + batch
    f32 = dict(dtype=torch.float32, device=q.device)
    m_acc = torch.full(lead + (H, T), NEG_INF, **f32)
    num_acc = torch.zeros(lead + (T, H, Dh), **f32)
    den_acc = torch.zeros(lead + (H, T), **f32)
    kk, vv = k, v
    for s in range(p):
        j = (my - s + p) % p                 # origin rank of each block
        k_pos = j[..., None] * T + torch.arange(kk.shape[-3],
                                                device=q.device)
        m_blk, num_blk, den_blk = _block_attend(
            q32, kk.float(), vv.float(), q_pos, k_pos, scale, causal)
        new_m = torch.maximum(m_acc, m_blk)
        # rescale previous accumulators and the new block to the new max
        alpha = torch.exp(m_acc - new_m)
        beta = torch.exp(m_blk - new_m)
        num_acc = num_acc * _heads_last(alpha) + num_blk * _heads_last(beta)
        den_acc = den_acc * alpha + den_blk * beta
        m_acc = new_m
        if s < p - 1:
            # rotate KV to the right neighbour: at step s+1 rank i holds
            # block i-s-1
            kk = ring_shift(kk, comm, 1)
            vv = ring_shift(vv, comm, 1)
    den_acc = torch.clamp(den_acc, min=1e-20)
    return (num_acc / _heads_last(den_acc)).to(q.dtype)


def local_attention_reference(q, k, v, causal: bool = True,
                              scale: Optional[float] = None):
    """Dense attention for correctness checks. q/k/v: ``[..., T, H, Dh]``
    (a full sequence, with optional leading batch dims). Builds
    ``[..., H, T, T]``: small sizes only."""
    T, Dh = q.shape[-3], q.shape[-1]
    scale = scale if scale is not None else Dh ** -0.5
    s = torch.einsum("...thd,...khd->...htk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(T, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("...htk,...khd->...thd", w, v.float()).to(q.dtype)


def ring_attention_flash(q, k, v, comm, causal: bool = True,
                         block_q: int = 128, block_k: int = 128):
    """Ring attention with K16 (``models/flash.py``) as the per-step
    compute: KV movement stays ``ring_shift``, each block's (max,
    numerator, denominator) parts come from ``flash_attention_parts``,
    and the streaming merge is ``ring_attention``'s rescaling with the
    guards of the JAX function.

    One launch a step covers the ranks that compute: with ``causal``,
    step 0 is every rank's diagonal (block-local causal mask); at step
    s > 0 ranks i >= s hold a past block (unmasked) and ranks i < s a
    future one, which the JAX ``lax.switch`` skips: their parts are the
    constants (NEG_INF, 0, 0). Without ``causal`` every step attends
    every rank unmasked. Either way, p launches a call.
    """
    from .flash import flash_attention_parts

    if comm.axes != comm.mesh.axis_names:
        # the launches below slice the stacked ranks by comm rank
        raise NotImplementedError(
            f"ring_attention_flash over {comm.axes} of the mesh "
            f"{comm.mesh.axis_names}: it takes a comm over the whole mesh")
    p = axis_size(comm)
    _, T, H, Dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    m_acc = torch.full((p, H, T), NEG_INF, **f32)
    num_acc = torch.zeros((p, T, H, Dh), **f32)
    den_acc = torch.zeros((p, H, T), **f32)
    kk, vv = k, v
    for s in range(p):
        if not causal or s == 0:
            m_blk, num_blk, den_blk = flash_attention_parts(
                q, kk, vv, causal, block_q, block_k)
        else:
            # ranks [0, s): a future block; ranks [s, p): a past one
            m_blk = torch.full((p, H, T), NEG_INF, **f32)
            num_blk = torch.zeros((p, T, H, Dh), **f32)
            den_blk = torch.zeros((p, H, T), **f32)
            m_blk[s:], num_blk[s:], den_blk[s:] = flash_attention_parts(
                q[s:], kk[s:], vv[s:], False, block_q, block_k)
        new_m = torch.maximum(m_acc, m_blk)
        safe = torch.where(new_m > NEG_INF / 2, new_m, 0.0)
        alpha = torch.where(m_acc > NEG_INF / 2,
                            torch.exp(m_acc - safe), 0.0)
        beta = torch.where(m_blk > NEG_INF / 2,
                           torch.exp(m_blk - safe), 0.0)
        num_acc = num_acc * _heads_last(alpha) + num_blk * _heads_last(beta)
        den_acc = den_acc * alpha + den_blk * beta
        m_acc = new_m
        if s < p - 1:
            kk = ring_shift(kk, comm, 1)
            vv = ring_shift(vv, comm, 1)
    den_acc = torch.clamp(den_acc, min=1e-20)
    return (num_acc / _heads_last(den_acc)).to(q.dtype)
