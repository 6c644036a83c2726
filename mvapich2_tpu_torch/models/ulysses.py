"""Ulysses sequence parallelism: attention through a head <-> sequence
all-to-all reshard (counterpart of ``mvapich2_tpu/models/ulysses.py``).

Each rank holds a sequence block of all heads; one all-to-all turns
that into all tokens of a head block, attention runs per head, and the
inverse all-to-all restores the sequence sharding:

    [T/p tokens, H heads]  --a2a-->  [T tokens, H/p heads]
        (attention over the head block)
    [T tokens, H/p heads]  --a2a-->  [T/p tokens, H heads]

The functions take the stacked layout of ``ops/collectives.py`` and the
``MeshComm`` where the JAX ones take the axis name; run them through
``MeshComm.run``. With ``use_flash`` the attention is K15
(``models/flash.py``), one launch over all ``p * H/p`` head rows;
without, the dense ``local_attention_reference`` (small sizes only).
"""

from __future__ import annotations

from ..ops.collectives import all_to_all, axis_size
from .flash import flash_attention
from .ring_attention import local_attention_reference


def _seq_to_heads(x, comm):
    """``[p, T/p, H, Dh]`` -> ``[p, T, H/p, Dh]``: gather the sequence,
    scatter the heads."""
    return all_to_all(x, comm, split_axis=1, concat_axis=0)


def _heads_to_seq(x, comm):
    """``[p, T, H/p, Dh]`` -> ``[p, T/p, H, Dh]``: the inverse reshard."""
    return all_to_all(x, comm, split_axis=0, concat_axis=1)


def ulysses_attention(q, k, v, comm, causal: bool = True,
                      use_flash: bool = False, block_q: int = 128,
                      block_k: int = 128):
    """Sequence-parallel attention through the head/sequence reshard.
    q/k/v: stacked ``[p, T/p, H, Dh]``, every rank's sequence block of
    every head (H % p == 0). Returns the output in the same layout and
    q's dtype; the attention runs in f32."""
    H = q.shape[2]
    p = axis_size(comm)
    if H % p != 0:
        raise ValueError(f"heads {H} not divisible by axis size {p}")
    qh = _seq_to_heads(q, comm)          # [p, T, H/p, Dh]
    kh = _seq_to_heads(k, comm)
    vh = _seq_to_heads(v, comm)
    if use_flash:
        oh = flash_attention(qh, kh, vh, causal=causal, block_q=block_q,
                             block_k=block_k)
    else:
        oh = local_attention_reference(qh, kh, vh, causal=causal)
    return _heads_to_seq(oh, comm).to(q.dtype)    # [p, T/p, H, Dh]
