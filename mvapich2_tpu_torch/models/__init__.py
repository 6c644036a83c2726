"""The model layer of the port (counterpart of
``mvapich2_tpu/models``): the sequence-parallel attention paths,
``ring_attention`` (ring attention, K16 per step in its flash form) and
``ulysses`` (the head/sequence all-to-all around K15), over the flash
kernels of ``flash``; the dp/sp/tp/ep ``transformer`` and its train step;
the 3-D ``stencil`` with halo exchange."""

from . import flash, ring_attention, stencil, transformer, ulysses

__all__ = ["flash", "ring_attention", "stencil", "transformer", "ulysses"]
