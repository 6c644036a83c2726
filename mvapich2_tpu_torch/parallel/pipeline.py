"""Pipeline parallelism over a mesh axis, GPipe style (counterpart of
``mvapich2_tpu/parallel/pipeline.py``).

Stages are the ranks of a comm; activations move stage to stage by
``ring_shift`` and microbatches stream so that every stage fills. The
JAX ``lax.scan`` over the ticks is a Python loop here, and its
stage-dependent ``jnp.where`` / ``lax.cond`` are ``torch.where`` on each
rank's stage index: every stage computes every tick, as the JAX stages
do under ``shard_map``."""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.collectives import axis_rank, axis_size, ring_shift


def pipeline_apply(stage_fn: Callable, stage_params, micro: torch.Tensor,
                   comm) -> torch.Tensor:
    """Run ``stage_fn(params, x)`` as a pipeline over the comm's ranks,
    all stacked on dim 0 (``[S, ...]``, dim 0 the mesh rank).

    stage_params: every rank's stage parameters, stacked.
    micro: ``[S, n_micro, mb, ...]``, each rank's copy of the
    microbatches (only stage 0 injects them).
    Returns ``[S, n_micro, mb, ...]``: valid on the LAST stage; the other
    stages return zeros (sum over the comm to broadcast)."""
    p = axis_size(comm)
    n_micro = micro.shape[1]
    mb_shape = tuple(micro.shape[2:])
    stage = axis_rank(comm).reshape((-1,) + (1,) * len(mb_shape))
    act_in = torch.zeros((micro.shape[0],) + mb_shape, dtype=micro.dtype,
                         device=micro.device)
    outs = [torch.zeros_like(act_in) for _ in range(n_micro)]
    for t in range(n_micro + p - 1):
        # stage 0 injects microbatch t (while there is one); the others
        # take what arrived from the left
        inject = t if t < n_micro else 0
        act = torch.where(stage == 0, micro[:, inject], act_in)
        out = stage_fn(stage_params, act)
        # the last stage emits a result once the pipeline is full
        emit = t - (p - 1)
        if emit >= 0:
            outs[emit] = torch.where(stage == p - 1, out, outs[emit])
        act_in = ring_shift(out, comm, 1)    # stage i -> i+1 (wrap unused)
    return torch.stack(outs, dim=1)
