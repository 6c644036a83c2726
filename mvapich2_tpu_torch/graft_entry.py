"""The entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``): a one-device forward step and a multi-rank dry
run of the flagship transformer.

``entry()`` returns ``(fwd, (params, tokens))``: ``fwd(params, tokens)``
is the transformer's forward (ring attention, tensor-parallel matmuls,
the MoE layer) on a (1, 1, 1) mesh, returning the global ``[batch, seq,
vocab]`` logits, at the JAX entry's ``Config`` (vocab 128, d_model 128, 8
heads, 2 layers, d_ff 256, seq 128, batch 4, 4 experts).

``dryrun_multichip(n)`` runs one training step with real dp/sp/tp/ep
splits on ``n`` virtual ranks of one device, on the JAX mesh-shape table
(8 -> (2, 2, 2), 4 -> (1, 2, 2), 2 -> (1, 2, 1), 1 -> (1, 1, 1), else
``(1, *mesh_shape_for(n, 2))``) and the JAX dry run's ``Config``, then the
``n``-stage pipeline demo, and asserts a finite loss. Where the JAX
package re-executes itself on a virtual CPU mesh when the host has fewer
chips, the port's virtual ranks live on the one card.

Both run on ``cuda:0`` unless the caller passes ``device="cpu"``.
``python -m mvapich2_tpu_torch.graft_entry`` runs the forward and
``dryrun_multichip(8)`` (MV2T_DRYRUN_N overrides 8).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import carry
from .models import transformer as tf
from .ops import collectives as coll
from .parallel.mesh import MeshComm, P, make_mesh, mesh_shape_for
from .parallel.pipeline import pipeline_apply

ENTRY_CONFIG = tf.Config(vocab=128, d_model=128, n_heads=8, n_layers=2,
                         d_ff=256, seq_len=128, batch=4, n_experts=4)


def entry(device=None):
    """``(fwd, (params, tokens))`` on a (1, 1, 1) mesh of ``device``."""
    cfg, mesh, params, tokens, _ = tf.demo_setup(
        ENTRY_CONFIG, mesh_shape=(1, 1, 1), device=device, n=1)
    comm = MeshComm(mesh, tf.AXES)

    def fwd(p, t):
        return comm.unshard(tf.forward(p, t, cfg, mesh), P("dp", "sp"))

    return fwd, (params, tokens)


def dryrun_shape(n_devices: int):
    """The JAX dry run's (dp, sp, tp) mesh for ``n_devices`` ranks."""
    table = {8: (2, 2, 2), 4: (1, 2, 2), 2: (1, 2, 1), 1: (1, 1, 1)}
    if n_devices in table:
        return table[n_devices]
    a, b = mesh_shape_for(n_devices, 2)
    return (1, a, b)


def dryrun_config(shape) -> tf.Config:
    """The JAX dry run's Config for a (dp, sp, tp) mesh."""
    return tf.Config(vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128,
                     seq_len=16 * max(shape[1], 1),
                     batch=2 * max(shape[0], 1), n_experts=2 * shape[0],
                     moe_layer=1)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One train step and the pipeline demo on ``n_devices`` virtual
    ranks of ``device``; returns what it ran (see ``_dryrun_impl``)."""
    return _dryrun_impl(n_devices, device)


def _dryrun_impl(n_devices: int, device=None, params=None, tokens=None,
                 micro: Optional[np.ndarray] = None) -> dict:
    """The dry run. ``params`` (the JAX ``init_params`` pytree as numpy
    arrays) and ``tokens`` (global ``[batch, seq]`` ints) replace the
    port's seeded draws, as does ``micro`` (``[2n, 4, 16]`` floats) for
    the pipeline's microbatches: a test feeds the JAX run's through
    ``carry.params_from_numpy``. Returns the mesh shape, the step's loss,
    its new parameters (stacked) and the pipeline's output."""
    shape = dryrun_shape(n_devices)
    cfg = dryrun_config(shape)
    mesh = make_mesh(shape, tf.AXES, device)
    if params is None:
        gen = torch.Generator().manual_seed(0)
        params = tf.shard_params(tf.init_params(cfg, gen, mesh.device), cfg,
                                 mesh)
    else:
        params = {k: v.to(mesh.device) for k, v in
                  carry.params_from_numpy(params, cfg, mesh).items()}
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len),
                               generator=torch.Generator().manual_seed(1))
    tokens = tf.shard_tokens(torch.as_tensor(np.asarray(tokens))
                             .to(mesh.device), mesh)
    new_params, loss = tf.make_train_step(cfg, mesh)(params, tokens)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"

    # pp demonstration: a pipeline of affine stages over all n ranks
    D, n_micro = 16, 2 * n_devices
    pmesh = make_mesh((n_devices,), ("pp",), mesh.device)
    pcomm = MeshComm(pmesh, "pp")
    ws = torch.stack([torch.eye(D) * (1.0 + 0.01 * i)
                      for i in range(n_devices)]).to(pmesh.device)
    if micro is None:
        m = torch.randn((n_micro, 4, D),
                        generator=torch.Generator().manual_seed(2))
    else:
        m = torch.from_numpy(np.asarray(micro, dtype=np.float32))
    m = m.to(pmesh.device)

    def run(w, mb):
        # results live on the last stage; the sum broadcasts them
        return coll.allreduce(pipeline_apply(
            lambda a, b: b @ a[:, 0], w, mb, pcomm), pcomm)

    out = pcomm.run(run, ws, m, in_specs=(P("pp"), P()), out_specs=P())
    assert torch.isfinite(out).all(), "non-finite pipeline output"
    return {"mesh": shape, "loss": loss, "params": new_params,
            "pipeline_out": out}


if __name__ == "__main__":
    fn, args = entry()
    print("entry forward:", tuple(fn(*args).shape))
    n = int(os.environ.get("MV2T_DRYRUN_N", "8"))
    res = dryrun_multichip(n)
    print(f"dryrun_multichip({n}): mesh={res['mesh']} "
          f"loss={res['loss']:.4f} "
          f"pipeline_out={tuple(res['pipeline_out'].shape)} OK")
