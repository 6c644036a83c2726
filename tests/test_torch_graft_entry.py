"""The port's graft entry (``mvapich2_tpu_torch/graft_entry.py``) held
against the JAX package's ``__graft_entry__.py`` on the CPU.

``entry()``'s forward gives the JAX forward's logits on the JAX
parameters carried across (``carry.params_from_numpy``), within the
forward tolerance of ``test_torch_models.py`` (rtol 1e-4 / atol 1e-5).
``_dryrun_impl(8)`` on the JAX dry run's parameters, tokens and
microbatches gives its train-step loss within rtol 1e-5 (the train
step's tolerance in ``test_torch_models.py``) and its pipeline output within rtol 2e-4 / atol 2e-5.
``dryrun_multichip`` runs on the JAX mesh-shape table at 1, 2, 4 and 8
ranks with a finite loss (and the shape rule past the table matches).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

import __graft_entry__ as jax_graft
from mvapich2_tpu.models import transformer as jtf
from mvapich2_tpu.parallel.mesh import MeshComm as JaxMeshComm
from mvapich2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mvapich2_tpu.parallel.pipeline import pipeline_apply as jax_pipeline

from mvapich2_tpu_torch import carry, graft_entry
from mvapich2_tpu_torch.models import transformer as tf


def test_entry_forward_matches_jax():
    jfwd, (jparams, jtokens) = jax_graft.entry()
    want = np.asarray(jax.jit(jfwd)(jparams, jtokens))
    fwd, (params, tokens) = graft_entry.entry(device="cpu")
    jcfg = jtf.Config(vocab=128, d_model=128, n_heads=8, n_layers=2,
                      d_ff=256, seq_len=128, batch=4, n_experts=4)
    for k in ("vocab", "d_model", "n_heads", "n_layers", "d_ff", "seq_len",
              "batch", "n_experts", "moe_layer"):
        assert getattr(graft_entry.ENTRY_CONFIG, k) == getattr(jcfg, k), k
    assert tuple(fwd(params, tokens).shape) == want.shape == (4, 128, 128)
    cfg = graft_entry.ENTRY_CONFIG
    from mvapich2_tpu_torch import make_mesh
    mesh = make_mesh((1, 1, 1), tf.AXES, "cpu")
    mine = carry.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, mesh)
    toks = tf.shard_tokens(torch.from_numpy(np.asarray(jtokens)), mesh)
    got = fwd(mine, toks).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dryrun_matches_jax():
    n = 8
    shape = graft_entry.dryrun_shape(n)
    assert shape == (2, 2, 2)
    jcfg = jtf.Config(vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128,
                      seq_len=16 * shape[1], batch=2 * shape[0],
                      n_experts=2 * shape[0], moe_layer=1)
    cfg = graft_entry.dryrun_config(shape)
    for k in ("vocab", "d_model", "n_heads", "n_layers", "d_ff", "seq_len",
              "batch", "n_experts", "moe_layer"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    devices = jax.devices()[:n]
    mesh = jax_make_mesh(shape, ("dp", "sp", "tp"), devices)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (jcfg.batch, jcfg.seq_len), 0, jcfg.vocab,
                                jnp.int32)
    _, jloss = jtf.make_train_step(jcfg, mesh)(
        jtf.shard_params(jparams, jcfg, mesh), tokens)
    # the JAX pipeline demo on the same microbatches
    D, n_micro = 16, 2 * n
    micro = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                         (n_micro, 4, D)))
    ws = jnp.stack([jnp.eye(D) * (1.0 + 0.01 * i) for i in range(n)])
    pcomm = JaxMeshComm(jax_make_mesh((n,), ("pp",), devices), "pp")
    jout = pcomm.run(lambda w, m: jax.lax.psum(jax_pipeline(
        lambda a, x: x @ a[0], w, m, "pp"), "pp"), ws, jnp.asarray(micro),
        in_specs=(JP("pp"), JP()), out_specs=JP())

    res = graft_entry._dryrun_impl(
        n, "cpu", params={k: np.asarray(v) for k, v in jparams.items()},
        tokens=np.asarray(tokens), micro=micro)
    assert res["mesh"] == shape
    np.testing.assert_allclose(res["loss"], float(jloss), rtol=1e-5)
    np.testing.assert_allclose(res["pipeline_out"].numpy(),
                               np.asarray(jout), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n,shape", [(1, (1, 1, 1)), (2, (1, 2, 1)),
                                     (4, (1, 2, 2)), (8, (2, 2, 2))])
def test_dryrun_multichip_shapes(n, shape):
    """The JAX table (and ``(1, *mesh_shape_for(n, 2))`` beyond it) and a
    finite loss, with the port's own seeded draws."""
    import math
    from mvapich2_tpu.parallel.mesh import mesh_shape_for as jax_msf
    for m in (3, 6, 12, 16):
        assert graft_entry.dryrun_shape(m) == (1, *jax_msf(m, 2))
    res = graft_entry.dryrun_multichip(n, device="cpu")
    assert res["mesh"] == shape and math.isfinite(res["loss"])
    assert tuple(res["pipeline_out"].shape) == (2 * n, 4, 16)


def test_entry_defaults_to_the_card(monkeypatch):
    """No device named means cuda:0; without a card it raises, never
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
