"""The port's MoE step bench (mvapich2_tpu_torch/bench/moe.py) against the
JAX package's (mvapich2_tpu/bench/moe.py): the routing matrices, one
step of dispatch alltoallv -> expert matmul -> combine alltoallv at
tokens 32, dmodel 16, p = 8, and the artifact.

The JAX step is built from the JAX dispatchers ``ici_all_to_allv`` in
Pallas interpret mode on the 8-device virtual CPU mesh; this jax's
interpreter cannot signal a remote semaphore, so
``pallas_ici.have_remote_signal`` is patched (through monkeypatch) to
say so and the kernels run creditless. Both sides get the same seeded
numpy tokens and the same expert matrix, carried from numpy
(``carry.expert_from_numpy``).

Tolerances: the alltoall halves bitwise (they move bytes); the expert
product rtol 1e-5 / atol 1e-5 (float32 sums of 16 products, taken in
another order by XLA and by torch)."""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mvapich2_tpu.bench import moe as jax_moe
from mvapich2_tpu.coll import tuning as jax_tuning
from mvapich2_tpu.ops import pallas_alltoall, pallas_ici
from mvapich2_tpu.parallel import MeshComm, make_mesh as jax_make_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import carry
from mvapich2_tpu_torch.bench import moe
from mvapich2_tpu_torch.ops import alltoall
from mvapich2_tpu_torch.utils.config import get_config

NP = 8
TOKENS, DMODEL = 32, 16


@pytest.fixture
def creditless(monkeypatch):
    """The JAX kernels creditless under the interpreter, no measured JAX
    profile in force; both configs reloaded after."""
    monkeypatch.setattr(pallas_ici, "have_remote_signal", lambda: False)
    monkeypatch.setattr(jax_tuning, "_DEVICE_CROSSOVERS", {})
    monkeypatch.setattr(jax_tuning, "_KERNEL_PARAMS", {})
    yield
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()


@pytest.mark.parametrize("p,tokens", [(8, 32), (8, 24), (8, 4096),
                                      (3, 10), (4, 7), (2, 5)])
@pytest.mark.parametrize("shape", ["uniform", "skew", "hot"])
def test_routing_matches(p, tokens, shape):
    got = moe.routing(p, tokens, shape)
    assert got == jax_moe.routing(p, tokens, shape)
    if shape != "uniform" or tokens % p == 0:    # uniform: tokens // p each
        assert all(sum(row) == tokens for row in got)


def test_moe_step_matches_jax(creditless):
    comm8 = MeshComm(jax_make_mesh((NP,), ("x",)))
    ecounts = [[c * DMODEL for c in row]
               for row in moe.routing(NP, TOKENS, "hot")]
    back = [[ecounts[j][i] for j in range(NP)] for i in range(NP)]
    rng = np.random.default_rng(21)
    w = rng.normal(size=(DMODEL, DMODEL)).astype(np.float32)
    xs = [rng.normal(size=TOKENS * DMODEL).astype(np.float32)
          for _ in range(NP)]
    recv = [sum(ecounts[j][r] for j in range(NP)) for r in range(NP)]

    # the JAX step, as bench/moe.py builds it (shards padded to in_len)
    _, _, in_len, _ = pallas_alltoall.packed_displs(ecounts)
    _, _, rlen, _ = pallas_alltoall.packed_displs(back)
    wj = jnp.asarray(w)

    def jstep(v):
        toks = pallas_alltoall.ici_all_to_allv(v.reshape(-1), "x", NP,
                                               ecounts, interpret=True)
        h = (toks.reshape(-1, DMODEL) @ wj).reshape(-1)
        bk = jnp.zeros((rlen,), jnp.float32).at[:h.size].set(h)
        out = pallas_alltoall.ici_all_to_allv(bk, "x", NP, back,
                                              interpret=True)
        return toks, h, out

    buf = np.zeros((NP, in_len), np.float32)
    for r in range(NP):
        buf[r, :xs[r].size] = xs[r]
    jt, jh, jo = (np.asarray(a).reshape(NP, -1) for a in comm8.run(
        jstep, jnp.asarray(buf.reshape(-1)),
        out_specs=(P("x"), P("x"), P("x"))))

    W = carry.expert_from_numpy(w)
    alltoall.reset_counts()
    toks, h, out = moe.moe_step([torch.from_numpy(x) for x in xs], W,
                                ecounts)
    assert alltoall.PLAIN_CALLS["hbm_alltoallv"] == 2
    for r in range(NP):
        # dispatch, bitwise
        np.testing.assert_array_equal(toks[r].numpy(), jt[r, :recv[r]])
        # the expert product
        np.testing.assert_allclose(h[r].numpy(), jh[r, :recv[r]],
                                   rtol=1e-5, atol=1e-5)
        # the whole step: every token back at its rank, times W
        np.testing.assert_allclose(out[r].numpy(), jo[r, :xs[r].size],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            out[r].numpy(), (xs[r].reshape(-1, DMODEL) @ w).reshape(-1),
            rtol=1e-5, atol=1e-5)
    # combine, bitwise: the port's combine on the JAX expert outputs
    comb = alltoall.ici_all_to_allv(
        [torch.from_numpy(np.array(jh[r, :recv[r]]))
         for r in range(NP)], back)
    for r in range(NP):
        np.testing.assert_array_equal(comb[r].numpy(), jo[r, :xs[r].size])


def test_sweep_artifact(tmp_path):
    art = moe.sweep([20], dmodel=8, iters=1, device="cpu")
    assert set(art) == {"results", "a2a_tiers", "wire_bytes", "detail"}
    assert set(art["results"]) == {"dev_alltoall_effbw", "moe_step",
                                   "moe_step_skew", "moe_step_hot"}
    key = str(16 * 8 * 4)                 # 20 tokens cut to p | T = 16
    for band in art["results"].values():
        assert set(band) == {key} and band[key] > 0
    assert art["a2a_tiers"] == {key: "hbm"}
    # the JAX bench's analytic wire bytes
    want = {}
    for shape in ("uniform", "skew", "hot"):
        ec = [[c * 8 for c in row] for row in jax_moe.routing(NP, 16, shape)]
        want[shape] = 4 * max(sum(c for j, c in enumerate(row) if j != i)
                              for i, row in enumerate(ec))
    assert art["wire_bytes"] == {key: want}
    assert art["detail"]["platform"] == "cpu"
    assert art["detail"]["matmul_allow_tf32"] is False
    out = tmp_path / "moe.json"
    assert moe.main(["--tokens", "16", "--dmodel", "4", "--iters", "1",
                     "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["detail"]["dmodel"] == 4


def test_moe_step_round_trip_and_carry():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(8, 8)).astype(np.float32)
    W = carry.expert_from_numpy(w)
    np.testing.assert_array_equal(carry.to_numpy(W), w)
    with pytest.raises(ValueError, match="square"):
        carry.expert_from_numpy(w[:, :4])
    counts = [[c * 8 for c in row] for row in moe.routing(4, 12, "skew")]
    xs = [torch.from_numpy(rng.normal(size=12 * 8).astype(np.float32))
          for _ in range(4)]
    _, _, out = moe.moe_step(xs, W, counts)
    for x, o in zip(xs, out):
        np.testing.assert_allclose(o.numpy(), (x.numpy().reshape(-1, 8) @ w)
                                   .reshape(-1), rtol=1e-5, atol=1e-5)


def test_bench_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.sweep([16], dmodel=4, iters=1)
    counts = [[4] * 2 for _ in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.breakdown([torch.zeros(8)] * 2, torch.eye(4), counts)
