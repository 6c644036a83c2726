"""Parity of the port's sequence-parallel attention slice
(mvapich2_tpu_torch/ops/collectives.py in the stacked layout,
MeshComm.run, models/ring_attention.py and models/ulysses.py) with the
JAX package's, whose functions run under shard_map on the 8-device
virtual CPU mesh (the flash kernels in Pallas interpret mode). Both
sides get the same seeded numpy inputs; the path has no parameters.

Tolerances: the stacked collectives move values, so they are bitwise
(the sum too: both fold the ranks in order). Attention outputs: rtol
2e-4 / atol 2e-5 in f32 (the JAX tests' bound for flash against dense:
the streaming softmax and the matrix products order f32 sums
differently), one ulp of the output for bf16 inputs (an f32 result that
differs in its last bits may round the other way)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax

from mvapich2_tpu.models import ring_attention as jra
from mvapich2_tpu.models import ulysses as jul
from mvapich2_tpu.ops import collectives as jcoll
from mvapich2_tpu.parallel import MeshComm as JaxMeshComm
from mvapich2_tpu.parallel import make_mesh as jax_make_mesh
from mvapich2_tpu_torch import make_mesh
from mvapich2_tpu_torch.models import flash
from mvapich2_tpu_torch.models import ring_attention as ra
from mvapich2_tpu_torch.models import ulysses as ul
from mvapich2_tpu_torch.ops import collectives as coll
from mvapich2_tpu_torch.parallel import MeshComm

from test_torch_flash import DTYPES, assert_close

NP = 8


@pytest.fixture(scope="module")
def comms():
    return (MeshComm(make_mesh((NP,), ("sp",), "cpu")),
            JaxMeshComm(jax_make_mesh((NP,), ("sp",), jax.devices()[:NP])))


def _qkv(seed, T, H, D, dt):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((T, H, D)).astype(np.float32)
              for _ in range(3)]
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# ---------------------------------------------------------------------------
# the stacked collectives, bitwise against lax
# ---------------------------------------------------------------------------

def _same(got, want):
    g = got.numpy()
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ring_shift_matches_ppermute(comms, shift):
    mine, ref = comms
    x = np.random.default_rng(30).standard_normal((NP * 4, 3, 5)).astype(
        np.float32)
    _same(mine.run(lambda s: coll.ring_shift(s, mine, shift), x),
          ref.run(lambda s: jcoll.ring_shift(s, "sp", shift), x))


@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1), (0, 0), (1, 2),
                                          (2, 1)])
def test_all_to_all_matches_lax(comms, split, concat):
    """The reshard alone: a wrong block order would still pass an
    attention test whenever q, k and v were permuted alike."""
    mine, ref = comms
    x = np.arange(NP * 8 * 16 * 8, dtype=np.int32).reshape(NP * 8, 16, 8)
    _same(mine.run(lambda s: coll.all_to_all(s, mine, split, concat), x),
          ref.run(lambda s: jcoll.all_to_all(s, "sp", split, concat), x))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_allreduce_matches_psum(comms, op):
    mine, ref = comms
    x = np.random.default_rng(31).standard_normal((NP * 2, 257)).astype(
        np.float32)
    _same(mine.run(lambda s: coll.allreduce(s, mine, op), x),
          ref.run(lambda s: jcoll.allreduce(s, "sp", op), x))


def test_axis_rank_and_size(comms):
    mine, ref = comms
    x = np.zeros((NP, 1), np.int32)
    got = mine.run(
        lambda s: s + coll.axis_rank(mine).to(s.dtype)[:, None, None], x)
    want = ref.run(lambda s: s + lax.axis_index("sp").astype(s.dtype), x)
    _same(got, want)
    assert coll.axis_size(mine) == NP


def test_meshcomm_run_layout(comms):
    mine, _ = comms
    x = torch.arange(NP * 3 * 2).reshape(NP * 3, 2)
    seen = []
    out = mine.run(lambda s: seen.append(s.shape) or s * 2, x)
    assert seen == [(NP, 3, 2)] and torch.equal(out, x * 2)
    a, b = mine.run(lambda s: (s, s + 1), x)
    assert torch.equal(a, x) and torch.equal(b, x + 1)
    with pytest.raises(ValueError, match="does not split"):
        mine.run(lambda s: s, torch.zeros(NP + 1))


# ---------------------------------------------------------------------------
# the attention paths against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(comms, causal, dt):
    mine, ref = comms
    (jq, jk, jv), (tq, tk, tv) = _qkv(40, 128, 2, 32, dt)
    want = ref.run(lambda q, k, v: jra.ring_attention(q, k, v, "sp",
                                                      causal=causal),
                   jq, jk, jv)
    got = mine.run(lambda q, k, v: ra.ring_attention(q, k, v, mine,
                                                     causal=causal),
                   tq, tk, tv)
    assert got.dtype == DTYPES[dt][1]
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_flash_matches_jax(comms, causal, dt):
    """K16 (its plain version) each step, one call a step over the ranks
    that compute: p calls in all."""
    mine, ref = comms
    (jq, jk, jv), (tq, tk, tv) = _qkv(41, 128, 2, 32, dt)
    want = ref.run(lambda q, k, v: jra.ring_attention_flash(
        q, k, v, "sp", causal=causal, block_q=16, block_k=16,
        interpret=True), jq, jk, jv)
    flash.reset_counts()
    got = mine.run(lambda q, k, v: ra.ring_attention_flash(
        q, k, v, mine, causal=causal, block_q=16, block_k=16), tq, tk, tv)
    assert flash.PLAIN_CALLS == {"flash_attention": 0,
                                 "flash_attention_parts": NP}
    assert flash.LAUNCHES == {"flash_attention": 0,
                              "flash_attention_parts": 0}
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_attention_matches_jax(comms, causal, use_flash, dt):
    mine, ref = comms
    (jq, jk, jv), (tq, tk, tv) = _qkv(42, 128, 8, 32, dt)
    want = ref.run(lambda q, k, v: jul.ulysses_attention(
        q, k, v, "sp", causal=causal, use_flash=use_flash, interpret=True),
        jq, jk, jv)
    flash.reset_counts()
    got = mine.run(lambda q, k, v: ul.ulysses_attention(
        q, k, v, mine, causal=causal, use_flash=use_flash), tq, tk, tv)
    assert flash.PLAIN_CALLS["flash_attention"] == int(use_flash)
    assert got.dtype == DTYPES[dt][1]
    assert_close(got, want, dt)


def test_ring_and_ulysses_agree_with_dense(comms):
    """The port's two strategies agree with each other and with dense
    attention over the gathered sequence (f32, causal), and the JAX
    dense reference agrees with the port's."""
    mine, _ = comms
    (jq, jk, jv), (tq, tk, tv) = _qkv(43, 128, 8, 32, "f32")
    ring = mine.run(lambda q, k, v: ra.ring_attention_flash(
        q, k, v, mine, block_q=16, block_k=16), tq, tk, tv)
    uly = mine.run(lambda q, k, v: ul.ulysses_attention(
        q, k, v, mine, use_flash=True), tq, tk, tv)
    np.testing.assert_allclose(ring.numpy(), uly.numpy(), rtol=2e-4,
                               atol=2e-5)
    dense = ra.local_attention_reference(tq, tk, tv)
    assert_close(dense, jra.local_attention_reference(jq, jk, jv))
    assert_close(ring, dense)
    assert_close(uly, dense)


def test_heads_must_divide(comms):
    mine, _ = comms
    x = torch.zeros(NP * 2, 4, 16)
    with pytest.raises(ValueError, match="not divisible"):
        mine.run(lambda q, k, v: ul.ulysses_attention(q, k, v, mine), x, x,
                 x)
