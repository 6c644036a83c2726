"""Parity of the port's slot kernels module (mvapich2_tpu_torch/ops/hbm.py,
plain route on the CPU) with the JAX package's ops/pallas_hbm.py run in
Pallas interpret mode. Inputs come from numpy seeds and reach both sides
through mvapich2_tpu_torch.carry.

Tolerances: rtol 2e-5 / atol 1e-4 on normal f32 data (the JAX tests'
own; the two sides sum in different orders); bitwise on integer-valued
f32 and on int32."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvapich2_tpu.ops import pallas_hbm as ph
from mvapich2_tpu_torch import carry
from mvapich2_tpu_torch.ops import hbm

RTOL, ATOL = 2e-5, 1e-4


def _bufs(seed, R, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(R, n)).astype(np.float32)
    if kind == "intf32":
        return rng.integers(-1000, 1000, size=(R, n)).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=(R, n), dtype=np.int32)
    raise ValueError(kind)


def _compare(got, want, kind):
    got = carry.to_numpy(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "normal":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _jax_slots(bufs, layout):
    x = jnp.asarray(bufs)
    if layout == "interleaved":
        return ph.pack_interleaved(x)
    R, n = bufs.shape
    return x.reshape(R, n // 128, 128)


@pytest.mark.parametrize("kind", ["normal", "intf32"])
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("R", [4, 3])
def test_fused_reduce_to_slot_parity(layout, mean, kind, R):
    M = 8
    bufs = _bufs(10, R, M * 128, kind)
    want = ph.fused_reduce_to_slot(_jax_slots(bufs, layout), layout=layout,
                                   mean=mean, block_m=4)
    x = carry.slots_from_numpy(bufs, layout, "cpu")
    before = hbm.PLAIN_CALLS["fused_reduce_to_slot"]
    got = hbm.fused_reduce_to_slot(x, layout=layout, mean=mean, block_m=4)
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == before + 1
    assert tuple(got.shape) == (M, 128)
    # bitwise on integer data for mean too: both sides multiply by
    # the float32 value of 1/R (R=3: a division would differ)
    _compare(got, want, kind)


def test_fused_reduce_to_slot_int32_wraps_like_jax():
    R, M = 8, 4
    bufs = _bufs(11, R, M * 128, "int32")     # sums overflow int32
    want = ph.fused_reduce_to_slot(_jax_slots(bufs, "planar"),
                                   layout="planar", block_m=4)
    got = hbm.fused_reduce_to_slot(carry.slots_from_numpy(bufs, "planar"),
                                   layout="planar")
    _compare(got, want, "int32")


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("kind", ["normal", "intf32"])
def test_fused_allreduce_parity(donate, kind):
    R, M = 8, 16
    bufs = _bufs(12, R, M * 128, kind)
    want = ph.fused_allreduce(ph.pack_interleaved(jnp.asarray(bufs)),
                              block_m=8, donate=donate)
    x = carry.slots_from_numpy(bufs, "interleaved", "cpu")
    got = hbm.fused_allreduce(x, block_m=8, donate=donate)
    assert (got is x) == donate
    _compare(got, want, kind)


@pytest.mark.parametrize("kind", ["normal", "intf32"])
def test_hbm_slot_allreduce_ragged_parity(kind):
    # n not a multiple of 128: the pad must not leak into the result
    R, n = 3, 1000
    bufs = _bufs(2, R, n, kind)
    want = ph.hbm_slot_allreduce(jnp.asarray(bufs))
    got = hbm.hbm_slot_allreduce(carry.slots_from_numpy(bufs, "rows"))
    assert tuple(got.shape) == (n,)
    _compare(got, want, kind)


def test_pack_unpack_roundtrip_parity():
    R, n = 4, 512
    bufs = np.arange(R * n, dtype=np.float32).reshape(R, n)
    t = carry.slots_from_numpy(bufs, "rows")
    packed = hbm.pack_interleaved(t)
    np.testing.assert_array_equal(
        carry.to_numpy(packed),
        np.asarray(ph.pack_interleaved(jnp.asarray(bufs))))
    np.testing.assert_array_equal(
        carry.to_numpy(packed),
        carry.to_numpy(carry.slots_from_numpy(bufs, "interleaved")))
    np.testing.assert_array_equal(
        carry.to_numpy(hbm.unpack_interleaved(packed)), bufs)


def test_bench_candidates_match_jax():
    M, R = 2048, 8
    mine = hbm.bench_candidates(M=M, R=R)
    ref = ph.bench_candidates(M=M, R=R)
    assert [(c[0], c[2], c[3]) for c in mine] == \
        [(c[0], c[2], c[3]) for c in ref]
    m = M * 128 * 4
    for name, _, traffic, chains in mine:
        assert traffic == ((R + 1) * m if "slot" in name else 2 * R * m)
        assert chains == name.startswith("hbm_fused")


def test_bench_candidates_ops_run():
    M, R = 512, 2
    bufs = _bufs(13, R, M * 128, "intf32")
    x = carry.slots_from_numpy(bufs, "interleaved")
    want = ph.bench_candidates(M=M, R=R)
    for (name, op, _, chains), (_, jop, _, _) in zip(
            hbm.bench_candidates(M=M, R=R), want):
        got = op(x)
        assert tuple(got.shape) == (tuple(x.shape) if chains else (M, 128))
        _compare(got, jop(ph.pack_interleaved(jnp.asarray(bufs))), "intf32")


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16])
def test_narrow_int_plain_wraps_like_jax(dtype):
    # the Pallas body's output cast wraps narrow integer sums; so do the
    # port's kernel and its plain version
    R, M = 8, 2
    np_dt = {torch.int8: np.int8, torch.uint8: np.uint8,
             torch.int16: np.int16}[dtype]
    info = np.iinfo(np_dt)
    bufs = np.random.default_rng(14).integers(
        info.min, info.max, size=(R, M * 128), endpoint=True).astype(np_dt)
    want = ph.fused_reduce_to_slot(_jax_slots(bufs, "planar"),
                                   layout="planar", block_m=2)
    got = hbm.fused_reduce_to_slot(carry.slots_from_numpy(bufs, "planar"),
                                   layout="planar")
    _compare(got, want, "int32")


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_plain_accumulates_in_f32(dtype):
    R, M = 8, 2
    x = torch.from_numpy(np.random.default_rng(15).normal(
        size=(R, M, 128)).astype(np.float32)).to(dtype)
    got = hbm.fused_reduce_to_slot(x)
    want = x.to(torch.float32).sum(0).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        hbm.fused_reduce_to_slot(torch.zeros(2, 4, 128), layout="diagonal")
    with pytest.raises(ValueError):
        hbm.fused_reduce_to_slot(torch.zeros(2, 4, 64))
    with pytest.raises(ValueError):
        hbm.fused_allreduce(torch.zeros(4, 128))
    with pytest.raises(TypeError):
        hbm.fused_reduce_to_slot(np.zeros((2, 4, 128), np.float32))
