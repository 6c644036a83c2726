"""Parity of the port's streaming ring module (mvapich2_tpu_torch/ops/
ici.py: K3 hbm_ring_all_reduce, K5 hbm_ring_all_gather, their helpers
and the tier dispatch; plain route on the CPU) with the JAX package's
ops/pallas_ici.py run in Pallas interpret mode on the 8-device virtual
CPU mesh. The interpreter of this jax cannot signal a remote semaphore,
so the JAX kernels run with ``credits=False`` (the interpreter's
documented mode: its emulation is synchronous, flow control is moot).

Shapes: the chunk-boundary cases of tests/test_pallas_ici.py (blocks
that divide exactly, an identity-padded tail, a short last chunk, one
chunk covering the block), at pipeline depth 2, 3 and 4, with both ring
directions and with one.

Tolerances: bitwise everywhere. The plain versions replay the kernels'
ring schedule, so they fold in the kernels' order on any data.

Every test that changes an MV2T_* variable restores it and reloads both
packages' configs in the fixture's teardown, and the JAX package's
measured-profile tables are swapped for empty ones while a test runs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mvapich2_tpu.coll import tuning as jax_tuning
from mvapich2_tpu.ops import pallas_ici
from mvapich2_tpu.parallel import MeshComm, make_mesh as jax_make_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import mpit
from mvapich2_tpu_torch.coll import tuning
from mvapich2_tpu_torch.ops import ici, ring
from mvapich2_tpu_torch.utils.config import get_config

NP = 8
_TORCH = {np.float32: torch.float32, np.int32: torch.int32,
          np.int16: torch.int16, np.int8: torch.int8, np.uint8: torch.uint8,
          np.float16: torch.float16}


@pytest.fixture(scope="module")
def comm8():
    return MeshComm(jax_make_mesh((NP,), ("x",)))


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages; the
    teardown restores the environment and reloads both configs. No
    measured JAX profile is in force while the test runs."""
    monkeypatch.setattr(jax_tuning, "_DEVICE_CROSSOVERS", {})
    monkeypatch.setattr(jax_tuning, "_KERNEL_PARAMS", {})

    def set_env(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(f"MV2T_{k}", raising=False)
            else:
                monkeypatch.setenv(f"MV2T_{k}", str(v))
        jax_config().reload()
        get_config().reload()
    set_env()
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()


def _data(seed, shape, kind, op="sum"):
    rng = np.random.default_rng(seed)
    if op == "prod":        # small factors: every product is exact
        return rng.integers(1, 3, size=shape).astype(
            np.int32 if kind == "int32" else np.float32)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "intf32":
        return rng.integers(-1000, 1000, size=shape).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    raise ValueError(kind)


def _jax_all_reduce(comm8, xv, op, **kw):
    out = comm8.run(lambda s: pallas_ici.hbm_ring_all_reduce(
        s, "x", NP, op=op, interpret=True, credits=False, **kw),
        jnp.asarray(xv.reshape(-1)))
    return np.asarray(out).reshape(NP, -1)


# ---------------------------------------------------------------------------
# K3 against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,chunk_bytes", [
    (8, 16),          # shard divides p, chunks divide the block exactly
    (13, 16),         # shard % p != 0: identity-padded tail
    (37, 64),         # non-divisible block/chunk remainder (last short)
    (5, 1 << 20),     # 1-chunk degenerate: chunk covers the whole block
])
def test_all_reduce_chunk_boundaries(comm8, shard, chunk_bytes):
    xv = _data(shard, (NP, shard), "intf32")
    want = _jax_all_reduce(comm8, xv, "sum", chunk_bytes=chunk_bytes)
    ici.reset_counts()
    got = ici.hbm_ring_all_reduce(torch.from_numpy(xv),
                                  chunk_bytes=chunk_bytes)
    assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 1
    assert ici.LAUNCHES["hbm_ring_all_reduce"] == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_all_reduce_depth_and_direction(comm8, depth, bidirectional):
    """Normal f32 data, so a different fold order would show."""
    xv = _data(7 + depth, (NP, 37), "normal")
    want = _jax_all_reduce(comm8, xv, "sum", chunk_bytes=64, depth=depth,
                           bidirectional=bidirectional)
    got = ici.hbm_ring_all_reduce(torch.from_numpy(xv), chunk_bytes=64,
                                  depth=depth, bidirectional=bidirectional)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("kind", ["int32", "intf32"])
def test_all_reduce_ops(comm8, op, kind):
    xv = _data(3, (NP, 21), kind, op)          # ragged: 21 % 8 != 0
    want = _jax_all_reduce(comm8, xv, op, chunk_bytes=32)
    got = ici.hbm_ring_all_reduce(torch.from_numpy(xv), op,
                                  chunk_bytes=32)
    assert got.dtype == _TORCH[xv.dtype.type]
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K5 against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,chunk_bytes,bidirectional", [
    (13, 16, True), (13, 16, False), (6, 1 << 20, True)])
def test_all_gather_parity(comm8, shard, chunk_bytes, bidirectional):
    xv = _data(60 + shard, (NP, shard), "int32")
    want = comm8.run(lambda s: pallas_ici.hbm_ring_all_gather(
        s, "x", NP, chunk_bytes=chunk_bytes, bidirectional=bidirectional,
        interpret=True, credits=False), jnp.asarray(xv.reshape(-1)),
        out_specs=P("x"))
    want = np.asarray(want).reshape(NP, NP * shard)
    ici.reset_counts()
    got = ici.hbm_ring_all_gather([torch.from_numpy(r) for r in xv],
                                  chunk_bytes=chunk_bytes,
                                  bidirectional=bidirectional)
    assert ici.PLAIN_CALLS["hbm_ring_all_gather"] == 1
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the helpers against their JAX twins
# ---------------------------------------------------------------------------

def test_chunks_and_spans_match():
    for lo, hi, chunk in [(0, 64, 16), (0, 37, 16), (19, 37, 8),
                          (0, 5, 1 << 20), (3, 3, 4)]:
        assert ici._chunks(lo, hi, chunk) == pallas_ici._chunks(lo, hi,
                                                                chunk)
    for nblk in (0, 1, 2, 5, 37, 64):
        for ndir in (1, 2):
            assert ici._block_spans(nblk, ndir) == \
                pallas_ici._block_spans(nblk, ndir)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float16, np.int32,
                                      np.int16, np.int8, np.uint8])
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_pad_identity_matches(np_dtype, op):
    assert ici._pad_identity(_TORCH[np_dtype], op) == \
        pallas_ici._pad_identity(np_dtype, op)


def test_knobs_and_their_env_precedence(env):
    for dt in (np.float32, np.int16, np.uint8):
        for cb in (None, 16, 1 << 20):
            assert ici._cfg_chunk_elems(_TORCH[dt], cb) == \
                pallas_ici._cfg_chunk_elems(dt, cb)
    for d in (None, 1, 2, 3, 5):
        assert ici._cfg_depth(d) == pallas_ici._cfg_depth(d)
    for p in (2, 3, 8):
        for b in (None, True, False):
            assert ici._resolve_ndir(p, b) == pallas_ici._resolve_ndir(p, b)
    env(ICI_CHUNK_BYTES="64K", ICI_PIPELINE_DEPTH="3", ICI_BIDIR="0")
    assert ici._cfg_chunk_elems(torch.float32, None) == \
        pallas_ici._cfg_chunk_elems(np.float32, None) == 16384
    assert ici._cfg_chunk_elems(torch.float32, 256) == 64   # argument wins
    assert ici._cfg_depth(None) == pallas_ici._cfg_depth(None) == 3
    assert ici._resolve_ndir(8, None) == pallas_ici._resolve_ndir(8, None) \
        == 1
    assert ici._resolve_ndir(8, True) == 2


def test_device_tier_matches(env):
    sizes = [1, 4 << 20, (4 << 20) + 1, 1 << 27]
    for nb in sizes:
        assert tuning.device_tier("allreduce", nb) == \
            jax_tuning.device_tier("allreduce", nb)
    env(DEV_TIER_VMEM_MAX="64", DEV_TIER_XLA_MIN="4096")
    for nb in (64, 65, 4095, 4096, 1 << 20):
        assert tuning.device_tier("allreduce", nb) == \
            jax_tuning.device_tier("allreduce", nb)
    assert tuning.device_tier("allreduce", 4096) == "xla"


def test_planned_tier_matches(env):
    env(DEV_TIER_VMEM_MAX="64", DEV_TIER_XLA_MIN="4096")
    cases = [(64, np.float32, "sum"), (100, np.float32, "sum"),
             (8192, np.float32, "sum"), (100, np.float32, "land"),
             (100, np.int8, "max"), (0, np.float32, "sum")]
    for nb, dt, op in cases:
        assert ici.planned_tier("allreduce", nb, _TORCH[dt], op) == \
            pallas_ici.planned_tier("allreduce", nb, dt, op, interpret=True)
    assert ici.planned_tier("allreduce", 100, torch.complex64, "sum") == \
        pallas_ici.planned_tier("allreduce", 100, np.complex64, "sum",
                                interpret=True) == ("xla", "dtype")


def test_quant_bin_raises_until_its_kernel_is_ported(env):
    env(QUANT_COLL="1e-2")
    nb = 8 << 20
    assert jax_tuning.device_tier("allreduce", nb) == "quant"
    assert tuning.device_tier("allreduce", nb) == "quant"
    with pytest.raises(NotImplementedError, match="K9"):
        ici.planned_tier("allreduce", nb, torch.float32, "sum")
    # at or below the vmem edge the budget changes nothing
    assert ici.planned_tier("allreduce", 4 << 20, torch.float32,
                            "sum") == ("vmem", None)
    # past a lowered vmem edge, the JAX default quant edge (1 MiB) holds;
    # a malformed budget or wire reads as off
    for budget in ("1e-2", "fp8:0.25", "Q8:1e-3", "xx:1e-2", "q8:", "abc",
                   ""):
        env(QUANT_COLL=budget, DEV_TIER_VMEM_MAX="64")
        for nb in (65, (1 << 20) - 1, 1 << 20):
            assert tuning.device_tier("allreduce", nb) == \
                jax_tuning.device_tier("allreduce", nb), (budget, nb)


# ---------------------------------------------------------------------------
# the dispatchers
# ---------------------------------------------------------------------------

def test_dispatch_routes_by_tier(env):
    x = torch.from_numpy(_data(9, (NP, 64), "intf32"))
    want = np.broadcast_to(x.numpy().sum(0), (NP, 64))
    ring.reset_counts()
    ici.reset_counts()
    np.testing.assert_array_equal(ici.ici_all_reduce(x).numpy(), want)
    assert ring.PLAIN_CALLS["ring_all_reduce"] == 1           # K6
    np.testing.assert_array_equal(
        ici.ici_all_reduce(x[:, :61]).numpy(),
        np.broadcast_to(x.numpy()[:, :61].sum(0), (NP, 61)))
    assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 1        # n % p: K3
    ici.ici_all_reduce(x, "max")
    assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 2        # max: K3
    env(DEV_TIER_VMEM_MAX="16")
    ici.ici_all_reduce(x)
    assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 3        # > vmem: K3
    ici.ici_all_gather(x)
    assert ici.PLAIN_CALLS["hbm_ring_all_gather"] == 1        # K5
    env(DEV_TIER_VMEM_MAX=None)
    ici.ici_all_gather(x)
    assert ring.PLAIN_CALLS["ring_all_gather"] == 1           # K7


def test_dispatch_stock_lowering(env):
    """Past DEV_TIER_XLA_MIN the stock reduction runs; the dispatcher
    counts nothing (the mesh channel counts each call per rank)."""
    env(DEV_TIER_VMEM_MAX="64", DEV_TIER_XLA_MIN="256")
    before = mpit.pvar("dev_coll_fallback_size").read()
    ici.reset_counts()
    x = torch.from_numpy(_data(10, (NP, 100), "intf32"))      # 400 B
    got = ici.ici_all_reduce(x, "min")
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(x.numpy().min(0), (NP, 100)))
    got = ici.ici_all_gather(x)
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(x.numpy().reshape(-1), (NP, 800)))
    assert mpit.pvar("dev_coll_fallback_size").read() == before
    assert ici.PLAIN_CALLS == {"hbm_ring_all_reduce": 0,
                               "hbm_ring_all_gather": 0}
    # every rank gets its own output
    assert got[0].data_ptr() != got[1].data_ptr()


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = [torch.empty(16, device="meta") for _ in range(NP)]
    ici.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ici.hbm_ring_all_reduce(meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ici.hbm_ring_all_gather(meta)
    with pytest.raises(ValueError, match="op"):
        ici.hbm_ring_all_reduce(meta, "land")
    assert ici.PLAIN_CALLS == {"hbm_ring_all_reduce": 0,
                               "hbm_ring_all_gather": 0}
