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
from mvapich2_tpu_torch.bench import k8_ablation
from mvapich2_tpu_torch.coll import tuning
from mvapich2_tpu_torch.ops import ici, quant, ring
from mvapich2_tpu_torch.utils.config import get_config

NP = 8
_TORCH = {np.float32: torch.float32, np.int32: torch.int32,
          np.int16: torch.int16, np.int8: torch.int8, np.uint8: torch.uint8,
          np.float16: torch.float16, np.uint16: torch.uint16,
          np.uint32: torch.uint32}


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
    if kind == "int8":
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    if kind == "bf16":
        return rng.normal(size=shape).astype(jnp.bfloat16)
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


@pytest.mark.parametrize("op", ["max", "min"])
def test_all_reduce_signed_zeros_and_nan_match_jax(comm8, op):
    """f32 max and min on values from {-1, -0.0, +0.0, 1, NaN}: a tie of
    -0.0 and +0.0 takes the sign the JAX kernel's jnp.maximum/minimum
    give it, and NaNs land where the JAX kernel's land. Bit patterns,
    with every NaN taken as one pattern (its payload is the arithmetic's,
    not the fold order's)."""
    rng = np.random.default_rng(17 + len(op))
    pool = np.array([-1.0, -0.0, 0.0, 1.0, np.nan], np.float32)
    xv = pool[rng.integers(0, 5, size=(NP, 101))]
    xv[:, :64] = pool[rng.integers(0, 4, size=(NP, 64))]   # no NaN: ties
    want = _jax_all_reduce(comm8, xv, op, chunk_bytes=32)
    got = ici.hbm_ring_all_reduce(torch.from_numpy(xv), op,
                                  chunk_bytes=32).numpy()

    def bits(a):
        return np.where(np.isnan(a), -1, a.view(np.int32))
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("np_dtype,op", [(np.uint32, "max"),
                                         (np.uint32, "sum"),
                                         (np.uint16, "min")])
def test_all_reduce_unsigned_matches_jax(comm8, np_dtype, op):
    """uint16 and uint32 run as the JAX kernel runs them: sums wrap, and
    max and min order values past 2^15 and 2^31 as unsigned."""
    info = np.iinfo(np_dtype)
    rng = np.random.default_rng(info.bits + len(op))
    xv = rng.integers(0, info.max, size=(NP, 21), endpoint=True) \
        .astype(np_dtype)
    want = _jax_all_reduce(comm8, xv, op, chunk_bytes=32)
    got = ici.hbm_ring_all_reduce(torch.from_numpy(xv), op, chunk_bytes=32)
    assert got.dtype == _TORCH[np_dtype]
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K5 against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,chunk_bytes,bidirectional,kind", [
    (13, 16, True, "int32"), (13, 16, False, "int32"),
    (6, 1 << 20, True, "int32"), (13, 16, True, "bf16"),
    (16, 8, False, "int8")])
def test_all_gather_parity(comm8, shard, chunk_bytes, bidirectional, kind):
    xv = _data(60 + shard, (NP, shard), kind)
    want = comm8.run(lambda s: pallas_ici.hbm_ring_all_gather(
        s, "x", NP, chunk_bytes=chunk_bytes, bidirectional=bidirectional,
        interpret=True, credits=False), jnp.asarray(xv.reshape(-1)),
        out_specs=P("x"))
    want = np.asarray(want).reshape(NP, NP * shard)
    ici.reset_counts()
    if kind == "bf16":
        rows = [torch.from_numpy(r.view(np.int16)).view(torch.bfloat16)
                for r in xv]
    else:
        rows = [torch.from_numpy(r) for r in xv]
    got = ici.hbm_ring_all_gather(rows, chunk_bytes=chunk_bytes,
                                  bidirectional=bidirectional)
    assert ici.PLAIN_CALLS["hbm_ring_all_gather"] == 1
    iv = {1: (torch.int8, np.int8), 2: (torch.int16, np.int16),
          4: (torch.int32, np.int32)}[got.element_size()]
    np.testing.assert_array_equal(got.view(iv[0]).numpy(),
                                  want.view(iv[1]))


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
                                      np.int16, np.int8, np.uint8,
                                      np.uint16, np.uint32])
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
    """The quant bin runs now that K9 is ported: an eligible call plans
    'quant', an ineligible one (here a budget below the bound at 8
    ranks) the exact 'hbm' tier, as the JAX planned_tier does."""
    env(QUANT_COLL="1e-2")
    nb = 8 << 20
    assert jax_tuning.device_tier("allreduce", nb) == "quant"
    assert tuning.device_tier("allreduce", nb) == "quant"
    for p in (2, 8):
        assert ici.planned_tier("allreduce", nb, torch.float32, "sum",
                                num_devices=p) == \
            pallas_ici.planned_tier("allreduce", nb, np.float32, "sum",
                                    interpret=True, num_devices=p)
    assert ici.planned_tier("allreduce", nb, torch.float32, "sum",
                            num_devices=2) == ("quant", None)
    assert ici.planned_tier("allreduce", nb, torch.float32, "sum",
                            num_devices=8) == ("hbm", None)
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
                               "hbm_ring_all_gather": 0,
                               "quant_ring_all_reduce": 0,
                               "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0}
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
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant.quant_ring_all_reduce(meta)
    assert ici.PLAIN_CALLS == {"hbm_ring_all_reduce": 0,
                               "hbm_ring_all_gather": 0,
                               "quant_ring_all_reduce": 0,
                               "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0}


def _model_k8(from_addrs, to_addrs, nbytes, esize, tile, grid):
    """Replay ``csrc/ring.cu`` ``remote_sendrecv_kernel``'s cut of its rows
    byte by byte from ``ici.k8_plan``: the threads' element pass (each
    bulk row's head and tail, every other row whole) and the bulk tiles,
    block by block as the kernel walks them (block b: tiles b, b + grid,
    ... of the bulk rows' flat index space, ``k8_cut`` recomputed from
    the output address as the kernel does). Returns how often each
    output byte of each row is written; every bulk tile is checked for
    16-byte aligned addresses on both sides and a whole number of 16
    bytes, every element range for whole elements."""
    p = len(to_addrs)
    mask, tpr, cuts = ici.k8_plan(from_addrs, to_addrs, nbytes, tile)
    cover = np.zeros((p, nbytes), np.int64)
    for r, c in enumerate(cuts):
        if c is None:
            cover[r] += 1
            continue
        head, mid = c
        assert head % esize == 0 and (nbytes - head - mid) % esize == 0
        assert head < 16 and nbytes - head - mid < 16
        cover[r, :head] += 1
        cover[r, head + mid:] += 1
    rows = [r for r in range(p) if mask >> r & 1]
    total = len(rows) * tpr
    for b in range(grid):
        for g in range(b, total, grid):
            r, k = rows[g // tpr], g % tpr
            head = min(nbytes, -to_addrs[r] % 16)       # the kernel's k8_cut
            mid = (nbytes - head) // 16 * 16
            assert cuts[r] == (head, mid)
            off = head + k * tile
            nb = max(0, min(tile, mid - k * tile))
            if nb:
                assert (from_addrs[r] + off) % 16 == 0
                assert (to_addrs[r] + off) % 16 == 0 and nb % 16 == 0
                cover[r, off:off + nb] += 1
    return cover


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("shard_off", [0, 1, 3])
@pytest.mark.parametrize("esize", [1, 2, 4])
def test_k8_cut_covers_every_byte_once(esize, shard_off, grid):
    """K8's cut (``k8_plan``, and the kernel's walk of it modelled by
    ``_model_k8``) writes every output byte exactly once, and only by
    16-byte aligned bulk copies or whole elements: p = 2, 3 and 8 ranks,
    shards at ``shard_off`` elements past a 16-byte boundary and the
    fresh ``(p, n)`` output's rows, n from one element to several tiles
    (tiles of 16 and 64 bytes), both partners of the exchange."""
    v = 16 // esize
    for p, src, dst in ((2, 0, 1), (3, 2, 0), (8, 1, 6)):
        part = ici._partners(p, src, dst)
        shard = [4096 * (j + 1) + shard_off * esize for j in range(p)]
        for n in (1, 3, v - 1, v, v + 1, 4 * v + 3, 37, 100):
            for tile in (16, 64):
                nbytes = n * esize
                cover = _model_k8([shard[j] for j in part],
                                  [r * nbytes for r in range(p)], nbytes,
                                  esize, tile, grid)
                assert (cover == 1).all(), (p, n, tile)


def test_k8_plan_rows():
    """Which rows go by bulk tiles: a row whose shard and output agree
    mod 16 bytes; the others are copied element by element whole."""
    # f32, n = 5: rows start at 0, 20, 40 (residues 0, 4, 8); shards at 4
    mask, tpr, cuts = ici.k8_plan([4, 4100, 8196], [0, 20, 40], 20, 64)
    assert mask == 0b010 and tpr == 1
    assert cuts == [None, (12, 0), None]
    # aligned shards and rows of whole words: every row bulk, no head
    mask, tpr, cuts = ici.k8_plan([0, 4096], [0, 64], 64, 16)
    assert mask == 0b11 and tpr == 4 and cuts == [(0, 64), (0, 64)]


@pytest.mark.parametrize("name", sorted(k8_ablation.EDITS))
def test_k8_ablation_edits_apply(name):
    """Every K8 ablation's text edits still fit ``csrc/ring.cu`` (each
    anchor once), and only the kernel variant leaves it as it is."""
    src = k8_ablation.variant_source(name)
    assert (src == k8_ablation.variant_source("kernel")) == (name == "kernel")
    assert name in k8_ablation.SHAPES
    for tile, stages, ahead, ctas in k8_ablation.SHAPES[name]:
        assert tile % 16 == 0 and 1 <= ahead <= stages <= 8 and ctas >= 1
