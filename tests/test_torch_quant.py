"""Parity of the port's quant tier (mvapich2_tpu_torch/ops/quant.py: the
codec, the K9 wrapper quant_ring_all_reduce and its plain version, a CPU
model of K9's direct walk, the wire accounting; plus K14's quantized
wire in ops/rma.py and the quant tier plans) with the JAX package's
ops/pallas_quant.py and
ops/pallas_rma.py, run in Pallas interpret mode on the 8-device virtual
CPU mesh (``credits=False``: the interpreter cannot signal a remote
semaphore).

The JAX kernels run jitted, so the reference arithmetic is what XLA's
CPU code makes of them: the scale ``amax / 127`` becomes ``amax *
f32(1/127)`` and the decode-and-fold ``acc + q * scale`` one fused
multiply-add. The codec tests compare against the jitted codec and show
both rewrites.

Tolerances: bitwise everywhere (codes, scales, every rank's result, the
window), except the exact-fold test, which holds the quantized result to
``declared_bound`` of an f64 sum.

Every test that changes an MV2T_* variable restores it and reloads both
packages' configs in the fixture's teardown, and the JAX package's
measured-profile tables are swapped for empty ones while a test runs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mvapich2_tpu.coll import tuning as jax_tuning
from mvapich2_tpu.ops import pallas_ici, pallas_quant, pallas_rma
from mvapich2_tpu.parallel import MeshComm, make_mesh as jax_make_mesh
from mvapich2_tpu.parallel.mesh import shard_map
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import carry
from mvapich2_tpu_torch.coll import tuning
from mvapich2_tpu_torch.ops import ici, quant, rma
from mvapich2_tpu_torch.utils.config import get_config

NP = 8
_MESHES = {}
_TORCH = {np.float32: torch.float32, np.float16: torch.float16,
          np.int32: torch.int32, np.int8: torch.int8,
          np.uint32: torch.uint32, np.float64: torch.float64,
          jnp.bfloat16: torch.bfloat16}


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


def _comm(p):
    if p not in _MESHES:
        _MESHES[p] = MeshComm(jax_make_mesh((p,), ("x",),
                                            jax.devices()[:p]))
    return _MESHES[p]


def _bits(a):
    """The raw bits of a float array or tensor (bf16 included)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def _torch_in(a, dtype):
    """The same values as a torch tensor and a JAX array: numpy f32,
    rounded to f16 by numpy or to bf16 by the JAX side, carried bit for
    bit."""
    if dtype == "bf16":
        j = np.asarray(jnp.asarray(a, jnp.bfloat16))
        return carry.window_from_numpy(j), jnp.asarray(j)
    if dtype == "f16":
        a = a.astype(np.float16)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def _blocks(rng, nb, blk, wire):
    """nb blocks of blk f32 values: normal data at mixed scales, a zero
    block, -0.0, a block whose codes sit exactly on rounding ties, and
    values past the code range after rounding."""
    x = (rng.standard_normal(nb * blk) *
         rng.choice([1e-3, 1.0, 1e3], size=nb * blk)).astype(np.float32)
    x[:blk] = 0.0
    x[blk] = -0.0
    t = x[2 * blk:3 * blk]
    if wire == "q8":
        # absmax 127 makes the scale 127 * f32(1/127); k + 0.5 lands on
        # or beside a tie of the code rounding
        t[:] = (np.arange(blk) % 254 - 127 + 0.5).astype(np.float32)
        t[0] = 127.0
    else:
        # absmax 448: the scale is 448 * f32(1/448) == 1, so these are
        # exact e4m3 ties (1.0625 between 1 and 1.125, 17 between 16 and
        # 18, 0.01953125 halfway down the subnormals, ...)
        ties = np.array([1.0625, -1.0625, 17.0, -17.0, 2.125, 0.01953125,
                         -0.013671875, 232.0, 0.0009765625, -3.25],
                        np.float32)
        t[:] = np.resize(ties, blk)
        t[0] = 448.0
    return x


# ---------------------------------------------------------------------------
# the codec against the JAX codec, jitted as the JAX kernel runs it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["q8", "fp8"])
@pytest.mark.parametrize("blk", [8, 16, 32, 128])
def test_codec_matches_jax(wire, blk):
    rng = np.random.default_rng(blk)
    x = _blocks(rng, 48, blk, wire)
    want = np.asarray(jax.jit(lambda v: pallas_quant._encode_f32(
        v, blk, wire))(jnp.asarray(x)))
    got = quant.encode_f32_ref(torch.from_numpy(x), blk, wire)
    assert got.dtype == torch.int32 and got.numel() == \
        quant.wire_words(x.size, blk) == want.size
    np.testing.assert_array_equal(got.numpy(), want)
    # the decode, and the decode folded into an accumulator
    acc = rng.standard_normal(x.size).astype(np.float32)
    dec = jax.jit(lambda w: pallas_quant._decode_f32(w, blk, wire))(want)
    fold = jax.jit(lambda a, w: a + pallas_quant._decode_f32(
        w, blk, wire))(jnp.asarray(acc), want)
    tw = torch.from_numpy(want.copy())
    np.testing.assert_array_equal(
        _bits(quant.decode_f32_ref(tw, blk, wire)), _bits(dec))
    np.testing.assert_array_equal(
        _bits(quant.decode_add_ref(torch.from_numpy(acc), tw, blk, wire)),
        _bits(fold))


def test_jitted_codec_arithmetic():
    """What XLA's CPU code does to the JAX codec: the scale is a product
    with the rounded reciprocal (eager JAX divides), the quotient x /
    scale stays an IEEE division, and the fold is one fused
    multiply-add (eager JAX rounds the product first)."""
    blk = 8
    rng = np.random.default_rng(5)
    # a scale where amax / 127 and amax * f32(1/127) differ
    amax = next(a for a in rng.uniform(1, 2, 10000).astype(np.float32)
                if np.float32(a / np.float32(127)) !=
                np.float32(a * (np.float32(1) / np.float32(127))))
    x = np.zeros(blk, np.float32)
    x[0] = amax
    jitted = np.asarray(jax.jit(lambda v: pallas_quant._encode_f32(
        v, blk, "q8"))(jnp.asarray(x)))
    eager = np.asarray(pallas_quant._encode_f32(jnp.asarray(x), blk, "q8"))
    assert jitted[:1].view(np.float32)[0] == \
        np.float32(amax * (np.float32(1) / np.float32(127)))
    assert eager[:1].view(np.float32)[0] == np.float32(amax / np.float32(127))
    np.testing.assert_array_equal(
        quant.encode_f32_ref(torch.from_numpy(x), blk, "q8").numpy(), jitted)
    # one rounding in the fold: 1 + 2^-23 plus a code whose product is
    # just below half an ulp; rounding the product first lands on the
    # tie and rounds up to even
    acc = np.full(blk, 1 + 2.0 ** -23, np.float32)
    w = np.zeros(quant.wire_words(blk, blk), np.int32)
    w[0] = np.array([np.float32(10845877 * 2.0 ** -54)]).view(np.int32)[0]
    w[1:] = np.array([(99 + 128) * 0x01010101], np.uint32).view(np.int32)
    fold = np.asarray(jax.jit(lambda a, ww: a + pallas_quant._decode_f32(
        ww, blk, "q8"))(jnp.asarray(acc), jnp.asarray(w)))
    np.testing.assert_array_equal(fold, acc)
    got = quant.decode_add_ref(torch.from_numpy(acc), torch.from_numpy(w),
                               blk, "q8")
    np.testing.assert_array_equal(got.numpy(), acc)
    two = (torch.from_numpy(acc) +
           quant.decode_f32_ref(torch.from_numpy(w), blk, "q8")).numpy()
    assert (two != acc).all()


def test_fma_emulation_is_exact():
    """_fma_f32 against the exactly rounded value (numpy f64 is exact
    for these operands when their exponents are close; the crafted
    midpoint cases are checked by hand)."""
    rng = np.random.default_rng(9)
    q = rng.integers(-127, 128, 4096).astype(np.float32)
    s = rng.uniform(1e-3, 1, 4096).astype(np.float32)
    a = rng.standard_normal(4096).astype(np.float32)
    want = (q.astype(np.float64) * s + a).astype(np.float32)
    got = quant._fma_f32(torch.from_numpy(q), torch.from_numpy(s),
                         torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)
    # sums that round to an f32 midpoint in f64: below it and above it
    m = np.float32(10845877 * 2.0 ** -54)     # 99 * m = 2^-24 - 2^-54
    for acc, code, res in ((1 + 2.0 ** -23, 99.0, 1 + 2.0 ** -23),
                           (-(1 + 2.0 ** -23), -99.0, -(1 + 2.0 ** -23))):
        got = quant._fma_f32(torch.tensor([code]), torch.tensor([m]),
                             torch.tensor([acc], dtype=torch.float32))
        assert got.item() == np.float32(res)


# ---------------------------------------------------------------------------
# accounting, tier plans and the cvar grammar against their JAX twins
# ---------------------------------------------------------------------------

def test_wire_geometry_matches(env):
    for nelems, blk in ((128, 128), (256, 128), (64, 8), (96, 32)):
        assert quant.wire_words(nelems, blk) == \
            pallas_quant.wire_words(nelems, blk)
    for nblk in (8, 16, 24, 128, 136):
        for ndir in (1, 2):
            for blk in (8, 16):
                if nblk % blk == 0:
                    assert quant._quant_spans(nblk, ndir, blk) == \
                        pallas_quant._quant_spans(nblk, ndir, blk)
    for p in (1, 2, 4, 8):
        for wire in ("q8", "fp8"):
            assert quant.declared_bound(p, wire) == \
                pallas_quant.declared_bound(p, wire)
    for qb in (None, "32", "100", "256", "4096"):
        env(QUANT_BLOCK=qb)
        for dt in (np.float32, np.float16):
            assert quant.quant_block_elems(_TORCH[dt]) == \
                pallas_quant.quant_block_elems(dt), (qb, dt)
        for count in (1, 37, 1000, 1 << 20, 1 << 24):
            for p in (2, 3, 8):
                for dt in (np.float32, np.float16):
                    for bb in (None, 32, 64, 512):
                        assert quant.wire_stats(count, _TORCH[dt], p, bb) \
                            == pallas_quant.wire_stats(count, dt, p, bb)
    env(QUANT_BLOCK=None)
    # the main path's accounting: 64 MiB f32 a rank on 8 ranks
    assert quant.wire_stats(16 << 20, torch.float32, 8) == \
        (117440512, 30277632)


_SPELLINGS = ("", "0", "1e-2", "5e-2", "fp8:0.3", "q8:1e-1", "Q8:1e-3",
              " fp8 : 0.25", "q8:-3", "xx:1e-2", "q8:", "abc", ":0.1",
              "q8:fp8:0.1", "fp8:nan", "inf", "1e-4")


def test_quant_params_and_eligibility_match(env):
    for spec in _SPELLINGS:
        env(QUANT_COLL=spec)
        want = jax_tuning.quant_params()
        got = tuning.quant_params()
        assert got[0] == want[0] and (got[1] == want[1] or
                                      (got[1] != got[1] and
                                       want[1] != want[1])), spec
        for name in ("allreduce", "reduce", "allgather"):
            for dt in (np.float32, np.float16, np.int32, np.float64,
                       jnp.bfloat16):
                for op in ("sum", "max", None):
                    for p in (None, 2, 8):
                        assert quant.quant_eligible(
                            name, _TORCH[dt], op, p) == \
                            pallas_quant.quant_eligible(name, dt, op, p), \
                            (spec, name, dt, op, p)


def test_device_tier_and_planned_tier_match_over_cvars(env):
    sizes = (16, 64, 65, 4096, (1 << 20) - 1, 1 << 20, 4 << 20,
             (4 << 20) + 1, 1 << 27)
    for spec in ("", "5e-2", "fp8:0.3", "1e-4"):
        for qmin in (None, "-1", "64", "8192"):
            for vmax, xmin in ((None, None), ("64", "4096")):
                env(QUANT_COLL=spec, DEV_TIER_QUANT_MIN=qmin,
                    DEV_TIER_VMEM_MAX=vmax, DEV_TIER_XLA_MIN=xmin)
                for nb in sizes:
                    key = (spec, qmin, vmax, xmin, nb)
                    assert tuning.device_tier("allreduce", nb) == \
                        jax_tuning.device_tier("allreduce", nb), key
                    for name, dt, op in (("allreduce", np.float32, "sum"),
                                         ("allreduce", np.int32, "sum"),
                                         ("allreduce", np.float32, "max"),
                                         ("reduce", np.float16, "sum"),
                                         ("allgather", np.float32, None)):
                        for p in (2, 8):
                            assert ici.planned_tier(
                                name, nb, _TORCH[dt], op, num_devices=p) \
                                == pallas_ici.planned_tier(
                                    name, nb, dt, op, interpret=True,
                                    num_devices=p), key + (name, dt, op, p)


def test_bf16_plans_match_the_reference(env):
    """bfloat16 (ml_dtypes' numpy kind 'V' in the JAX package): the JAX
    allreduce and alltoall planners send it to the stock lowering; the
    port's plan it as the JAX planners plan an exact 2-byte type
    (int16), at every size and under every quant budget, so a bf16
    tensor runs the kernels (the quant bin does not quantize it
    either). The RMA planner keeps the JAX plan, the epoch tier."""
    from mvapich2_tpu.ops import pallas_alltoall
    from mvapich2_tpu_torch.ops import alltoall
    for spec in ("", "5e-2", "q8:1e-1"):
        env(QUANT_COLL=spec, DEV_TIER_VMEM_MAX="64", DEV_RMA_RDMA_MIN="0",
            DEV_RMA_QUANT_MIN="0")
        for nb in (64, 4096, 1 << 20):
            for name, op in (("allreduce", "sum"), ("reduce", "max"),
                             ("allgather", None)):
                for p in (2, 4, 8):
                    assert pallas_ici.planned_tier(
                        name, nb, jnp.bfloat16, op, interpret=True,
                        num_devices=p) == ("xla", "dtype")
                    got = ici.planned_tier(name, nb, torch.bfloat16, op,
                                           num_devices=p)
                    assert got == pallas_ici.planned_tier(
                        name, nb, np.int16, op, interpret=True,
                        num_devices=p), (spec, nb, name, p)
                    assert got[0] in ("vmem", "hbm"), got
            assert pallas_alltoall.planned_a2a_tier(
                nb, jnp.bfloat16, interpret=True) == ("xla", "dtype")
            assert alltoall.planned_a2a_tier(nb, torch.bfloat16) == \
                pallas_alltoall.planned_a2a_tier(
                    nb, np.int16, interpret=True) == ("hbm", None)
            for kind in ("put", "get", "acc"):
                for contig in (True, False):
                    assert rma.planned_rma_tier(
                        kind, nb, torch.bfloat16, contig, 8,
                        count=nb // 2) == pallas_rma.planned_rma_tier(
                            kind, nb, jnp.bfloat16, contig,
                            interpret=True, num_devices=8,
                            count=nb // 2), (spec, nb, kind, contig)


def test_planned_rma_tier_quant_matches(env):
    for spec in ("", "q8:1e-1", "fp8:1e-1", "fp8:1e-2", "q8:1e-3"):
        for qmin in (None, "-1", "512", "4096"):
            for qb in (None, "1024"):
                env(QUANT_COLL=spec, DEV_RMA_QUANT_MIN=qmin, QUANT_BLOCK=qb)
                for count in (128, 130, 256, 1024, 1 << 18):
                    for dt in (np.float32, np.int32, np.float16):
                        nb = count * np.dtype(dt).itemsize
                        mine = rma.planned_rma_tier(
                            "acc", nb, _TORCH[dt], True, 8, count=count)
                        ref = pallas_rma.planned_rma_tier(
                            "acc", nb, dt, True, interpret=True,
                            num_devices=8, count=count)
                        assert mine == ref, (spec, qmin, qb, count, dt)


# ---------------------------------------------------------------------------
# the quantized allreduce against the JAX kernel
# ---------------------------------------------------------------------------

def _jax_quant(xv, p, **kw):
    out = _comm(p).run(lambda s: pallas_quant.quant_ring_all_reduce(
        s, "x", p, interpret=True, credits=False, **kw), xv)
    return np.asarray(out).reshape(p, -1)


@pytest.mark.parametrize("p,wire,dt,shard,bb,cb,depth,bidir", [
    (2, "q8", "f32", 128, 64, 128, 2, None),      # blocks divide exactly
    (2, "fp8", "bf16", 37, 32, 1 << 20, 2, None),  # one chunk, padded tail
    (4, "q8", "f16", 300, 64, 256, 3, True),      # padded tail, chunks
    (4, "fp8", "f32", 37, 32, 128, 2, False),
    (8, "q8", "f32", 300, 64, 256, 2, True),
    (8, "fp8", "f32", 128, 128, 256, 3, False),
    (8, "q8", "bf16", 37, 32, 128, 2, True),
    (8, "fp8", "f16", 300, 64, 256, 2, True),
    (4, "q8", "f32", 50, 48, 1 << 20, 2, True),   # 12-value blocks, 3 words
    (2, "fp8", "f16", 2100, 4096, 1 << 20, 2, None),  # 1024-value blocks
])
def test_quant_all_reduce_matches_jax(p, wire, dt, shard, bb, cb, depth,
                                      bidir):
    """f32 and f16 quantize (cast to f32); bf16 takes the exact K3 ring,
    as in the JAX package, whose quant path tests numpy kind 'f' (and
    ml_dtypes' bfloat16 has kind 'V')."""
    rng = np.random.default_rng(p * shard + bb)
    xv = rng.standard_normal((p, shard)).astype(np.float32)
    tx, jx = _torch_in(xv, dt)
    kw = dict(wire=wire, block_bytes=bb, chunk_bytes=cb, depth=depth,
              bidirectional=bidir)
    want = _jax_quant(jx.reshape(-1), p, **kw)
    ici.reset_counts()
    got = quant.quant_ring_all_reduce(tx, **kw)
    q = int(dt != "bf16")
    assert ici.PLAIN_CALLS == {"hbm_ring_all_reduce": 1 - q,
                               "hbm_ring_all_gather": 0,
                               "quant_ring_all_reduce": q,
                               "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0}
    assert not any(ici.LAUNCHES.values())
    assert got.dtype == tx.dtype and got.shape == (p, shard)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref = quant.quant_ring_all_reduce_ref(tx, wire=wire, block_bytes=bb,
                                          bidirectional=bidir)
    assert torch.equal(ref, got)


def test_non_float_and_non_sum_take_the_exact_ring():
    xv = (np.arange(NP * 16) % 11 - 5).astype(np.int32).reshape(NP, 16)
    want = _jax_quant(jnp.asarray(xv.reshape(-1)), NP, op="max",
                      chunk_bytes=32)
    ici.reset_counts()
    got = quant.quant_ring_all_reduce(torch.from_numpy(xv), "max",
                                      chunk_bytes=32)
    assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 1
    assert ici.PLAIN_CALLS["quant_ring_all_reduce"] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    f = torch.from_numpy(xv.astype(np.float32))
    np.testing.assert_array_equal(
        quant.quant_ring_all_reduce(f, "min").numpy(),
        ici.hbm_ring_all_reduce_ref(f, "min").numpy())
    one = torch.ones((1, 5))
    assert torch.equal(quant.quant_ring_all_reduce(one), one)


def test_k9_wire_is_the_encoded_reduced_block(env):
    """The plain K9's wire output is each rank's own fully reduced block
    encoded once, and every rank's result decodes the same words."""
    rng = np.random.default_rng(21)
    xs = [torch.from_numpy(rng.standard_normal(300).astype(np.float32))
          for _ in range(NP)]
    blk, nblk = quant._geometry(NP, 300, 64)
    assert (blk, nblk) == (16, 48)
    ici.reset_counts()
    wires = quant.quant_reduce_scatter(xs, nblk, blk, "q8", 2)
    assert ici.PLAIN_CALLS["quant_ring_all_reduce"] == 1
    ref_w, own = quant.quant_reduce_scatter_ref(xs, nblk, blk, "q8", 2)
    assert torch.equal(wires, ref_w) and \
        wires.shape == (NP, quant.wire_words(nblk, blk)) == (NP, 15)
    for r in range(NP):
        assert torch.equal(wires[r], quant.encode_f32_ref(own[r], blk, "q8"))
    out = quant.quant_ring_all_reduce(xs, wire="q8", block_bytes=64,
                                      chunk_bytes=256)
    for r in range(1, NP):
        assert torch.equal(out[r], out[0])


def _model_k9(xs, nblk, blk, wire, ndir):
    """K9's walk (csrc/ring.cu quant_ring_all_reduce_kernel), one
    quantization block at a time: its direction and chain of ranks in
    closed form, acc = x[first], then acc = decode(encode(acc)) + x[r]
    for each next rank r (one rounding), the owner's block encoded once
    into its wire output and decoded into every rank's row. Returns
    (wires ``(p, wire_words(nblk))``, rows ``(p, n)`` in the input
    dtype)."""
    p, n, dt = len(xs), xs[0].numel(), xs[0].dtype
    x = torch.nn.functional.pad(torch.stack(xs).to(torch.float32),
                                (0, p * nblk - n))
    per, run = nblk // blk, 1 + blk // 4
    wires = torch.empty((p, per * run), dtype=torch.int32)
    res = torch.empty(p * nblk)
    for q in range(p * per):
        k, jb = divmod(q, per)
        d = p - 1 if ndir == 2 and jb >= (per + 1) // 2 else 1
        chain = [(k + d * j) % p for j in range(1, p + 1)]
        assert chain[-1] == k          # the chain ends at the block's owner
        e0 = k * nblk + jb * blk
        acc = x[chain[0], e0:e0 + blk]
        for r in chain[1:]:
            acc = quant.decode_add_ref(
                x[r, e0:e0 + blk], quant.encode_f32_ref(acc, blk, wire),
                blk, wire)
        w = quant.encode_f32_ref(acc, blk, wire)
        wires[k, jb * run:(jb + 1) * run] = w
        res[e0:e0 + blk] = quant.decode_f32_ref(w, blk, wire)
    return wires, res[:n].to(dt).reshape(1, n).expand(p, n)


@pytest.mark.parametrize("wire", ["q8", "fp8"])
@pytest.mark.parametrize("blk", [8, 12, 128, 1024])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_k9_direct_walk_is_the_rings(p, ndir, blk, wire):
    """The direct kernel's walk, modelled on the CPU, against the ring
    replay: the wire outputs and every rank's decoded row bit for bit.
    Three quantization blocks a ring block (two when ndir == 2 split them
    2 + 1), a padded tail, a block of zeros on every rank (scale 0),
    values at mixed scales; f16 inputs at p = 3."""
    rng = np.random.default_rng(p * 7 + ndir * 3 + blk + len(wire))
    n = (3 * p - 1) * blk + 5
    xv = (rng.standard_normal((p, n)) *
          rng.choice([1e-3, 1.0, 1e3], size=(p, n))).astype(np.float32)
    xv[:, :blk] = 0.0
    if p == 3:
        xv = xv.astype(np.float16)
    xs = [torch.from_numpy(r.copy()) for r in xv]
    blk_, nblk = quant._geometry(p, n, 4 * blk)
    assert blk_ == blk and nblk == 3 * blk
    want_w, _ = quant.quant_reduce_scatter_ref(xs, nblk, blk, wire, ndir)
    wires, rows = _model_k9(xs, nblk, blk, wire, ndir)
    assert torch.equal(wires, want_w)
    row = quant.decode_f32_ref(want_w.reshape(-1), blk, wire)[:n]
    np.testing.assert_array_equal(_bits(rows[0]),
                                  _bits(row.to(xs[0].dtype)))
    if p > 2 or ndir == 1:
        ref = quant.quant_ring_all_reduce_ref(
            xs, wire=wire, block_bytes=4 * blk, bidirectional=ndir == 2)
        np.testing.assert_array_equal(_bits(rows), _bits(ref))


@pytest.mark.parametrize("wire", ["q8", "fp8"])
@pytest.mark.parametrize("p", [2, 3, 8])
def test_exact_fold_within_declared_bound(p, wire):
    """The one comparison that is not bitwise: the quantized sum against
    an exact f64 sum, relative to the largest |sum|, within
    declared_bound(p, wire)."""
    rng = np.random.default_rng(p)
    for n, bb in ((1000, None), (333, 32)):
        xv = rng.standard_normal((p, n)).astype(np.float32)
        got = quant.quant_ring_all_reduce(torch.from_numpy(xv), wire=wire,
                                          block_bytes=bb).numpy()
        exp = xv.astype(np.float64).sum(0)
        rel = np.abs(got - exp).max() / np.abs(exp).max()
        assert rel <= quant.declared_bound(p, wire), (n, rel)


# ---------------------------------------------------------------------------
# K14's quantized wire against the JAX kernel
# ---------------------------------------------------------------------------

def _jax_window(nd, prog, win):
    mesh = jax_make_mesh((nd,), ("x",), jax.devices()[:nd])
    f = shard_map(prog, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                  check_vma=False)
    return np.asarray(jax.jit(f)(jax.device_put(
        win, NamedSharding(mesh, P("x")))))


@pytest.mark.parametrize("nd,wire,n,disp,cb,qb", [
    (4, "q8", 64, 3, 64, "64"),       # 4 blocks of 16, 4 chunks
    (4, "fp8", 48, 0, 128, "64"),     # a short last chunk
    (8, "q8", 40, 5, 16, "256"),      # block = min(64, n) = 40
    (2, "fp8", 256, 1, None, None),   # the default block, one chunk
])
def test_quant_accumulate_matches_jax(env, nd, wire, n, disp, cb, qb):
    env(QUANT_COLL=f"{wire}:1e-1", QUANT_BLOCK=qb)
    rng = np.random.default_rng(n + nd)
    win = (rng.standard_normal((nd, n + disp + 3)) * 4).astype(np.float32)
    src = rng.standard_normal(n).astype(np.float32)
    origin, target = 0, nd - 1
    want = _jax_window(nd, lambda w: pallas_rma.rma_accumulate(
        jnp.asarray(src), w[0], "x", nd, origin, target, disp,
        quantized=True, chunk_bytes=cb, interpret=True,
        credits=False)[None, :], jnp.asarray(win))
    twin = carry.window_from_numpy(win)
    rma.reset_counts()
    got = rma.rma_accumulate(torch.from_numpy(src), twin, origin, target,
                             disp, quantized=True, chunk_bytes=cb)
    assert got is twin and rma.PLAIN_CALLS["rma_accumulate_quant"] == 1
    assert rma.PLAIN_CALLS["rma_accumulate"] == 0
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the plain version alone, and one hop's error bound
    plain = carry.window_from_numpy(win)
    rma.rma_accumulate_ref(torch.from_numpy(src), plain, origin, target,
                           disp, quantized=True)
    assert torch.equal(plain, twin)
    err = np.abs(carry.to_numpy(got)[target, disp:disp + n] -
                 (win[target, disp:disp + n].astype(np.float64) + src))
    assert err.max() <= quant.declared_bound(1, wire) * np.abs(src).max() \
        + 1e-5


def test_k9_load_group_is_one_constant():
    """``chip_smoke.py --sweep`` varies K9's sources in flight by editing
    the one definition of ``kQuantGroup`` in ``csrc/ring.cu``."""
    import re
    from mvapich2_tpu_torch.ops import _build
    src = (_build.CSRC_DIR / "ring.cu").read_text()
    found = re.findall(r"constexpr int kQuantGroup = (\d+);", src)
    assert len(found) == 1 and 1 <= int(found[0]) <= 8
