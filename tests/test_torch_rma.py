"""Parity of the port's RMA kernel module (mvapich2_tpu_torch/ops/rma.py:
K12 rma_put, K13 rma_get, K14 rma_accumulate, K17 direct_put, their
helpers and the tier plan; plain route on the CPU) with the JAX
package's ops/pallas_rma.py and rma/device.py pallas_put, run in Pallas
interpret mode inside shard_map over the 8-device virtual CPU mesh. The
interpreter of this jax cannot signal a remote semaphore, so
rma_put/rma_get/rma_accumulate run with ``credits=False`` (its
creditless mode; pallas_put has no credits).

Shapes: the sweep of tests/test_pallas_rma.py (p = 2, 4, 8 x f32, bf16,
i32; 16-byte chunks, a count of 2.5 chunks, a misaligned disp), its four
chunk-boundary shapes for each op, and origin == target.

Tolerances: bitwise everywhere (the kernels move bytes, and the
accumulate adds once per element in the window dtype). Every window row
is compared; for get, the origin's row of the JAX output against the
port's result, and the JAX output's other rows are zero (its symmetric
DMA), which the port does not reproduce.

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
from mvapich2_tpu.ops import pallas_rma
from mvapich2_tpu.parallel import make_mesh as jax_make_mesh
from mvapich2_tpu.parallel.mesh import shard_map
from mvapich2_tpu.rma.device import pallas_put
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import carry
from mvapich2_tpu_torch.ops import rma
from mvapich2_tpu_torch.utils.config import get_config

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (jnp.int32, torch.int32)}
_CB = 16                         # 16-byte chunks
_MESHES = {}


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


def _mesh(nd):
    if nd not in _MESHES:
        _MESHES[nd] = jax_make_mesh((nd,), ("x",), jax.devices()[:nd])
    return _MESHES[nd]


def _jax_run(nd, prog, win):
    """``prog`` over the (nd, N) window rows inside shard_map; returns
    numpy rows."""
    mesh = _mesh(nd)
    f = shard_map(prog, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                  check_vma=False)
    return np.asarray(jax.jit(f)(jax.device_put(
        win, NamedSharding(mesh, P("x")))))


def _values(rng, shape, dt):
    """Seeded values for dtype ``dt``: normal floats (bf16: rounded
    from f32), full-range int32 (so accumulates wrap)."""
    if dt == "i32":
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    return rng.normal(size=shape).astype(np.float32)


def _both(a, dt):
    """The same values as a JAX array and a torch tensor of ``dt``."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(a, jdt)
    return j, carry.window_from_numpy(np.asarray(j)[None])[0].clone() \
        if a.ndim == 1 else carry.window_from_numpy(np.asarray(j))


def _np(x):
    """numpy rows of a JAX array or torch tensor, bf16 as f32."""
    if isinstance(x, torch.Tensor):
        return carry.to_numpy(x)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _nelems(dt):
    epc = _CB // (2 if dt == "bf16" else 4)
    return 2 * epc + epc // 2


def _case(seed, nd, dt, n, extra=8):
    rng = np.random.default_rng(seed)
    jwin, twin = _both(_values(rng, (nd, n + extra), dt), dt)
    jsrc, tsrc = _both(_values(rng, (n,), dt), dt)
    return jwin, twin, jsrc, tsrc


def _check_put(nd, dt, n, disp, origin, target, cb, seed):
    jwin, twin, jsrc, tsrc = _case(seed, nd, dt, n, extra=max(8, disp + 5))
    want = _jax_run(nd, lambda w: pallas_rma.rma_put(
        jsrc, w[0], "x", nd, origin, target, disp, chunk_bytes=cb,
        interpret=True, credits=False)[None, :], jwin)
    rma.reset_counts()
    got = rma.rma_put(tsrc, twin, origin, target, disp, chunk_bytes=cb)
    assert got is twin and rma.PLAIN_CALLS["rma_put"] == 1
    assert rma.LAUNCHES["rma_put"] == 0
    np.testing.assert_array_equal(_np(got), _np(want))


def _check_get(nd, dt, n, disp, origin, target, cb, seed):
    jwin, twin, _, _ = _case(seed, nd, dt, n, extra=max(8, disp + 5))
    want = _jax_run(nd, lambda w: pallas_rma.rma_get(
        w[0], n, "x", nd, origin, target, disp, chunk_bytes=cb,
        interpret=True, credits=False)[None, :], jwin)
    before = twin.clone()
    rma.reset_counts()
    got = rma.rma_get(twin, n, origin, target, disp, chunk_bytes=cb)
    assert rma.PLAIN_CALLS["rma_get"] == 1
    np.testing.assert_array_equal(_np(got), _np(want)[origin])
    # the JAX kernel's symmetric DMA leaves zeros on every other rank
    others = [r for r in range(nd) if r != origin]
    assert not _np(want)[others].any()
    assert torch.equal(twin, before)


def _check_acc(nd, dt, n, disp, origin, target, cb, seed):
    jwin, twin, jsrc, tsrc = _case(seed, nd, dt, n, extra=max(8, disp + 5))
    want = _jax_run(nd, lambda w: pallas_rma.rma_accumulate(
        jsrc, w[0], "x", nd, origin, target, disp, chunk_bytes=cb,
        interpret=True, credits=False)[None, :], jwin)
    rma.reset_counts()
    got = rma.rma_accumulate(tsrc, twin, origin, target, disp,
                             chunk_bytes=cb)
    assert got is twin and rma.PLAIN_CALLS["rma_accumulate"] == 1
    np.testing.assert_array_equal(_np(got), _np(want))


def _check_direct(nd, dt, n, disp, origin, target, cb, seed):
    jwin, twin, jsrc, tsrc = _case(seed, nd, dt, n, extra=max(8, disp + 5))
    want = _jax_run(nd, lambda w: pallas_put(
        jsrc, w[0], "x", origin, target, disp, interpret=True)[None, :],
        jwin)
    rma.reset_counts()
    got = rma.direct_put(tsrc, twin, origin, target, disp)
    assert got is twin and rma.PLAIN_CALLS["direct_put"] == 1
    np.testing.assert_array_equal(_np(got), _np(want))


CHECKS = {"put": _check_put, "get": _check_get, "acc": _check_acc,
          "direct_put": _check_direct}


# ---------------------------------------------------------------------------
# the sweep of tests/test_pallas_rma.py, bitwise against the JAX kernels
# ---------------------------------------------------------------------------

SWEEP = [(nd, dt) for nd in (2, 4, 8) for dt in ("f32", "bf16", "i32")]


@pytest.mark.parametrize("nd,dt", SWEEP)
def test_put_parity(nd, dt):
    _check_put(nd, dt, _nelems(dt), 3, nd - 2, nd - 1, _CB, nd)


@pytest.mark.parametrize("nd,dt", SWEEP)
def test_get_parity(nd, dt):
    _check_get(nd, dt, _nelems(dt), 5, 0, nd - 1, _CB, 10 + nd)


@pytest.mark.parametrize("nd,dt", SWEEP)
def test_accumulate_parity(nd, dt):
    _check_acc(nd, dt, _nelems(dt), 2, 1, 0, _CB, 20 + nd)


@pytest.mark.parametrize("nd,dt,n,disp", [
    (2, "f32", 7, 3), (4, "f32", 7, 3), (8, "f32", 7, 3),
    # K17 is K12's copy: 2- and 4-byte elements at a disp off the 16-byte
    # words, with a count that is no whole number of words
    (4, "bf16", 13, 5), (8, "bf16", 9, 1), (8, "i32", 11, 5),
    (2, "i32", 6, 1)], ids=["2", "4", "8", "4-bf16-disp5", "8-bf16-disp1",
                            "8-i32-disp5", "2-i32-disp1"])
def test_direct_put_parity(nd, dt, n, disp):
    _check_direct(nd, dt, n, disp, 0, nd - 1, None, 30 + nd)


# the chunk-boundary shapes of test_pallas_rma.py, for every op
@pytest.mark.parametrize("op", ("put", "get", "acc"))
@pytest.mark.parametrize("n,disp,cb", [
    (8, 0, 16),     # exact chunk multiple at the window base
    (3, 1, 16),     # single partial chunk
    (4, 12, 16),    # n == chunk, landing flush with the window end
    (21, 2, 8),     # many (11) tiny chunks, partial tail
])
def test_chunk_boundary_shapes(op, n, disp, cb):
    CHECKS[op](4, "f32", n, disp, 3, 1, cb, 40 + n)


@pytest.mark.parametrize("op", ("put", "get", "acc", "direct_put"))
@pytest.mark.parametrize("nd", (2, 8))
def test_origin_equals_target(op, nd):
    CHECKS[op](nd, "i32", 10, 3, nd - 1, nd - 1, _CB, 50 + nd)


# ---------------------------------------------------------------------------
# the helpers and the tier plan against their JAX twins
# ---------------------------------------------------------------------------

_TORCH_DT = {np.float32: torch.float32, np.int32: torch.int32,
             np.complex64: torch.complex64, np.bool_: torch.bool,
             np.int8: torch.int8, np.float16: torch.float16}


def _tiers(kind, nb, dt, contiguous=True, count=0):
    mine = rma.planned_rma_tier(kind, nb, _TORCH_DT[dt], contiguous, 8,
                                count=count)
    ref = pallas_rma.planned_rma_tier(kind, nb, dt, contiguous,
                                      interpret=True, num_devices=8,
                                      count=count)
    return mine, ref


def test_planned_rma_tier_matches(env):
    for args in [("put", 4096, np.float32), ("get", 4096, np.int8),
                 ("acc", 4096, np.float16), ("put", 4096, np.float32, False),
                 ("get", 4096, np.complex64), ("put", 64, np.bool_),
                 ("put", 0, np.float32), ("acc", 0, np.int32)]:
        mine, ref = _tiers(*args)
        assert mine == ref, args
    assert _tiers("put", 4096, np.float32, False)[0] == ("epoch",
                                                         "noncontig")
    env(DEV_RMA_RDMA_MIN="1024")
    for nb in (512, 1023, 1024, 2048):
        mine, ref = _tiers("put", nb, np.float32)
        assert mine == ref, nb
    assert _tiers("put", 512, np.float32)[0] == ("epoch", "size")
    env(DEV_RMA_RDMA_MIN="-1")
    assert _tiers("get", 1 << 20, np.float32)[0] == ("epoch", "size")
    assert _tiers("get", 1 << 20, np.float32)[1] == ("epoch", "size")


def test_planned_rma_tier_quant_bin_raises(env):
    """The quant bin plans 'quant' now that K14's quantized wire is
    ported, where the JAX planned_rma_tier does."""
    env(QUANT_COLL="q8:1e-1", DEV_RMA_QUANT_MIN="1024")
    nb, count = 1 << 20, (1 << 20) // 4
    mine, ref = _tiers("acc", nb, np.float32, True, count)
    assert mine == ref == ("quant", None)
    # puts never quantize; int and non-block-multiple accumulates, and a
    # budget below the one-hop bound, keep the exact kernel
    for args in [("put", nb, np.float32, True, count),
                 ("acc", nb, np.int32, True, count),
                 ("acc", 520, np.float32, True, 130)]:
        mine, ref = _tiers(*args)
        assert mine == ref == ("rdma", None), args
    env(QUANT_COLL="q8:1e-4")
    mine, ref = _tiers("acc", nb, np.float32, True, count)
    assert mine == ref == ("rdma", None)
    env(QUANT_COLL=None)
    mine, ref = _tiers("acc", nb, np.float32, True, count)
    assert mine == ref == ("rdma", None)


def test_acc_quant_ok_matches(env):
    for spec in ("q8:1e-1", "q8:1e-4", "fp8:1e-1", "fp8:1e-2", "1e-1",
                 "bogus:1e-1", "q8:x", ""):
        env(QUANT_COLL=spec)
        for dt, count in ((np.float32, 512), (np.float32, 130),
                          (np.int32, 512), (np.float32, 128)):
            assert rma.acc_quant_ok(_TORCH_DT[dt], count, 8) == \
                pallas_rma.acc_quant_ok(dt, count, 8), (spec, dt, count)
    env(QUANT_COLL="q8:1e-1", QUANT_BLOCK="1024")
    assert rma.quant_block_elems() == 256
    assert rma.acc_quant_ok(torch.float32, 256, 8) == \
        pallas_rma.acc_quant_ok(np.float32, 256, 8) is True
    assert rma.acc_quant_ok(torch.float32, 128, 8) == \
        pallas_rma.acc_quant_ok(np.float32, 128, 8) is False


def test_rma_chunk_inherits_ici(env):
    for rma_cb, ici_cb in ((None, None), (None, "4096"), ("256", "4096"),
                           ("0", "64K"), ("-1", None)):
        env(RMA_CHUNK_BYTES=rma_cb, ICI_CHUNK_BYTES=ici_cb)
        for dt in (np.float32, np.int8):
            assert rma._cfg_chunk_elems(_TORCH_DT[dt], None) == \
                pallas_rma._cfg_chunk_elems(dt, None), (rma_cb, ici_cb)
    env(RMA_CHUNK_BYTES="256", ICI_CHUNK_BYTES=None)
    assert rma._cfg_chunk_elems(torch.float32, None) == 64
    assert rma._cfg_chunk_elems(torch.float32, 32) == 8
    for d in (None, 1, 3):
        assert rma._cfg_depth(d) == pallas_rma._cfg_depth(d)


# ---------------------------------------------------------------------------
# no CPU route for a tensor that is not on the CPU; argument checks
# ---------------------------------------------------------------------------

def test_wrappers_raise_on_meta_tensors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    win = torch.empty((8, 64), device="meta")
    src = torch.empty(16, device="meta")
    rma.reset_counts()
    for call in (lambda: rma.rma_put(src, win, 0, 7, 3),
                 lambda: rma.rma_get(win, 16, 0, 7, 3),
                 lambda: rma.rma_accumulate(src, win, 0, 7, 3),
                 lambda: rma.direct_put(src, win, 0, 7, 3)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert not any(rma.PLAIN_CALLS.values())
    assert not any(rma.LAUNCHES.values())


def test_argument_checks():
    win = torch.zeros((4, 16))
    src = torch.ones(5)
    rma.reset_counts()
    with pytest.raises(ValueError, match="past the window"):
        rma.rma_put(src, win, 0, 1, 12)
    with pytest.raises(ValueError, match="past the window"):
        rma.rma_get(win, 17, 0, 1)
    with pytest.raises(ValueError, match="rank"):
        rma.rma_accumulate(src, win, 0, 4)
    with pytest.raises(ValueError, match="disp"):
        rma.direct_put(src, win, 0, 1, -1)
    with pytest.raises(ValueError, match="src is"):
        rma.rma_put(src.int(), win, 0, 1)
    # the quantized wire takes whole blocks of whole 4-code words (a
    # count of 5 is one block of 5) and f32 windows
    with pytest.raises(ValueError, match="block-multiple"):
        rma.rma_accumulate(src, win, 0, 1, quantized=True)
    with pytest.raises(TypeError, match="f32"):
        rma.rma_accumulate(src[:4].int(), win.int(), 0, 1, quantized=True)
    assert not any(rma.PLAIN_CALLS.values())
    # an empty op touches nothing and takes no route
    assert rma.rma_put(src[:0], win, 0, 1, 16) is win
    assert rma.rma_get(win, 0, 0, 1).numel() == 0
    assert not any(rma.PLAIN_CALLS.values())
    assert not win.any()


def test_kernel_dtype_gates():
    for dt in (torch.float64, torch.int64):
        with pytest.raises(NotImplementedError, match="8-byte"):
            rma._elem_size(dt, "x")
        with pytest.raises(NotImplementedError, match="8-byte"):
            rma._acc_code(dt, "x")
    for dt in (torch.bool, torch.complex64):
        with pytest.raises(TypeError):
            rma._elem_size(dt, "x")
    # the copies move any 1-, 2- or 4-byte element; the fold takes the
    # nine arithmetic dtypes of the ring kernels, uint16 and uint32 too
    for dt, code in ((torch.uint16, 7), (torch.uint32, 8)):
        assert rma._elem_size(dt, "x") == dt.itemsize
        assert rma._acc_code(dt, "x") == code
    assert rma._acc_code(torch.bfloat16, "x") == 2


@pytest.mark.parametrize("np_dtype", [np.uint16, np.uint32])
def test_accumulate_unsigned_wraps_like_jax(np_dtype):
    """K14 folds uint16 and uint32 with wraparound, as the JAX kernel;
    the plain version adds in int64 and wraps back."""
    info = np.iinfo(np_dtype)
    rng = np.random.default_rng(info.bits)
    nd, n = 4, 13
    win = rng.integers(info.max // 2, info.max, size=(nd, n + 6),
                       endpoint=True).astype(np_dtype)
    src = rng.integers(info.max // 2, info.max, size=n,
                       endpoint=True).astype(np_dtype)
    want = _jax_run(nd, lambda w: pallas_rma.rma_accumulate(
        jnp.asarray(src), w[0], "x", nd, 1, 2, 3, chunk_bytes=16,
        interpret=True, credits=False)[None, :], jnp.asarray(win))
    twin = carry.window_from_numpy(win)
    rma.reset_counts()
    rma.rma_accumulate(torch.from_numpy(src), twin, 1, 2, 3, chunk_bytes=16)
    assert rma.PLAIN_CALLS["rma_accumulate"] == 1
    np.testing.assert_array_equal(carry.to_numpy(twin), want)
    assert (carry.to_numpy(twin)[2, 3:3 + n] < win[2, 3:3 + n]).any()


def test_plain_accumulate_arithmetic():
    """Floats add in float and round once to the dtype; integers wrap."""
    w = torch.tensor([[1.0, 2.0], [0.5, 3.0]], dtype=torch.bfloat16)
    s = torch.tensor([2.0 ** -9, 1.0], dtype=torch.bfloat16)
    want = (w[1].float() + s.float()).to(torch.bfloat16)
    rma.rma_accumulate_ref(s, w, 0, 1)
    assert torch.equal(w[1], want)
    i8 = torch.tensor([[127, -128]], dtype=torch.int8)
    rma.rma_accumulate_ref(torch.tensor([1, -1], dtype=torch.int8), i8, 0,
                           0)
    assert i8.tolist() == [[-128, 127]]


# ---------------------------------------------------------------------------
# a source that overlaps the target range: the JAX result (its sources are
# immutable, so the op writes the values the source held before it)
# ---------------------------------------------------------------------------

_OVERLAP = {"before": -3, "after": 3, "alias": 0}


@pytest.mark.parametrize("dt", ("f32", "i32"))
@pytest.mark.parametrize("overlap", sorted(_OVERLAP))
@pytest.mark.parametrize("op", ("rma_put", "direct_put", "rma_accumulate"))
def test_overlapping_source_matches_jax(op, overlap, dt):
    nd, n, disp, origin, target = 4, 11, 6, 1, 2
    jwin, twin, _, _ = _case(60 + len(op), nd, dt, n, extra=12)
    lo = disp + _OVERLAP[overlap]
    jsrc = jnp.asarray(np.asarray(jwin)[target, lo:lo + n])   # a copy
    if op == "rma_put":
        prog = lambda w: pallas_rma.rma_put(          # noqa: E731
            jsrc, w[0], "x", nd, origin, target, disp, chunk_bytes=_CB,
            interpret=True, credits=False)[None, :]
    elif op == "rma_accumulate":
        prog = lambda w: pallas_rma.rma_accumulate(   # noqa: E731
            jsrc, w[0], "x", nd, origin, target, disp, chunk_bytes=_CB,
            interpret=True, credits=False)[None, :]
    else:
        prog = lambda w: pallas_put(                  # noqa: E731
            jsrc, w[0], "x", origin, target, disp, interpret=True)[None, :]
    want = _jax_run(nd, prog, jwin)
    rma.reset_counts()
    src = twin[target, lo:lo + n]                    # a view of the window
    kwargs = {} if op == "direct_put" else {"chunk_bytes": _CB}
    got = getattr(rma, op)(src, twin, origin, target, disp, **kwargs)
    assert got is twin and rma.PLAIN_CALLS[op] == 1
    np.testing.assert_array_equal(_np(got), _np(want))


def test_unshared_copies_only_a_partial_overlap():
    win = torch.arange(40, dtype=torch.float32).reshape(4, 10)
    row = win[2]
    assert rma.unshared(row[3:7], win, 2, 3) is not None
    assert rma.unshared(row[3:7], win, 2, 3).data_ptr() == \
        row[3:7].data_ptr()                              # the range itself
    for lo in (0, 1, 2, 4, 5, 6):                        # partly over it
        got = rma.unshared(row[lo:lo + 4], win, 2, 3)
        assert got.data_ptr() != row[lo:lo + 4].data_ptr(), lo
        assert torch.equal(got, row[lo:lo + 4])
    # disjoint, another row, another tensor, an empty source: no copy
    for src in (row[7:10], win[1, 3:7], torch.ones(4), row[3:3]):
        assert rma.unshared(src, win, 2, 3).data_ptr() == src.data_ptr()
    # a source that runs into the range from the row before
    flat = win.reshape(-1)
    assert rma.unshared(flat[18:22], win, 2, 0).data_ptr() != \
        flat[18:22].data_ptr()
    # a strided target span (the epoch tier's put): the start is not exempt
    assert rma.unshared(row[3:5], win, 2, 3, span=3).data_ptr() != \
        row[3:5].data_ptr()
    # a strided source is judged by its extent: copied when the extent
    # meets the span (even between its elements), not when it ends before
    assert rma.unshared(row[0:3:2], win, 2, 4, span=4).data_ptr() == \
        row[0:3:2].data_ptr()                            # 0..2 before 4
    assert rma.unshared(row[::3], win, 2, 4, span=1).data_ptr() != \
        row[::3].data_ptr()                              # 0..9 holds 4


# ---------------------------------------------------------------------------
# the direct copy of K12/K13: copy_plan, the model of the split its C entry
# computes, and a model of the kernel that executes it byte for byte
# ---------------------------------------------------------------------------

def _funnel_r(lo, hi, shift):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> (shift & 31)."""
    return (((hi << 32) | lo) >> (shift & 31)) & 0xFFFFFFFF


def _model_copy(mem, src, dst, n, esize):
    """Execute the kernel's split on byte memory ``mem`` (a numpy uint8
    array addressed from 0): the head and tail element by element, the
    body as 16-byte words, each assembled from the two aligned source
    words that hold its bytes (``realign``). Returns per-byte write
    counts and the aligned source words loaded."""
    head, nvec, shift = rma.copy_plan(src, dst, n, esize)
    v = 16 // esize
    assert 0 <= head < v and nvec >= 0
    tail = n - head - nvec * v
    assert 0 <= tail < v
    writes = np.zeros(mem.size, np.int64)
    loads = []

    def element(i):
        a, b = src + i * esize, dst + i * esize
        mem[b:b + esize] = mem[a:a + esize]
        writes[b:b + esize] += 1

    for i in range(head):
        element(i)
    if nvec:
        body_src, body_dst = src + head * esize, dst + head * esize
        assert body_dst % 16 == 0 and (body_src - shift) % 16 == 0
        assert shift == body_src & 15
        q, r8 = shift >> 2, (shift & 3) * 8
        for w in range(nvec):
            at = body_src - shift + 16 * w
            if shift:
                words = mem[at:at + 32].view("<u4").tolist()
                loads += [at, at + 16]
                out = [_funnel_r(words[j + q], words[j + q + 1], r8)
                       for j in range(4)]
                word = np.array(out, "<u4").view(np.uint8)
            else:
                loads.append(at)
                word = mem[at:at + 16].copy()
            mem[body_dst + 16 * w:body_dst + 16 * w + 16] = word
            writes[body_dst + 16 * w:body_dst + 16 * w + 16] += 1
    for i in range(head + nvec * v, n):
        element(i)
    return writes, loads


_COUNTS = [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 47, 48, 49,
           64, 100]


@pytest.mark.parametrize("n", _COUNTS)
@pytest.mark.parametrize("esize", (1, 2, 4))
def test_copy_plan_covers_every_element_once(esize, n):
    """For every source and destination offset mod 16 bytes, the split
    writes each destination byte exactly once with its source byte,
    nothing outside the range, and loads only aligned words that hold a
    source byte (so a load never leaves the source's page)."""
    rng = np.random.default_rng(esize * 1000 + n)
    base_src, base_dst = 64, 64 + 16 * 16 + 2048
    size = base_dst + 16 * 16 + 2048
    for so in range(0, 16, esize):
        for do in range(0, 16, esize):
            mem = rng.integers(0, 256, size=size, dtype=np.uint8)
            src, dst = base_src + so, base_dst + do
            nb = n * esize
            want = mem[src:src + nb].copy()
            writes, loads = _model_copy(mem, src, dst, n, esize)
            np.testing.assert_array_equal(mem[dst:dst + nb], want)
            assert (writes[dst:dst + nb] == 1).all(), (so, do)
            assert writes.sum() == nb, (so, do)
            for at in loads:
                assert at % 16 == 0 and at < src + nb and src < at + 16, \
                    (so, do, at)


def test_copy_plan_shapes():
    # aligned both sides: no head, whole words, the rest is tail
    assert rma.copy_plan(256, 512, 37, 4) == (0, 9, 0)
    # destination 4 bytes short of its boundary: one f32 of head
    assert rma.copy_plan(256, 524, 37, 4) == (1, 9, 4)
    # the N - 7 at disp 5 shape of the smoke run: the window is misaligned
    # by 20 bytes, the source aligned
    head, nvec, shift = rma.copy_plan(0, 20, (1 << 24) - 7, 4)
    assert (head, shift) == (3, 12) and head + 4 * nvec <= (1 << 24) - 7
    # fewer elements than reach the boundary: all head
    assert rma.copy_plan(0, 1, 5, 1) == (5, 0, 5)
    assert rma.copy_plan(0, 0, 0, 2) == (0, 0, 0)


def test_copy_wrappers_take_the_stream_arguments():
    """K12/K13 accept and validate chunk_bytes and depth (the JAX
    kernels' arguments) and ignore them: the results are the same."""
    win = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    want = win.clone()
    src = torch.arange(100, 105, dtype=torch.int32)
    rma.rma_put_ref(src, want, 0, 1, 3)
    for kw in ({}, {"chunk_bytes": 16, "depth": 3},
               {"chunk_bytes": 4096}, {"depth": 5}):
        got = win.clone()
        rma.rma_put(src, got, 0, 1, 3, **kw)
        assert torch.equal(got, want)
        assert torch.equal(rma.rma_get(got, 5, 2, 1, 3, **kw), src)
    with pytest.raises(ValueError):
        rma.rma_put(src, win.clone(), 0, 1, 3, chunk_bytes="many")
    with pytest.raises(ValueError):
        rma.rma_get(win, 5, 0, 1, 3, depth="deep")


# ---------------------------------------------------------------------------
# the direct fold of K14: copy_plan's cut, executed on byte memory for every
# source and destination offset mod 16 bytes, each pair folded in the window
# dtype, against the JAX kernel's accumulate of the same values
# ---------------------------------------------------------------------------

_K14 = {"f32": np.float32, "f16": np.float16, "bf16": jnp.bfloat16,
        "i32": np.int32, "i16": np.int16, "i8": np.int8, "u8": np.uint8,
        "u16": np.uint16, "u32": np.uint32}
_K14_TORCH = {"f32": torch.float32, "f16": torch.float16,
              "bf16": torch.bfloat16, "i32": torch.int32,
              "i16": torch.int16, "i8": torch.int8, "u8": torch.uint8,
              "u16": torch.uint16, "u32": torch.uint32}
_SAME_WIDTH = {1: (np.int8, torch.int8), 2: (np.int16, torch.int16),
               4: (np.int32, torch.int32)}


def _k14_values(rng, n, dt):
    """Seeded values of K14 dtype ``dt``: normal floats, full-range
    integers (so sums wrap)."""
    npdt = np.dtype(_K14[dt])
    if npdt.kind in "iu":
        info = np.iinfo(npdt)
        return rng.integers(info.min, info.max, size=n, endpoint=True,
                            dtype=npdt)
    return (rng.normal(size=n) * 4).astype(np.float32).astype(npdt)


def _jax_acc_row(row, src, disp, quantized=False):
    """Row 1 of a two-rank window after the JAX accumulate from rank 0
    (interpret mode, creditless); row 0 is zeros."""
    win = np.stack([np.zeros_like(row), row])
    out = _jax_run(2, lambda w: pallas_rma.rma_accumulate(
        jnp.asarray(src), w[0], "x", 2, 0, 1, disp, quantized=quantized,
        interpret=True, credits=False)[None, :], jnp.asarray(win))
    assert not np.asarray(out[0]).view(np.uint8).any()
    return np.asarray(out[1])


def _bytes_as(b, dt):
    """The elements of dtype ``dt`` held in bytes ``b``, as a tensor."""
    npw, tw = _SAME_WIDTH[np.dtype(_K14[dt]).itemsize]
    return torch.from_numpy(b.view(npw).copy()).view(_K14_TORCH[dt])


def _as_bytes(t):
    return t.view(_SAME_WIDTH[t.element_size()][1]).numpy().view(np.uint8)


def _model_fold(mem, src, dst, n, dt):
    """K14 on byte memory ``mem``: ``_model_copy`` pairs each destination
    element with the source bytes the kernel's cut loads for it (head and
    tail element by element, the body as realigned 16-byte words); each
    pair is then folded in the window dtype (``add_values``: floats in
    f32 rounded once, integers wrapping). Returns the per-byte write
    counts of the cut."""
    esize = np.dtype(_K14[dt]).itemsize
    paired = mem.copy()
    writes, _ = _model_copy(paired, src, dst, n, esize)
    nb = n * esize
    mem[dst:dst + nb] = _as_bytes(rma.add_values(
        _bytes_as(mem[dst:dst + nb], dt), _bytes_as(paired[dst:dst + nb], dt)))
    return writes


def _place(mem, at, values):
    mem[at:at + values.nbytes] = values.view(np.uint8)


@pytest.mark.parametrize("dt", sorted(_K14))
def test_direct_fold_cut_matches_jax(dt):
    """For every source and destination offset mod 16 bytes, K14's cut
    folds each window element exactly once with its own source element,
    touches nothing outside the range, and leaves the row the JAX kernel
    leaves, bitwise."""
    esize = np.dtype(_K14[dt]).itemsize
    v = 16 // esize
    n, disp = 3 * v + v // 2 + 1, 3                # head, words, tail
    rng = np.random.default_rng(sorted(_K14).index(dt) + 700)
    row = _k14_values(rng, n + disp + 5, dt)
    src = _k14_values(rng, n, dt)
    want = _jax_acc_row(row, src, disp).view(np.uint8)
    base_src, base_row = 64, 64 + 256
    for so in range(0, 16, esize):
        for do in range(0, 16, esize):
            mem = rng.integers(0, 256, size=base_row + 128 + row.nbytes,
                               dtype=np.uint8)
            dst = base_row + do
            at_row = dst - disp * esize
            _place(mem, at_row, row)
            _place(mem, base_src + so, src)
            before = mem.copy()
            writes = _model_fold(mem, base_src + so, dst, n, dt)
            assert (writes[dst:dst + n * esize] == 1).all(), (so, do)
            assert writes.sum() == n * esize, (so, do)
            np.testing.assert_array_equal(
                mem[at_row:at_row + row.nbytes], want, err_msg=f"{so} {do}")
            outside = np.ones(mem.size, bool)
            outside[dst:dst + n * esize] = False
            np.testing.assert_array_equal(mem[outside], before[outside])


@pytest.mark.parametrize("dt", sorted(_K14))
def test_direct_fold_alias_doubles_like_jax(dt):
    """A source that is exactly the target range (``unshared`` leaves it
    in place, and the kernel reads each word through both pointers
    before it stores it) doubles the range, as the JAX kernel does with
    its immutable copy: the cut on byte memory at every destination
    offset, and the wrapper on a view of the window."""
    esize = np.dtype(_K14[dt]).itemsize
    v = 16 // esize
    n, disp = 2 * v + 3, 2
    rng = np.random.default_rng(sorted(_K14).index(dt) + 800)
    row = _k14_values(rng, n + disp + 4, dt)
    want = _jax_acc_row(row, row[disp:disp + n].copy(), disp)
    for do in range(0, 16, esize):
        mem = rng.integers(0, 256, size=256 + row.nbytes, dtype=np.uint8)
        dst = 64 + do
        _place(mem, dst - disp * esize, row)
        _model_fold(mem, dst, dst, n, dt)
        np.testing.assert_array_equal(
            mem[dst - disp * esize:dst - disp * esize + row.nbytes],
            want.view(np.uint8), err_msg=str(do))
    win = torch.stack([torch.zeros(row.size, dtype=_K14_TORCH[dt]),
                       _bytes_as(row.view(np.uint8), dt)])
    rma.reset_counts()
    rma.rma_accumulate(win[1, disp:disp + n], win, 0, 1, disp)
    assert rma.PLAIN_CALLS["rma_accumulate"] == 1
    np.testing.assert_array_equal(_as_bytes(win[1]), want.view(np.uint8))
    assert not _as_bytes(win[0]).any()


# ---------------------------------------------------------------------------
# K14q: its warp-per-block walk on the CPU against the jitted JAX kernel
# ---------------------------------------------------------------------------

def _model_quant_fold(row, src, disp, blk, wire):
    """K14q's walk: one warp a quantization block of ``blk`` values; lane
    l loads the 4-value words l, l + 32, ... and keeps the absmax of its
    words, the shuffle takes the block's; then each lane codes its words
    against scale = absmax * f32(1/top), decodes and folds them into the
    window with one rounding (``quant._fma_f32``). Returns the new row;
    asserts that every element is folded once."""
    from mvapich2_tpu_torch.ops import quant
    out = row.clone()
    n, nw = src.numel(), blk // 4
    top = 127.0 if wire == "q8" else 448.0
    inv = torch.tensor(quant._INV[wire], dtype=torch.float32)
    folds = torch.zeros(n, dtype=torch.int64)
    for k in range(n // blk):
        xb = src[k * blk:(k + 1) * blk]
        lanes = [torch.zeros((), dtype=torch.float32) for _ in range(32)]
        for lane in range(32):
            for i in range(lane, nw, 32):
                lanes[lane] = torch.maximum(lanes[lane],
                                            xb[4 * i:4 * i + 4].abs().max())
        scale = torch.stack(lanes).max() * inv
        safe = scale if scale > 0 else torch.ones_like(scale)
        for lane in range(32):
            for i in range(lane, nw, 32):
                x = xb[4 * i:4 * i + 4] / safe
                if wire == "q8":
                    code = torch.clamp(torch.round(x), -top, top)
                else:
                    code = torch.clamp(x, -top, top).to(
                        torch.float8_e4m3fn).to(torch.float32)
                at = disp + k * blk + 4 * i
                out[at:at + 4] = quant._fma_f32(code, scale, out[at:at + 4])
                folds[k * blk + 4 * i:k * blk + 4 * i + 4] += 1
    assert (folds == 1).all()
    return out


@pytest.mark.parametrize("qb,disp,wire", [
    (64, 0, "q8"), (64, 5, "fp8"), (512, 0, "fp8"), (512, 5, "q8"),
    (1024, 0, "q8"), (1024, 5, "fp8")])
def test_quant_fold_walk_matches_jax(env, qb, disp, wire):
    """QUANT_BLOCK of 64, 512 and 1024 bytes (16, 128 and 256 f32: 4, 32
    and 64 four-value words, so most lanes idle, one word a lane, two
    words a lane), at disp 0
    and 5 (a window row off its 16-byte boundary), three blocks, one of
    them all zeros (scale 0): the walk, the plain version and the JAX
    kernel leave the same row, bitwise."""
    env(QUANT_COLL=f"{wire}:1e-1", QUANT_BLOCK=str(qb))
    blk = rma.quant_block_elems()
    assert blk == qb // 4
    rng = np.random.default_rng(qb + disp)
    n = 3 * blk
    row = (rng.standard_normal(n + disp + 7) * 3).astype(np.float32)
    src = rng.standard_normal(n).astype(np.float32)
    src[blk:2 * blk] = 0.0
    want = _jax_acc_row(row, src, disp, quantized=True).view(np.int32)
    got = _model_quant_fold(torch.from_numpy(row), torch.from_numpy(src),
                            disp, blk, wire)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want)
    win = torch.stack([torch.zeros(row.size), torch.from_numpy(row)])
    rma.reset_counts()
    rma.rma_accumulate(torch.from_numpy(src), win, 0, 1, disp,
                       quantized=True)
    assert rma.PLAIN_CALLS["rma_accumulate_quant"] == 1
    np.testing.assert_array_equal(win[1].numpy().view(np.int32), want)


def test_quant_fold_alias_matches_jax(env):
    """K14q from the target range itself: each lane reads its words
    before it stores them, so the walk folds the old values, as the JAX
    kernel does with its immutable copy."""
    env(QUANT_COLL="q8:1e-1", QUANT_BLOCK="512")
    rng = np.random.default_rng(9)
    n, disp = 256, 4
    row = (rng.standard_normal(n + disp + 3) * 3).astype(np.float32)
    want = _jax_acc_row(row, row[disp:disp + n].copy(), disp,
                        quantized=True).view(np.int32)
    t = torch.from_numpy(row.copy())
    np.testing.assert_array_equal(
        _model_quant_fold(t, t[disp:disp + n], disp, 128, "q8").numpy()
        .view(np.int32), want)
    win = torch.stack([torch.zeros(row.size), torch.from_numpy(row)])
    rma.rma_accumulate(win[1, disp:disp + n], win, 0, 1, disp,
                       quantized=True)
    np.testing.assert_array_equal(win[1].numpy().view(np.int32), want)


# the JAX wrapper's chunk_bytes / depth: bad values raise in its argument
# checks, good ones are taken and do not change the result
_STREAM_ARGS = [{"chunk_bytes": "many"}, {"depth": "deep"},
                {"chunk_bytes": [16]}, {"depth": [3]},
                {"chunk_bytes": 0, "depth": 0},
                {"chunk_bytes": 64, "depth": 7}]


@pytest.mark.parametrize("quantized", (False, True),
                         ids=("exact", "quantized"))
def test_accumulate_stream_args_raise_like_jax(env, quantized):
    env(QUANT_COLL="q8:1e-1", QUANT_BLOCK="64")
    rng = np.random.default_rng(11)
    row = rng.standard_normal(40).astype(np.float32)
    src = rng.standard_normal(32).astype(np.float32)
    plain = _jax_acc_row(row, src, 3, quantized).view(np.int32)
    win = np.stack([np.zeros_like(row), row])
    for kw in _STREAM_ARGS:
        try:
            want = _jax_run(2, lambda w: pallas_rma.rma_accumulate(
                jnp.asarray(src), w[0], "x", 2, 0, 1, 3,
                quantized=quantized, interpret=True, credits=False,
                **kw)[None, :], jnp.asarray(win))[1].view(np.int32)
            err = None
        except (TypeError, ValueError) as e:
            err = type(e)
        got = torch.from_numpy(win.copy())
        if err is None:
            rma.rma_accumulate(torch.from_numpy(src), got, 0, 1, 3,
                               quantized=quantized, **kw)
            np.testing.assert_array_equal(want, plain)
            np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                          want, err_msg=str(kw))
        else:
            with pytest.raises(err):
                rma.rma_accumulate(torch.from_numpy(src), got, 0, 1, 3,
                                   quantized=quantized, **kw)
            assert torch.equal(got, torch.from_numpy(win)), kw
