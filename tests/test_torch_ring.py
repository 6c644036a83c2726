"""Parity of the port's resident ring kernels module
(mvapich2_tpu_torch/ops/ring.py, K6 ring_all_reduce and K7
ring_all_gather, plain route on the CPU) with the JAX package's
ops/pallas_ring.py run in Pallas interpret mode on the 8-device virtual
CPU mesh. The interpreter of this jax cannot signal a remote semaphore,
so the JAX kernels run creditless (``have_remote_signal`` patched to
False through monkeypatch), the interpreter's documented mode.

Inputs meet the conditions under which the JAX wrapper really reaches
its kernel (sum, n % p == 0, at most 4 MiB); otherwise it returns
``lax.psum`` and the comparison would not test the kernel.

Tolerances: bitwise everywhere. The plain versions replay the kernels'
ring schedule, so even normal f32 data folds in the kernels' order.

The CUDA kernels do not replay the ring: K6 folds each block directly
in the ring's order and K7 copies each shard into every row. CPU models
of their loops (``_model_fold``, ``_model_gather``, unit by unit as
csrc/ring.cu walks them) are held bitwise against the plain versions,
which the JAX parity tests above hold against the JAX kernels in f32,
int32, bf16, f16 and int8. The same gather kernel runs K5 of
ops/ici.py over several rings at once; ``_model_gather`` over lines is
held against ``ici.hbm_ring_all_gather_ref``, which
tests/test_torch_ici.py holds against the JAX K5. The same fold kernel
runs K3 of ops/ici.py (any op, any n, both ring directions, several
rings); ``_model_k3`` is held against ``ici.hbm_ring_all_reduce_ref``,
which tests/test_torch_ici.py holds against the JAX K3. K4 runs the same
loop with each block stored into its owner's row alone and the op's
identity in the padded tail; ``_model_k4`` is held against
``ici.hbm_ring_reduce_scatter_ref``, which tests/test_torch_ici.py and
tests/test_torch_reduce_scatter.py hold against the JAX K4."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mvapich2_tpu.ops import pallas_ring
from mvapich2_tpu.parallel import MeshComm, make_mesh as jax_make_mesh
from mvapich2_tpu_torch.ops import ici, ring

NP = 8


@pytest.fixture(scope="module")
def comm8():
    return MeshComm(jax_make_mesh((NP,), ("x",)))


@pytest.fixture
def creditless(monkeypatch):
    monkeypatch.setattr(pallas_ring, "have_remote_signal", lambda: False)


def _data(seed, shape, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "intf32":
        return rng.integers(-1000, 1000, size=shape).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    if kind == "int8":
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    if kind in ("bf16", "f16"):
        return rng.normal(size=shape).astype(
            jnp.bfloat16 if kind == "bf16" else np.float16)
    raise ValueError(kind)


def _torch(xv):
    """``xv`` as a torch tensor of its dtype (numpy's bfloat16 through
    its bits)."""
    if xv.dtype == jnp.bfloat16:
        return torch.from_numpy(xv.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(xv)


def _same_bits(got, want):
    """``got`` (torch) and ``want`` (JAX) agree bit for bit."""
    iv = {1: np.int8, 2: np.int16, 4: np.int32}[got.element_size()]
    np.testing.assert_array_equal(
        got.view({1: torch.int8, 2: torch.int16,
                  4: torch.int32}[got.element_size()]).numpy(),
        np.asarray(want).view(iv))


@pytest.mark.parametrize("shard,kind", [
    (8, "intf32"),        # one element per block
    (64, "normal"),       # normal data: bitwise too, same fold order
    (40, "int32"),        # int32 sums wrap as the JAX kernel's do
    (64, "bf16"),         # bf16 and f16: every partial rounded
    (64, "f16"),
    (40, "int8"),         # narrow sums wrap
])
def test_ring_all_reduce_parity(comm8, creditless, shard, kind):
    xv = _data(40 + shard, (NP, shard), kind)
    want = comm8.run(lambda s: pallas_ring.ring_all_reduce(
        s, "x", NP, interpret=True), jnp.asarray(xv.reshape(-1)))
    want = np.asarray(want).reshape(NP, shard)
    ring.reset_counts()
    got = ring.ring_all_reduce(_torch(xv))
    assert ring.PLAIN_CALLS["ring_all_reduce"] == 1
    assert ring.LAUNCHES["ring_all_reduce"] == 0
    _same_bits(got, want)


@pytest.mark.parametrize("shard,kind", [(5, "intf32"), (16, "normal"),
                                        (3, "int32"), (16, "bf16"),
                                        (16, "f16"), (5, "int8")])
def test_ring_all_gather_parity(comm8, creditless, shard, kind):
    xv = _data(50 + shard, (NP, shard), kind)
    want = comm8.run(lambda s: pallas_ring.ring_all_gather(
        s, "x", NP, interpret=True), jnp.asarray(xv.reshape(-1)),
        out_specs=P("x"))
    want = np.asarray(want).reshape(NP, NP * shard)
    ring.reset_counts()
    got = ring.ring_all_gather([_torch(r) for r in xv])
    assert ring.PLAIN_CALLS["ring_all_gather"] == 1
    _same_bits(got, want)


@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_replay_matches_the_sum_for_every_ring_size(p):
    """The replayed schedule reduces and gathers for any p (odd rings
    and the two-rank ring, where left and right are one rank)."""
    x = torch.from_numpy(_data(p, (p, 4 * p), "intf32"))
    np.testing.assert_array_equal(
        ring.ring_all_reduce_ref(x).numpy(),
        np.broadcast_to(x.numpy().sum(0), (p, 4 * p)))
    np.testing.assert_array_equal(
        ring.ring_all_gather_ref(x).numpy(),
        np.broadcast_to(x.numpy().reshape(-1), (p, 4 * p * p)))


def test_narrow_integers_wrap():
    x = torch.full((NP, 16), 100, dtype=torch.int8)
    got = ring.ring_all_reduce(x)
    assert got.dtype == torch.int8
    assert int(got[0, 0]) == np.int8(np.int32(800).astype(np.int8))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="n % p"):
        ring.ring_all_reduce(torch.zeros((NP, 12)))       # 12 % 8 != 0
    with pytest.raises(ValueError, match="4194304"):
        ring.ring_all_reduce(torch.zeros((NP, 2 << 20)))  # 8 MiB shard
    with pytest.raises(ValueError, match="4194304"):
        ring.ring_all_gather(torch.zeros((NP, 1 << 18)))  # 8 MiB output
    with pytest.raises(ValueError, match="differ"):
        ring.ring_all_gather([torch.zeros(4), torch.zeros(5)])


def test_cuda_request_without_card_raises(monkeypatch):
    """A tensor that is not on the CPU never takes the plain route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = [torch.empty(16, device="meta") for _ in range(NP)]
    ring.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring.ring_all_reduce(meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring.ring_all_gather(meta)
    assert ring.PLAIN_CALLS == {"ring_all_reduce": 0, "ring_all_gather": 0}
    from mvapich2_tpu_torch.ops import _build
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load("ring")
    ring.check_errors()      # nothing loaded: nothing to check


def test_error_word_raises_once(monkeypatch):
    """check_errors and the next launch raise on the word a timed-out
    spin leaves, and the read clears it."""
    from mvapich2_tpu_torch.ops import _build

    class Lib:
        code = 1

        def mv2t_ring_error(self, clear):
            code = self.code
            if clear:
                self.code = 0
            return code

    lib = Lib()
    monkeypatch.setitem(_build._loaded, "ring", lib)
    with pytest.raises(RuntimeError, match="error word 1"):
        ring.check_errors(torch.device("cpu"))
    ring.check_errors(torch.device("cpu"))        # cleared by the read
    lib.code = 2
    monkeypatch.setattr(_build, "load", lambda name: lib)
    with pytest.raises(RuntimeError, match="error word 2"):
        ring.launch("mv2t_ring_all_reduce", torch.device("cpu"))
    assert lib.code == 0


def test_ring_signatures_cover_every_entry():
    """The ctypes table of csrc/ring.cu names every C entry point, and
    every pointer argument is a c_void_p (the parametrised
    test_torch_isolation check matches names and types one by one)."""
    import ctypes
    import os
    import re
    from mvapich2_tpu_torch.ops import _build
    src = open(os.path.join(os.path.dirname(_build.__file__), "..", "csrc",
                            "ring.cu")).read()
    body = src[src.index('extern "C" {'):]
    entries = set(re.findall(r"^(?:int|const char\*) (mv2t_\w+)\(", body,
                             re.M))
    table = _build.SIGNATURES["ring"]
    assert entries == set(table)
    for fn, (_, args) in table.items():
        for name, t in args:
            if name in ("ins", "outs", "slots", "flags", "stream"):
                assert t is ctypes.c_void_p, f"{fn}({name})"
    # K3 and K4 are direct launches: no slot, flag, blocks-a-lane count or
    # working rows, and K4 takes K3's arguments; K17 launches through
    # K12's entry and K10 through K11's, and neither has one of its own
    names = {name for name, _ in table["mv2t_hbm_ring_all_reduce"][1]}
    assert not names & {"slots", "flags", "ctas", "chunk", "depth"}
    k4 = table["mv2t_hbm_ring_reduce_scatter"]
    assert not {name for name, _ in k4[1]} & {
        "slots", "flags", "ctas", "chunk", "depth", "work", "nblk"}
    assert k4 == table["mv2t_hbm_ring_all_reduce"]
    assert "mv2t_direct_put" not in table
    assert "mv2t_hbm_alltoall" not in table


# ---------------------------------------------------------------------------
# CPU models of the direct kernels (csrc/ring.cu
# ring_all_reduce_direct_kernel, ring_all_gather_direct_kernel)
# ---------------------------------------------------------------------------

DIRECT_KINDS = {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16, "i16": torch.int16, "i8": torch.int8,
                "u8": torch.uint8, "u16": torch.uint16, "u32": torch.uint32}


def _kind_data(seed, shape, kind):
    """Normal floats rounded to the dtype; integers over the dtype's
    whole range, so that sums wrap."""
    rng = np.random.default_rng(seed)
    dt = DIRECT_KINDS[kind]
    if dt.is_floating_point:
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dt)
    nt = {"i16": np.int16, "i8": np.int8, "u8": np.uint8,
          "u16": np.uint16, "u32": np.uint32}[kind]
    info = np.iinfo(nt)
    return torch.from_numpy(rng.integers(info.min, info.max, size=shape,
                                         endpoint=True).astype(nt))


def _bits(t):
    """The bit patterns of ``t`` as numpy integers of its width."""
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()]).numpy()


def _red(a, b):
    """``red<T, SUM>`` of csrc/ring.cu: floats add in f32 and round to T,
    integers add and wrap to T (in int64 here, the same modulo 2^k)."""
    if a.dtype.is_floating_point:
        return (a.float() + b.float()).to(a.dtype)
    return (a.to(torch.int64) + b.to(torch.int64)).to(a.dtype)


def _units(n, v):
    """Unit u's elements: u*v .. u*v + v - 1 (a 16-byte word of v
    elements on the vector path, one element on the scalar path)."""
    u = torch.arange(n // v)
    return u, u[:, None] * v + torch.arange(v)


def _model_fold(x, vec, carry_f32=False):
    """K6's loop over ``x`` of shape (p, n): unit u of block b =
    u // per_blk starts as rank b+1's unit and folds rank (b+j) % p's as
    ``red(x, acc)`` for j = 2..p; the result goes to every rank's row.
    ``carry_f32`` carries an f32 accumulator over the p terms and rounds
    once, which the kernel must not do."""
    p, n = x.shape
    v = 16 // x.element_size() if vec else 1
    blk = n // p
    assert blk % v == 0           # the vector path's condition
    u, cols = _units(n, v)
    b = u // (blk // v)
    acc = x[((b + 1) % p)[:, None], cols]
    if carry_f32:
        acc = acc.float()
    for j in range(2, p + 1):
        inc = x[((b + j) % p)[:, None], cols]
        acc = inc.float() + acc if carry_f32 else _red(inc, acc)
    return acc.to(x.dtype).reshape(1, n).expand(p, n).clone()


def _model_gather(x, vec, lines=1):
    """K7's and K5's loop over ``x`` of shape (lines*p, m), on the bit
    patterns: unit u of lines*p*mu is unit u - s*mu of shard s = u // mu
    (= g*p + q of line g), loaded once and stored at unit u - g*p*mu of
    the p rows of line g."""
    rows, m = x.shape
    p = rows // lines
    v = 16 // x.element_size() if vec else 1
    assert m % v == 0             # the vector path's condition
    xb = torch.from_numpy(_bits(x))
    u, _ = _units(rows * m, v)
    mu = m // v
    sh = u // mu
    first = sh // p * p
    lane = torch.arange(v)
    vals = xb[sh[:, None], (u - sh * mu)[:, None] * v + lane]
    out = torch.zeros((rows, p * m), dtype=xb.dtype)
    at = (u - first * mu)[:, None] * v + lane
    for r in range(p):
        out[(first + r)[:, None], at] = vals
    return out.numpy()


@pytest.mark.parametrize("kind", sorted(DIRECT_KINDS))
@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_direct_fold_order_is_the_rings(p, kind):
    """K6's closed form, x[b] + (x[b-1] + (... + x[b+1])) rounded at
    every step, is the ring's result bit for bit: on the vector path
    (a block of 32, a whole number of words for every width) and the
    scalar one (also an odd block of 5)."""
    for blk, paths in ((32, (True, False)), (5, (False,))):
        x = _kind_data(p * 100 + blk, (p, p * blk), kind)
        want = _bits(ring.ring_all_reduce_ref(x))
        for vec in paths:
            np.testing.assert_array_equal(_bits(_model_fold(x, vec)), want)


@pytest.mark.parametrize("kind", sorted(DIRECT_KINDS))
@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_direct_gather_map_is_the_rings(p, kind):
    """K7's (shard, word) -> every row map is the ring's result, on the
    vector path (32 elements a shard) and the scalar one (also 7)."""
    for m, paths in ((32, (True, False)), (7, (False,))):
        x = _kind_data(p * 200 + m, (p, m), kind)
        want = _bits(ring.ring_all_gather_ref(x))
        for vec in paths:
            np.testing.assert_array_equal(_model_gather(x, vec), want)


@pytest.mark.parametrize("kind", sorted(DIRECT_KINDS))
@pytest.mark.parametrize("lines", [1, 2, 4])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_direct_gather_map_over_lines_is_k5s(p, lines, kind):
    """K5's (line, shard, unit) -> rows map (K7's kernel over ``lines``
    rings of p, shards line-major) is the ring replay line by line, on
    the vector path (32 elements a shard) and the scalar one (also 7)."""
    for m, paths in ((32, (True, False)), (7, (False,))):
        x = _kind_data(p * 300 + lines * 10 + m, (lines * p, m), kind)
        want = _bits(ici.hbm_ring_all_gather_ref(x, lines=lines))
        for vec in paths:
            np.testing.assert_array_equal(_model_gather(x, vec, lines),
                                          want)


def test_an_f32_accumulator_would_break_the_bf16_ring_order():
    """Carrying an f32 sum across the p terms and rounding once gives
    other bf16 bits than the ring, which rounds every partial: the
    kernel must round at every step."""
    x = _kind_data(7, (NP, NP * 32), "bf16")
    want = _bits(ring.ring_all_reduce_ref(x))
    np.testing.assert_array_equal(_bits(_model_fold(x, True)), want)
    assert not np.array_equal(_bits(_model_fold(x, True, carry_f32=True)),
                              want)


# ---------------------------------------------------------------------------
# a CPU model of K3's direct fold (csrc/ring.cu ring_all_reduce_direct_kernel
# over lines rings, any op, both directions, a short last block)
# ---------------------------------------------------------------------------

K3_KINDS = dict(DIRECT_KINDS, i32=torch.int32)


def _k3_data(seed, shape, kind):
    if kind == "i32":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=shape,
                                             dtype=np.int32))
    return _kind_data(seed, shape, kind)


def _model_k3(x, op, vec, ndir, lines=1, swap=False):
    """K3's loop over ``x`` of shape (lines*p, n): unit u of lines*nu is
    unit k = u - g*nu of line g = u // nu; its block b = k // per_blk, and
    it folds counter-clockwise when ndir == 2 and its offset in the block
    is at or past the half point (``swap``: the other way round). The
    fold starts at rank b + d of its line (d = 1, or p - 1 for
    counter-clockwise) and folds ranks b + 2d, ..., b + pd (mod p) as
    ``red(x, acc)``; the result goes to every row of the line. uint16 and
    uint32 fold in int64 and wrap at the end, as the replay does (sums and
    products modulo 2^k, max and min on the unsigned values)."""
    rows, n = x.shape
    p = rows // lines
    v = 16 // x.element_size() if vec else 1
    nblk = -(-n // p)
    h = (nblk + 1) // 2
    if vec:                       # the vector path's conditions
        assert n % v == 0 and nblk % v == 0 and (ndir == 1 or h % v == 0)
    nu, per_blk, half = n // v, nblk // v, h // v
    xw = x.to(torch.int64) if x.dtype in ring.WIDE else x
    red = ring.reducer(op)
    u = torch.arange(lines * nu)
    g, k = u // nu, u % nu
    b = k // per_blk
    ccw = (k - b * per_blk >= half) if ndir == 2 else torch.zeros_like(
        u, dtype=torch.bool)
    if swap:
        ccw = ~ccw
    d = torch.where(ccw, p - 1, 1)
    cols = k[:, None] * v + torch.arange(v)
    q = (b + d) % p
    acc = xw[(g * p + q)[:, None], cols]
    for _ in range(2, p + 1):
        q = (q + d) % p
        acc = red(xw[(g * p + q)[:, None], cols], acc)
    out = torch.empty((rows, n), dtype=xw.dtype)
    for r in range(p):
        out[(g * p + r)[:, None], cols] = acc
    return out.to(x.dtype)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("kind", sorted(K3_KINDS))
@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_k3_direct_fold_is_the_rings(p, kind, op):
    """K3's direct fold is the streaming ring's result bit for bit, over
    1, 2 and 4 lines, in one and two ring directions: on the vector path
    (n = 32p: a block of 32, its half 16, whole words at every width)
    and the scalar one (also a ragged n = 7p - 3, whose last block is
    short and whose halves differ)."""
    for n, paths in ((32 * p, (True, False)), (7 * p - 3, (False,))):
        for lines in (1, 2, 4):
            x = _k3_data(p * 1000 + lines * 100 + n, (lines * p, n), kind)
            for ndir in (1, 2):
                want = _bits(ici.hbm_ring_all_reduce_ref(
                    x, op, bidirectional=ndir == 2, lines=lines))
                for vec in paths:
                    np.testing.assert_array_equal(
                        _bits(_model_k3(x, op, vec, ndir, lines)), want,
                        err_msg=f"n={n} lines={lines} ndir={ndir} "
                                f"vec={vec}")


def _nan_zero_data(seed, shape, dt):
    """Values from {-1, -0.0, +0.0, 1, NaN}: ties of signed zeros and NaN
    operands on both sides of the fold."""
    rng = np.random.default_rng(seed)
    pool = np.array([-1.0, -0.0, 0.0, 1.0, np.nan], np.float32)
    return torch.from_numpy(pool[rng.integers(0, 5, size=shape)]).to(dt)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "f16"])
def test_k3_nan_and_signed_zero_follow_the_ring(kind, op):
    """max and min keep the ring's (own, acc) operand order, so a NaN
    operand propagates with the payload of the fold order, while a tie of
    -0.0 and +0.0 gives the zero of jnp.maximum/minimum in either order;
    the model follows the replay bit for bit."""
    p, n = 8, 32 * 8          # a block of 32: whole words at 2 bytes
    for lines in (1, 2):
        x = _nan_zero_data(len(kind) + lines, (lines * p, n),
                           K3_KINDS[kind])
        for ndir in (1, 2):
            want = _bits(ici.hbm_ring_all_reduce_ref(
                x, op, bidirectional=ndir == 2, lines=lines))
            for vec in (True, False):
                np.testing.assert_array_equal(
                    _bits(_model_k3(x, op, vec, ndir, lines)), want)


def test_signed_zeros_order_as_jnp_maximum_and_minimum():
    """red(own, acc) for max of -0.0 and +0.0 is +0.0 and for min -0.0,
    in either order, as XLA's jnp.maximum/minimum give them, on every
    position of a long tensor (the CPU's torch.maximum answers by
    position in its vector loop); a NaN operand on either side
    propagates."""
    neg, pos = torch.full((37,), -0.0), torch.zeros(37)
    nan = torch.full((37,), float("nan"))
    for op, sign in (("max", False), ("min", True)):
        red = ring.reducer(op)
        assert (torch.signbit(red(neg, pos)) == sign).all()
        assert (torch.signbit(red(pos, neg)) == sign).all()
        assert red(nan, pos).isnan().all() and red(pos, nan).isnan().all()


def test_k3_model_tells_the_directions_apart():
    """On non-integer f32 at p = 8 with both directions, the model with
    the halves' orders swapped, or with one direction only, gives other
    bits than the ring: the kernel must take the split as it is."""
    x = _k3_data(11, (NP, NP * 32), "f32")
    want = _bits(ici.hbm_ring_all_reduce_ref(x, bidirectional=True))
    np.testing.assert_array_equal(_bits(_model_k3(x, "sum", True, 2)), want)
    assert not np.array_equal(
        _bits(_model_k3(x, "sum", True, 2, swap=True)), want)
    assert not np.array_equal(_bits(_model_k3(x, "sum", True, 1)), want)


# ---------------------------------------------------------------------------
# a CPU model of K4's direct fold (csrc/ring.cu direct_fold with the owner-row
# store: ring_reduce_scatter_direct_kernel)
# ---------------------------------------------------------------------------

def _model_k4(x, op, vec, ndir, lines=1):
    """K4's loop over ``x`` of shape (lines*p, n): unit u of
    lines*p*per_blk is unit k = u - g*p*per_blk of line g's padded blocks;
    below nu it folds as ``_model_k3``'s unit k (block b = k // per_blk,
    offset j = k - b*per_blk, counter-clockwise when ndir == 2 and j is at
    or past the half point) and goes to unit j of row g*p + b alone; from
    nu on (the padded tail of the last block) the op's identity goes
    there and nothing is read."""
    rows, n = x.shape
    p = rows // lines
    v = 16 // x.element_size() if vec else 1
    nblk = -(-n // p)
    h = (nblk + 1) // 2
    if vec:                       # the vector path's conditions
        assert n % v == 0 and nblk % v == 0 and (ndir == 1 or h % v == 0)
    nu, per_blk, half = n // v, nblk // v, h // v
    xw = x.to(torch.int64) if x.dtype in ring.WIDE else x
    red = ring.reducer(op)
    u = torch.arange(lines * p * per_blk)
    g, k = u // (p * per_blk), u % (p * per_blk)
    b = k // per_blk
    j = k - b * per_blk
    real = k < nu
    d = torch.where((j >= half) & (ndir == 2), p - 1, 1)
    lane = torch.arange(v)
    cols = k[:, None] * v + lane
    out = torch.empty((rows, nblk), dtype=xw.dtype)
    at = (g * p + b)[:, None], j[:, None] * v + lane
    out[at[0][~real], at[1][~real]] = ici._pad_identity(x.dtype, op)
    g, b, d, cols = g[real], b[real], d[real], cols[real]
    q = (b + d) % p
    acc = xw[(g * p + q)[:, None], cols]
    for _ in range(2, p + 1):
        q = (q + d) % p
        acc = red(xw[(g * p + q)[:, None], cols], acc)
    out[at[0][real], at[1][real]] = acc
    return out.to(x.dtype)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("kind", sorted(K3_KINDS))
@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_k4_direct_fold_is_the_rings(p, kind, op):
    """K4's direct fold, kept to each block's owner, is the reduce-scatter
    ring's result bit for bit, over 1, 2 and 4 lines, in one and two ring
    directions: on the vector path (n = 32p: a block of 32, its half 16,
    whole words at every width) and the scalar one (also a ragged n = 7p
    - 3, whose last block ends in three elements of identity padding,
    and n = 1, where every block but the first is padding)."""
    for n, paths in ((32 * p, (True, False)), (7 * p - 3, (False,)),
                     (1, (False,))):
        for lines in (1, 2, 4):
            x = _k3_data(p * 2000 + lines * 100 + n, (lines * p, n), kind)
            for ndir in (1, 2):
                want = _bits(ici.hbm_ring_reduce_scatter_ref(
                    x, op, bidirectional=ndir == 2, lines=lines))
                for vec in paths:
                    np.testing.assert_array_equal(
                        _bits(_model_k4(x, op, vec, ndir, lines)), want,
                        err_msg=f"n={n} lines={lines} ndir={ndir} "
                                f"vec={vec}")


def _nan_as_one(t):
    """``_bits(t)`` with every NaN as one pattern: torch on the CPU gives a
    16-bit NaN another payload in a vectorized loop than in a scalar one,
    so two computations of one fold order agree on where the NaNs land,
    not on their payloads."""
    b = _bits(t).copy()
    b[t.float().isnan().numpy()] = -1
    return b


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "f16"])
def test_k4_nan_and_signed_zero_follow_the_ring(kind, op):
    """K4 under max and min with NaNs and ties of signed zeros follows
    the replay as K3 does (a block of 32 bit for bit; a ragged n with its
    NaNs taken as one pattern, whose payload torch's 16-bit loops set)."""
    p = 8
    for n, paths in ((32 * p, (True, False)), (7 * p - 3, (False,))):
        bits = _bits if n == 32 * p else _nan_as_one
        for lines in (1, 2):
            x = _nan_zero_data(len(kind) + lines + n, (lines * p, n),
                               K3_KINDS[kind])
            for ndir in (1, 2):
                want = bits(ici.hbm_ring_reduce_scatter_ref(
                    x, op, bidirectional=ndir == 2, lines=lines))
                for vec in paths:
                    np.testing.assert_array_equal(
                        bits(_model_k4(x, op, vec, ndir, lines)), want)
