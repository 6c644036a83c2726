"""Parity of the port's alltoall module (mvapich2_tpu_torch/ops/
alltoall.py: K10 hbm_alltoall, K11 hbm_alltoallv, their helpers and the
tier dispatch; plain route on the CPU) with the JAX package's
ops/pallas_alltoall.py run in Pallas interpret mode on the 8-device
virtual CPU mesh. The interpreter of this jax cannot signal a remote
semaphore, so the JAX kernels run with ``credits=False`` (the
interpreter's creditless mode: its emulation is synchronous).

Shapes: p = 8 with small ``chunk_bytes`` so every call makes many
chunks; a block that is not a multiple of the chunk; one and two lanes;
the MoE bench's three routing matrices; a matrix with zero-count pairs,
a row of zeros and steps that are empty on every rank; spread explicit
displacements with ``out_len``; a pair that spans many tiles.

The CUDA K11 is one direct copy by a table of tiles
(``alltoall.tile_table``); ``_replay_tiles`` copies the same tiles with
torch slices on the CPU and is held against the JAX kernel too, and the
tiles are checked to cover every pair exactly once. The CUDA K10 is the
same copy over the uniform plan's table (``alltoall.uniform_plan``),
whose replay is held against the block transpose, the plain K10, which
the parity tests hold against the JAX K10.

Tolerances: bitwise everywhere (the kernels only move bytes).

Every test that changes an MV2T_* variable restores it and reloads both
packages' configs in the fixture's teardown, and the JAX package's
measured-profile tables are swapped for empty ones while a test runs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mvapich2_tpu.bench.moe import routing as jax_routing
from mvapich2_tpu.coll import tuning as jax_tuning
from mvapich2_tpu.ops import pallas_alltoall
from mvapich2_tpu.parallel import MeshComm, make_mesh as jax_make_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import mpit
from mvapich2_tpu_torch.ops import alltoall
from mvapich2_tpu_torch.utils.config import get_config

NP = 8


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


def _data(seed, shape, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    if kind == "int8":
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    if kind == "bf16":
        return rng.normal(size=shape).astype(jnp.bfloat16)
    raise ValueError(kind)


def _torch(xv):
    """``xv`` as a torch tensor of its dtype (numpy's bfloat16 through
    its bits)."""
    if xv.dtype == jnp.bfloat16:
        return torch.from_numpy(xv.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(xv)


def _bits(t):
    """The bit patterns of a torch tensor as numpy integers of its
    width."""
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()]).numpy()


def _np_bits(a):
    return np.asarray(a).view({1: np.int8, 2: np.int16,
                               4: np.int32}[np.asarray(a).itemsize])


def _sparse():
    """Zero-count pairs, a row of zeros (rank 6 sends nothing but
    receives), and steps 2, 4, 5 and 6 empty on every rank."""
    c = [[0] * NP for _ in range(NP)]
    for r, j, n in ((0, 1, 37), (1, 2, 5), (2, 3, 1), (3, 6, 19),
                    (5, 0, 3), (7, 6, 11), (4, 4, 7)):
        c[r][j] = n
    return c


def _spread():
    """The spread layout of test_alltoallv_layouts_and_lowerings_agree:
    at most 4 elements a pair of the sparse matrix, every send and
    receive at 4 * peer, outputs of 40."""
    disp = [[4 * j for j in range(NP)] for _ in range(NP)]
    counts = [[min(c, 4) for c in row] for row in _sparse()]
    return counts, dict(sdispls=disp, rdispls=disp, out_len=40)


def _multi():
    """One pair far larger than the rest (rank 2 sends rank 5 300
    elements), so it spans many tiles."""
    c = [[(r + j) % 3 for j in range(NP)] for r in range(NP)]
    c[2][5] = 300
    return c


def _matrix(shape):
    """(counts, layout keywords) of a named test matrix."""
    if shape == "spread":
        return _spread()
    if shape == "sparse":
        return _sparse(), {}
    if shape == "multi":
        return _multi(), {}
    return jax_routing(NP, 24, shape), {}


def _jax_alltoallv(comm8, payloads, counts, **kw):
    """The JAX K11 over the payloads, each padded to the longest of the
    mesh-wide in_len and their own lengths (shard_map needs uniform
    shapes); one row per rank."""
    _, _, in_len, _ = pallas_alltoall.packed_displs(counts)
    in_len = max([in_len] + [x.size for x in payloads])
    buf = np.zeros((NP, in_len), payloads[0].dtype)
    for r, x in enumerate(payloads):
        buf[r, :x.size] = x
    out = comm8.run(lambda s: pallas_alltoall.hbm_alltoallv(
        s, "x", NP, counts, interpret=True, credits=False, **kw),
        jnp.asarray(buf.reshape(-1)))
    return np.asarray(out).reshape(NP, -1)


def _replay_tiles(shards, plan, rows):
    """The CUDA K11's copy on the CPU: every tile of ``rows`` one slice
    copy from its source payload into its destination output (in table
    order; no two tiles store to one element)."""
    outs = plan.outputs(shards[0])
    for sr, so, dr, do, n, _ in rows:
        outs[dr][do:do + n] = shards[sr][so:so + n]
    return outs


# ---------------------------------------------------------------------------
# K10 against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,c,chunk_bytes,bidirectional,depth", [
    ("normal", 13, 16, True, 2),     # ragged: 13 = 3 chunks of 4 + 1
    ("int32", 13, 16, False, 3),     # one lane, depth 3
])
def test_alltoall_parity(comm8, kind, c, chunk_bytes, bidirectional,
                         depth):
    xv = _data(c + depth, (NP, NP * c), kind)
    want = comm8.run(lambda s: pallas_alltoall.hbm_alltoall(
        s, "x", NP, chunk_bytes=chunk_bytes, depth=depth,
        bidirectional=bidirectional, interpret=True, credits=False),
        jnp.asarray(xv.reshape(-1)))
    want = np.asarray(want).reshape(NP, NP * c)
    alltoall.reset_counts()
    got = alltoall.hbm_alltoall([torch.from_numpy(r) for r in xv],
                                chunk_bytes=chunk_bytes, depth=depth,
                                bidirectional=bidirectional)
    assert alltoall.PLAIN_CALLS["hbm_alltoall"] == 1
    assert alltoall.LAUNCHES["hbm_alltoall"] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        alltoall.hbm_alltoall_ref(torch.from_numpy(xv)).numpy(), want)


def test_alltoall_edges():
    x = torch.arange(24, dtype=torch.float32).reshape(1, 24)
    assert torch.equal(alltoall.hbm_alltoall(x), x)              # p == 1
    empty = [torch.empty(0) for _ in range(NP)]
    assert alltoall.hbm_alltoall(empty).shape == (NP, 0)
    with pytest.raises(ValueError, match="not divisible"):
        alltoall.hbm_alltoall(torch.zeros(NP, 12))


# ---------------------------------------------------------------------------
# K11 against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "shape,kind,chunk_bytes,bidirectional,tile_bytes", [
        ("hot", "normal", 16, True, 16),
        ("skew", "int32", 16, False, 64),
        ("uniform", "normal", 16, True, alltoall.TILE_BYTES),
        ("sparse", "int32", 8, True, 16),
        ("hot", "bf16", 16, False, 32),
        ("skew", "int8", 16, True, 16),
        ("uniform", "int8", 8, False, 48),
        ("sparse", "bf16", 8, True, 64),
        ("spread", "int32", 8, True, 16),
        ("spread", "bf16", 8, False, 8),
        ("multi", "normal", 256, True, 64),
        ("multi", "int8", 64, False, 48),
    ])
def test_alltoallv_parity(comm8, shape, kind, chunk_bytes, bidirectional,
                          tile_bytes):
    """The plain K11 and the replay of its tile table (at tile sizes
    from 8 bytes, where most pairs span several tiles, to TILE_BYTES)
    against the JAX kernel, bit for bit. A spread layout leaves gaps: the
    port zeroes them, the JAX interpreter leaves them uninitialised, so
    those places are compared with zero alone."""
    counts, layout = _matrix(shape)
    n_in = 4 * NP if layout else None
    payloads = [_data(40 + r, (n_in or sum(counts[r]),), kind)
                for r in range(NP)]
    want = _jax_alltoallv(comm8, payloads, counts, chunk_bytes=chunk_bytes,
                          bidirectional=bidirectional, **layout)
    xs = [_torch(x) for x in payloads]
    alltoall.reset_counts()
    got = alltoall.hbm_alltoallv(xs, counts, chunk_bytes=chunk_bytes,
                                 bidirectional=bidirectional, **layout)
    assert alltoall.PLAIN_CALLS["hbm_alltoallv"] == 1
    assert alltoall.LAUNCHES["hbm_alltoallv"] == 0
    plan = alltoall._VPlan(xs, counts, layout.get("sdispls"),
                           layout.get("rdispls"), layout.get("out_len"), "t")
    rows = alltoall.tile_table(plan, xs[0].element_size(), tile_bytes)
    replay = _replay_tiles(xs, plan, rows)
    for j in range(NP):
        recv = layout.get("out_len") or sum(counts[r][j] for r in range(NP))
        written = np.zeros(recv, bool)
        for r in range(NP):
            d = plan.rd[j][r]
            written[d:d + counts[r][j]] = True
        for out in (got[j], replay[j]):
            assert out.numel() == recv             # own receive length
            np.testing.assert_array_equal(_bits(out)[written],
                                          _np_bits(want[j, :recv])[written])
            assert not _bits(out)[~written].any()


def test_alltoallv_layouts_and_lowerings_agree():
    """The plain version, the stock index-copy lowering and explicit
    displacements with ``out_len`` agree; unwritten places are zero."""
    counts = _sparse()
    xs = [torch.arange(sum(counts[r]), dtype=torch.int32) + 100 * r
          for r in range(NP)]
    ref = alltoall.hbm_alltoallv_ref(xs, counts)
    plan = alltoall._VPlan(xs, counts, None, None, None, "t")
    for a, b in zip(alltoall._stock_all_to_allv(xs, plan), ref):
        assert torch.equal(a, b)
    assert [t.numel() for t in ref] == [3, 37, 5, 1, 7, 0, 30, 0]
    # each rank's sends spread out with gaps, receives at rank*4
    sd = [[4 * j for j in range(NP)] for _ in range(NP)]
    rd = [[4 * j for j in range(NP)] for _ in range(NP)]
    small = [[min(c, 4) for c in row] for row in counts]
    spread = [torch.arange(4 * NP, dtype=torch.int32) + 100 * r
              for r in range(NP)]
    got = alltoall.hbm_alltoallv(spread, small, sdispls=sd, rdispls=rd,
                                 out_len=40)
    for j in range(NP):
        want = torch.zeros(40, dtype=torch.int32)
        for r in range(NP):
            n = small[r][j]
            want[4 * r:4 * r + n] = spread[r][4 * j:4 * j + n]
        assert torch.equal(got[j], want)
    with pytest.raises(ValueError, match="payload"):
        alltoall.hbm_alltoallv([x[:-1] if x.numel() else x for x in xs],
                               counts)
    with pytest.raises(ValueError, match="out_len"):
        alltoall.hbm_alltoallv(xs, counts, out_len=2)


# ---------------------------------------------------------------------------
# the helpers against their JAX twins
# ---------------------------------------------------------------------------

def test_helpers_match():
    for p in (1, 2, 3, 4, 7, 8):
        for ndir in (1, 2):
            assert alltoall._lane_steps(p, ndir) == \
                pallas_alltoall._lane_steps(p, ndir)
    for counts in (jax_routing(8, 24, "hot"), jax_routing(8, 64, "skew"),
                   jax_routing(3, 9, "uniform"), _sparse(),
                   [[0] * 4 for _ in range(4)]):
        assert alltoall.packed_displs(counts) == \
            pallas_alltoall.packed_displs(counts)


@pytest.mark.parametrize("esize", [1, 2, 4])
@pytest.mark.parametrize("shape,tile_bytes", [
    (shape, tb) for shape in ("hot", "skew", "uniform", "sparse", "spread",
                              "multi")
    for tb in (16, 48, alltoall.TILE_BYTES)] + [
    ("moe_hot", alltoall.TILE_BYTES)])
def test_tiles_cover_each_pair_once(shape, tile_bytes, esize):
    """K11's tile table: every tile lies inside one pair, at most
    ``tile_bytes`` long, with its source and destination offsets moved
    together; the tiles of a pair cover it exactly once, in order; empty
    pairs have none; a tile's vec says whether both offsets and its
    length are whole 16-byte words. "moe_hot" is the MoE dispatch at
    4096 tokens x 4096 elements."""
    if shape == "moe_hot":
        counts = [[c * 4096 for c in row]
                  for row in jax_routing(NP, 4096, "hot")]
        layout = {}
    else:
        counts, layout = _matrix(shape)
    n_in = [max(layout["sdispls"][r][j] + counts[r][j] for j in range(NP))
            if layout else sum(counts[r]) for r in range(NP)]
    xs = [torch.empty(n, dtype={1: torch.int8, 2: torch.int16,
                                4: torch.int32}[esize]) for n in n_in]
    plan = alltoall._VPlan(xs, counts, layout.get("sdispls"),
                           layout.get("rdispls"), layout.get("out_len"), "t")
    rows = alltoall.tile_table(plan, esize, tile_bytes)
    step = tile_bytes // esize
    covered = {}
    for sr, so, dr, do, n, vec in rows:
        s0, d0 = plan.sd[sr][dr], plan.rd[dr][sr]
        assert 0 < n <= step
        assert s0 <= so and so + n <= s0 + counts[sr][dr]
        assert do - d0 == so - s0
        assert vec == all(v * esize % 16 == 0 for v in (so, do, n))
        covered.setdefault((sr, dr), []).append((so - s0, n))
    for r in range(NP):
        for j in range(NP):
            spans = covered.get((r, j), [])
            assert bool(spans) == bool(counts[r][j])
            at = 0
            for off, n in spans:
                assert off == at
                at += n
            assert at == counts[r][j]
    if shape == "moe_hot":
        assert all(vec for *_, vec in rows)   # every MoE tile is words


@pytest.mark.parametrize("esize", [1, 2, 4])
@pytest.mark.parametrize("c", [13, 64])
@pytest.mark.parametrize("p", [2, 3, 8])
def test_uniform_plan_tiles_are_the_block_transpose(p, c, esize):
    """K10 on the card is K11's copy over ``uniform_plan``'s tile table:
    every pair (r -> j) moves its block of c elements from j*c of rank r
    to r*c of rank j, each pair covered once, in order, by tiles of at
    most ``tile_bytes`` (several a pair at 16 bytes, one at TILE_BYTES),
    with vec set exactly where both offsets and the length are whole
    16-byte words (every tile at c = 64); the replay of those tiles is
    the plain block transpose, bit for bit, at a ragged c (13) and a
    word-multiple one."""
    dt = {1: torch.int8, 2: torch.int16, 4: torch.int32}[esize]
    info = torch.iinfo(dt)
    rng = np.random.default_rng(100 * p + c + esize)
    xs = [torch.from_numpy(rng.integers(info.min, info.max, size=p * c,
                                        endpoint=True)).to(dt)
          for _ in range(p)]
    plan = alltoall.uniform_plan(xs)
    assert plan.counts == ((c,) * p,) * p and plan.lens == [p * c] * p
    want = alltoall._block_transpose(xs)
    for tile_bytes in (16, alltoall.TILE_BYTES):
        rows = alltoall.tile_table(plan, esize, tile_bytes)
        spans = {}
        for sr, so, dr, do, n, vec in rows:
            assert 0 < n <= tile_bytes // esize
            assert dr * c <= so and so + n <= (dr + 1) * c
            assert do - sr * c == so - dr * c
            assert vec == all(v * esize % 16 == 0 for v in (so, do, n))
            spans.setdefault((sr, dr), []).append((so - dr * c, n))
        assert sorted(spans) == [(r, j) for r in range(p) for j in range(p)]
        for pieces in spans.values():
            at = 0
            for off, n in pieces:
                assert off == at
                at += n
            assert at == c
        if c == 64:
            assert all(vec for *_, vec in rows)
        got = torch.stack(_replay_tiles(xs, plan, rows))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_overlapping_receives_raise():
    """Explicit receive ranges that overlap raise (MPI requires them
    disjoint; K11's tiles store in no set order)."""
    counts = [[2] * NP for _ in range(NP)]
    xs = [torch.arange(2 * NP, dtype=torch.int32) for _ in range(NP)]
    sd = [[2 * j for j in range(NP)] for _ in range(NP)]
    rd = [[2 * j for j in range(NP)] for _ in range(NP)]
    assert len(alltoall.hbm_alltoallv(xs, counts, sdispls=sd,
                                      rdispls=rd)) == NP
    rd[3][5] = 2 * 4 + 1                   # into rank 4's range at rank 3
    with pytest.raises(ValueError, match="overlap"):
        alltoall.hbm_alltoallv(xs, counts, sdispls=sd, rdispls=rd)


def test_planned_a2a_tier_matches(env):
    cases = [(1, np.float32), (4 << 20, np.float32), ((4 << 20) + 1,
             np.int8), (1 << 27, np.uint8), (0, np.float32),
             (64, np.float16), (64, np.complex64), (64, np.bool_)]
    torch_dt = {np.float32: torch.float32, np.int8: torch.int8,
                np.uint8: torch.uint8, np.float16: torch.float16,
                np.complex64: torch.complex64, np.bool_: torch.bool}

    def both(nb, dt):
        return (alltoall.planned_a2a_tier(nb, torch_dt[dt]),
                pallas_alltoall.planned_a2a_tier(nb, dt, interpret=True))

    for nb, dt in cases:
        mine, ref = both(nb, dt)
        assert mine == ref, (nb, dt)
    env(DEV_TIER_VMEM_MAX="64", DEV_TIER_XLA_MIN="4096")
    for nb in (64, 65, 4095, 4096, 1 << 20):
        mine, ref = both(nb, np.float32)
        assert mine == ref, nb
    assert alltoall.planned_a2a_tier(4096, torch.float32) == ("xla",
                                                               "size")
    # a quant budget sends alltoall to the kernels, never raises
    env(DEV_TIER_XLA_MIN=None, QUANT_COLL="1e-2")
    for nb in (65, 1 << 20, 8 << 20):
        mine, ref = both(nb, np.float32)
        assert mine == ref == ("hbm", None), nb


# ---------------------------------------------------------------------------
# the dispatchers
# ---------------------------------------------------------------------------

def test_dispatch_routes_by_tier(env):
    x = torch.from_numpy(_data(5, (NP, NP * 6), "int32"))
    want = x.reshape(NP, NP, 6).transpose(0, 1).reshape(NP, -1)
    counts = jax_routing(NP, 16, "hot")
    vs = [torch.arange(sum(counts[r]), dtype=torch.float32) + 1000 * r
          for r in range(NP)]
    vwant = alltoall.hbm_alltoallv_ref(vs, counts)
    before = mpit.pvar("dev_coll_fallback_size").read()
    alltoall.reset_counts()
    assert torch.equal(alltoall.ici_all_to_all(x), want)
    for a, b in zip(alltoall.ici_all_to_allv(vs, counts), vwant):
        assert torch.equal(a, b)
    assert alltoall.PLAIN_CALLS == {"hbm_alltoall": 1, "hbm_alltoallv": 1}
    # past DEV_TIER_XLA_MIN: the stock lowerings, the same bytes
    env(DEV_TIER_VMEM_MAX="16", DEV_TIER_XLA_MIN="64")
    got = alltoall.ici_all_to_all(x)
    assert torch.equal(got, want) and got[0].data_ptr() != got[1].data_ptr()
    for a, b in zip(alltoall.ici_all_to_allv(vs, counts), vwant):
        assert torch.equal(a, b)
    # a matrix of zeros takes the stock path at any size
    env(DEV_TIER_VMEM_MAX=None, DEV_TIER_XLA_MIN=None)
    zeros = alltoall.ici_all_to_allv([torch.empty(0)] * NP,
                                     [[0] * NP] * NP)
    assert [z.numel() for z in zeros] == [0] * NP
    assert alltoall.PLAIN_CALLS == {"hbm_alltoall": 1, "hbm_alltoallv": 1}
    # the dispatchers count nothing
    assert mpit.pvar("dev_coll_fallback_size").read() == before
    # one rank: its own payload
    one = alltoall.ici_all_to_allv([torch.arange(5.0)], [[3]])
    assert torch.equal(one[0], torch.arange(3.0))
    assert torch.equal(alltoall.ici_all_to_all([torch.arange(4.0)]),
                       torch.arange(4.0).reshape(1, 4))


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = [torch.empty(16, device="meta") for _ in range(NP)]
    alltoall.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        alltoall.hbm_alltoall(meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        alltoall.hbm_alltoallv(meta, [[2] * NP] * NP)
    assert alltoall.PLAIN_CALLS == {"hbm_alltoall": 0, "hbm_alltoallv": 0}
