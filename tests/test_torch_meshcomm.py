"""Parity of the port's multi-axis ``MeshComm`` (parallel/mesh.py) and
its collectives (ops/collectives.py) with the JAX package's, whose
functions run under shard_map on the 8-device virtual CPU mesh. Both
sides get the same seeded numpy inputs, split over every mesh axis on
dim 0 (rank r holds block r), on the (2, 4) ("x", "y") mesh and the
(2, 2, 2) ("dp", "sp", "tp") mesh of the transformer.

Each comm's JAX collectives run in one shard_map that returns them all
(one compile a comm, built once in a module-scoped cache); each case then
holds one port collective against its output.

Tolerances: bitwise on integer-valued f32 and on int32, where both sides
are exact whatever their order of summation; ``scan`` on normal floats
within rtol 1e-6 / atol 1e-6 (the JAX package takes a masked product
with the gathered axis, the port a cumulative sum in rank order). The
multi-axis ``allreduce`` runs the K4/K5 decomposition (its plain
versions on the CPU) above DEV_TIER_AXES_MIN and one K3 an axis below
it; the JAX ``MeshComm.allreduce`` runs its per-axis phases under
``MV2T_ICI_INTERPRET=1`` (the stock lowering of the interpreter's
``_mesh_mode`` "xla"), so both are compared on integer-valued data."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

from mvapich2_tpu.coll import tuning as jax_tuning
from mvapich2_tpu.ops import collectives as jcoll
from mvapich2_tpu.parallel import MeshComm as JaxMeshComm
from mvapich2_tpu.parallel import make_mesh as jax_make_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import make_mesh
from mvapich2_tpu_torch.ops import collectives as coll
from mvapich2_tpu_torch.ops import ici
from mvapich2_tpu_torch.parallel import MeshComm, P
from mvapich2_tpu_torch.utils.config import get_config

NP = 8
MESHES = {"2x4": ((2, 4), ("x", "y")),
          "2x2x2": ((2, 2, 2), ("dp", "sp", "tp"))}
# (mesh, comm axes): one axis, a sub-tuple (also out of mesh order), all
COMMS = [("2x4", "x"), ("2x4", "y"), ("2x4", ("x", "y")),
         ("2x4", ("y", "x")), ("2x2x2", "sp"), ("2x2x2", ("dp", "sp")),
         ("2x2x2", ("sp", "tp")), ("2x2x2", ("tp", "dp")),
         ("2x2x2", ("dp", "sp", "tp"))]


def _cid(c):
    mesh, axes = c
    return f"{mesh}-{'.'.join(axes) if isinstance(axes, tuple) else axes}"


@pytest.fixture(scope="module")
def meshes():
    return {k: (make_mesh(shape, names, "cpu"),
                jax_make_mesh(shape, names, jax.devices()[:NP]))
            for k, (shape, names) in MESHES.items()}


def _all(mesh_key):
    return MESHES[mesh_key][1]


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", COMMS, ids=_cid)
def test_introspection_matches_jax(meshes, c):
    mesh_key, axes = c
    mine_mesh, ref_mesh = meshes[mesh_key]
    mine, ref = MeshComm(mine_mesh, axes), JaxMeshComm(ref_mesh, axes)
    assert mine.axes == ref.axes and mine.axis == ref.axis
    assert mine.multi_axis == ref.multi_axis
    assert mine.size == ref.size and coll.axis_size(mine) == ref.size
    assert mine.axis_sizes() == ref.axis_sizes()
    for r in range(mine.size):
        assert mine._coords(r) == ref._coords(r)
    sub = mine.sub(_all(mesh_key)[-1])
    assert sub.axes == ref.sub(_all(mesh_key)[-1]).axes
    assert sub.mesh is mine.mesh
    spec = JP(_all(mesh_key))
    want = jax.jit(lambda a: ref.run(
        lambda s: jnp.full((1,), ref.rank(), jnp.int32), a,
        in_specs=(spec,), out_specs=spec))(np.zeros(NP, np.int32))
    got = mine.rank()
    assert got.dtype == torch.int64 and got.shape == (NP,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(coll.axis_rank(mine).numpy(),
                                  np.asarray(want))


def test_comm_rejects_bad_axes(meshes):
    mesh = meshes["2x2x2"][0]
    with pytest.raises(ValueError, match="not in"):
        MeshComm(mesh, ("dp", "pp"))
    with pytest.raises(ValueError, match="bad comm axes"):
        MeshComm(mesh, ("dp", "dp"))
    with pytest.raises(ValueError, match="stacked"):
        MeshComm(mesh, "dp").group(torch.zeros(4, 2))


# ---------------------------------------------------------------------------
# the ops of ops/collectives.py against lax, per comm
# ---------------------------------------------------------------------------

def _ints(seed, shape, lo=-50, hi=50):
    return np.random.default_rng(seed).integers(lo, hi, size=shape) \
        .astype(np.float32)


def _inputs(p):
    """One global input an op, dim 0 split over the 8 ranks; shapes that
    need the group size ``p`` take it."""
    rng = np.random.default_rng(100 + p)
    signed = _ints(1, (NP * 4, 3))
    signed[::5] = -0.0                     # the bcast's -0.0 becomes 0.0
    return {
        "x": _ints(2, (NP * 4, 3)),
        "signed": signed,
        "prod": np.random.default_rng(3).integers(1, 3, (NP * 4, 3))
        .astype(np.int32),
        "i32": np.random.default_rng(4).integers(-2**31, 2**31 - 1,
                                                 (NP * 4, 3), dtype=np.int32),
        "by8": _ints(5, (NP * 8, 3)),
        "byp": _ints(6, (NP * p, 3)),
        "byp1": _ints(7, (NP * 3, p)),
        "wide": _ints(8, (NP * 2, 8)),
        "normal": rng.standard_normal((NP * 4, 3)).astype(np.float32),
    }


# name -> (input, JAX fn(x, axes, p), port fn(x, comm, p)); p: group size
OPS = {
    "sum": ("x", lambda x, a, p: jcoll.allreduce(x, a),
            lambda x, c, p: coll.allreduce(x, c)),
    "max": ("i32", lambda x, a, p: jcoll.allreduce(x, a, "max"),
            lambda x, c, p: coll.allreduce(x, c, "max")),
    "min": ("i32", lambda x, a, p: jcoll.allreduce(x, a, "min"),
            lambda x, c, p: coll.allreduce(x, c, "min")),
    "prod": ("prod", lambda x, a, p: jcoll.allreduce(x, a, "prod"),
             lambda x, c, p: coll.allreduce(x, c, "prod")),
    "mean": ("x", lambda x, a, p: jcoll.allreduce(x, a, "mean"),
             lambda x, c, p: coll.allreduce(x, c, "mean")),
    "reduce_scatter": ("by8", lambda x, a, p: jcoll.reduce_scatter(x, a),
                       lambda x, c, p: coll.reduce_scatter(x, c)),
    "reduce_scatter_dim1": (
        "wide", lambda x, a, p: jcoll.reduce_scatter(x, a, 1),
        lambda x, c, p: coll.reduce_scatter(x, c, 1)),
    "reduce_scatter_untiled": (
        "byp", lambda x, a, p: jcoll.reduce_scatter(x, a, tiled=False),
        lambda x, c, p: coll.reduce_scatter(x, c, tiled=False)),
    "scan": ("x", lambda x, a, p: jcoll.scan_axis(x, a),
             lambda x, c, p: coll.scan_axis(x, c)),
    "scan_float": ("normal", lambda x, a, p: jcoll.scan_axis(x, a),
                   lambda x, c, p: coll.scan_axis(x, c)),
    "all_gather": ("x", lambda x, a, p: jcoll.all_gather(x, a),
                   lambda x, c, p: coll.all_gather(x, c)),
    "all_gather_tiled": (
        "x", lambda x, a, p: jcoll.all_gather(x, a, tiled=True),
        lambda x, c, p: coll.all_gather(x, c, tiled=True)),
    "all_gather_axis1": (
        "x", lambda x, a, p: jcoll.all_gather(x, a, gather_axis=1),
        lambda x, c, p: coll.all_gather(x, c, gather_axis=1)),
    "all_gather_tiled_axis1": (
        "x", lambda x, a, p: jcoll.all_gather(x, a, True, 1),
        lambda x, c, p: coll.all_gather(x, c, True, 1)),
    "bcast": ("signed", lambda x, a, p: jcoll.bcast(x, a, p - 1),
              lambda x, c, p: coll.bcast(x, c, p - 1)),
    "all_to_all": ("by8", lambda x, a, p: jcoll.all_to_all(x, a, 0, 0),
                   lambda x, c, p: coll.all_to_all(x, c, 0, 0)),
    "all_to_all_1_0": ("wide", lambda x, a, p: jcoll.all_to_all(x, a, 1, 0),
                       lambda x, c, p: coll.all_to_all(x, c, 1, 0)),
    "all_to_all_untiled": (
        "byp", lambda x, a, p: jcoll.all_to_all(x, a, 0, 0, tiled=False),
        lambda x, c, p: coll.all_to_all(x, c, 0, 0, tiled=False)),
    "all_to_all_untiled_0_1": (
        "byp", lambda x, a, p: jcoll.all_to_all(x, a, 0, 1, tiled=False),
        lambda x, c, p: coll.all_to_all(x, c, 0, 1, tiled=False)),
    "all_to_all_untiled_1_0": (
        "byp1", lambda x, a, p: jcoll.all_to_all(x, a, 1, 0, tiled=False),
        lambda x, c, p: coll.all_to_all(x, c, 1, 0, tiled=False)),
    "ppermute": ("x", lambda x, a, p: jcoll.ppermute(x, a, [(0, 1), (1, 0)]),
                 lambda x, c, p: coll.ppermute(x, c, [(0, 1), (1, 0)])),
    "ring_shift": ("x", lambda x, a, p: jcoll.ring_shift(x, a, 1),
                   lambda x, c, p: coll.ring_shift(x, c, 1)),
    "ring_shift_back": ("x", lambda x, a, p: jcoll.ring_shift(x, a, -3),
                        lambda x, c, p: coll.ring_shift(x, c, -3)),
    "sendrecv_shift": (   # the pair joined on dim 0 of each shard
        "x", lambda x, a, p: jnp.concatenate(jcoll.sendrecv_shift(x, a)),
        lambda x, c, p: torch.cat(coll.sendrecv_shift(x, c), 1)),
    "halo": ("x", lambda x, a, p: jcoll.halo_exchange(x, a, 1),
             lambda x, c, p: coll.halo_exchange(x, c, 1)),
    "halo_open": ("x", lambda x, a, p: jcoll.halo_exchange(x, a, 1, 0, False),
                  lambda x, c, p: coll.halo_exchange(x, c, 1, 0, False)),
    "halo_dim1": ("x", lambda x, a, p: jcoll.halo_exchange(x, a, 1, 1, False),
                  lambda x, c, p: coll.halo_exchange(x, c, 1, 1, False)),
    "moe_shuffle": ("by8", lambda x, a, p: jcoll.moe_shuffle(x, a),
                    lambda x, c, p: coll.moe_shuffle(x, c)),
}
OP_COMMS = [("2x2x2", "sp"), ("2x2x2", ("dp", "sp")),
            ("2x2x2", ("tp", "dp")), ("2x2x2", ("dp", "sp", "tp")),
            ("2x4", ("x", "y"))]

_REF = {}


def _jax_ops(meshes, c):
    """Every op of OPS over comm ``c`` in one JAX shard_map (cached)."""
    if c in _REF:
        return _REF[c]
    mesh_key, axes = c
    _, ref_mesh = meshes[mesh_key]
    comm = JaxMeshComm(ref_mesh, axes)
    p = comm.size
    data = _inputs(p)
    names = list(OPS)
    spec = JP(_all(mesh_key))

    def body(*shards):
        outs = [OPS[name][1](s, axes, p) for name, s in zip(names, shards)]
        outs.append(jcoll.barrier(axes)[None])
        return tuple(outs)

    args = [data[OPS[n][0]] for n in names]
    got = jax.jit(jax_mesh_shard_map(body, ref_mesh, len(args), spec))(
        *args)
    _REF[c] = (data, {n: np.asarray(g) for n, g in zip(names + ["barrier"],
                                                       got)})
    return _REF[c]


def jax_mesh_shard_map(body, mesh, nargs, spec):
    from mvapich2_tpu.parallel.mesh import shard_map
    return shard_map(body, mesh=mesh, in_specs=(spec,) * nargs,
                     out_specs=spec, check_vma=False)


@pytest.mark.parametrize("c", OP_COMMS, ids=_cid)
@pytest.mark.parametrize("name", list(OPS))
def test_collective_matches_lax(meshes, c, name):
    mesh_key, axes = c
    mine = MeshComm(meshes[mesh_key][0], axes)
    data, want = _jax_ops(meshes, c)
    inp, _, fn = OPS[name]
    x = mine.shard(torch.from_numpy(data[inp]), P(_all(mesh_key)))
    got = mine.unshard(fn(x, mine, mine.size), P(_all(mesh_key)))
    w = want[name]
    assert got.shape == w.shape, (got.shape, w.shape)
    if name == "scan_float":
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6)
    else:
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)
        if name == "bcast":   # bitwise: the root's -0.0 arrives as 0.0
            assert not np.signbit(got.numpy()[got.numpy() == 0]).any()


@pytest.mark.parametrize("c", OP_COMMS, ids=_cid)
def test_barrier_matches_lax(meshes, c):
    mesh_key, axes = c
    mine = MeshComm(meshes[mesh_key][0], axes)
    _, want = _jax_ops(meshes, c)
    got = coll.barrier(mine)
    assert got.shape == (NP,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want["barrier"])


# ---------------------------------------------------------------------------
# the MeshComm methods against the JAX MeshComm's
# ---------------------------------------------------------------------------

@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value)`` sets MV2T_NAME for both packages, with the JAX
    package's measured-profile tables emptied; the teardown restores the
    environment and reloads both configs."""
    monkeypatch.setattr(jax_tuning, "_DEVICE_CROSSOVERS", {})
    monkeypatch.setattr(jax_tuning, "_KERNEL_PARAMS", {})

    def set_env(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(f"MV2T_{k}", str(v))
        jax_config().reload()
        get_config().reload()
    set_env()
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()


# name -> (input, method call on a comm (either package's), p)
METHODS = {
    "bcast": ("x", lambda c, x, p: c.bcast(x, p - 1)),
    "all_gather": ("x", lambda c, x, p: c.all_gather(x)),
    "all_gather_tiled": ("x", lambda c, x, p: c.all_gather(x, tiled=True)),
    "all_gather_axis1": ("x", lambda c, x, p: c.all_gather(
        x, tiled=True, gather_axis=1)),
    "reduce_scatter": ("by8", lambda c, x, p: c.reduce_scatter(x)),
    "all_to_all": ("by8", lambda c, x, p: c.all_to_all(x)),
    "ring_shift": ("x", lambda c, x, p: c.ring_shift(x, 1)),
    "halo_exchange": ("x", lambda c, x, p: c.halo_exchange(x, 1, 0, False)),
    "scan": ("x", lambda c, x, p: c.scan(x)),
}
METHOD_COMMS = [("2x2x2", "sp"), ("2x2x2", ("dp", "sp")),
                ("2x2x2", ("sp", "tp")), ("2x2x2", ("dp", "sp", "tp")),
                ("2x4", ("x", "y")), ("2x4", ("y", "x"))]
_MREF = {}


def _jax_methods(meshes, c):
    if c in _MREF:
        return _MREF[c]
    mesh_key, axes = c
    comm = JaxMeshComm(meshes[mesh_key][1], axes)
    data = _inputs(comm.size)
    names = list(METHODS)
    spec = JP(_all(mesh_key))

    def body(*shards):
        outs = [METHODS[n][1](comm, s, comm.size)
                for n, s in zip(names, shards)]
        return tuple(outs) + (comm.barrier()[None],)

    got = jax.jit(jax_mesh_shard_map(body, meshes[mesh_key][1], len(names),
                                     spec))(
        *[data[METHODS[n][0]] for n in names])
    _MREF[c] = (data, {n: np.asarray(g) for n, g in
                       zip(names + ["barrier"], got)})
    return _MREF[c]


@pytest.mark.parametrize("c", METHOD_COMMS, ids=_cid)
@pytest.mark.parametrize("name", list(METHODS) + ["barrier"])
def test_method_matches_jax(meshes, c, name):
    mesh_key, axes = c
    mine = MeshComm(meshes[mesh_key][0], axes)
    data, want = _jax_methods(meshes, c)
    spec = P(_all(mesh_key))
    if name == "barrier":
        got = mine.barrier()[:, None]      # one 0.0 a rank, as [1] shards
    else:
        inp, call = METHODS[name]
        got = call(mine, mine.shard(torch.from_numpy(data[inp]), spec),
                   mine.size)
    got = mine.unshard(got, spec)
    np.testing.assert_array_equal(got.numpy(), want[name])


@pytest.mark.parametrize("c", METHOD_COMMS + [("2x4", "y")], ids=_cid)
@pytest.mark.parametrize("n,above", [(1030, True), (250, False)],
                         ids=["above_edge", "below_edge"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_allreduce_matches_jax(meshes, env, c, n, above, op):
    """A multi-axis comm's allreduce is ops/ici.py's decomposition: above
    DEV_TIER_AXES_MIN (4096 bytes) K4 then K5 a live axis, below it one
    K3 a live axis (their plain versions here), held bitwise against the
    JAX ``MeshComm.allreduce`` (pallas_ici.ici_all_reduce_mesh, its
    phases on the stock lowering under MV2T_ICI_INTERPRET=1); a one-axis
    comm's is the stock group reduction, as the JAX package's psum."""
    env(ICI_INTERPRET=1)
    mesh_key, axes = c
    mine_mesh, ref_mesh = meshes[mesh_key]
    mine, ref = MeshComm(mine_mesh, axes), JaxMeshComm(ref_mesh, axes)
    x = (_ints(n, (NP, n)) if op == "sum" else
         np.random.default_rng(n).integers(-2**31, 2**31 - 1, (NP, n),
                                           dtype=np.int32))
    spec = JP(_all(mesh_key))
    want = np.asarray(jax.jit(lambda a: ref.run(
        lambda s: ref.allreduce(s[0], op)[None], a, in_specs=(spec,),
        out_specs=spec))(x))
    ici.reset_counts()
    got = mine.allreduce(mine.shard(torch.from_numpy(x), P(_all(mesh_key))),
                         op)
    assert got.shape == (NP, 1, n) and got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.reshape(NP, n).numpy(), want)
    # each group's reduction, from numpy
    grouped = mine.group(torch.from_numpy(x)).numpy()
    red = grouped.sum(1) if op == "sum" else grouped.max(1)
    np.testing.assert_array_equal(
        mine.group(got.reshape(NP, n)).numpy(),
        np.broadcast_to(red[:, None], grouped.shape))
    live = sum(s > 1 for _, s in mine.axis_sizes())
    calls = (ici.PLAIN_CALLS["hbm_ring_reduce_scatter"],
             ici.PLAIN_CALLS["hbm_ring_all_gather"],
             ici.PLAIN_CALLS["hbm_ring_all_reduce"])
    if not mine.multi_axis:
        assert calls == (0, 0, 0)
    elif above:
        assert calls == (live, live, 0)
    else:
        assert calls == (0, 0, live)


def test_allreduce_shapes_and_edge(meshes, env):
    """A shard of any shape reduces as its flat payload (padded to the
    reduced extent above the edge); DEV_TIER_AXES_MIN=-1 always
    decomposes; a result owns its memory."""
    mine = MeshComm(meshes["2x2x2"][0], ("dp", "tp"))
    x = torch.from_numpy(_ints(11, (NP, 7, 151)))       # 4228 bytes a rank
    want = mine.sub("dp").allreduce(mine.sub("tp").allreduce(x))
    for edge, rs in (("4096", 2), ("8192", 0), ("-1", 2)):
        env(DEV_TIER_AXES_MIN=edge)
        ici.reset_counts()
        got = mine.allreduce(x)
        assert ici.PLAIN_CALLS["hbm_ring_reduce_scatter"] == rs
        assert torch.equal(got, want)
    assert got.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="not axes of"):
        ici.ici_all_reduce_mesh(list(x.reshape(NP, -1)),
                                (("dp", 2), ("sp", 2), ("tp", 2)),
                                over=("dp", "pp"))


# ---------------------------------------------------------------------------
# run with specs
# ---------------------------------------------------------------------------

# (global shape, in spec, out spec): the function adds every rank's rank
# over all three axes, so an output under P() shows whose copy it is
RUN_SPECS = [
    ((4, 6), P(), P()),
    ((4, 6), P("dp", "sp"), P("dp", "sp")),
    ((4, 8), P(None, "tp"), P(None, "tp")),
    ((4, 3, 2), P("dp", None, None), P("dp", None, None)),
    ((4, 6), P("dp", "sp"), P()),
    ((4, 8), P(None, "tp"), P("tp")),
    ((8, 2), P(("dp", "sp", "tp")), P(("tp", "sp", "dp"))),
]


@pytest.mark.parametrize("shape,ins,outs", RUN_SPECS,
                         ids=lambda v: repr(v).replace(" ", ""))
def test_run_specs_match_shard_map(meshes, shape, ins, outs):
    mine_mesh, ref_mesh = meshes["2x2x2"]
    axes = _all("2x2x2")
    mine, ref = MeshComm(mine_mesh, axes), JaxMeshComm(ref_mesh, axes)
    x = _ints(len(ins) + sum(shape), shape)
    want = jax.jit(lambda a: ref.run(
        lambda s: s * 10 + ref.rank().astype(s.dtype), a,
        in_specs=(JP(*ins),), out_specs=JP(*outs)))(x)
    seen = []

    def fn(s):
        seen.append(tuple(s.shape))
        r = coll.axis_rank(mine).to(s.dtype)
        return s * 10 + r.reshape((-1,) + (1,) * (s.dim() - 1))
    got = mine.run(fn, torch.from_numpy(x), in_specs=(ins,), out_specs=outs)
    assert seen == [tuple(mine.shard(torch.from_numpy(x), ins).shape)]
    assert seen[0][0] == NP
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if outs == P() and ins == P():
        # check_vma=False: the first device's copy (rank 0 adds 0)
        np.testing.assert_array_equal(got.numpy(), x * 10)


def test_run_spec_trees_and_defaults(meshes):
    """Spec trees (a dict of specs, as the transformer's parameters take)
    map over matching trees; the defaults are P(axis) in and out; shard
    and unshard are inverse."""
    mine_mesh, ref_mesh = meshes["2x2x2"]
    mine = MeshComm(mine_mesh, ("dp", "sp", "tp"))
    ref = JaxMeshComm(ref_mesh, ("dp", "sp", "tp"))
    tree = {"a": _ints(21, (4, 8)), "b": _ints(22, (6,))}
    specs = {"a": P(None, "tp"), "b": P()}
    jspecs = {"a": JP(None, "tp"), "b": JP()}
    want = ref.run(lambda t: {"a": t["a"] + 1, "b": t["b"] * 2}, tree,
                   in_specs=(jspecs,), out_specs=jspecs)
    got = mine.run(lambda t: {"a": t["a"] + 1, "b": t["b"] * 2},
                   {k: torch.from_numpy(v) for k, v in tree.items()},
                   in_specs=(specs,), out_specs=specs)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    x = _ints(23, (16, 3))
    want = ref.run(lambda s: s - 1, x)
    got = mine.run(lambda s: s - 1, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for spec in (P(), P("dp"), P(None, ("sp", "tp")), P("tp", "dp")):
        t = torch.from_numpy(_ints(24, (4, 8)))
        assert torch.equal(mine.unshard(mine.shard(t, spec), spec), t)
    with pytest.raises(ValueError, match="does not split"):
        mine.shard(torch.zeros(3, 8), P("dp", "sp"))
