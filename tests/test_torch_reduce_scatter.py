"""Parity of the port's reduce-scatter and exchange kernels and the
multi-axis composition (mvapich2_tpu_torch/ops/ici.py: K4
hbm_ring_reduce_scatter, K8 remote_sendrecv, the ``lines`` form of K3,
K4 and K5, ici_reduce_scatter and ici_*_mesh; plain route on the CPU)
with the JAX package's ops/pallas_ici.py. The JAX kernels run in Pallas
interpret mode with ``credits=False`` on the 8-device virtual CPU mesh,
as in tests/test_torch_ici.py; the JAX mesh functions run under
shard_map on 2-D CPU meshes, where the interpreter sends every per-axis
phase to the stock lowering (``_mesh_mode`` "xla"), so they are compared
on integer-valued data.

Tolerances: bitwise everywhere. The plain versions replay the kernels'
ring schedule, so K4 folds in the JAX kernel's order on any data.

Every MV2T_* change is restored, and both packages' configs reloaded,
in the ``env`` fixture's teardown; the JAX package's measured-profile
tables are swapped for empty ones while a test runs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mvapich2_tpu.coll import tuning as jax_tuning
from mvapich2_tpu.ops import pallas_ici
from mvapich2_tpu.parallel import MeshComm
from mvapich2_tpu.parallel import mesh as jax_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import make_mesh, run_ranks
from mvapich2_tpu_torch.ops import ici
from mvapich2_tpu_torch.parallel import mesh
from mvapich2_tpu_torch.utils.config import get_config

NP = 8


@pytest.fixture(scope="module")
def comm8():
    return MeshComm(jax_mesh.make_mesh((NP,), ("x",)))


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages; the
    teardown restores the environment and reloads both configs."""
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
        return rng.integers(1, 3, size=shape).astype(np.int32)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "intf32":
        return rng.integers(-1000, 1000, size=shape).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# K4 and K8 against the JAX kernels
# ---------------------------------------------------------------------------

# n = 1024: blocks of 128 divide exactly; 1025: an identity-padded tail;
# chunk_bytes 128 and 256: chunks of 32 and 64 elements, smaller than the
# block (a short last chunk at 1025)
@pytest.mark.parametrize("n,kind,op,chunk_bytes,depth,bidir", [
    (1024, "normal", "sum", None, 2, True),
    (1025, "normal", "sum", 256, 3, False),
    (1024, "int32", "max", 128, 2, True),
    (1025, "int32", "min", 256, 3, True),
    (1024, "int32", "prod", None, 2, False),
    (1025, "int32", "sum", 128, 2, True),
])
def test_reduce_scatter_matches_jax_kernel(comm8, n, kind, op, chunk_bytes,
                                           depth, bidir):
    xv = _data(n + depth, (NP, n), kind, op)
    want = comm8.run(lambda s: pallas_ici.hbm_ring_reduce_scatter(
        s, "x", NP, op=op, chunk_bytes=chunk_bytes, depth=depth,
        bidirectional=bidir, interpret=True, credits=False),
        jnp.asarray(xv.reshape(-1)))
    want = np.asarray(want).reshape(NP, -1)
    ici.reset_counts()
    got = ici.hbm_ring_reduce_scatter(torch.from_numpy(xv), op,
                                      chunk_bytes=chunk_bytes, depth=depth,
                                      bidirectional=bidir)
    assert ici.PLAIN_CALLS["hbm_ring_reduce_scatter"] == 1
    assert ici.LAUNCHES["hbm_ring_reduce_scatter"] == 0
    assert got.shape == (NP, -(-n // NP))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,dst", [(2, 5), (0, 7), (3, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_sendrecv_matches_jax_kernel(comm8, src, dst, dtype):
    xv = (np.arange(NP * 4) * 7 - 50).astype(dtype)
    out = comm8.run(lambda s: pallas_ici.remote_sendrecv(
        s, "x", NP, src=src, dst=dst, interpret=True), jnp.asarray(xv),
        out_specs=P("x"))
    want = np.asarray(out).reshape(NP, 4)
    exp = xv.reshape(NP, 4).copy()
    exp[[src, dst]] = exp[[dst, src]]
    np.testing.assert_array_equal(want, exp)
    x = torch.from_numpy(xv.reshape(NP, 4))
    ici.reset_counts()
    got = ici.remote_sendrecv(x, src, dst)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ici.PLAIN_CALLS["remote_sendrecv"] == int(src != dst)
    if src != dst:
        assert got.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(
        ici.remote_sendrecv([r.clone() for r in x], src, dst).numpy(), want)


def test_sendrecv_rejects_a_bad_rank():
    with pytest.raises(ValueError, match="outside"):
        ici.remote_sendrecv(torch.zeros(NP, 4), 2, NP)


# ---------------------------------------------------------------------------
# the lines form: one ring per line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lines", [1, 2, 4])
@pytest.mark.parametrize("kernel", ["K3", "K4", "K5"])
def test_lines_form_is_the_1d_version_per_line(kernel, lines):
    x = torch.from_numpy(_data(lines, (NP, 1001), "normal"))
    p = NP // lines
    fn = {"K3": ici.hbm_ring_all_reduce_ref,
          "K4": ici.hbm_ring_reduce_scatter_ref,
          "K5": ici.hbm_ring_all_gather_ref}[kernel]
    name = {"K3": "hbm_ring_all_reduce", "K4": "hbm_ring_reduce_scatter",
            "K5": "hbm_ring_all_gather"}[kernel]
    want = torch.cat([fn(x[g * p:(g + 1) * p]) for g in range(lines)])
    assert torch.equal(fn(x, lines=lines), want)
    ici.reset_counts()
    wrapper = getattr(ici, name)
    assert torch.equal(wrapper(list(x.unbind(0)), lines=lines), want)
    assert ici.PLAIN_CALLS[name] == 1
    with pytest.raises(ValueError, match="lines"):
        wrapper(x, lines=3)


# ---------------------------------------------------------------------------
# the multi-axis composition against the JAX functions
# ---------------------------------------------------------------------------

def _jax_mesh_call(shape, fn, xv):
    """``fn(shard, axes)`` under shard_map on the 2-D CPU mesh of
    ``shape`` over axes ("x", "y"), ranks row-major; returns the per-rank
    rows."""
    m = jax_mesh.make_mesh(shape, ("x", "y"), jax.devices()[:xv.shape[0]])
    axes = tuple(zip(("x", "y"), shape))
    sm = jax_mesh.shard_map(lambda s: fn(s, axes), mesh=m,
                            in_specs=(P(("x", "y")),),
                            out_specs=P(("x", "y")), check_vma=False)
    return np.asarray(jax.jit(sm)(jnp.asarray(xv.reshape(-1)))) \
        .reshape(xv.shape[0], -1)


# (shape, element count, DEV_TIER_AXES_MIN side) -> the port's plain calls
# of K3/K4/K5 per allreduce: above the edge RS/AG a live axis each, below
# it one full allreduce a live axis; the (1, 8) mesh has one live axis
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2), (1, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("n,above", [(1030, True), (250, False)])
def test_mesh_functions_match_jax(env, shape, n, above):
    ptot = shape[0] * shape[1]
    live = sum(s > 1 for s in shape)
    axes = tuple(zip(("x", "y"), shape))
    xv = _data(ptot + n, (ptot, n), "intf32")
    mx = _data(ptot + n + 1, (ptot, n), "int32")
    rs = _data(ptot + n + 2, (ptot, ptot * 16), "int32")

    def run(fn, x):
        return _jax_mesh_call(shape, fn, x)
    jax_ar = run(lambda s, a: pallas_ici.ici_all_reduce_mesh(
        s, a, interpret=True), xv)
    jax_mx = run(lambda s, a: pallas_ici.ici_all_reduce_mesh(
        s, a, op="max", interpret=True), mx)
    jax_ag = run(lambda s, a: pallas_ici.ici_all_gather_mesh(
        s, a, interpret=True), xv)
    jax_rs = run(lambda s, a: pallas_ici.ici_reduce_scatter_mesh(
        s, a, interpret=True), rs)

    ici.reset_counts()
    ar = ici.ici_all_reduce_mesh(torch.from_numpy(xv), axes)
    ar_calls = dict(ici.PLAIN_CALLS)
    mxr = ici.ici_all_reduce_mesh(torch.from_numpy(mx), axes, "max")
    ici.reset_counts()
    ag = ici.ici_all_gather_mesh(torch.from_numpy(xv), axes)
    assert ici.PLAIN_CALLS["hbm_ring_all_gather"] == live
    ici.reset_counts()
    rsr = ici.ici_reduce_scatter_mesh(torch.from_numpy(rs), axes)
    assert ici.PLAIN_CALLS["hbm_ring_reduce_scatter"] == live
    decompose = above and live > 1
    assert (ar_calls["hbm_ring_reduce_scatter"],
            ar_calls["hbm_ring_all_gather"],
            ar_calls["hbm_ring_all_reduce"]) == \
        ((live, live, 0) if decompose else (0, 0, live))
    for got, want in ((ar, jax_ar), (mxr, jax_mx), (ag, jax_ag),
                      (rsr, jax_rs)):
        assert len(got) == ptot
        np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    np.testing.assert_array_equal(jax_ar[0], xv.sum(0))


@pytest.mark.parametrize("naxes", [1, 2, 3])
def test_mesh_shape_for_matches_jax(naxes):
    for n in range(1, 65):
        assert mesh.mesh_shape_for(n, naxes) == \
            jax_mesh.mesh_shape_for(n, naxes)
    m = make_mesh(None, ("x", "y", "z")[:naxes], "cpu")
    assert tuple(m.shape.values()) == jax_mesh.mesh_shape_for(8, naxes)
    assert m.size == 8


@pytest.mark.parametrize("value,want", [(None, 4096), ("8K", 8192),
                                        ("-1", -1), ("0", 0)])
def test_axes_min_env_matches_jax(env, value, want):
    env(DEV_TIER_AXES_MIN=value)
    assert ici._mesh_axes_min() == pallas_ici._mesh_axes_min() == want
    get_config().set("DEV_TIER_AXES_MIN", 12)
    assert ici._mesh_axes_min() == 12


def test_axes_min_edge_decides_the_decomposition(env):
    """At the edge the call decomposes; one byte under, it runs a full
    allreduce an axis; -1 always decomposes."""
    axes = (("x", 2), ("y", 4))
    x = torch.from_numpy(_data(5, (NP, 1024), "int32"))   # 4096 bytes
    for edge, decomposed in (("4096", True), ("4097", False), ("-1", True)):
        env(DEV_TIER_AXES_MIN=edge)
        ici.reset_counts()
        got = ici.ici_all_reduce_mesh(x, axes)
        assert (ici.PLAIN_CALLS["hbm_ring_reduce_scatter"] == 2) is \
            decomposed
        for row in got:
            assert torch.equal(row, x.sum(0, dtype=torch.int32))


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2, 4), ("x", "y"), "cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(NP, lambda c: None, device="cuda:0")
    meta = [torch.empty(16, device="meta") for _ in range(NP)]
    ici.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ici.hbm_ring_reduce_scatter(meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ici.hbm_ring_reduce_scatter(meta, lines=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ici.remote_sendrecv(meta, 1, 2)
    assert not any(ici.PLAIN_CALLS.values())
