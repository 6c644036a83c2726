"""Parity of the port's model layer (models/stencil.py,
parallel/pipeline.py, models/transformer.py, ring_attention over a
sub-axis with batch dims, and carry.py's parameter crossing) with the
JAX package's, which runs under shard_map on the 8-device virtual CPU
mesh. Both sides get the same seeded numpy inputs; the transformer runs
on the JAX ``init_params`` carried across (``carry.params_from_numpy``).

Each JAX reference is built once, in a module-scoped fixture: two JAX
train steps ((2, 2, 2) with the MoE layer, (1, 2, 2)) and one JAX
forward, at vocab 32, d_model 32, 4 heads, 2 layers, d_ff 64, seq 32,
batch 4, 4 experts. The JAX package's own train-step tests are marked
slow (tests/test_models.py); their torch-only forms here (it learns, the
parallel step matches one device, the MoE layer is finite) run the port
alone.

Tolerances (f32): the train step's loss within rtol 1e-5 and every new
parameter within rtol 1e-4 / atol 1e-5 of the JAX step's (the local
products and XLA's psum order their f32 sums differently); the forward's
logits within rtol 1e-4 / atol 1e-5; the stencil within rtol 1e-6 /
atol 1e-7 (XLA may contract its update into fused multiply-adds);
the pipeline's affine stages and attention within rtol 2e-4 / atol
2e-5, as the JAX attention tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from mvapich2_tpu.models import ring_attention as jra
from mvapich2_tpu.models import stencil as jst
from mvapich2_tpu.models import transformer as jtf
from mvapich2_tpu.parallel import MeshComm as JaxMeshComm
from mvapich2_tpu.parallel import make_mesh as jax_make_mesh
from mvapich2_tpu.parallel.mesh import shard_map
from mvapich2_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from mvapich2_tpu_torch import carry, make_mesh
from mvapich2_tpu_torch.models import ring_attention as ra
from mvapich2_tpu_torch.models import stencil as st
from mvapich2_tpu_torch.models import transformer as tf
from mvapich2_tpu_torch.ops import collectives as coll
from mvapich2_tpu_torch.parallel import MeshComm, P
from mvapich2_tpu_torch.parallel.pipeline import pipeline_apply

NP = 8
SMALL = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             seq_len=32, batch=4, n_experts=4)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the stencil
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zcomms():
    return (MeshComm(make_mesh((NP,), ("z",), "cpu")),
            JaxMeshComm(jax_make_mesh((NP,), ("z",), jax.devices()[:NP])))


@pytest.mark.parametrize("grid", [16, 32])
@pytest.mark.parametrize("periodic", [True, False])
def test_stencil_matches_jax(zcomms, grid, periodic):
    mine, ref = zcomms
    iters = 3
    want = np.asarray(jax.jit(lambda: jst.run_stencil(ref, grid, iters,
                                                      periodic))())
    got = st.run_stencil(mine, grid, iters, periodic)
    assert got.shape == (grid,) * 3 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    u0 = st.initial_grid(grid, "cpu")
    jax_u0 = jnp.arange(grid ** 3, dtype=jnp.float32).reshape(
        grid, grid, grid)
    np.testing.assert_array_equal(u0.numpy(), np.asarray((jax_u0 % 97)
                                                         / 97.0))
    ref_jax = np.asarray(jax.jit(lambda u: jst.reference_stencil(
        u, iters, periodic))(jnp.asarray(u0.numpy())))
    ref_mine = st.reference_stencil(u0, iters, periodic)
    np.testing.assert_allclose(ref_mine.numpy(), ref_jax, rtol=1e-6,
                               atol=1e-7)
    # the split run is the single-device reference (the JAX test's check)
    np.testing.assert_allclose(got.numpy(), ref_mine.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_stencil_initial_grid_rounds_as_f32_arange():
    """Past 2^24 elements the JAX f32 arange rounds the index; the
    port's start rounds it the same way."""
    idx = torch.tensor([2 ** 24 + 1, 2 ** 24 + 3, 2 ** 26 + 5])
    want = np.float32(np.asarray(idx.numpy(), np.float32) % np.float32(97))
    got = torch.fmod(idx.to(torch.float32), 97.0)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not split"):
        st.run_stencil(MeshComm(make_mesh((3,), ("z",), "cpu")), 16, 1)
    if not torch.cuda.is_available():     # None is cuda:0, as make_mesh's
        with pytest.raises(RuntimeError, match="no CUDA device"):
            st.initial_grid(16)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _pipeline_inputs(n):
    D, n_micro = 16, 2 * n
    ws = np.stack([np.eye(D, dtype=np.float32) * np.float32(1.0 + 0.01 * i)
                   for i in range(n)])
    rng = np.random.default_rng(2)
    micro = rng.standard_normal((n_micro, 4, D)).astype(np.float32)
    return ws, micro


def test_pipeline_matches_jax():
    """The graft entry's pipeline demo: affine stages over 8 ranks, the
    outputs summed over the stages (only the last holds them)."""
    ws, micro = _pipeline_inputs(NP)
    jcomm = JaxMeshComm(jax_make_mesh((NP,), ("pp",), jax.devices()[:NP]),
                        "pp")

    def jrun(ws_local, micro_all):
        outs = jax_pipeline(lambda w, x: x @ w[0], ws_local, micro_all, "pp")
        return jax.lax.psum(outs, "pp")
    want = np.asarray(jcomm.run(jrun, ws, micro, in_specs=(JP("pp"), JP()),
                                out_specs=JP()))
    comm = MeshComm(make_mesh((NP,), ("pp",), "cpu"))
    got_last = []

    def run(ws_st, micro_st):
        outs = pipeline_apply(lambda w, x: x @ w[:, 0], ws_st, micro_st,
                              comm)
        got_last.append(outs)
        return coll.allreduce(outs, comm)
    got = comm.run(run, torch.from_numpy(ws), torch.from_numpy(micro),
                   in_specs=(P("pp"), P()), out_specs=P())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    scale = np.prod([1.0 + 0.01 * i for i in range(NP)], dtype=np.float32)
    np.testing.assert_allclose(got.numpy(), micro * scale, rtol=1e-5,
                               atol=1e-6)
    # only the last stage holds outputs
    assert torch.count_nonzero(got_last[0][:-1]) == 0


def test_pipeline_over_a_sub_axis():
    """Over "y" of a (2, 4) mesh each x-row is a pipeline of its own."""
    ws, micro = _pipeline_inputs(4)
    mesh = make_mesh((2, 4), ("x", "y"), "cpu")
    comm = MeshComm(mesh, "y")
    ws2 = np.concatenate([ws, ws * 2])               # x-row 1 doubles
    got = MeshComm(mesh, ("x", "y")).run(
        lambda w, m: pipeline_apply(lambda a, b: b @ a[:, 0], w, m, comm),
        torch.from_numpy(ws2), torch.from_numpy(micro),
        in_specs=(P(("x", "y")), P()), out_specs=P(("x", "y")))
    got = got.reshape(2, 4, *micro.shape)
    scale = np.prod([1.0 + 0.01 * i for i in range(4)], dtype=np.float32)
    np.testing.assert_allclose(got[0, 3].numpy(), micro * scale, rtol=1e-5)
    np.testing.assert_allclose(got[1, 3].numpy(), micro * scale * 16,
                               rtol=1e-5)
    assert torch.count_nonzero(got[:, :3]) == 0


# ---------------------------------------------------------------------------
# ring attention over the sp sub-axis of a 3-D mesh, with a batch dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_sub_axis_batched_matches_jax(causal):
    shape, names = (2, 2, 2), ("dp", "sp", "tp")
    rng = np.random.default_rng(50)
    q, k, v = (rng.standard_normal((4, 32, 4, 8)).astype(np.float32)
               for _ in range(3))
    spec = ("dp", "sp", "tp")
    jmesh = jax_make_mesh(shape, names, jax.devices()[:NP])
    jfn = shard_map(
        lambda a, b, c: jax.vmap(lambda x, y, z: jra.ring_attention(
            x, y, z, "sp", causal=causal))(a, b, c),
        mesh=jmesh, in_specs=(JP("dp", "sp", "tp"),) * 3,
        out_specs=JP("dp", "sp", "tp"), check_vma=False)
    want = np.asarray(jax.jit(jfn)(q, k, v))
    mesh = make_mesh(shape, names, "cpu")
    comm = MeshComm(mesh, spec)
    got = comm.run(lambda a, b, c: ra.ring_attention(
        a, b, c, MeshComm(mesh, "sp"), causal=causal),
        *(torch.from_numpy(a) for a in (q, k, v)),
        in_specs=(P("dp", "sp", "tp"),) * 3, out_specs=P("dp", "sp", "tp"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_ring_attention_flash_takes_the_whole_mesh():
    """The flash form slices the stacked ranks by comm rank: a comm over
    part of a mesh raises instead of mixing groups."""
    mesh = make_mesh((2, 4), ("x", "y"), "cpu")
    q = torch.zeros(NP, 16, 2, 16)
    with pytest.raises(NotImplementedError, match="whole mesh"):
        ra.ring_attention_flash(q, q, q, MeshComm(mesh, "y"))


# ---------------------------------------------------------------------------
# the gradient scale of the stacked layout
# ---------------------------------------------------------------------------

def test_group_sum_backward_matches_check_vma_false():
    """``pmean_a(sum(psum_b(w * x)))`` on a (2, 4) mesh: under shard_map
    with check_vma=False the JAX gradient is 4 on every rank (the
    transpose of psum is psum), and the stacked program's backward of
    ``loss.sum()`` gives the same."""
    jmesh = jax_make_mesh((2, 4), ("a", "b"), jax.devices()[:NP])

    def jloss(w, x):
        return jax.lax.pmean(jnp.sum(jax.lax.psum(w * x, "b")), "a")

    jfn = shard_map(lambda w, x: jax.grad(jloss)(w[0], x[0])[None],
                    mesh=jmesh, in_specs=(JP(("a", "b")),) * 2,
                    out_specs=JP(("a", "b")), check_vma=False)
    w = np.ones((NP, 3), np.float32)
    want = np.asarray(jax.jit(jfn)(w, w))
    mesh = make_mesh((2, 4), ("a", "b"), "cpu")
    wt = torch.ones((NP, 3), requires_grad=True)
    part = coll.allreduce(wt * torch.ones(NP, 3), MeshComm(mesh, "b"))
    loss = coll.allreduce(part.sum(-1), MeshComm(mesh, "a"), "mean")
    loss.sum().backward()
    np.testing.assert_array_equal(want, np.full((NP, 3), 4.0, np.float32))
    np.testing.assert_array_equal(wt.grad.numpy(), want)


# ---------------------------------------------------------------------------
# the transformer against the JAX package
# ---------------------------------------------------------------------------

def _jax_case(shape, moe_layer=1, forward=False):
    """The JAX step (and forward) at SMALL on ``shape``, from its own
    init_params and tokens; returns numpy params, tokens, the step's
    loss and new params, and the logits."""
    cfg = jtf.Config(**SMALL, moe_layer=moe_layer)
    n = int(np.prod(shape))
    mesh = jax_make_mesh(shape, ("dp", "sp", "tp"), jax.devices()[:n])
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (cfg.batch, cfg.seq_len), 0, cfg.vocab,
                                jnp.int32)
    sp = jtf.shard_params(params, cfg, mesh)
    st_ = jax.device_put(tokens, NamedSharding(mesh, JP("dp", "sp")))
    out = {"params": {k: np.array(v) for k, v in params.items()},
           "tokens": np.array(tokens)}
    if forward:
        fwd = shard_map(lambda pp, tt: jtf.forward(pp, tt, cfg), mesh=mesh,
                        in_specs=(jtf.param_specs(cfg), JP("dp", "sp")),
                        out_specs=JP("dp", "sp"), check_vma=False)
        out["logits"] = np.asarray(jax.jit(fwd)(sp, st_))
    new, loss = jtf.make_train_step(cfg, mesh)(sp, st_)
    out["loss"] = float(loss)
    out["new"] = {k: np.asarray(v) for k, v in new.items()}
    return out


@pytest.fixture(scope="module")
def jax_moe_222():
    return _jax_case((2, 2, 2), forward=True)


@pytest.fixture(scope="module")
def jax_moe_122():
    return _jax_case((1, 2, 2))


def _port_step(ref, shape, moe_layer=1):
    cfg = tf.Config(**SMALL, moe_layer=moe_layer)
    mesh = make_mesh(shape, tf.AXES, "cpu")
    params = carry.params_from_numpy(ref["params"], cfg, mesh)
    tokens = tf.shard_tokens(torch.from_numpy(ref["tokens"]), mesh)
    new, loss = tf.make_train_step(cfg, mesh)(params, tokens)
    return cfg, mesh, params, tokens, new, loss


@pytest.mark.parametrize("case", ["moe_222", "moe_122"])
def test_train_step_matches_jax(case, request):
    ref = request.getfixturevalue(f"jax_{case}")
    shape = (2, 2, 2) if case == "moe_222" else (1, 2, 2)
    cfg, mesh, _, _, new, loss = _port_step(ref, shape)
    assert loss.shape == () and torch.isfinite(loss)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    got = carry.params_to_numpy(new, cfg, mesh)
    assert set(got) == set(ref["new"])
    for k, want in ref["new"].items():
        assert got[k].shape == want.shape, k
        np.testing.assert_allclose(got[k], want, err_msg=k, **STEP_TOL)
        # the update itself, not only the unchanged bulk of the weights
        moved = np.abs(want - ref["params"][k]).max()
        np.testing.assert_allclose(got[k] - ref["params"][k],
                                   want - ref["params"][k],
                                   rtol=0, atol=max(moved * 2e-2, 1e-9),
                                   err_msg=k)


def test_forward_and_loss_match_jax(jax_moe_222):
    ref = jax_moe_222
    cfg = tf.Config(**SMALL)
    mesh = make_mesh((2, 2, 2), tf.AXES, "cpu")
    params = carry.params_from_numpy(ref["params"], cfg, mesh)
    tokens = tf.shard_tokens(torch.from_numpy(ref["tokens"]), mesh)
    logits = tf.forward(params, tokens, cfg, mesh)
    assert logits.shape == (NP, 2, 16, cfg.vocab)
    got = MeshComm(mesh, tf.AXES).unshard(logits, P("dp", "sp"))
    np.testing.assert_allclose(got.numpy(), ref["logits"], **STEP_TOL)
    loss = tf.loss_fn(params, tokens, cfg, mesh)
    assert loss.shape == (NP,)
    # every rank's copy is the dp x sp mean: the same value everywhere
    assert torch.equal(loss, loss[:1].expand(NP))
    np.testing.assert_allclose(float(loss[0]), ref["loss"], rtol=1e-5)


def test_carry_round_trip_and_specs(jax_moe_222):
    ref = jax_moe_222
    cfg = tf.Config(**SMALL)
    jcfg = jtf.Config(**SMALL)
    assert {k: tuple(v) for k, v in tf.param_specs(cfg).items()} == \
        {k: tuple(v) for k, v in jtf.param_specs(jcfg).items()}
    for shape in ((2, 2, 2), (1, 2, 2), (1, 1, 1)):
        mesh = make_mesh(shape, tf.AXES, "cpu")
        stacked = carry.params_from_numpy(ref["params"], cfg, mesh)
        for k, v in stacked.items():
            assert v.shape[0] == mesh.size and v.is_contiguous()
        back = carry.params_to_numpy(stacked, cfg, mesh)
        for k, v in ref["params"].items():
            np.testing.assert_array_equal(back[k], v)
    mesh = make_mesh((2, 2, 2), tf.AXES, "cpu")
    stacked = carry.params_from_numpy(ref["params"], cfg, mesh)
    assert stacked["layer_0/wq"].shape == (NP, 32, 16)      # P(None, tp)
    assert stacked["layer_1/w1"].shape == (NP, 2, 32, 64)   # P(dp, ...)
    # rank (dp=1, sp=0, tp=1) = 5 holds the wq columns 16:32, experts 2:4
    np.testing.assert_array_equal(stacked["layer_0/wq"][5].numpy(),
                                  ref["params"]["layer_0/wq"][:, 16:])
    np.testing.assert_array_equal(stacked["layer_1/w1"][5].numpy(),
                                  ref["params"]["layer_1/w1"][2:])


def test_init_params_and_demo_setup_match_jax_shapes():
    cfg = tf.Config(**SMALL)
    jparams = jtf.init_params(jtf.Config(**SMALL), jax.random.PRNGKey(0))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert params["emb"].dtype == torch.float32
    std = float(torch.cat([params[k].reshape(-1) for k in params
                           if "ln" not in k]).std())
    assert 0.018 < std < 0.022
    if not torch.cuda.is_available():     # None is cuda:0, as make_mesh's
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tf.init_params(cfg, torch.Generator().manual_seed(0))
    for n in (1, 2, 4, 8):
        _, jmesh, *_ = jtf.demo_setup(jtf.Config(**SMALL),
                                      devices=jax.devices()[:n])
        assert tf.default_mesh_shape(n) == tuple(jmesh.shape.values())
    assert tf.default_mesh_shape(6) == (1,) + jtf.mesh_shape_for(6, 2)
    cfg2, mesh, params, tokens, step = tf.demo_setup(cfg, device="cpu")
    assert tuple(mesh.shape.values()) == (2, 2, 2) and cfg2 is cfg
    assert tokens.shape == (NP, 2, 16) and tokens.dtype == torch.int32


# ---------------------------------------------------------------------------
# the torch-only forms of the JAX package's slow train-step tests
# ---------------------------------------------------------------------------

def test_train_step_runs_and_learns():
    cfg = tf.Config(**SMALL, lr=5e-2)
    cfg, mesh, params, tokens, step = tf.demo_setup(cfg, device="cpu")
    assert mesh.shape == {"dp": 2, "sp": 2, "tp": 2}
    losses = []
    for _ in range(6):
        params, loss = step(params, tokens)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"no learning: {losses}"


def test_train_step_parallel_matches_single_device():
    """The dense model's loss on (2, 2, 2) matches one device's (rtol
    1e-3, as the JAX test). The new parameters are not compared, in
    either package: the step's gradients carry the dp x sp sum of the
    local losses' gradients and the tp fan-in (``make_train_step``),
    which one device does not have."""
    cfg = tf.Config(**SMALL, moe_layer=-1)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len),
                           generator=torch.Generator().manual_seed(1))
    losses = []
    for shape in ((1, 1, 1), (2, 2, 2)):
        mesh = make_mesh(shape, tf.AXES, "cpu")
        new, loss = tf.make_train_step(cfg, mesh)(
            tf.shard_params(params, cfg, mesh),
            tf.shard_tokens(tokens, mesh))
        assert all(torch.isfinite(v).all() for v in new.values())
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


def test_moe_layer_forward_finite():
    cfg = tf.Config(**{**SMALL, "batch": 8, "n_experts": 8}, moe_layer=1)
    _, mesh, params, tokens, step = tf.demo_setup(cfg, device="cpu")
    assert params["layer_1/w1"].shape == (NP, 4, 32, 64)
    new, loss = step(params, tokens)
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(v).all() for v in new.values())
