"""The port's alltoall and alltoallv through the 1:1 mesh channel:
mvapich2_tpu_torch.run_ranks(8) bound one to one to a mesh of 8 virtual
ranks on the CPU (so K10/K11 take their plain versions), held against
numpy and against the JAX package's run_ranks(8) over the 8-device
virtual CPU mesh (collectives forced onto the device there with
MV2T_ALLTOALL_ALGO=device). Bitwise throughout: these collectives only
move bytes.

Also: numpy and tensor buffers, dense and gapped displacements, a rank
that sends nothing, the per-rank tier pvars, the cases the JAX package
sends to its host path (which raise here), and a K10/K11 spin timeout.

Every MV2T_* change is restored, and both configs reloaded, in the
``env`` fixture's teardown; the JAX package is kept from loading its
measured CPU profile (autotune's load-once flag and the tuning tables
are patched through monkeypatch)."""

import numpy as np
import pytest

import jax
import torch

from mvapich2_tpu import autotune as jax_autotune
from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.coll import tuning as jax_tuning
from mvapich2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import make_mesh, mpit, run_ranks
from mvapich2_tpu_torch.bench.moe import routing
from mvapich2_tpu_torch.core.comm import IN_PLACE
from mvapich2_tpu_torch.ops import alltoall

NP = 8


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages; the
    JAX alltoall family is forced onto the device. The teardown restores
    the environment and reloads both configs."""
    from mvapich2_tpu_torch.utils.config import get_config
    monkeypatch.setattr(jax_autotune, "_default_attempted", True)
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
    set_env(ALLTOALL_ALGO="device")
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()


def _mesh():
    return make_mesh((NP,), ("x",), "cpu")


def _both(app):
    mine = run_ranks(NP, app, device_mesh=_mesh())
    ref = jax_run_ranks(NP, app, device_mesh=jax_make_mesh(
        (NP,), ("x",), jax.devices()[:NP]))
    return mine, ref


def _payloads(counts, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sum(counts[r])).astype(dtype) if dtype ==
            np.float32 else rng.integers(-2**31, 2**31 - 1,
                                         size=sum(counts[r]), dtype=dtype)
            for r in range(NP)]


def _expected(counts, payloads, r):
    """Rank r's packed receive: sender order, each sender's block for r."""
    sd = [np.cumsum([0] + list(row[:-1])) for row in counts]
    return np.concatenate([payloads[j][sd[j][r]:sd[j][r] + counts[j][r]]
                           for j in range(NP)])


@pytest.mark.parametrize("kind", ["float32", "int32"])
def test_alltoall_parity_with_jax(env, kind):
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(NP, NP * 5)).astype(np.float32)
            if kind == "float32" else
            rng.integers(-2**31, 2**31 - 1, size=(NP, NP * 5),
                         dtype=np.int32))

    def app(comm):
        return comm.alltoall(data[comm.rank].copy())

    alltoall.reset_counts()
    hbm0 = mpit.pvar("dev_coll_tier_hbm").read()
    mine, ref = _both(app)
    assert alltoall.PLAIN_CALLS["hbm_alltoall"] == 1
    assert mpit.pvar("dev_coll_tier_hbm").read() == hbm0 + NP
    want = data.reshape(NP, NP, 5).transpose(1, 0, 2).reshape(NP, -1)
    for r in range(NP):
        np.testing.assert_array_equal(mine[r], ref[r])
        np.testing.assert_array_equal(mine[r], want[r])


@pytest.mark.parametrize("shape", ["hot", "skew"])
def test_alltoallv_parity_with_jax(env, shape):
    counts = routing(NP, 24, shape)
    payloads = _payloads(counts, 7)

    def app(comm):
        r = comm.rank
        rc = [counts[j][r] for j in range(NP)]
        sd = list(np.cumsum([0] + counts[r][:-1]))
        rd = list(np.cumsum([0] + rc[:-1]))
        recv = np.zeros(sum(rc), np.float32)
        comm.alltoallv(payloads[r].copy(), counts[r], sd, recv, rc, rd)
        return recv

    alltoall.reset_counts()
    mine, ref = _both(app)
    assert alltoall.PLAIN_CALLS["hbm_alltoallv"] == 1
    for r in range(NP):
        np.testing.assert_array_equal(mine[r], ref[r])
        np.testing.assert_array_equal(mine[r], _expected(counts, payloads,
                                                          r))


def test_alltoallv_buffers_layouts_and_pvars(env):
    """Tensor and numpy buffers, dense (None) and gapped displacements,
    a rank (3) that sends nothing but receives: every rank's result
    against numpy, one plain K11 call and 8 dev_coll_tier_hbm counts per
    collective."""
    counts = routing(NP, 16, "skew")
    counts[3] = [0] * NP
    payloads = _payloads(counts, 11, np.int32)
    gap = 3

    def app(comm):
        r = comm.rank
        sc = counts[r]
        rc = [counts[j][r] for j in range(NP)]
        # dense, tensors, displacements left to default
        t = comm.alltoallv(torch.from_numpy(payloads[r].copy()), sc, None,
                           None, rc, None)
        # gapped on both sides, numpy, recvbuf allocated by the comm
        sd = [int(sum(sc[:j])) + gap * j for j in range(NP)]
        send = np.full(sum(sc) + gap * NP, -1, np.int32)
        for j in range(NP):
            send[sd[j]:sd[j] + sc[j]] = payloads[r][sum(sc[:j]):
                                                    sum(sc[:j + 1])]
        rd = [int(sum(rc[:j])) + gap * j for j in range(NP)]
        g = comm.alltoallv(send, sc, sd, None, rc, rd)
        # gapped receive into a tensor result
        tg = comm.alltoallv(torch.from_numpy(send), sc, sd, None, rc, rd)
        return t, g, tg, rd

    alltoall.reset_counts()
    hbm0 = mpit.pvar("dev_coll_tier_hbm").read()
    got = run_ranks(NP, app, device_mesh=_mesh())
    assert alltoall.PLAIN_CALLS == {"hbm_alltoall": 0, "hbm_alltoallv": 3}
    assert alltoall.LAUNCHES == {"hbm_alltoall": 0, "hbm_alltoallv": 0}
    assert mpit.pvar("dev_coll_tier_hbm").read() == hbm0 + 3 * NP
    for r, (t, g, tg, rd) in enumerate(got):
        want = _expected(counts, payloads, r)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), want)
        rc = [counts[j][r] for j in range(NP)]
        off = 0
        for j in range(NP):
            np.testing.assert_array_equal(g[rd[j]:rd[j] + rc[j]],
                                          want[off:off + rc[j]])
            np.testing.assert_array_equal(tg[rd[j]:rd[j] + rc[j]].numpy(),
                                          want[off:off + rc[j]])
            off += rc[j]
        assert g.size == rd[-1] + rc[-1]


def test_host_path_cases_raise(env):
    """What the JAX package sends to its host path raises
    NotImplementedError here: alltoallv with MPI_IN_PLACE, a forced host
    ALLTOALL_ALGO (alltoall and alltoallv), alltoallv on the slot
    channel."""
    c = [1] * NP

    def in_place(comm):
        comm.alltoallv(IN_PLACE, c, None, np.zeros(NP, np.float32), c,
                       None)

    def a2av(comm):
        comm.alltoallv(np.arange(NP, dtype=np.float32), c, None, None, c,
                       None)

    def a2a(comm):
        comm.alltoall(np.arange(NP, dtype=np.float32))

    for app, kw, before in ((in_place, {"device_mesh": _mesh()}, None),
                            (a2av, {"device_mesh": _mesh()}, "bruck"),
                            (a2a, {"device_mesh": _mesh()}, "bruck"),
                            (a2av, {"device": "cpu"}, None)):
        if before:
            env(ALLTOALL_ALGO=before)
        with pytest.raises(RuntimeError) as ei:
            run_ranks(NP, app, timeout=30, **kw)
        assert isinstance(ei.value.__cause__, NotImplementedError)
        env(ALLTOALL_ALGO="device")


class _ErrorWord:
    """Stands in for the loaded ring library: its error word reads
    ``code`` until a read clears it, as a timed-out spin leaves it."""

    def __init__(self, code):
        self.code = code

    def mv2t_ring_error(self, clear):
        code = self.code
        if clear:
            self.code = 0
        return code


@pytest.mark.parametrize("coll", ["alltoall", "alltoallv"])
def test_spin_timeout_raises_on_every_rank(env, monkeypatch, coll):
    """A K10/K11 spin timeout leaves the error word set: the leader's
    per-call check raises on every rank of that call, and the next call
    runs."""
    from mvapich2_tpu_torch.ops import _build
    monkeypatch.setitem(_build._loaded, "ring", _ErrorWord(1))
    c = [2] * NP

    def call(comm):
        x = np.arange(2 * NP, dtype=np.float32) + 100 * comm.rank
        if coll == "alltoall":
            return comm.alltoall(x)
        return comm.alltoallv(x, c, None, None, c, None)

    def app(comm):
        try:
            call(comm)
            first = None
        except RuntimeError as e:
            first = str(e.__cause__)
        return first, call(comm)

    got = run_ranks(NP, app, device_mesh=_mesh())
    for r, (msg, second) in enumerate(got):
        assert msg is not None and "spin bound" in msg
        want = np.concatenate([np.arange(2 * r, 2 * r + 2) + 100 * s
                               for s in range(NP)]).astype(np.float32)
        np.testing.assert_array_equal(second, want)
