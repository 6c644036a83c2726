"""The port's MPI program entry held against the JAX package on the CPU:
the wire codec, the KVS, the shared-memory ring, the launcher's exit
codes, job control and segment cleanup, and ``mpirun --vpod``.

* Wire codec: ``encode_packet`` gives the JAX package's bytes for every
  packet type of the port, payloads of 0, 1, 4096 and 2^17 bytes, with
  and without ``extra``; each side decodes the other's bytes.
* KVS: a port server with a JAX client and the other way round: put/get,
  put_many/get_many, peek_many, add, peek/delete (a JAX client), a fence
  of 4 threads that carries cards, and abort releasing a blocked get.
* Shared-memory ring: the same sends (wrap-around, a full ring, an
  oversize record) give equal return codes, equal segment bytes and
  equal receive sequences on both ``_PyRing``s.
* Exit codes: ``_abort_exit_code`` against the JAX function.
* Jobs (``python -m mvapich2_tpu_torch.run`` in a subprocess, each with
  its own timeout; nothing calls ``mpi.Init`` in the pytest process): a
  failing rank kills the job, ``MPI_Abort(3)`` exits 3, a singleton
  ``mpi.Init()`` (with its startup timestamps), the flags that are not
  ported exit 2, no ``mv2t-shm`` file of a job is left after it ends or
  is killed, the launcher imports no torch, and ``progs/pingpong.py`` on
  -np 4 over two fake nodes, with the default rendezvous and with R3
  (over TCP the rendezvous payload moves through the socket either way,
  over shared memory through a file under RGET and through the ring
  under R3; a tensor off the CPU is refused).
* ``--vpod`` in process under ``MV2T_VPOD_REAL=0``: 8 rank threads give
  results bitwise equal to ``run_ranks(8, device_mesh=make_mesh((8,),
  ("x",), "cpu"))`` and to numpy, with the same ``dev_coll_tier_*``
  pvars; ``progs/vpod_collectives.py`` runs its checks; a rank that
  raises aborts the device rendezvous (its peers fail, the launch
  returns 1); without the variable and without a CUDA device the launch
  raises.
"""

import glob
import importlib.util
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mvapich2_tpu.runtime import kvs as jax_kvs
from mvapich2_tpu.runtime import launcher as jax_launcher
from mvapich2_tpu.transport import base as jax_base
from mvapich2_tpu.transport import shm as jax_shm

from mvapich2_tpu_torch import mpit, run_ranks
from mvapich2_tpu_torch.parallel import make_mesh
from mvapich2_tpu_torch.runtime import kvs as port_kvs
from mvapich2_tpu_torch.runtime import launcher
from mvapich2_tpu_torch.transport import base as port_base
from mvapich2_tpu_torch.transport import shm as port_shm
from mvapich2_tpu_torch.utils.config import get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGS = os.path.join(REPO, "mvapich2_tpu_torch", "progs")
JOB_TIMEOUT = 90


def mpirun(args, prog_text=None, tmp_path=None, env=None, timeout=JOB_TIMEOUT):
    """``python -m mvapich2_tpu_torch.run <args> python <prog>``; the
    program is ``prog_text`` written to ``tmp_path`` when given."""
    cmd = [sys.executable, "-m", "mvapich2_tpu_torch.run", *args]
    if prog_text is not None:
        prog = tmp_path / "prog.py"
        prog.write_text(prog_text)
        cmd += [sys.executable, str(prog)]
    full = dict(os.environ)
    full.pop("MV2T_KVS", None)
    full.update(env or {})
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env=full)


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

EXTRAS = (None, {"handle": ("file", "/dev/shm/mv2t-shm-1-abcd.rget-0-x"),
                 "last": True})


@pytest.mark.parametrize("extra", EXTRAS, ids=("plain", "extra"))
@pytest.mark.parametrize("nbytes", (0, 1, 4096, 1 << 17))
@pytest.mark.parametrize("ptype", list(port_base.PktType),
                         ids=lambda t: t.name)
def test_wire_codec_equals_jax(ptype, nbytes, extra):
    rng = np.random.default_rng(int(ptype) * 7 + nbytes)
    data = rng.integers(0, 256, nbytes, dtype=np.uint8) if nbytes else None
    fields = dict(src_world=3, ctx=(1 << 20) + 6, comm_src=2, tag=-2,
                  nbytes=nbytes, data=data, sreq_id=41, rreq_id=77,
                  protocol="RPUT" if ptype == port_base.PktType.RNDV_RTS
                  else "", offset=1 << 18, extra=extra)
    pb = port_base.encode_packet(port_base.Packet(ptype, **fields))
    jb = jax_base.encode_packet(
        jax_base.Packet(jax_base.PktType(int(ptype)), **fields))
    assert pb == jb
    for pkt in (jax_base.decode_packet(pb), port_base.decode_packet(jb)):
        assert int(pkt.type) == int(ptype)
        for k, v in fields.items():
            if k == "data":
                got = pkt.data
                assert (got is None and v is None) or \
                    np.array_equal(got, v)
            else:
                assert getattr(pkt, k) == v, k


def test_wire_codec_strips_plane_flag():
    pkt = port_base.Packet(port_base.PktType.EAGER_SEND, 0,
                           ctx=8 | port_base.PLANE_CTX_FLAG)
    blob = port_base.encode_packet(pkt)
    assert port_base.decode_packet(blob).ctx == 8
    assert jax_base.decode_packet(blob).ctx == 8
    assert port_base.PKT_HDR_SIZE == jax_base.PKT_HDR_SIZE


# ---------------------------------------------------------------------------
# KVS, across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server,client", [
    (port_kvs.KVSServer, jax_kvs.KVSClient),
    (jax_kvs.KVSServer, port_kvs.KVSClient)], ids=("port-server",
                                                   "jax-server"))
def test_kvs_interoperates(server, client):
    srv = server(4)
    try:
        c = client(srv.address, timeout=30)
        c.put("a", "1")
        assert c.get("a") == "1"
        c.put_many({"b": "2", "c": "3"})
        assert c.get_many(["c", "b", "a"]) == ["3", "2", "1"]
        assert c.peek_many(["a", "nope"]) == ["1", None]
        assert c.add("n", 5) == 5 and c.add("n", -2) == 3
        # the single-key verbs the port's client does not use
        j = jax_kvs.KVSClient(srv.address, timeout=30)
        assert j.peek("nope") is None and j.peek("c") == "3"
        j.delete("a")
        assert c.peek_many(["a"]) == [None]
        j.close()
        # a fence of 4 members, each carrying its card: when it releases,
        # every card is readable
        got, errs = {}, []

        def member(i):
            try:
                m = client(srv.address, timeout=30)
                m.fence("g", count=4, cards={f"card-{i}": str(i * i)})
                got[i] = m.get_many([f"card-{j}" for j in range(4)])
                m.close()
            except Exception as e:   # noqa: BLE001 - reported below
                errs.append(e)

        ts = [threading.Thread(target=member, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not errs and all(not t.is_alive() for t in ts)
        assert got == {i: ["0", "1", "4", "9"] for i in range(4)}
        # abort releases a get blocked on a key nobody puts
        box = []

        def blocked():
            m = client(srv.address, timeout=30)
            try:
                m.get("never")
            except KeyError:
                box.append("released")

        t = threading.Thread(target=blocked)
        t.start()
        c.abort("rank 1 called MPI_Abort(3)")
        t.join(30)
        assert box == ["released"]
        assert srv.state.aborted == "rank 1 called MPI_Abort(3)"
        c.close()
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the shared-memory ring, byte for byte
# ---------------------------------------------------------------------------

def test_pyring_equals_jax(tmp_path):
    nr, ring_bytes = 3, 512
    # the port's ring attaches to a zero-filled segment (the leader's
    # light boot makes it); the JAX ring creates its own
    seg = tmp_path / "seg-0"
    seg.write_bytes(bytes(nr * nr * ring_bytes))
    rings = [port_shm._PyRing(str(seg), nr, ring_bytes),
             jax_shm._PyRing(str(tmp_path / "seg-1"), nr, ring_bytes, True)]
    rng = np.random.default_rng(5)
    log = [[], []]
    ops = []
    # fill (0 -> 1) until full, drain part, wrap, an oversize record,
    # other pairs interleaved
    for k in range(40):
        ops.append(("send", 0, 1, rng.integers(1, 90)))
    ops += [("recv", 0, 1)] * 5
    for k in range(12):
        ops.append(("send", 0, 1, rng.integers(1, 120)))
        ops.append(("send", 2, 1, rng.integers(0, 40)))
        ops.append(("recv", 0, 1))
    ops.append(("send", 1, 0, ring_bytes))       # can never fit: -1
    ops += [("recv", 0, 1)] * 40 + [("recv", 2, 1)] * 14
    for op in ops:
        for i, ring in enumerate(rings):
            if op[0] == "send":
                payload = bytes(rng.integers(0, 256, op[3], np.uint8)) \
                    if i == 0 else payload
                log[i].append(ring.send(op[1], op[2], payload))
            else:
                log[i].append(ring.recv(op[1], op[2]))
    assert log[0] == log[1]
    assert 0 in log[0] and -1 in log[0] and None in log[0]
    assert bytes(rings[0].mm) == bytes(rings[1].mm)
    for ring in rings:
        ring.close()


# ---------------------------------------------------------------------------
# launcher exit codes and job control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aborted,default", [
    (None, 1), ("", 1), (None, 5), ("rank 0 called MPI_Abort(3)", 1),
    ("rank 2 called MPI_Abort(0)", 1), ("MPI_Abort(-4)", 1),
    ("MPI_Abort(255)", 1), ("MPI_Abort(256)", 1), ("killed", 9),
    ("rank 1 called MPI_Abort(77) twice MPI_Abort(5)", 1)])
def test_abort_exit_code_equals_jax(aborted, default):
    assert launcher._abort_exit_code(aborted, default) == \
        jax_launcher._abort_exit_code(aborted, default)


def test_launcher_imports_no_torch():
    code = ("import sys; import mvapich2_tpu_torch.run, "
            "mvapich2_tpu_torch.runtime.launcher; "
            "print('torch' in sys.modules, 'numpy' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and r.stdout.split() == ["False", "False"], \
        r.stderr


FAIL_PROG = """
from mvapich2_tpu_torch import mpi
mpi.Init()
c = mpi.COMM_WORLD
if c.rank == 1:
    raise RuntimeError("rank 1 fails")
import numpy as np
c.recv(np.empty(4), source=1, tag=3)      # never matched
"""

ABORT_PROG = """
from mvapich2_tpu_torch import mpi
import numpy as np
mpi.Init()
c = mpi.COMM_WORLD
c.barrier()
if c.rank == 1:
    mpi.Abort(c, 3)
c.recv(np.empty(4), source=1, tag=3)      # never matched
"""


def test_failing_rank_kills_job(tmp_path):
    r = mpirun(["-np", "3"], FAIL_PROG, tmp_path)
    assert r.returncode != 0
    assert "rank 1 fails" in r.stderr


def test_mpi_abort_exit_code(tmp_path):
    r = mpirun(["-np", "4"], ABORT_PROG, tmp_path)
    assert r.returncode == 3, r.stderr
    assert "MPI_Abort(3)" in r.stderr


def test_singleton_init():
    code = ("from mvapich2_tpu_torch import mpi; import numpy as np; "
            "mpi.Init(); c = mpi.COMM_WORLD; s = mpi.COMM_SELF; "
            "assert (c.size, c.rank, s.size) == (1, 0, 1); "
            "assert c.allreduce(np.ones(4))[0] == 1.0; "
            "assert mpi.Initialized() and not mpi.Finalized(); "
            "mpi.Finalize(); assert mpi.Finalized(); print('No Errors')")
    env = dict(os.environ, MV2T_STARTUP_TIMING="1")
    for k in ("MV2T_KVS", "MV2T_RANK", "MV2T_SIZE"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and "No Errors" in r.stdout, r.stderr
    assert "startup timestamps" in r.stderr and "MPI_Init" in r.stderr


@pytest.mark.parametrize("flags", (["--hostfile", "hosts"],
                                   ["--map", "cyclic"], ["--ft"]))
def test_unported_flags_exit_2(flags):
    r = mpirun(["-np", "2", *flags, sys.executable, "-c", "pass"])
    assert r.returncode == 2
    assert "not ported" in r.stderr


SHM_PROG = """
import os, sys
import numpy as np
from mvapich2_tpu_torch import mpi
mpi.Init()
c = mpi.COMM_WORLD
ch = c.u.shm_channel
if c.rank == 0:
    # an unmatched rendezvous send leaves its file exposed
    c.isend(np.zeros(1 << 17), dest=1, tag=9)
c.barrier()                      # every channel (and doorbell) is built
if c.rank in (0, 2):
    stem = os.path.basename(ch.path)
    files = sorted(f for f in os.listdir(os.path.dirname(ch.path))
                   if f.startswith(stem))
    # one write a line: the ranks share the launcher's stdout
    os.write(1, f"SHM {ch.path} {len(files)}\\n".encode())
c.barrier()
if sys.argv[1] == "kill":
    if c.rank == 1:
        os._exit(1)
    c.recv(np.empty(4), source=1, tag=3)      # never matched
else:
    if c.rank == 1:
        c.recv(np.empty(1 << 17), source=0, tag=9)
    mpi.Finalize()
"""


NO_SEGMENT_PROG = """
import os
import numpy as np
from mvapich2_tpu_torch import mpi, mpit
from mvapich2_tpu_torch.runtime import boot


def refuse(n_local):
    raise OSError("no room for the segment")


boot._make_raw_segments = refuse
mpi.Init()
c = mpi.COMM_WORLD
assert c.u.shm_channel is None
peer = c.rank ^ 1                    # the co-located rank
out = np.empty(1 << 15)
c.sendrecv(np.full(1 << 15, c.rank, np.float64), peer, 4, out, peer, 4)
assert (out == peer).all()
assert c.allreduce(np.ones(8))[0] == c.size
sent = int(mpit.pvar("chan_tcp_bytes_sent").read())
os.write(1, f"SENT {c.rank} {sent}\\n".encode())    # one write a line
mpi.Finalize()
"""


def test_leader_without_segment_uses_tcp(tmp_path):
    # a leader that cannot provision its node's segment publishes an
    # empty card: the node's ranks talk over TCP
    r = mpirun(["-np", "4", "--fake-nodes", "0,0,1,1"], NO_SEGMENT_PROG,
               tmp_path)
    assert r.returncode == 0, r.stderr
    sent = [ln.split() for ln in r.stdout.splitlines()
            if ln.startswith("SENT ")]
    assert sorted(int(s[1]) for s in sent) == [0, 1, 2, 3]
    assert all(int(s[2]) > (1 << 18) for s in sent)
    assert "uses tcp" in r.stderr


@pytest.mark.parametrize("how", ("normal", "kill"))
def test_shm_segments_removed(tmp_path, how):
    prog = tmp_path / "prog.py"
    prog.write_text(SHM_PROG)
    r = mpirun(["-np", "4", "--fake-nodes", "0,0,1,1", sys.executable,
                str(prog), how])
    assert (r.returncode == 0) == (how == "normal"), r.stderr
    seen = [ln.split() for ln in r.stdout.splitlines()
            if ln.startswith("SHM ")]
    assert len(seen) == 2
    for _, path, nfiles in seen:
        # ring, flags and both doorbells (+ rank 0's rendezvous file)
        assert int(nfiles) >= 4
        assert glob.glob(path + "*") == []


PINGPONG = os.path.join(PROGS, "pingpong.py")


@pytest.mark.parametrize("env", ({}, {"MV2T_RNDV_PROTOCOL": "R3"}),
                         ids=("rget", "r3"))
def test_pingpong_prog_over_shm_and_tcp(env):
    r = mpirun(["-np", "4", "--fake-nodes", "0,0,1,1", sys.executable,
                PINGPONG, "--sizes", "1,65536,1048576", "--iters", "3"],
               env=env)
    assert r.returncode == 0, r.stderr
    import json
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("PINGPONG_JSON ")]
    out = json.loads(line[0].split(" ", 1)[1])
    assert set(out["pingpong_us"]) == {"shm", "tcp"}
    assert out["card_tensor_refused"] == "meta"
    assert len(out["init_s"]) == 4
    pv = out["pvars_rank0"]
    # 1 MiB each way: rendezvous; over TCP (RPUT/R3) the payload rides
    # the socket, over shared memory a file (RGET) or the ring (R3)
    assert pv["pt2pt_rndv_sent"] >= 2 * 5
    assert pv["chan_tcp_bytes_sent"] > 5 * (1 << 20)
    if env:
        assert pv["chan_shm_bytes_sent"] > 5 * (1 << 20)
    else:
        assert pv["chan_shm_bytes_sent"] < (1 << 20)


# ---------------------------------------------------------------------------
# --vpod
# ---------------------------------------------------------------------------

VPOD_PROG = """
import os, sys
import numpy as np
import torch
from mvapich2_tpu_torch import mpi


def ints(seed, r, n):
    return np.random.default_rng(seed * 100 + r).integers(
        -8, 9, n).astype(np.float32)


def body(comm):
    r, p = comm.rank, comm.size
    t = lambda seed, n: torch.from_numpy(ints(seed, r, n))
    out = {"ar_small": comm.allreduce(t(1, 1024)),
           "ar_big": comm.allreduce(t(2, 1 << 15)),
           "ar_max": comm.allreduce(t(3, 4096), op=mpi.MAX),
           "ar_numpy": comm.allreduce(ints(4, r, 1 << 13)),
           "allgather": comm.allgather(t(5, 1 << 12)),
           "alltoall": comm.alltoall(t(6, 512 * p)),
           "alltoallv": comm.alltoallv(t(7, 3 * p), [3] * p, None, None,
                                       [3] * p, None),
           "bcast": comm.bcast(t(8, 256), root=2),
           "rsb": comm.reduce_scatter_block(t(9, 64 * p))}
    return {k: np.asarray(v) for k, v in out.items()}


if __name__ == "__main__":
    mpi.Init()
    c = mpi.COMM_WORLD
    res = body(c)
    np.savez(os.path.join(sys.argv[1], f"rank{c.rank}.npz"), **res)
    mpi.Finalize()
"""

TIERS = ("dev_coll_tier_vmem", "dev_coll_tier_hbm", "dev_coll_tier_quant",
         "dev_coll_fallback_size", "dev_coll_fallback_dtype",
         "dev_coll_fallback_shape")


@pytest.fixture
def vpod_env(monkeypatch):
    monkeypatch.setenv("MV2T_VPOD_REAL", "0")
    # the 128 KiB allreduce takes K3 (the streaming ring), the rest K6
    monkeypatch.setenv("MV2T_DEV_TIER_VMEM_MAX", "65536")
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    get_config().reload()
    yield
    monkeypatch.undo()
    get_config().reload()


def _tiers():
    return {k: mpit.pvar(k).read() for k in TIERS}


def test_vpod_in_process_equals_run_ranks(tmp_path, vpod_env):
    prog = tmp_path / "vpod_prog.py"
    prog.write_text(VPOD_PROG)
    spec = importlib.util.spec_from_file_location("vpod_prog", prog)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p = 8
    t0 = _tiers()
    rc = launcher.launch_vpod(p, [sys.executable, str(prog),
                                  str(tmp_path)], timeout=60)
    assert rc == 0
    t1 = _tiers()
    ref = run_ranks(p, mod.body, device_mesh=make_mesh((p,), ("x",), "cpu"),
                    timeout=60)
    t2 = _tiers()
    vpod_tiers = {k: t1[k] - t0[k] for k in TIERS}
    assert vpod_tiers == {k: t2[k] - t1[k] for k in TIERS}
    assert vpod_tiers["dev_coll_tier_vmem"] > 0
    assert vpod_tiers["dev_coll_tier_hbm"] > 0
    x = lambda seed, n: [mod.ints(seed, r, n) for r in range(p)]
    for r in range(p):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(ref[r])
        for k in got.files:
            assert np.array_equal(got[k], ref[r][k]), (r, k)
        np.testing.assert_array_equal(got["ar_small"],
                                      np.sum(x(1, 1024), 0))
        np.testing.assert_array_equal(got["ar_big"],
                                      np.sum(x(2, 1 << 15), 0))
        np.testing.assert_array_equal(got["ar_max"],
                                      np.max(x(3, 4096), 0))
        np.testing.assert_array_equal(got["ar_numpy"],
                                      np.sum(x(4, 1 << 13), 0))
        np.testing.assert_array_equal(got["allgather"],
                                      np.concatenate(x(5, 1 << 12)))
        a2a = np.stack(x(6, 512 * p)).reshape(p, p, 512)
        np.testing.assert_array_equal(got["alltoall"], a2a[:, r].ravel())
        a2v = np.stack(x(7, 3 * p)).reshape(p, p, 3)
        np.testing.assert_array_equal(got["alltoallv"], a2v[:, r].ravel())
        np.testing.assert_array_equal(got["bcast"], x(8, 256)[2])
        np.testing.assert_array_equal(
            got["rsb"], np.sum(x(9, 64 * p), 0)[64 * r:64 * (r + 1)])


def test_vpod_collectives_prog(vpod_env, capsys):
    rc = launcher.launch_vpod(8, [sys.executable,
                                  os.path.join(PROGS, "vpod_collectives.py"),
                                  "--big", "65536", "--small", "1024",
                                  "--ag-big", "16384", "--ag-small", "512",
                                  "--a2a", "8192", "--a2av", "4096",
                                  "--iters", "2"], timeout=60)
    assert rc == 0
    import json
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("VPOD_JSON ")]
    out = json.loads(line[0].split(" ", 1)[1])
    n = out["calls"]
    assert out["bitwise"] and out["counts_of"] == "PLAIN_CALLS"
    assert out["launches"]["hbm_ring_all_reduce"] == n["allreduce_big"]
    assert out["launches"]["ring_all_reduce"] == n["allreduce_small"]
    assert out["launches"]["hbm_ring_all_gather"] == 1
    assert out["launches"]["ring_all_gather"] == 1
    assert out["launches"]["hbm_alltoall"] == 1
    assert out["launches"]["hbm_alltoallv"] == 1


VPOD_FAIL_PROG = """
import torch
from mvapich2_tpu_torch import mpi
mpi.Init()
c = mpi.COMM_WORLD
if c.rank == 3:
    raise RuntimeError("rank 3 fails")
c.allreduce(torch.ones(4096))      # the device rendezvous rank 3 never joins
"""


def test_vpod_failing_rank_aborts_the_rendezvous(tmp_path, vpod_env):
    prog = tmp_path / "p.py"
    prog.write_text(VPOD_FAIL_PROG)
    t0 = time.monotonic()
    rc = launcher.launch_vpod(8, [sys.executable, str(prog)], timeout=60)
    assert rc == 1
    assert time.monotonic() - t0 < 30      # the peers raised, no hang


def test_vpod_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("MV2T_VPOD_REAL", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    prog = tmp_path / "p.py"
    prog.write_text("raise SystemExit(3)\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.launch_vpod(2, [sys.executable, str(prog)])
