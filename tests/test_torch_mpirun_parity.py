"""Process-mode and ``--vpod`` jobs of the port held against the JAX
package's, on the CPU.

One rank program (kept here as a string, written to ``tmp_path``) takes
the package name and runs seeded numpy calls: ``sendrecv`` around the
ring (eager, and 2^17 f64 by rendezvous), allreduce (f32, f64 and int32;
sum and max; the recursive-doubling and ring sizes), bcast, allgather,
alltoall, ``reduce_scatter_block``, barrier, split and dup. Each rank
writes a sha256 of every result and its ``pt2pt_*`` / ``coll_*_calls``
pvar deltas. The job runs under ``python -m mvapich2_tpu.run`` and
``python -m mvapich2_tpu_torch.run`` with ``-np 4 --fake-nodes
0,0,1,1`` (ranks 0-1 and 2-3 share memory, the others talk TCP) and
with ``-np 2``: the digests and the pvar deltas must be equal. The JAX
job runs on its Python ring and staged rendezvous (``MV2T_USE_CPLANE=0``,
``MV2T_USE_CMA=0``, ``MV2T_SHMRING_SO`` naming no file). The port's
rendezvous from rank 1 to rank 2 crosses the fake nodes on TCP, where it
takes RPUT/R3: its payload bytes are counted on ``chan_tcp_*``, while
rank 0's rendezvous to rank 1 (RGET through a file) keeps the payload
off the shared-memory ring.

A rung program (a rank 0 <-> 1 echo of 64 KiB and 1 MiB and an
allreduce, ``-np 2`` on one node) runs under both packages with each
rung of the shared-memory rendezvous forced: CMA (the JAX job with its
Python ring and CMA on), ``MV2T_USE_CMA=0`` (the arena, with the
pipelined rendezvous in 16 KiB chunks: 64 KiB spans four) and
``MV2T_USE_CMA=0 MV2T_ARENA_BYTES=4096`` (the file rung): equal
digests and equal ``pt2pt_*``, ``rndv_*`` and ``arena_allocs`` deltas.

A second program (numpy, above the host-to-device crossover) runs under
``mpirun --vpod -np 4`` of both packages, the port's under
``MV2T_VPOD_REAL=0``: the digests must be equal.

Every job is a subprocess with its own timeout.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT = 120

PARITY_PROG = '''
import hashlib
import importlib
import json
import sys

import numpy as np

pkg, outdir = sys.argv[1], sys.argv[2]
mpi = importlib.import_module(pkg + ".mpi")
mpit = importlib.import_module(pkg + ".mpit")
reg = getattr(mpit._pvars, "_vars", mpit._pvars)


def snap(prefixes):
    return {k: float(v.read()) for k, v in list(reg.items())
            if k.startswith(prefixes) and not k.endswith("_time")
            and v.klass == mpit.PVAR_CLASS_COUNTER}


mpi.Init()
c = mpi.COMM_WORLD
r, n = c.rank, c.size
before = snap(("pt2pt_", "coll_", "chan_"))
rng = np.random.default_rng(1234 + r)
out = {}


def dig(name, a):
    out[name] = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def ints(shape, dt):
    return rng.integers(-50, 50, shape).astype(dt)


nxt, prv = (r + 1) % n, (r - 1) % n
for name, size in (("eager", 1000), ("rndv", 1 << 17)):
    s = ints(size, np.float64)
    got = np.empty_like(s)
    c.sendrecv(s, nxt, 7, got, prv, 7)
    dig("sendrecv_" + name, got)
for dt in (np.float32, np.float64, np.int32):
    for nel in (1000, 3000):
        x = ints(nel, dt)
        dig("allreduce_sum_%s_%d" % (np.dtype(dt).name, nel), c.allreduce(x))
        dig("allreduce_max_%s_%d" % (np.dtype(dt).name, nel),
            c.allreduce(x, op=mpi.MAX))
b = ints(5000, np.float64) if r == 1 % n else np.zeros(5000)
dig("bcast", c.bcast(b, root=1 % n))
dig("allgather", c.allgather(ints(256, np.int32)))
dig("alltoall", c.alltoall(ints(128 * n, np.float32)))
dig("reduce_scatter_block", c.reduce_scatter_block(ints(512 * n, np.float32)))
c.barrier()
sub = c.split(r % 2, r)
dig("split_allreduce", sub.allreduce(ints(700, np.float32)))
d = c.dup()
dig("dup_allreduce", d.allreduce(ints(900, np.int32)))
d.free()
sub.free()
after = snap(("pt2pt_", "coll_", "chan_"))
deltas = {k: after[k] - before.get(k, 0.0) for k in after
          if after[k] != before.get(k, 0.0)}
with open("%s/rank%d.json" % (outdir, r), "w") as f:
    json.dump({"digests": out, "pvars": deltas}, f, sort_keys=True)
mpi.Finalize()
'''

VPOD_PROG = '''
import hashlib
import importlib
import json
import sys

import numpy as np

pkg, outdir = sys.argv[1], sys.argv[2]
mpi = importlib.import_module(pkg + ".mpi")
mpi.Init()
c = mpi.COMM_WORLD
r, p = c.rank, c.size
out = {}


def dig(name, a):
    out[name] = hashlib.sha256(
        np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()


def ints(seed, n):
    return np.random.default_rng(seed).integers(-8, 9, n).astype(np.float32)


for n in (8192, 65536):
    dig("allreduce_%d" % n, c.allreduce(ints(100 + r, n)))
    dig("allreduce_max_%d" % n, c.allreduce(ints(150 + r, n), op=mpi.MAX))
dig("allgather", c.allgather(ints(200 + r, 8192)))
dig("alltoall", c.alltoall(ints(300 + r, 8192 * p)))
c.barrier()
with open("%s/rank%d.json" % (outdir, r), "w") as f:
    json.dump(out, f, sort_keys=True)
mpi.Finalize()
'''

# the JAX package's Python ring and staged rendezvous (MV2T_SHMRING_SO is
# set per test to a file that does not exist; its arena has no switch,
# ARENA_BYTES only sizes it, and the compared pvars match with it)
JAX_ENV = {"MV2T_USE_CPLANE": "0", "MV2T_USE_CMA": "0"}


def _job(pkg, args, prog_text, tmp_path, env):
    prog = tmp_path / "prog.py"
    prog.write_text(prog_text)
    outdir = tmp_path / pkg
    outdir.mkdir()
    full = dict(os.environ)
    full.pop("MV2T_KVS", None)
    full["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in full.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    full.update(env)
    r = subprocess.run([sys.executable, "-m", f"{pkg}.run", *args,
                        sys.executable, str(prog), pkg, str(outdir)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=JOB_TIMEOUT, env=full)
    assert r.returncode == 0, f"{pkg}: {r.stderr[-3000:]}"
    return [json.load(open(outdir / f"rank{i}.json"))
            for i in range(int(args[1]))]


@pytest.mark.parametrize("args", (["-np", "4", "--fake-nodes", "0,0,1,1"],
                                  ["-np", "2"]), ids=("np4-2nodes", "np2"))
def test_process_mode_job_equals_jax(tmp_path, args):
    jax_env = dict(JAX_ENV,
                   MV2T_SHMRING_SO=str(tmp_path / "no-such-libshmring.so"))
    port = _job("mvapich2_tpu_torch", args, PARITY_PROG, tmp_path, {})
    ref = _job("mvapich2_tpu", args, PARITY_PROG, tmp_path, jax_env)
    for r, (p, j) in enumerate(zip(port, ref)):
        assert p["digests"] == j["digests"], r
        pick = lambda d: {k: v for k, v in d["pvars"].items()
                          if not k.startswith("chan_")}
        assert pick(p) == pick(j), r
        assert p["pvars"]["pt2pt_rndv_sent"] >= 1
    if len(port) == 4:
        pv = [p["pvars"] for p in port]
        # rank 1 -> 2 crosses the fake nodes: RPUT/R3 over TCP, the 1 MiB
        # payload in DATA chunks on the socket
        assert pv[1]["chan_tcp_bytes_sent"] > 8 << 17
        assert pv[2]["chan_tcp_bytes_recv"] > 8 << 17
        # rank 0 -> 1 shares memory: RGET, the payload through a file
        assert 0 < pv[0]["chan_shm_bytes_sent"] < 8 << 17
    else:
        assert all("chan_tcp_msgs_sent" not in p["pvars"] for p in port)


def test_vpod_job_equals_jax(tmp_path):
    args = ["-np", "4", "--vpod"]
    port = _job("mvapich2_tpu_torch", args, VPOD_PROG, tmp_path,
                {"MV2T_VPOD_REAL": "0"})
    ref = _job("mvapich2_tpu", args, VPOD_PROG, tmp_path, {})
    assert port == ref
    assert len(port[0]) == 6


RUNG_PROG = '''
import hashlib
import importlib
import json
import sys

import numpy as np

pkg, outdir = sys.argv[1], sys.argv[2]
mpi = importlib.import_module(pkg + ".mpi")
mpit = importlib.import_module(pkg + ".mpit")
reg = getattr(mpit._pvars, "_vars", mpit._pvars)


def snap():
    return {k: float(v.read()) for k, v in list(reg.items())
            if k.startswith(("pt2pt_", "rndv_", "arena_allocs"))
            and v.klass == mpit.PVAR_CLASS_COUNTER}


mpi.Init()
c = mpi.COMM_WORLD
r = c.rank
# the node's wiring (the rung agreement) is lazy: wait until both ranks
# have it, so the first rendezvous takes the agreed rung in either package
ch = c.u.shm_channel
while not c.allreduce(np.array([int(ch._wired)], np.int32), op=mpi.MIN)[0]:
    pass
before = snap()
rng = np.random.default_rng(77 + r)
out = {}
for n in (1 << 16, 1 << 20):
    x = rng.integers(0, 256, n).astype(np.uint8)
    got = np.empty(n, np.uint8)
    if r == 0:
        c.send(x, dest=1, tag=5)
        c.recv(got, source=1, tag=6)
    else:
        c.recv(got, source=0, tag=5)
        c.send(got, dest=0, tag=6)
    out["echo_%d" % n] = hashlib.sha256(got.tobytes()).hexdigest()
y = rng.integers(-50, 50, 3000).astype(np.float32)
out["allreduce"] = hashlib.sha256(c.allreduce(y).tobytes()).hexdigest()
after = snap()
deltas = {k: after[k] - before.get(k, 0.0) for k in after
          if after[k] != before.get(k, 0.0)}
with open("%s/rank%d.json" % (outdir, r), "w") as f:
    json.dump({"digests": out, "pvars": deltas}, f, sort_keys=True)
mpi.Finalize()
'''

RUNGS = {"cma": {"MV2T_USE_CMA": "1"},
         "arena": {"MV2T_USE_CMA": "0"},
         "file": {"MV2T_USE_CMA": "0", "MV2T_ARENA_BYTES": "4096"}}


@pytest.mark.parametrize("rung", list(RUNGS))
def test_shm_rendezvous_rungs_equal_jax(tmp_path, rung):
    """Each rung of the shared-memory rendezvous, forced the same way in
    both packages, moves the same bytes with the same counters; the
    counters name the rung."""
    env = dict(RUNGS[rung], MV2T_RNDV_CHUNK="16384")
    jax_env = dict(JAX_ENV, **env,
                   MV2T_SHMRING_SO=str(tmp_path / "no-such-libshmring.so"))
    args = ["-np", "2"]
    port = _job("mvapich2_tpu_torch", args, RUNG_PROG, tmp_path, env)
    ref = _job("mvapich2_tpu", args, RUNG_PROG, tmp_path, jax_env)
    assert port == ref
    pv = port[1]["pvars"]           # rank 1 pulls rank 0's first message
    assert pv["pt2pt_rndv_sent"] >= 2
    took = {"cma": pv.get("rndv_cma_bytes", 0) > 0,
            "arena": pv.get("rndv_pipeline_chunks", 0) > 0,
            "file": not any(k.startswith(("rndv_", "arena_")) for k in pv)}
    assert took[rung], pv
