"""The port's one-sided host windows (``rma/win.py``) held against the
JAX package on the CPU.

Each program runs through the JAX ``run_ranks`` and the port's
``run_ranks(..., device="cpu")`` on seeded numpy inputs; the windows'
contents, the fetched values, the counts and the error classes are
compared bit for bit, and the pt2pt and collective pvars move by the
same amounts. Covered: every case of ``tests/test_rma.py`` (put, get and
accumulate under fence, REPLACE at a displacement, get_accumulate and
fetch_and_op, compare_and_swap, the exclusive-lock counter, PSCW,
win_allocate with flush, dynamic windows, a derived target datatype,
rget/rput, shared windows, the sync errors, self RMA),
``tests/test_threads.py::test_multithreaded_rma``, two ranks locking,
reading and writing each other at once, a passive target that
sleeps outside MPI while the other ranks lock, put and unlock on it
(every unlock returns before it wakes: the asynchronous drain), and a
keyval's ``delete_fn`` firing on ``free``. Results that depend on which
rank came first (the fetched values, the CAS winner) are compared as
the sets they must be.

The JAX engine runs with the port's inline-drain rule patched in
(``jax_drain``): unpatched, it deadlocks two ranks under load.

What the port alone does: a CPU tensor given to ``win_create`` is the
window memory, and a tensor that does not lie on the CPU (a meta tensor
stands for the card) raises ``NotImplementedError`` as a window buffer,
an attached region, an origin, result or compare buffer on every rank,
with no packet sent. Every ``run_ranks`` takes the shared 30 s timeout.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from mvapich2_tpu.core import attr as jax_attr
from mvapich2_tpu.rma import win as jax_win
from mvapich2_tpu.transport import progress as jax_progress

from mvapich2_tpu_torch import run_ranks
from mvapich2_tpu_torch.core import attr as port_attr
from mvapich2_tpu_torch.rma import win as port_win

from test_torch_pt2pt import (JAX, PORT, TIMEOUT, assert_same,  # noqa: F401
                              env, run_both)

JAXR = types.SimpleNamespace(**vars(JAX), win=jax_win, attr=jax_attr)
PORTR = types.SimpleNamespace(**vars(PORT), win=port_win, attr=port_attr)
N = 4
SLEEP = 0.5


# the packet-handler depth of the calling thread, for the JAX engine
_JAX_HANDLER = threading.local()


@pytest.fixture(autouse=True)
def jax_drain(monkeypatch):
    """The JAX engine's inline drain deadlocks under load: two rank
    threads, each holding its own engine's mutex inside a FLUSH handler,
    each spinning for the other's mutex to deliver its FLUSH_ACK (seen
    in 6 of 6 loaded runs of 60 fence/accumulate rounds, and as the 120 s
    timeouts of ``tests/test_rma.py``). The JAX side runs here with the
    port's rule (``transport/progress.py`` ``_async_drain``): from inside
    a handler a failed try-lock rings the holder and returns. The
    handlers, and so every result, are the JAX package's."""
    real = jax_progress.ProgressEngine._dispatch

    def dispatch(self, pkt):
        _JAX_HANDLER.depth = getattr(_JAX_HANDLER, "depth", 0) + 1
        try:
            real(self, pkt)
        finally:
            _JAX_HANDLER.depth -= 1

    def async_drain(self):
        in_handler = getattr(_JAX_HANDLER, "depth", 0) > 0
        while not self.shutdown:
            with self._inbox_lock:
                if not self._inbox:
                    return
            if self.mutex.acquire(blocking=False):
                try:
                    self._drain_inbox(swallow_errors=True)
                finally:
                    self.mutex.release()
                continue
            self.wakeup()
            if in_handler:
                return
            time.sleep(0.0001)

    monkeypatch.setattr(jax_progress.ProgressEngine, "_dispatch", dispatch)
    monkeypatch.setattr(jax_progress.ProgressEngine, "_async_drain",
                        async_drain)


def _both(n, app, pvars=True):
    def run(comm, lib):
        return app(comm, JAXR if lib.name == "jax" else PORTR)
    j, p = run_both(n, run, pvars=pvars)
    assert_same(j, p)
    return p


def _ints(comm, seed, n, dt):
    return np.random.default_rng(seed + comm.rank).integers(
        -1000, 1000, n).astype(dt)


def _code(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - both packages' classes
        return getattr(e, "error_class", type(e).__name__)
    return None


# ---------------------------------------------------------------------------
# the cases of tests/test_rma.py
# ---------------------------------------------------------------------------

def put_fence(comm, lib):
    buf = _ints(comm, 1, 8, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    win.fence()
    win.put(_ints(comm, 2, 8, np.int64), (comm.rank + 1) % comm.size, 0)
    win.fence()
    win.free()
    return buf


def get_fence(comm, lib):
    buf = np.random.default_rng(3 + comm.rank).standard_normal(16)
    win = comm.win_create(buf, disp_unit=8)
    win.fence()
    out = np.zeros(16, np.float64)
    win.get(out, (comm.rank + 1) % comm.size, 0)
    win.fence()
    win.free()
    return out


def accumulate_sum_fence(comm, lib):
    buf = _ints(comm, 4, 4, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    win.fence()
    win.accumulate(_ints(comm, 5, 4, np.int64), 0, 0, op=lib.op.SUM)
    win.fence()
    win.free()
    return buf


def accumulate_replace_and_disp(comm, lib):
    buf = np.zeros(8, np.int32)
    win = comm.win_create(buf, disp_unit=4)
    win.fence()
    val = _ints(comm, 6, 1, np.int32)
    for t in range(comm.size):
        win.accumulate(val, t, comm.rank, op=lib.op.REPLACE)
    win.fence()
    win.free()
    return buf


def get_accumulate_and_fetch_op(comm, lib):
    buf = np.zeros(3, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    win.lock(0, lib.win.LOCK_EXCLUSIVE)
    old = np.zeros(1, np.int64)
    win.fetch_and_op(np.array([1], np.int64), old, 0, 0, op=lib.op.SUM)
    win.unlock(0)
    comm.barrier()
    allold = np.zeros(comm.size, np.int64)
    comm.allgather(old, allold, count=1)
    # get_accumulate of two int64 with MAX, then a NO_OP fetch
    win.fence()
    res = np.zeros(2, np.int64)
    win.get_accumulate(_ints(comm, 7, 2, np.int64), res, 0, 1, op=lib.op.MAX)
    win.fence()
    got = np.zeros(2, np.int64)
    win.get_accumulate(None, got, 0, 1, op=lib.op.NO_OP)
    win.fence()
    win.free()
    return np.sort(allold), int(buf[0]), got


def compare_and_swap(comm, lib):
    buf = np.zeros(1, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    win.lock_all()
    result = np.array([-1], np.int64)
    win.compare_and_swap(np.array([comm.rank + 1], np.int64),
                         np.array([0], np.int64), result, 0, 0)
    win.unlock_all()
    comm.barrier()
    wins = np.zeros(comm.size, np.int64)
    comm.allgather(np.array([int(result[0] == 0)], np.int64), wins,
                   count=1)
    comm.barrier()
    win.free()
    # exactly one CAS succeeded; its value stands at rank 0
    return int(wins.sum()), (comm.rank != 0
                             or int(buf[0]) == int(np.argmax(wins)) + 1)


def lock_exclusive_counter(comm, lib):
    buf = np.zeros(1, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    for _ in range(5):
        win.lock(0, lib.win.LOCK_EXCLUSIVE)
        cur = np.zeros(1, np.int64)
        win.get(cur, 0, 0)
        win.flush(0)
        win.put(cur + 1, 0, 0)
        win.unlock(0)
    comm.barrier()
    win.free()
    return buf


def pscw(comm, lib):
    buf = np.zeros(4, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    even = comm.rank % 2 == 0
    peer = comm.rank + 1 if even else comm.rank - 1
    group = comm.group.incl([peer])
    if even:
        win.start(group)
        win.put(_ints(comm, 8, 4, np.int64), peer, 0)
        win.complete()
    else:
        win.post(group)
        win.wait()
    win.free()
    return buf


def win_allocate_and_flush(comm, lib):
    win = comm.win_allocate(64, disp_unit=8)
    win.lock_all()
    win.put(_ints(comm, 9, 1, np.int64), (comm.rank + 1) % comm.size, 2)
    win.flush_all()
    win.unlock_all()
    comm.barrier()
    local = win.base.view(np.int64).copy()
    win.free()
    return local


def dynamic_window(comm, lib):
    win = comm.win_create_dynamic()
    arr = np.zeros(8, np.float32)
    addr = win.attach(arr)
    addrs = np.zeros(comm.size, np.int64)
    comm.allgather(np.array([addr], np.int64), addrs, count=1)
    win.fence()
    t = (comm.rank + 1) % comm.size
    src = np.random.default_rng(10 + comm.rank).standard_normal(8) \
        .astype(np.float32)
    win.put(src, t, int(addrs[t]))
    win.fence()
    win.detach(addr)
    win.free()
    return arr


def derived_datatype_put(comm, lib):
    dt = lib.dt
    buf = np.zeros(16, np.int32)
    win = comm.win_create(buf, disp_unit=1)
    win.fence()
    if comm.rank == 0:
        vec = dt.create_vector(4, 1, 2, dt.INT).commit()
        src = _ints(comm, 11, 4, np.int32)
        for t in range(comm.size):
            win.put(src, t, 0, count=1,
                    origin_dt=dt.create_contiguous(4, dt.INT).commit(),
                    target_dt=vec)
    win.fence()
    win.free()
    return buf


def rget_rput_requests(comm, lib):
    buf = _ints(comm, 12, 4, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    win.lock_all()
    t = (comm.rank + 1) % comm.size
    out = np.zeros(4, np.int64)
    win.rget(out, t, 0).wait()
    win.unlock_all()
    comm.barrier()
    win.lock_all()
    win.rput(_ints(comm, 13, 2, np.int64), t, 2).wait()
    win.unlock_all()
    comm.barrier()
    win.free()
    return out, buf


def shared_window(comm, lib):
    win = comm.win_allocate_shared(32, disp_unit=8)
    win.base.view(np.int64)[:] = _ints(comm, 14, 4, np.int64)
    comm.barrier()
    pbuf, psize, punit = win.shared_query((comm.rank + 1) % comm.size)
    seen = pbuf.view(np.int64).copy()
    comm.barrier()
    win.free()
    return seen, psize, punit


def rma_sync_errors(comm, lib):
    buf = np.zeros(2, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    codes = [_code(lambda: win.put(np.array([1], np.int64), 0, 0)),
             _code(lambda: win.unlock(1)), _code(lambda: win.complete())]
    win.fence()
    win.free()
    return codes


def self_rma(comm, lib):
    buf = np.zeros(4, np.int64)
    win = comm.win_create(buf, disp_unit=8)
    win.fence()
    win.put(_ints(comm, 15, 4, np.int64), comm.rank, 0)
    win.fence()
    out = np.zeros(4, np.int64)
    win.get(out, comm.rank, 0)
    win.fence()
    win.free()
    return buf, out


RMA_CASES = {
    "put_fence": (N, put_fence),
    "get_fence": (N, get_fence),
    "accumulate_sum_fence": (N, accumulate_sum_fence),
    "accumulate_replace_and_disp": (N, accumulate_replace_and_disp),
    "get_accumulate_and_fetch_op": (N, get_accumulate_and_fetch_op),
    "compare_and_swap": (N, compare_and_swap),
    "lock_exclusive_counter": (N, lock_exclusive_counter),
    "pscw": (N, pscw),
    "win_allocate_and_flush": (N, win_allocate_and_flush),
    "dynamic_window": (N, dynamic_window),
    "derived_datatype_put": (N, derived_datatype_put),
    "rget_rput_requests": (N, rget_rput_requests),
    "shared_window": (N, shared_window),
    "rma_sync_errors": (2, rma_sync_errors),
    "self_rma": (2, self_rma),
}


def _model(case, n):
    """What each case must give, from the same seeded inputs."""
    def ints(seed, r, k, dt):
        return np.random.default_rng(seed + r).integers(
            -1000, 1000, k).astype(dt)
    left = lambda r: (r - 1) % n      # noqa: E731
    if case == "put_fence":
        return [ints(2, left(r), 8, np.int64) for r in range(n)]
    if case == "get_fence":
        return [np.random.default_rng(3 + (r + 1) % n).standard_normal(16)
                for r in range(n)]
    if case == "accumulate_sum_fence":
        acc = ints(4, 0, 4, np.int64) + sum(ints(5, r, 4, np.int64)
                                           for r in range(n))
        return [acc] + [ints(4, r, 4, np.int64) for r in range(1, n)]
    if case == "accumulate_replace_and_disp":
        row = np.zeros(8, np.int32)
        row[:n] = [ints(6, r, 1, np.int32)[0] for r in range(n)]
        return [row] * n
    if case == "get_accumulate_and_fetch_op":
        mx = np.maximum.reduce([np.maximum(ints(7, r, 2, np.int64), 0)
                                for r in range(n)])
        return [(np.arange(n), n if r == 0 else 0, mx) for r in range(n)]
    if case == "compare_and_swap":
        return [(1, True)] * n
    if case == "lock_exclusive_counter":
        return [np.array([5 * n if r == 0 else 0]) for r in range(n)]
    if case == "pscw":
        return [ints(8, r - 1, 4, np.int64) if r % 2 else np.zeros(4)
                for r in range(n)]
    if case == "win_allocate_and_flush":
        rows = []
        for r in range(n):
            row = np.zeros(8, np.int64)
            row[2] = ints(9, left(r), 1, np.int64)[0]
            rows.append(row)
        return rows
    if case == "dynamic_window":
        return [np.random.default_rng(10 + left(r)).standard_normal(8)
                .astype(np.float32) for r in range(n)]
    if case == "derived_datatype_put":
        row = np.zeros(16, np.int32)
        row[0:8:2] = ints(11, 0, 4, np.int32)
        return [row] * n
    if case == "rget_rput_requests":
        out = []
        for r in range(n):
            b = ints(12, r, 4, np.int64)
            b[2:] = ints(13, left(r), 2, np.int64)
            out.append((ints(12, (r + 1) % n, 4, np.int64), b))
        return out
    if case == "shared_window":
        return [(ints(14, (r + 1) % n, 4, np.int64), 32, 8)
                for r in range(n)]
    if case == "self_rma":
        return [(ints(15, r, 4, np.int64),) * 2 for r in range(n)]
    return None


@pytest.mark.parametrize("case", list(RMA_CASES))
def test_rma_case_equals_jax(env, case):
    n, app = RMA_CASES[case]
    p = _both(n, app)
    want = _model(case, n)
    if case == "rma_sync_errors":
        from mvapich2_tpu_torch.core import errors as e
        assert p == [[e.MPI_ERR_RMA_SYNC] * 3] * n
        return
    for got, w in zip(p, want):
        if isinstance(w, tuple):
            for a, b in zip(got, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, w)


# ---------------------------------------------------------------------------
# threads, the asynchronous drain, keyvals
# ---------------------------------------------------------------------------

def test_multithreaded_rma(env):
    """Three threads a rank, each on its own window, lock, fetch_and_op
    and unlock rank 0's counter ten times (tests/test_threads.py)."""
    T = 3

    def app(comm, lib):
        wins = [comm.win_allocate(8 if comm.rank == 0 else 0)
                for _ in range(T)]
        comm.barrier()
        errs = []

        def worker(tid):
            try:
                old = np.zeros(1, np.int64)
                for _ in range(10):
                    wins[tid].lock(0, lib.win.LOCK_EXCLUSIVE)
                    wins[tid].fetch_and_op(np.array([1], np.int64), old, 0,
                                           0, op=lib.op.SUM)
                    wins[tid].unlock(0)
            except BaseException as e:   # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        comm.barrier()
        totals = [int(np.frombuffer(bytes(w.base[:8]), np.int64)[0])
                  if comm.rank == 0 else 0 for w in wins]
        comm.barrier()
        for w in wins:
            w.free()
        return totals

    p = _both(3, app)
    assert p[0] == [30, 30, 30]


def test_passive_target_progresses_while_it_sleeps(env):
    """The last rank sleeps outside MPI while every other rank locks,
    puts and unlocks on it: each unlock returns before it wakes, in both
    packages, and the window holds every put."""
    def app(comm, lib):
        win = comm.win_allocate(8 * comm.size, disp_unit=8)
        comm.barrier()
        tgt = comm.size - 1
        took = 0.0
        if comm.rank == tgt:
            time.sleep(SLEEP)
        else:
            t0 = time.perf_counter()
            win.lock(tgt, lib.win.LOCK_EXCLUSIVE)
            win.put(_ints(comm, 16, 1, np.int64), tgt, comm.rank)
            win.unlock(tgt)
            took = time.perf_counter() - t0
        comm.barrier()
        seen = win.base.view(np.int64).copy()
        win.free()
        return seen, took < SLEEP

    p = _both(N, app)
    assert all(ok for _, ok in p)
    want = np.zeros(N, np.int64)
    want[:N - 1] = [np.random.default_rng(16 + r).integers(-1000, 1000, 1)[0]
                    for r in range(N - 1)]
    np.testing.assert_array_equal(p[N - 1][0], want)


def test_two_ranks_lock_each_other_at_once(env):
    """Both ranks lock, get from, put to and unlock the other at once,
    so each one's handlers answer the other while it waits on its own
    epoch (the inline drain's re-entrancy and lock order)."""
    def app(comm, lib):
        w = comm.win_allocate(64, disp_unit=8)
        w.base.view(np.int64)[:] = _ints(comm, 17, 8, np.int64)
        comm.barrier()
        other = 1 - comm.rank
        got = np.zeros(2, np.int64)
        for i in range(200):
            w.lock(other, lib.win.LOCK_EXCLUSIVE)
            w.get(got, other, 2 * (i % 3))
            w.put(got, other, 6)
            w.unlock(other)
        comm.barrier()
        seen = w.base.view(np.int64).copy()
        w.free()
        return got, seen

    p = _both(2, app)
    for r, (got, seen) in enumerate(p):
        mine = np.random.default_rng(17 + r).integers(-1000, 1000, 8)
        np.testing.assert_array_equal(seen[:6], mine[:6])


def test_window_keyval_delete_fires_on_free(env):
    """A keyval's delete_fn runs on free with the window still whole (it
    sees the value, the extra state and the window's name)."""
    def app(comm, lib):
        seen = []
        kv = lib.attr.Keyval(delete_fn=lambda obj, k, val, extra: seen.append(
            (obj.get_name(), obj.freed, val, extra)), extra="x")
        win = comm.win_allocate(16)
        win.set_name("w")
        win.attrs.set(win, kv, comm.rank * 10)
        win.free()
        return seen

    p = _both(2, app)
    assert p == [[("w", False, 0, "x")], [("w", False, 10, "x")]]


# ---------------------------------------------------------------------------
# what the port alone does
# ---------------------------------------------------------------------------

def _card(n, dtype=torch.int64):
    """A tensor that does not lie on the CPU: the meta device stands in
    for the card (as ``tests/test_torch_intercomm.py`` ``_card``)."""
    return torch.empty(n, dtype=dtype, device="meta")


def test_cpu_tensor_is_the_window_memory():
    """A CPU tensor given to win_create is the window: a remote put shows
    in the tensor; CPU tensors serve as origin and result buffers."""
    def app(comm):
        t = torch.zeros(4, dtype=torch.int64)
        win = comm.win_create(t, disp_unit=8)
        win.fence()
        win.put(torch.full((4,), comm.rank + 5, dtype=torch.int64),
                (comm.rank + 1) % comm.size, 0)
        win.fence()
        got = torch.zeros(4, dtype=torch.int64)
        win.get(got, (comm.rank + 1) % comm.size, 0)
        win.fence()
        old = torch.zeros(1, dtype=torch.int64)
        win.lock(0, port_win.LOCK_EXCLUSIVE)
        win.fetch_and_op(torch.ones(1, dtype=torch.int64), old, 0, 3)
        win.unlock(0)
        comm.barrier()
        out = (t.clone(), got.clone(), int(old[0]))
        win.free()
        return out

    res = run_ranks(N, app, device="cpu", timeout=TIMEOUT)
    # rank N - 1 put N + 4 into rank 0, then every rank added one
    assert sorted(o for _, _, o in res) == [N + 4 + k for k in range(N)]
    for r, (t, got, _) in enumerate(res):
        want = torch.full((4,), (r - 1) % N + 5, dtype=torch.int64)
        if r == 0:
            want[3] = 2 * N + 4
        assert torch.equal(t, want), (r, t)
        assert torch.equal(got, torch.full((4,), r + 5, dtype=torch.int64))


def test_card_tensors_are_refused_with_no_packet(monkeypatch):
    sent = []           # the thread that sent each window packet
    real = port_win.RmaManager.send_to
    monkeypatch.setattr(port_win.RmaManager, "send_to",
                        lambda self, d, pkt: (sent.append(
                            threading.get_ident()), real(self, d, pkt)))

    def app(comm):
        refused = []

        def refuse(fn):
            try:
                fn()
            except NotImplementedError as e:
                assert "DeviceWin" in str(e)
                refused.append(True)

        refuse(lambda: comm.win_create(_card(8)))      # no rank blocks
        win = comm.win_create(np.zeros(4, np.int64), disp_unit=8)
        dyn = comm.win_create_dynamic()
        refuse(lambda: dyn.attach(_card(4)))
        t = (comm.rank + 1) % comm.size
        win.lock(t, port_win.LOCK_SHARED)
        me = threading.get_ident()
        before = sent.count(me)
        refuse(lambda: win.put(_card(4), t, 0))
        refuse(lambda: win.get(_card(4), t, 0))
        refuse(lambda: win.accumulate(_card(4), t, 0))
        refuse(lambda: win.fetch_and_op(np.ones(1, np.int64), _card(1), t))
        refuse(lambda: win.compare_and_swap(
            np.ones(1, np.int64), _card(1), np.zeros(1, np.int64), t))
        quiet = sent.count(me) == before
        win.unlock(t)
        comm.barrier()
        dyn.free()
        win.free()
        return len(refused), quiet

    assert run_ranks(N, app, device="cpu", timeout=TIMEOUT) == [(7, True)] * N
