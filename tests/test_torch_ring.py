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
ring schedule, so even normal f32 data folds in the kernels' order."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mvapich2_tpu.ops import pallas_ring
from mvapich2_tpu.parallel import MeshComm, make_mesh as jax_make_mesh
from mvapich2_tpu_torch.ops import ring

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
    raise ValueError(kind)


@pytest.mark.parametrize("shard,kind", [
    (8, "intf32"),        # one element per block
    (64, "normal"),       # normal data: bitwise too, same fold order
    (40, "int32"),        # int32 sums wrap as the JAX kernel's do
])
def test_ring_all_reduce_parity(comm8, creditless, shard, kind):
    xv = _data(40 + shard, (NP, shard), kind)
    want = comm8.run(lambda s: pallas_ring.ring_all_reduce(
        s, "x", NP, interpret=True), jnp.asarray(xv.reshape(-1)))
    want = np.asarray(want).reshape(NP, shard)
    ring.reset_counts()
    got = ring.ring_all_reduce(torch.from_numpy(xv))
    assert ring.PLAIN_CALLS["ring_all_reduce"] == 1
    assert ring.LAUNCHES["ring_all_reduce"] == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shard,kind", [(5, "intf32"), (16, "normal"),
                                        (3, "int32")])
def test_ring_all_gather_parity(comm8, creditless, shard, kind):
    xv = _data(50 + shard, (NP, shard), kind)
    want = comm8.run(lambda s: pallas_ring.ring_all_gather(
        s, "x", NP, interpret=True), jnp.asarray(xv.reshape(-1)),
        out_specs=P("x"))
    want = np.asarray(want).reshape(NP, NP * shard)
    ring.reset_counts()
    got = ring.ring_all_gather([torch.from_numpy(r) for r in xv])
    assert ring.PLAIN_CALLS["ring_all_gather"] == 1
    np.testing.assert_array_equal(got.numpy(), want)


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
