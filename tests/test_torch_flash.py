"""Parity of the port's flash kernels' plain versions
(mvapich2_tpu_torch/models/flash.py: K15 flash_attention, K16
flash_attention_parts, which a CPU tensor routes to) with the JAX
package's models/flash.py, whose Pallas kernels run in interpret mode.
Both sides get the same seeded numpy q, k and v (this path has no
parameters).

Cases: causal and full attention; the q0/k0 offsets, with a key block
wholly in the queries' future (out 0; m = NEG_INF, num = den = 0) and
one wholly in their past; ragged offsets; lengths whose blocks shrink by
gcd (T = 96 with block_q = 64); f32, f16 and bf16 inputs.

Tolerances: rtol 2e-4 / atol 2e-5 on f32 outputs (the JAX tests' own
bound for flash against dense attention): the plain version's matrix
products sum in another order than the interpreter's, so f32 sums
differ in their last bits. A bf16 or f16 output may then round the
other way: one ulp of the output's dtype.

The CUDA kernel runs both products on the tensor cores in split TF32
(three TF32 products a multiply-add). A numpy model of the streaming
loop in that arithmetic stays within the same tolerance of the JAX
kernel, and the same model with one TF32 product does not: the premise
of the kernel's design, pinned here; the card holds the kernel
itself."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mvapich2_tpu.models import flash as jflash
from mvapich2_tpu.models.ring_attention import NEG_INF as J_NEG_INF
from mvapich2_tpu_torch import make_mesh
from mvapich2_tpu_torch.bench import flash_ablation
from mvapich2_tpu_torch.models import flash
from mvapich2_tpu_torch.models.ring_attention import NEG_INF
from mvapich2_tpu_torch.ops import _build

RTOL, ATOL = 2e-4, 2e-5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "f16": (jnp.float16, torch.float16),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, T, Tk, H, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, H, D)).astype(np.float32),
            rng.standard_normal((Tk, H, D)).astype(np.float32),
            rng.standard_normal((Tk, H, D)).astype(np.float32))


def _both(arrays, dt):
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(got, want, dt="f32"):
    """f32: RTOL/ATOL; a 16-bit output: within one ulp of its dtype."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    if dt == "f32":
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        return
    # spacing of the 16-bit type at |want|: f32's spacing shifted by the
    # mantissa bits the type lacks (23 - 7 for bf16, 23 - 10 for f16)
    shift = {"bf16": 16, "f16": 13}[dt]
    tiny = np.float32(2.0 ** -14)
    ulp = np.spacing(np.maximum(np.abs(w), tiny)) * np.float32(2 ** shift)
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


# (seed, T, Tk, H, D, causal, q0, k0, block_q, block_k)
K15_CASES = [
    (7, 256, 256, 4, 64, True, 0, 0, 64, 64),       # causal
    (7, 256, 256, 4, 64, False, 0, 0, 64, 64),      # full
    (8, 128, 128, 2, 32, True, 0, 128, 64, 64),     # wholly future
    (8, 128, 128, 2, 32, True, 128, 0, 64, 64),     # wholly past
    (9, 96, 96, 2, 32, True, 0, 0, 64, 64),         # gcd: 32 x 32 blocks
    (10, 96, 160, 2, 32, True, 40, 7, 64, 48),      # ragged offsets, gcd
    (11, 64, 128, 2, 16, True, 0, 1, 64, 64),       # a row with no key
]


@pytest.mark.parametrize("case", K15_CASES, ids=lambda c: "-".join(
    map(str, c[1:])))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matches_jax(case, dt):
    seed, T, Tk, H, D, causal, q0, k0, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(seed, T, Tk, H, D), dt)
    want = jflash.flash_attention(jq, jk, jv, causal=causal, q0=q0, k0=k0,
                                  block_q=bq, block_k=bk, interpret=True)
    flash.reset_counts()
    got = flash.flash_attention(tq, tk, tv, causal=causal, q0=q0, k0=k0,
                                block_q=bq, block_k=bk)
    assert got.dtype == DTYPES[dt][1] and got.shape == (T, H, D)
    assert flash.PLAIN_CALLS["flash_attention"] == 1
    assert flash.LAUNCHES["flash_attention"] == 0
    assert_close(got, want, dt)
    if q0 == 0 and k0 == T:
        assert not got.float().any()                # wholly future: 0


def test_flash_attention_f16_and_batch():
    """f16 inputs give an f16 output; a leading batch dim is a batch of
    independent ranks, each the unbatched call's result bitwise."""
    arrays = _inputs(12, 128, 128, 2, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "f16")
    want = jflash.flash_attention(jq, jk, jv, causal=True, block_q=32,
                                  block_k=64, interpret=True)
    got = flash.flash_attention(tq, tk, tv, causal=True, block_q=32,
                                block_k=64)
    assert got.dtype == torch.float16
    assert_close(got, want, "f16")
    q, k, v = (torch.from_numpy(a) for a in arrays)
    qs, ks, vs = (torch.stack([x, x.flip(0)]) for x in (q, k, v))
    both = flash.flash_attention(qs, ks, vs, True, 3, 0, 32, 32)
    for i, (a, b, c) in enumerate(zip(qs, ks, vs)):
        assert torch.equal(both[i], flash.flash_attention(a, b, c, True, 3,
                                                          0, 32, 32))


# (seed, T, Tk, H, D, causal, block_q, block_k)
K16_CASES = [
    (20, 128, 128, 2, 32, True, 64, 64),       # the diagonal ring step
    (21, 128, 128, 2, 32, False, 64, 64),      # a past block
    (22, 96, 96, 2, 32, True, 64, 64),         # gcd
    (23, 64, 96, 2, 32, True, 16, 32),         # Tk > T, small blocks
]


@pytest.mark.parametrize("case", K16_CASES, ids=lambda c: "-".join(
    map(str, c[1:])))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_parts_matches_jax(case, dt):
    seed, T, Tk, H, D, causal, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(seed, T, Tk, H, D), dt)
    want = jflash.flash_attention_parts(jq, jk, jv, causal, bq, bk,
                                        interpret=True)
    flash.reset_counts()
    got = flash.flash_attention_parts(tq, tk, tv, causal, bq, bk)
    assert flash.PLAIN_CALLS["flash_attention_parts"] == 1
    assert flash.LAUNCHES["flash_attention_parts"] == 0
    for g, w, shape in zip(got, want, ((H, T), (T, H, D), (H, T))):
        assert g.dtype == torch.float32 and g.shape == shape
        assert_close(g, w)          # f32 parts whatever the input dtype


def test_parts_of_a_future_and_a_past_block():
    """The shared streaming core with the ring's offsets: a block wholly
    in the future leaves the parts at (NEG_INF, 0, 0) exactly, the
    constants the JAX ring merges for it; a wholly-past block equals the
    unmasked parts."""
    assert NEG_INF == J_NEG_INF
    q, k, v = (torch.from_numpy(a)[None] for a in
               _inputs(24, 128, 128, 2, 32))
    m, num, den = flash._stream_ref(q, k, v, True, 0, 128, 64, 64)
    assert torch.all(m == NEG_INF) and not num.any() and not den.any()
    past = flash._stream_ref(q, k, v, True, 128, 0, 64, 64)
    full = flash._stream_ref(q, k, v, False, 0, 0, 64, 64)
    for a, b in zip(past, full):
        assert torch.equal(a, b)


def test_causal_tile_walk_is_a_floor_division():
    """(last_q - k0) // Bk + 1 floors: a query tile that ends one
    position before the key block walks no key tile (C's truncating
    division would walk one)."""
    assert flash._nk_eff(True, 0, 64, 1, 1, 64, 64) == [0]
    assert flash._nk_eff(True, 0, 0, 2, 2, 64, 64) == [1, 2]
    assert flash._nk_eff(True, 128, 0, 2, 2, 64, 64) == [2, 2]
    assert flash._nk_eff(False, 0, 999, 2, 3, 64, 64) == [3, 3]


@pytest.mark.parametrize("T,Tk,bq,bk", [
    (256, 256, 128, 128), (96, 96, 64, 64), (96, 160, 64, 48),
    (100, 37, 128, 128), (4096, 4096, 128, 128), (48, 80, 32, 16)])
def test_block_sizes_match_jax(T, Tk, bq, bk):
    assert flash._block_sizes(T, Tk, bq, bk) == \
        jflash._block_sizes(T, Tk, bq, bk)


# ---------------------------------------------------------------------------
# the kernel's arithmetic: split TF32 products meet the f32 tolerance
# ---------------------------------------------------------------------------

def _tf32(x):
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, split):
    """``a @ b`` as the tensor cores take f32 operands: one TF32 product,
    or split TF32 (x = big + small, both TF32; three products, the two
    small ones first), the products exact and summed in f32."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    return (_tf32(a - ab) @ bb + ab @ _tf32(b - bb)) + ab @ bb


def _stream_model(q, k, v, causal, q0, k0, bq, bk, split):
    """numpy model of the JAX kernel's streaming loop (``_stream_blocks``,
    K15's normalisation) over [T, H, D] f32 inputs, in f32, with both
    products taken by ``_tf32_matmul``."""
    T, H, D = q.shape
    Tk = k.shape[0]
    neg = np.float32(NEG_INF)
    scale = np.float32(D ** -0.5)
    out = np.zeros((T, H, D), np.float32)
    nk = Tk // bk
    for h in range(H):
        for qi in range(T // bq):
            qq = q[qi * bq:(qi + 1) * bq, h] * scale
            qpos = q0 + qi * bq + np.arange(bq)[:, None]
            m = np.full(bq, neg, np.float32)
            num = np.zeros((bq, D), np.float32)
            den = np.zeros(bq, np.float32)
            for kt in range(flash._nk_eff(causal, q0, k0, T // bq, nk, bq,
                                          bk)[qi]):
                s = _tf32_matmul(qq, k[kt * bk:(kt + 1) * bk, h].T, split)
                if causal:
                    s = np.where(qpos >= k0 + kt * bk + np.arange(bk), s, neg)
                new_m = np.maximum(m, s.max(1))
                safe = np.where(new_m > neg / 2, new_m, np.float32(0))
                p = np.where(s > neg / 2, np.exp(s - safe[:, None]),
                             np.float32(0))
                alpha = np.where(m > neg / 2, np.exp(m - safe),
                                 np.float32(0))
                num = num * alpha[:, None] + _tf32_matmul(
                    p, v[kt * bk:(kt + 1) * bk, h], split)
                den = den * alpha + p.sum(1)
                m = new_m
            out[qi * bq:(qi + 1) * bq, h] = \
                num / np.maximum(den, np.float32(1e-20))[:, None]
    return out


TF32_CASES = K15_CASES[:2]              # causal and full, f32


def _tf32_case(case, split):
    seed, T, Tk, H, D, causal, q0, k0, bq, bk = case
    arrays = _inputs(seed, T, Tk, H, D)
    want = jflash.flash_attention(*(jnp.asarray(a) for a in arrays),
                                  causal=causal, q0=q0, k0=k0, block_q=bq,
                                  block_k=bk, interpret=True)
    bq, bk = flash._block_sizes(T, Tk, bq, bk)
    return (_stream_model(*arrays, causal, q0, k0, bq, bk, split),
            np.asarray(want))


@pytest.mark.parametrize("case", TF32_CASES, ids=lambda c: "-".join(
    map(str, c[1:])))
def test_split_tf32_products_meet_the_f32_tolerance(case):
    """The CUDA kernel's arithmetic, modelled: with both products in
    split TF32 the streaming loop stays within RTOL/ATOL of the JAX
    kernel (f32 products) in interpret mode."""
    got, want = _tf32_case(case, split=True)
    assert_close(got, want)


def test_one_tf32_product_misses_the_f32_tolerance():
    """The same model with one TF32 product a multiply-add falls outside
    RTOL/ATOL, so the tolerance tells the split form from it."""
    outside = []
    for case in TF32_CASES:
        got, want = _tf32_case(case, split=False)
        outside.append(not np.allclose(got, want, rtol=RTOL, atol=ATOL))
    assert any(outside)


@pytest.mark.parametrize("name", sorted(flash_ablation.EDITS))
def test_ablation_edits_fit_the_kernel(name):
    """Each variant of the ablation bench applies to csrc/flash.cu as it
    stands (every anchor once) and keeps its f32 instance at head width
    128 alone; every variant but the kernel itself differs from it."""
    src = flash_ablation.variant_source(name)
    assert "launch<T, 128>" in src and "launch<T, 64>" not in src
    assert "launch_d<float>" in src and "launch_d<__half>" not in src
    assert (src == flash_ablation.variant_source("kernel")) == \
        (name == "kernel")


def test_cuda_request_without_a_card_raises(monkeypatch):
    """A tensor that is not on the CPU never takes the plain route, and
    without a card the kernel's build raises."""
    q = torch.empty((64, 2, 32), device="meta")
    flash.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_parts(q, q, q, True)
    assert flash.PLAIN_CALLS == {"flash_attention": 0,
                                 "flash_attention_parts": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load("flash")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((8,), ("sp",), "cuda:0")


def test_kernel_inputs_are_16_byte_aligned():
    """The kernel reads vectors: the wrapper hands it contiguous tensors
    whose data starts on a 16-byte boundary, copying any that does not,
    and leaves an aligned contiguous tensor as it is."""
    buf = torch.arange(2 * 64 * 2 * 32 + 1, dtype=torch.float32)
    shifted = buf[1:].view(2, 64, 2, 32)
    assert shifted.data_ptr() % 16
    aligned, same = flash._aligned(shifted, buf[:-1].view(2, 64, 2, 32))
    assert aligned.data_ptr() % 16 == 0 and aligned.is_contiguous()
    assert torch.equal(aligned, shifted)
    assert same.data_ptr() == buf.data_ptr()


def test_shape_checks():
    q = torch.zeros(64, 2, 32)
    with pytest.raises(ValueError):
        flash.flash_attention(q, torch.zeros(64, 4, 32), torch.zeros(64, 4,
                                                                     32))
    with pytest.raises(ValueError):
        flash.flash_attention(q[None], q, q)
    with pytest.raises(ValueError):
        flash.flash_attention(q[:0], q, q)
