#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mvapich2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out report.json]

Needs one CUDA card of compute capability 9.0 (Hopper) and nvcc; exits
non-zero, printing no result, without them. Phases:

1. device: the card's name, and its name and power limit as nvidia-smi
   prints them;
2. build: the CUDA kernels, compiled from mvapich2_tpu_torch/csrc;
3. kernels: each kernel held against its plain PyTorch version on the
   card (bitwise on integer data, within stated tolerances otherwise),
   at small, ragged and full size;
4. main path: 8 ranks (run_ranks) allreduce 64 MiB f32 tensors each on
   cuda:0 through the slot channel into K1, plus the small collectives,
   then the one-chip bench candidates (K1 and K2) at the same size; the
   kernels' launch counts are zeroed before it and read after;
5. times, by CUDA events: each kernel beside its bound, its plain
   version and the library call; the staging stack; the end-to-end
   allreduce latency and effective bandwidth (2*R*m/t).

The line before the last is a JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}. Any failure raises.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

R = 8                              # ranks sharing the card
N = 64 * 1024 * 1024 // 4          # f32 elements per rank (64 MiB)
M_FULL = N // 128
M_SMALL = 16
SEED = 1234
F32_TOL = dict(rtol=2e-5, atol=1e-4)   # the JAX tests' own: summation order differs
HALF_TOL = dict(rtol=1e-2, atol=1e-2)  # 16-bit floats: one rounding of an f32 sum
# published dense peak of one H100 SXM in float32 outside the tensor
# cores (TFLOP/s); the reductions here are far below it
F32_PEAK_TFLOPS = 67.0


def log(msg):
    print(msg, flush=True)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"[device] torch: {name}; devices: {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    log(smi)
    return name, smi


def phase_build(_build):
    t0 = time.perf_counter()
    _build.load("hbm_slot")
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.BUILD_LOGS.get("hbm_slot", "")
            .splitlines() if "registers" in ln]
    log(f"[build] hbm_slot.cu built and loaded in {dt:.2f} s "
        f"({len(regs)} kernel instantiations; ptxas e.g.: "
        f"{regs[0] if regs else 'n/a'})")
    return dt


def _data(torch, np, rng, shape, kind, dev):
    if kind == "f32int":
        a = rng.integers(-1000, 1000, size=shape).astype(np.float32)
    elif kind == "i32":
        a = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    elif kind in ("i16", "i8", "u8"):
        dt = {"i16": np.int16, "i8": np.int8, "u8": np.uint8}[kind]
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, size=shape,
                         endpoint=True).astype(dt)
    else:
        a = rng.standard_normal(size=shape, dtype=np.float32)
    t = torch.from_numpy(a).to(dev)
    if kind == "bf16":
        t = t.to(torch.bfloat16)
    elif kind == "f16":
        t = t.to(torch.float16)
    return t


def _compare(torch, what, got, want, kind):
    """Assert agreement; return the max absolute error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    err = (got.double() - want.double()).abs().max().item() \
        if got.numel() else 0.0
    if kind in ("f32int", "i32", "i16", "i8", "u8"):
        ok = torch.equal(got, want)
    elif kind == "f32":
        ok = torch.allclose(got, want, **F32_TOL)
    else:
        ok = torch.allclose(got.float(), want.float(), **HALF_TOL)
    if not ok:
        raise AssertionError(f"{what}: kernel and plain version disagree "
                             f"(kind {kind}, max abs err {err})")
    return err


def phase_kernels(torch, np, hbm, dev):
    """Each kernel against its plain version; returns the max abs error
    of the full-size f32 checks per kernel."""
    rng = np.random.default_rng(SEED)
    n_checks = 0
    full_err = {"K1": 0.0, "K2": 0.0}
    # R=5: the mean scale 1/5 is inexact, so a kernel that divided by R
    # instead of multiplying by float(1/R) would differ from the plain one
    for rr, M in ((R, M_SMALL), (5, M_SMALL), (R, M_FULL)):
        kinds = (["f32int", "i32", "f32", "bf16"] if M == M_SMALL
                 else ["f32int", "f32"])
        for layout in ("planar", "interleaved"):
            shape = (rr, M, 128) if layout == "planar" else (M, rr, 128)
            for kind in kinds:
                x = _data(torch, np, rng, shape, kind, dev)
                for mean in (False, True):
                    got = hbm.fused_reduce_to_slot(x, layout=layout,
                                                   mean=mean)
                    want = hbm.fused_reduce_to_slot_ref(x, layout=layout,
                                                        mean=mean)
                    err = _compare(torch, f"K1 {layout} R={rr} M={M} "
                                   f"{kind} mean={mean}", got, want, kind)
                    n_checks += 1
                    if M == M_FULL and kind == "f32" and not mean \
                            and layout == "planar":
                        full_err["K1"] = err
                del x
        for kind in kinds:
            x = _data(torch, np, rng, (M, rr, 128), kind, dev)
            for mean in (False, True):
                for donate in (False, True):
                    want = hbm.fused_allreduce_ref(x, mean=mean)
                    xin = x.clone() if donate else x
                    got = hbm.fused_allreduce(xin, mean=mean, donate=donate)
                    if donate and got.data_ptr() != xin.data_ptr():
                        raise AssertionError("K2 donate did not write in "
                                             "place")
                    err = _compare(torch, f"K2 R={rr} M={M} {kind} "
                                   f"mean={mean} donate={donate}", got, want,
                                   kind)
                    n_checks += 1
                    if M == M_FULL and kind == "f32" and not mean \
                            and not donate:
                        full_err["K2"] = err
            del x
    # the other kernel dtypes, small
    for kind in ("f16", "i16", "i8", "u8"):
        x = _data(torch, np, rng, (R, M_SMALL, 128), kind, dev)
        _compare(torch, f"K1 planar {kind}", hbm.fused_reduce_to_slot(x),
                 hbm.fused_reduce_to_slot_ref(x), kind)
        xi = hbm.pack_interleaved(x.reshape(R, -1))
        _compare(torch, f"K2 {kind}", hbm.fused_allreduce(xi),
                 hbm.fused_allreduce_ref(xi), kind)
        n_checks += 2
    # ragged n through hbm_slot_allreduce: the pad must not leak
    for rr, n in ((3, 1000), (R, 100003)):
        b = _data(torch, np, rng, (rr, n), "f32int", dev)
        _compare(torch, f"hbm_slot_allreduce R={rr} n={n}",
                 hbm.hbm_slot_allreduce(b), b.sum(0), "f32int")
        n_checks += 1
    torch.cuda.synchronize()
    log(f"[kernels] {n_checks} kernel-vs-plain checks passed "
        f"(full-size f32 max abs err: K1 {full_err['K1']:.3g}, "
        f"K2 {full_err['K2']:.3g})")
    return full_err


def phase_main_path(torch, np, mvt, hbm, opmod, dev):
    """The port's main path: run_ranks(8) on cuda:0, 64 MiB f32
    allreduces through the slot channel into K1, the small collectives,
    then the one-chip bench candidates. Returns (launch counts, e2e
    latencies in s)."""
    inputs = [torch.from_numpy(np.random.default_rng(SEED + r)
                               .standard_normal(N, dtype=np.float32))
              .to(dev) for r in range(R)]
    want = hbm.fused_reduce_to_slot_ref(
        torch.stack(inputs).reshape(R, M_FULL, 128)).reshape(N)
    torch.cuda.synchronize()
    n_check, n_warm, n_timed = 3, 2, 10
    small = 1024

    def app(comm):
        me = inputs[comm.rank]
        outs = [comm.allreduce(me) for _ in range(n_check)]
        for _ in range(n_warm):
            comm.allreduce(me)
        lat = []
        stream = torch.cuda.current_stream()
        for _ in range(n_timed):
            t0 = time.perf_counter()
            comm.allreduce(me)
            stream.synchronize()
            lat.append(time.perf_counter() - t0)
        p, r = comm.size, comm.rank
        base = torch.arange(small, dtype=torch.float32, device=dev)
        # the same call at 4 KiB: the harness's own cost per collective
        lat_small = []
        for _ in range(n_warm + n_timed):
            t0 = time.perf_counter()
            comm.allreduce(base)
            stream.synchronize()
            lat_small.append(time.perf_counter() - t0)
        # max: the stock reduction, no K1
        mx = comm.allreduce(base + r, op=opmod.MAX)
        # reduce (sum, K1) to root 3, numpy buffers (device-to-host out)
        red = comm.reduce((base + r).cpu().numpy(), root=3)
        # bcast from root 5
        b = comm.bcast(base * 3 if r == 5 else torch.zeros_like(base),
                       root=5)
        ag = comm.allgather(torch.full((7,), float(r), device=dev))
        a2a = comm.alltoall(torch.arange(p * 3, dtype=torch.float32,
                                         device=dev) + 100 * r)
        rsb = comm.reduce_scatter_block(
            torch.arange(p * 5, dtype=torch.float32, device=dev) + r)
        stream.synchronize()
        return outs, (lat, lat_small[n_warm:]), (mx, red, b, ag, a2a, rsb)

    hbm.reset_counts()
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slice_launches = dict(hbm.LAUNCHES)
    n_sum = n_check + 2 * (n_warm + n_timed) + 2   # + 4 KiB, reduce, rsb
    if slice_launches["fused_reduce_to_slot"] != n_sum:
        raise AssertionError(f"K1 launched {slice_launches} times in the "
                             f"slice; expected {n_sum} (one per sum "
                             f"collective)")
    # results: one shared tensor per call, equal to the plain reduction
    for i in range(n_check):
        got = [res[r][0][i] for r in range(R)]
        if not all(g is got[0] for g in got):
            raise AssertionError("allreduce results are not one shared "
                                 "tensor")
        if got[0].shape != (N,) or not torch.isfinite(got[0]).all():
            raise AssertionError("allreduce result has the wrong shape or "
                                 "non-finite values")
        err = _compare(torch, f"allreduce call {i}", got[0], want, "f32")
    a = np.arange(small, dtype=np.float32)
    for r in range(R):
        mx, red, b, ag, a2a, rsb = res[r][2]
        np.testing.assert_array_equal(mx.cpu().numpy(), a + R - 1)
        if r == 3:
            np.testing.assert_array_equal(red, a * R + sum(range(R)))
        np.testing.assert_array_equal(b.cpu().numpy(), a * 3)
        np.testing.assert_array_equal(
            ag.cpu().numpy(), np.repeat(np.arange(R, dtype=np.float32), 7))
        np.testing.assert_array_equal(a2a.cpu().numpy(), np.concatenate(
            [np.arange(r * 3, r * 3 + 3) + 100 * s for s in range(R)]))
        np.testing.assert_array_equal(
            rsb.cpu().numpy(),
            np.arange(r * 5, r * 5 + 5, dtype=np.float32) * R + sum(range(R)))
    lat = res[0][1]
    log(f"[main] run_ranks({R}) on {dev}: "
        f"{n_check + n_warm + n_timed} allreduces of 64 MiB f32, "
        f"{n_warm + n_timed} of 4 KiB, + max/reduce/bcast/allgather/alltoall/reduce_scatter_block "
        f"in {wall:.2f} s; results checked (max abs err {err:.3g}); "
        f"K1 launches {slice_launches['fused_reduce_to_slot']}")
    # the one-chip bench path: bench_candidates at 64 MiB x 8 ranks,
    # interleaved slots (the JAX package's bench.py p == 1 branch)
    x = hbm.pack_interleaved(torch.stack(inputs))
    n_bench = 3
    for name, op, traffic, chains in hbm.bench_candidates(M_FULL, R):
        y = x.clone() if chains else x
        for _ in range(n_bench):
            out = op(y)
            y = out if chains else y
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"bench candidate {name}: non-finite")
    launches = dict(hbm.LAUNCHES)
    if launches["fused_allreduce"] == 0:
        raise AssertionError("K2 never launched on the bench path")
    log(f"[main] bench candidates: {[c[0] for c in hbm.bench_candidates(M_FULL, R)]}"
        f" x{n_bench}; launches on the main path: {launches}")
    del x, want
    return launches, slice_launches, lat, inputs


def phase_times(torch, hbm, timing, info, inputs, lat, launches, full_err):
    bw = info.hbm_bw_gbps * 1e9
    if bw <= 0:
        raise RuntimeError(f"no memory bandwidth known for "
                           f"{info.device_kind!r}: cannot state a bound")
    m = N * 4
    x = torch.stack(inputs).reshape(R, M_FULL, 128)
    xi = hbm.pack_interleaved(torch.stack(inputs))

    def bound(nbytes, flops):
        tb, to = nbytes / bw * 1e3, flops / (F32_PEAK_TFLOPS * 1e12) * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    k1_ms = timing.time_ms(lambda: hbm.fused_reduce_to_slot(x))
    k1i_ms = timing.time_ms(
        lambda: hbm.fused_reduce_to_slot(xi, layout="interleaved"))
    k1_plain = timing.time_ms(lambda: hbm.fused_reduce_to_slot_ref(x))
    k1_lib = timing.time_ms(lambda: torch.sum(x, 0))
    k2_ms = timing.time_ms(lambda: hbm.fused_allreduce(xi))
    k2_plain = timing.time_ms(lambda: hbm.fused_allreduce_ref(xi))
    k2_two_call = timing.time_ms(
        lambda: xi.sum(1, keepdim=True).expand_as(xi).contiguous())
    stack_ms = timing.time_ms(lambda: torch.stack(inputs))
    k1_b, k1_by = bound((R + 1) * m, (R - 1) * N)
    k2_b, k2_by = bound(2 * R * m, (R - 1) * N)
    e2e = statistics.median(lat[0])
    e2e_small = statistics.median(lat[1])
    kernels = [
        {"name": "fused_reduce_to_slot", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/hbm_slot.cu",
         "replaces": "mvapich2_tpu/ops/pallas_hbm.py:78",
         "launches": launches["fused_reduce_to_slot"],
         "max_abs_err": full_err["K1"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_b, "bound_by": k1_by, "library_ms": k1_lib},
        {"name": "fused_allreduce", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/hbm_slot.cu",
         "replaces": "mvapich2_tpu/ops/pallas_hbm.py:124",
         "launches": launches["fused_allreduce"],
         "max_abs_err": full_err["K2"], "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_b, "bound_by": k2_by, "library_ms": None},
    ]
    extra = {"k1_interleaved_ms": k1i_ms, "k2_two_call_ms": k2_two_call,
             "stack_ms": stack_ms, "e2e_allreduce_ms": e2e * 1e3,
             "e2e_allreduce_ms_all": [t * 1e3 for t in lat[0]],
             "e2e_small_allreduce_ms": e2e_small * 1e3,
             "e2e_small_allreduce_ms_all": [t * 1e3 for t in lat[1]],
             "device_share_of_e2e": (stack_ms + k1_ms) / (e2e * 1e3),
             "e2e_effbw_GBps": 2 * R * m / e2e / 1e9,
             "k1_actual_GBps": (R + 1) * m / (k1_ms * 1e-3) / 1e9,
             "k2_actual_GBps": 2 * R * m / (k2_ms * 1e-3) / 1e9,
             "hbm_bw_GBps": info.hbm_bw_gbps}
    log(f"[times] K1 planar {k1_ms:.4f} ms (interleaved {k1i_ms:.4f}; bound "
        f"{k1_b:.4f}, plain {k1_plain:.4f}, torch.sum {k1_lib:.4f}); "
        f"K2 {k2_ms:.4f} ms (bound {k2_b:.4f}, plain {k2_plain:.4f}, "
        f"two-call sum+expand {k2_two_call:.4f}); stack {stack_ms:.4f} ms; "
        f"e2e allreduce {e2e * 1e3:.4f} ms = "
        f"{extra['e2e_effbw_GBps']:.1f} GB/s effbw (2*R*m/t); 4 KiB "
        f"allreduce {e2e_small * 1e3:.4f} ms")
    log("kernels " + "; ".join(
        f"{k['name']}: launches {k['launches']}, {k['ms']:.4f} ms, bound "
        f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
        f"{k['plain_ms']:.4f} ms, library {k['library_ms']}"
        for k in kernels))
    return kernels, extra


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import mvapich2_tpu_torch as mvt
    from mvapich2_tpu_torch.core import op as opmod
    from mvapich2_tpu_torch.ops import _build, hbm
    from mvapich2_tpu_torch.utils import detect, timing

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    name, smi = phase_device(torch)
    build_s = phase_build(_build)
    full_err = phase_kernels(torch, np, hbm, dev)
    launches, slice_launches, lat, inputs = phase_main_path(
        torch, np, mvt, hbm, opmod, dev)
    info = detect.detect(dev)
    kernels, extra = phase_times(torch, hbm, timing, info, inputs, lat,
                                 launches, full_err)
    total_s = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi,
                       "build_s": build_s, "total_s": total_s,
                       "slice_launches": slice_launches,
                       "kernels": kernels, **extra}, f, indent=1)
    log(f"[done] {total_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
