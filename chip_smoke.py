#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mvapich2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out report.json] [--sweep]

Needs one CUDA card of compute capability 9.0 (Hopper) and nvcc; exits
non-zero, printing no result, without them. Phases:

1. device: the card's name, and its name and power limit as nvidia-smi
   prints them;
2. build: the CUDA kernels, compiled from mvapich2_tpu_torch/csrc (one
   nvcc per source, all started together);
3. kernels: each kernel held against its plain PyTorch version on the
   card (bitwise on integer data, within stated tolerances otherwise),
   at small, ragged and full size: the slot kernels K1/K2, then the ring
   kernels K3/K5/K6/K7 at pipeline depth 2/3/4, one and two ring
   directions, and the four ops on K3;
4. main path: 8 ranks (run_ranks) allreduce 64 MiB f32 tensors each on
   cuda:0 through the slot channel into K1, plus the small collectives,
   then the one-chip bench candidates (K1 and K2) at the same size; the
   kernels' launch counts are zeroed before it and read after;
5. mesh path: 8 ranks bound one to one to a mesh of 8 virtual ranks on
   cuda:0 (run_ranks(device_mesh=make_mesh(...))): allreduce of 64 MiB
   (K3) and 64 KiB (K6), allgathers of 1 MiB (K5) and 64 KiB (K7), a max
   allreduce, reduce, bcast, reduce_scatter_block, each checked; the
   ring kernels' launch counts are zeroed before it and read after, and
   the tier pvars checked;
6. times, by CUDA events: each kernel beside its bound, its plain
   version and the library call; the staging stack; the end-to-end
   allreduce latency and effective bandwidth (2*R*m/t) of both paths.

The line before the last is a JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}. Any failure raises. ``--sweep`` runs
only phases 1 and 2, then the ring kernels' launch-shape sweep
(``phase_sweep``), which chose the ring launch shape in
``coll/tuning.py``.
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
SOURCES = ("hbm_slot", "ring")     # mvapich2_tpu_torch/csrc/<name>.cu
SMALL_MESH = 16 * 1024             # f32 elements: 64 KiB a rank (K6, K7)
AG_MESH = 256 * 1024               # f32 elements: 1 MiB a rank (K5)
RESIDENT_FULL = 1024 * 1024        # f32 elements: 4 MiB, the K6 limit


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
    """Compile every source at once (one nvcc each), then bind them."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    dt = time.perf_counter() - t0
    for name in SOURCES:
        lines = _build.BUILD_LOGS.get(name, "").splitlines()
        regs = [ln.strip() for ln in lines if "registers" in ln]
        log(f"[build] {name}.cu: {len(regs)} kernel instantiations "
            f"(ptxas e.g.: {regs[0] if regs else 'n/a'})")
    log(f"[build] built and loaded {', '.join(SOURCES)} in {dt:.2f} s")
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


def _shards(torch, np, rng, p, n, kind, dev):
    """p per-rank shards, each its own allocation (as ranks deposit)."""
    x = _data(torch, np, rng, (p, n), kind, dev)
    return [x[r].clone() for r in range(p)]


def phase_ring_kernels(torch, np, ici, ring, dev):
    """K3, K5, K6 and K7 against their plain versions (which replay the
    same ring schedule): small, ragged and full sizes, pipeline depth
    2/3/4, one and two ring directions, the four ops on K3. Returns the
    max abs error of the full-size f32 checks per kernel."""
    rng = np.random.default_rng(SEED + 100)
    n_checks = 0
    full_err = {}

    def check(what, got, want, kind, key=None):
        nonlocal n_checks
        torch.cuda.synchronize()
        ring.check_errors()
        err = _compare(torch, what, got, want, kind)
        n_checks += 1
        if key:
            full_err[key] = err

    # K3: small / ragged (n % p != 0, a short last chunk) / full size
    small_kinds = ("f32int", "i32", "f32", "bf16", "i8", "u8")
    for p, n in ((8, 64), (8, 37), (3, 10), (2, 9), (8, 1000)):
        for kind in small_kinds:
            xs = _shards(torch, np, rng, p, n, kind, dev)
            for op in ("sum", "max", "min", "prod"):
                check(f"K3 p={p} n={n} {kind} {op}",
                      ici.hbm_ring_all_reduce(xs, op, chunk_bytes=64),
                      ici.hbm_ring_all_reduce_ref(xs, op), kind)
    for n, cb in ((100003, 4096), (8 * 3584, 4096), (100003, None)):
        for kind in ("f32int", "f32"):
            xs = _shards(torch, np, rng, R, n, kind, dev)
            for depth in (2, 3, 4):
                for bidir in (True, False):
                    check(f"K3 n={n} chunk={cb} {kind} depth={depth} "
                          f"bidir={bidir}",
                          ici.hbm_ring_all_reduce(
                              xs, chunk_bytes=cb, depth=depth,
                              bidirectional=bidir),
                          ici.hbm_ring_all_reduce_ref(
                              xs, bidirectional=bidir), kind)
    for kind in ("f32int", "f32"):
        xs = _shards(torch, np, rng, R, N, kind, dev)
        check(f"K3 full {kind}", ici.hbm_ring_all_reduce(xs),
              ici.hbm_ring_all_reduce_ref(xs), kind,
              "K3" if kind == "f32" else None)
        del xs
    # K5
    for p, m, cb in ((8, 13, 16), (3, 5, 16), (8, 100003, 4096),
                     (8, AG_MESH, None)):
        for kind in ("i32", "f32", "i8"):
            xs = _shards(torch, np, rng, p, m, kind, dev)
            for depth in ((2, 3, 4) if m == 100003 else (2,)):
                for bidir in (True, False):
                    check(f"K5 p={p} m={m} {kind} depth={depth} "
                          f"bidir={bidir}",
                          ici.hbm_ring_all_gather(
                              xs, chunk_bytes=cb, depth=depth,
                              bidirectional=bidir),
                          ici.hbm_ring_all_gather_ref(
                              xs, bidirectional=bidir), kind)
    xs = _shards(torch, np, rng, R, N, "f32", dev)
    check("K5 full f32", ici.hbm_ring_all_gather(xs),
          ici.hbm_ring_all_gather_ref(xs), "f32", "K5")
    del xs
    # K6 (n % p == 0, at most 4 MiB) and K7 (output at most 4 MiB)
    for p, n in ((8, 64), (3, 12), (2, 8), (8, SMALL_MESH),
                 (8, RESIDENT_FULL)):
        for kind in ("f32int", "i32", "f32", "bf16", "i8"):
            xs = _shards(torch, np, rng, p, n, kind, dev)
            full = n == RESIDENT_FULL and kind == "f32"
            check(f"K6 p={p} n={n} {kind}", ring.ring_all_reduce(xs),
                  ring.ring_all_reduce_ref(xs), kind, "K6" if full else None)
    for p, m in ((8, 13), (3, 5), (2, 7), (8, SMALL_MESH),
                 (8, RESIDENT_FULL // 8)):
        for kind in ("i32", "f32", "u8"):
            xs = _shards(torch, np, rng, p, m, kind, dev)
            full = m == RESIDENT_FULL // 8 and kind == "f32"
            check(f"K7 p={p} m={m} {kind}", ring.ring_all_gather(xs),
                  ring.ring_all_gather_ref(xs), kind, "K7" if full else None)
    log(f"[kernels] {n_checks} ring kernel-vs-plain checks passed "
        f"(full-size f32 max abs err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in full_err.items()) + ")")
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


def phase_mesh(torch, np, mvt, ici, ring, mpit, opmod, dev, inputs):
    """The 1:1 path: run_ranks(8) bound one to one to a mesh of 8 virtual
    ranks on cuda:0. Allreduce of 64 MiB f32 (K3), of 64 KiB (K6) and of
    4 KiB (K6, timed), a 4 KiB max allreduce (K3), allgathers of 1 MiB
    (K5) and 64 KiB (K7) a rank, reduce (K6), bcast and
    reduce_scatter_block (stock). Every result is held against the
    plain reduction; the ring kernels' launch counts are zeroed before
    the run and read after it, and the tier pvars checked. Returns
    (launch counts, e2e latencies in s)."""
    mesh = mvt.make_mesh((R,), ("x",), dev)
    rng = np.random.default_rng(SEED + 200)
    small = [_data(torch, np, rng, (SMALL_MESH,), "f32", dev)
             for _ in range(R)]
    ag_big = [_data(torch, np, rng, (AG_MESH,), "f32int", dev)
              for _ in range(R)]
    n_check, n_warm, n_timed = 3, 2, 10
    tiny = 1024

    def app(comm):
        r, p = comm.rank, comm.size
        stream = torch.cuda.current_stream()
        me = inputs[r]
        outs = [comm.allreduce(me) for _ in range(n_check)]
        for _ in range(n_warm):
            comm.allreduce(me)
        lat = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            comm.allreduce(me)
            stream.synchronize()
            lat.append(time.perf_counter() - t0)
        base = torch.arange(tiny, dtype=torch.float32, device=dev)
        lat_small = []
        for _ in range(n_warm + n_timed):
            t0 = time.perf_counter()
            comm.allreduce(base)
            stream.synchronize()
            lat_small.append(time.perf_counter() - t0)
        sm = comm.allreduce(small[r])
        mx = comm.allreduce(base + r, op=opmod.MAX)
        agb = comm.allgather(ag_big[r])
        ags = comm.allgather(small[r])
        red = comm.reduce((base + r).cpu().numpy(), root=3)
        b = comm.bcast(base * 3 if r == 5 else torch.zeros_like(base),
                       root=5)
        rsb = comm.reduce_scatter_block(
            torch.arange(p * 5, dtype=torch.float32, device=dev) + r)
        stream.synchronize()
        return outs, (lat, lat_small[n_warm:]), (sm, mx, agb, ags, red, b,
                                                 rsb)

    tiers = ("dev_coll_tier_vmem", "dev_coll_tier_hbm",
             "dev_coll_fallback_size", "dev_coll_fallback_dtype")
    before = {k: mpit.pvar(k).read() for k in tiers}
    ici.reset_counts()
    ring.reset_counts()
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app, device_mesh=mesh)
    torch.cuda.synchronize()
    ring.check_errors()
    wall = time.perf_counter() - t0
    launches = {**ici.LAUNCHES, **ring.LAUNCHES}
    n_big = n_check + n_warm + n_timed
    want_launches = {"hbm_ring_all_reduce": n_big + 1,      # + the max
                     "hbm_ring_all_gather": 1,
                     "ring_all_reduce": n_warm + n_timed + 2,  # + 64 KiB, reduce
                     "ring_all_gather": 1}
    if launches != want_launches:
        raise AssertionError(f"ring launches on the mesh path {launches}, "
                             f"expected {want_launches}")
    delta = {k: mpit.pvar(k).read() - before[k] for k in tiers}
    want_tiers = {"dev_coll_tier_vmem": R * (n_warm + n_timed + 4),
                  "dev_coll_tier_hbm": R * (n_big + 1),
                  "dev_coll_fallback_size": 0, "dev_coll_fallback_dtype": 0}
    if delta != want_tiers:
        raise AssertionError(f"tier pvars moved by {delta}, expected "
                             f"{want_tiers}")
    # results against the plain reduction
    want = torch.stack(inputs).sum(0)
    err = 0.0
    for i in range(n_check):
        got = [res[r][0][i] for r in range(R)]
        if len({g.data_ptr() for g in got}) != R:
            raise AssertionError("mesh allreduce: ranks share an output")
        for g in got:
            if g.shape != (N,) or not torch.isfinite(g).all():
                raise AssertionError("mesh allreduce result has the wrong "
                                     "shape or non-finite values")
            err = max(err, _compare(torch, f"mesh allreduce call {i}", g,
                                    want, "f32"))
    a = np.arange(tiny, dtype=np.float32)
    want_sm = torch.stack(small).sum(0)
    want_agb = torch.cat(ag_big)
    want_ags = torch.cat(small)
    for r in range(R):
        sm, mx, agb, ags, red, b, rsb = res[r][2]
        _compare(torch, "mesh 64 KiB allreduce", sm, want_sm, "f32")
        np.testing.assert_array_equal(mx.cpu().numpy(), a + R - 1)
        _compare(torch, "mesh 1 MiB allgather", agb, want_agb, "f32int")
        _compare(torch, "mesh 64 KiB allgather", ags, want_ags, "f32int")
        if r == 3:
            np.testing.assert_array_equal(red, a * R + sum(range(R)))
        np.testing.assert_array_equal(b.cpu().numpy(), a * 3)
        np.testing.assert_array_equal(
            rsb.cpu().numpy(),
            np.arange(r * 5, r * 5 + 5, dtype=np.float32) * R + sum(range(R)))
    log(f"[mesh] run_ranks({R}, device_mesh={mesh}): {n_big} allreduces of "
        f"64 MiB f32, {n_warm + n_timed} of 4 KiB, + 64 KiB allreduce, max, "
        f"1 MiB and 64 KiB allgathers, reduce, bcast, reduce_scatter_block "
        f"in {wall:.2f} s; results checked (max abs err {err:.3g}); "
        f"launches {launches}; tier pvars {delta}")
    return launches, res[0][1]


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


def phase_ring_times(torch, np, ici, ring, timing, info, inputs, mesh_lat,
                     launches, full_err):
    """Each ring kernel at the shapes the mesh path gives it, by CUDA
    events: its time, its plain version's, the library call's, its bound
    (each input read once, each output written once, over the memory
    rate; the adds over the f32 peak) and the bytes its schedule moves
    through device memory over the same rate."""
    bw = info.hbm_bw_gbps * 1e9
    rng = np.random.default_rng(SEED + 300)
    p = R

    def bound(nbytes, flops):
        tb, to = nbytes / bw * 1e3, flops / (F32_PEAK_TFLOPS * 1e12) * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def entry(name, kern, src_line, xs, fn, plain, lib, out_elems, flops,
              sched_bytes, sched_formula):
        n_in = sum(x.numel() for x in xs) * 4
        ms = timing.time_ms(fn)
        plain_ms = timing.time_ms(plain, warmup=1, iters=5)
        lib_ms = timing.time_ms(lib)
        b, by = bound(n_in + out_elems * 4, flops)
        ring.check_errors()
        return {"name": name, "route": "cuda",
                "source": "mvapich2_tpu_torch/csrc/ring.cu",
                "replaces": src_line, "launches": launches[name],
                "max_abs_err": full_err[kern], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": lib_ms,
                "schedule_bound_ms": sched_bytes / bw * 1e3,
                "schedule_bytes": sched_formula}

    m = N * 4
    dev = inputs[0].device
    small = [_data(torch, np, rng, (SMALL_MESH,), "f32", dev)
             for _ in range(p)]
    ag = [_data(torch, np, rng, (AG_MESH,), "f32", dev) for _ in range(p)]
    ms_, ma = SMALL_MESH * 4, AG_MESH * 4
    kernels = [
        entry("hbm_ring_all_reduce", "K3", "mvapich2_tpu/ops/pallas_ici.py:501",
              inputs, lambda: ici.hbm_ring_all_reduce(inputs),
              lambda: ici.hbm_ring_all_reduce_ref(inputs),
              lambda: torch.stack(inputs).sum(0), p * N, (p - 1) * N,
              p * (2 * m + (p - 1) * 9 * m / p),
              "p*(2m + (p-1)*9m/p): init copy, 5m/p a reduce-scatter "
              "step, 4m/p an all-gather step"),
        entry("hbm_ring_all_gather", "K5", "mvapich2_tpu/ops/pallas_ici.py:545",
              ag, lambda: ici.hbm_ring_all_gather(ag),
              lambda: ici.hbm_ring_all_gather_ref(ag),
              lambda: torch.cat(ag), p * p * AG_MESH, 0,
              p * (2 * ma + (p - 1) * 4 * ma),
              "p*(2m + (p-1)*4m): own block copied, 4m a step"),
        entry("ring_all_reduce", "K6", "mvapich2_tpu/ops/pallas_ring.py:214",
              small, lambda: ring.ring_all_reduce(small),
              lambda: ring.ring_all_reduce_ref(small),
              lambda: torch.stack(small).sum(0), p * SMALL_MESH,
              (p - 1) * SMALL_MESH,
              p * (2 * ms_ + (p - 1) * 9 * ms_ / p),
              "p*(2m + (p-1)*9m/p), as K3"),
        entry("ring_all_gather", "K7", "mvapich2_tpu/ops/pallas_ring.py:114",
              small, lambda: ring.ring_all_gather(small),
              lambda: ring.ring_all_gather_ref(small),
              lambda: torch.cat(small), p * p * SMALL_MESH, 0,
              p * (2 * ms_ + (p - 1) * 4 * ms_),
              "p*(2m + (p-1)*4m), as K5"),
    ]
    lat, lat_small = mesh_lat
    extra = {"mesh_e2e_allreduce_ms": statistics.median(lat) * 1e3,
             "mesh_e2e_allreduce_ms_all": [t * 1e3 for t in lat],
             "mesh_e2e_small_allreduce_ms": statistics.median(lat_small) * 1e3,
             "mesh_e2e_small_allreduce_ms_all": [t * 1e3 for t in lat_small],
             "mesh_e2e_effbw_GBps": 2 * R * m / statistics.median(lat) / 1e9}
    log("[times] ring kernels " + "; ".join(
        f"{k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f}, schedule "
        f"bound {k['schedule_bound_ms']:.4f}, plain {k['plain_ms']:.4f}, "
        f"library {k['library_ms']:.4f}), launches {k['launches']}"
        for k in kernels))
    log(f"[times] mesh e2e allreduce 64 MiB {extra['mesh_e2e_allreduce_ms']:.4f}"
        f" ms = {extra['mesh_e2e_effbw_GBps']:.1f} GB/s effbw (2*R*m/t); "
        f"4 KiB {extra['mesh_e2e_small_allreduce_ms']:.4f} ms")
    return kernels, extra


def phase_sweep(torch, ici, ring, tuning, timing, dev):
    """The ring kernels' launch-shape sweep (``--sweep``): K3 at 8 ranks
    x 64 MiB f32 over threads per block x blocks per SM x chunk bytes x
    pipeline depth, and K6 at 8 ranks x 64 KiB f32 over threads x blocks
    per SM, by CUDA events (median of 10 after 2 warm-ups). Every
    configuration is first held against the plain version (bitwise on
    integer-valued data). Returns the rows."""
    import itertools
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    def record(kernel, fn, want, threads, per_sm, **cfg):
        tuning.set_kernel_param("ring_threads", threads)
        tuning.set_kernel_param("ring_blocks_per_sm", per_sm)
        got = fn()
        ring.check_errors()
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {cfg}: kernel and plain "
                                 f"version disagree")
        ms = timing.time_ms(fn, warmup=2, iters=10)
        rows.append({"kernel": kernel, "threads": threads,
                     "blocks_per_sm": per_sm, **cfg, "ms": ms})
        log(f"[sweep] {rows[-1]}")

    def ints(n):
        return [torch.randint(-1000, 1000, (n,), device=dev, generator=gen)
                .float() for _ in range(R)]

    x = ints(N)
    want = ici.hbm_ring_all_reduce_ref(x)
    for threads, per_sm, cb, depth in itertools.product(
            (256, 512, 1024), (1, 2), (256 << 10, 1 << 20, 4 << 20),
            (2, 4)):
        record("K3", lambda: ici.hbm_ring_all_reduce(
            x, chunk_bytes=cb, depth=depth), want, threads, per_sm,
            chunk_bytes=cb, depth=depth)
    del x, want
    small = ints(SMALL_MESH)
    want = ring.ring_all_reduce_ref(small)
    for threads, per_sm in itertools.product((256, 512, 1024), (1, 2)):
        record("K6", lambda: ring.ring_all_reduce(small), want, threads,
               per_sm)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="run only the ring kernels' launch-shape sweep "
                    "(after the device and build phases)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import mvapich2_tpu_torch as mvt
    from mvapich2_tpu_torch import mpit
    from mvapich2_tpu_torch.core import op as opmod
    from mvapich2_tpu_torch.ops import _build, hbm, ici, ring
    from mvapich2_tpu_torch.utils import detect, timing

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    name, smi = phase_device(torch)
    build_s = phase_build(_build)
    if args.sweep:
        from mvapich2_tpu_torch.coll import tuning
        rows = phase_sweep(torch, ici, ring, tuning, timing, dev)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"device": name, "nvidia_smi": smi, "rows": rows},
                          f, indent=1)
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    full_err = phase_kernels(torch, np, hbm, dev)
    full_err.update(phase_ring_kernels(torch, np, ici, ring, dev))
    launches, slice_launches, lat, inputs = phase_main_path(
        torch, np, mvt, hbm, opmod, dev)
    mesh_launches, mesh_lat = phase_mesh(torch, np, mvt, ici, ring, mpit,
                                         opmod, dev, inputs)
    info = detect.detect(dev)
    kernels, extra = phase_times(torch, hbm, timing, info, inputs, lat,
                                 launches, full_err)
    ring_kernels, ring_extra = phase_ring_times(
        torch, np, ici, ring, timing, info, inputs, mesh_lat,
        mesh_launches, full_err)
    kernels += ring_kernels
    extra.update(ring_extra)
    total_s = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi,
                       "build_s": build_s, "total_s": total_s,
                       "slice_launches": slice_launches,
                       "mesh_launches": mesh_launches,
                       "kernels": kernels, **extra}, f, indent=1)
    log(f"[done] {total_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
